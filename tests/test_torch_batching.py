"""The port's member batching (``repro_torch.core.backend.batching``) against
the reference's: the same spellings accepted and rejected, the same parsed
specs and derived counts, and the same padding and chunk loops on the same
numbers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import batching as RB

from repro_torch.core.backend import batching as TB

GOOD = ["vmap", "grid", "vmap:4", "vmap:4,scan", "vmap:4,grid", "grid:4",
        "grid:4,scan", "vmap:1", "vmap:auto", "vmap:auto,grid", "grid:auto"]
BAD = ["vmap:0", "vmap:-3", "vmap:x", "vmap:2,foo", "grid:2,grid",
       "vmap:2,scan,extra", "", "pmap", "vmap:", ":2", "vmap,grid",
       "vmap:2:3", "vmap:2,"]


def _fields(spec):
    return (spec.mode, spec.chunk, spec.loop)


@pytest.mark.parametrize("text", GOOD)
def test_parse_batch_agrees_with_reference(text):
    ref, got = RB.parse_batch(text), TB.parse_batch(text)
    assert _fields(got) == _fields(ref)
    assert got.token == ref.token
    assert TB.parse_batch(got.token) == got
    assert TB.parse_batch(got) is got
    if got.chunk != TB.AUTO:
        for m in (1, 2, 3, 5, 8):
            assert got.chunk_for(m) == ref.chunk_for(m)
            assert got.n_chunks(m) == ref.n_chunks(m)
            assert got.padded_members(m) == ref.padded_members(m)


@pytest.mark.parametrize("text", BAD)
def test_parse_batch_rejects_what_reference_rejects(text):
    with pytest.raises(ValueError, match="batch"):
        RB.parse_batch(text)
    with pytest.raises(ValueError, match="batch"):
        TB.parse_batch(text)


def test_batchspec_typed_fields_and_validation():
    sp = TB.BatchSpec(mode="vmap", chunk=4, loop="grid")
    assert _fields(sp) == ("vmap", 4, "grid")
    assert TB.parse_batch("vmap:4,grid") == sp
    assert dataclasses.replace(sp, chunk=8) == TB.BatchSpec("vmap", 8, "grid")
    assert TB.BatchSpec() == TB.BatchSpec(mode="vmap", chunk=0, loop="scan")
    for kw in ({"mode": "pmap"}, {"loop": "pmap"}, {"chunk": -2},
               {"mode": "grid", "chunk": 2, "loop": "grid"}):
        with pytest.raises(ValueError, match="batch"):
            TB.BatchSpec(**kw)
        with pytest.raises(ValueError, match="batch"):
            RB.BatchSpec(**kw)
    with pytest.raises(ValueError, match="auto"):
        TB.parse_batch("vmap:auto").chunk_for(4)
    with pytest.raises(ValueError, match="batch"):
        TB.parse_batch(4)


@pytest.mark.parametrize("m,padded", [(3, 3), (3, 4), (5, 6), (1, 4)])
def test_pad_members_replicates_the_last_member(m, padded):
    x = np.random.default_rng(m).standard_normal((m, 2, 3)).astype(np.float32)
    ref = np.asarray(RB.pad_members(jnp.asarray(x), m, padded))
    got = TB.pad_members(torch.from_numpy(x), m, padded)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape[0] == padded


def _member_runner(fields, params=None):
    """A runner (of jax or torch arrays) whose result depends on each
    member and on the chunk's width, so a wrong slice or a lost pad
    shows."""
    x = fields["x"]
    n = x.shape[0]
    return {"y": x * 2.0 + n, "z": x[..., :1] - 1.0}


@pytest.mark.parametrize("m,c", [(5, 2), (4, 2), (3, 3), (3, 5), (6, 4)])
def test_scan_chunked_agrees_with_reference(m, c):
    x = np.random.default_rng(c).standard_normal((m, 3, 4)).astype(np.float32)
    ref = RB.scan_chunked(_member_runner, m, min(c, m))(
        {"x": jnp.asarray(x)})
    got = TB.scan_chunked(_member_runner, m, min(c, m))(
        {"x": torch.from_numpy(x)})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_pad_wrapped_agrees_with_reference():
    x = np.random.default_rng(1).standard_normal((3, 2, 2)).astype(np.float32)
    ref = RB.pad_wrapped(_member_runner, 3, 4)({"x": jnp.asarray(x)})
    got = TB.pad_wrapped(_member_runner, 3, 4)({"x": torch.from_numpy(x)})
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
