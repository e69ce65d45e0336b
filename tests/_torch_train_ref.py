"""Helpers of the port's training tests: the reference's parameters and a
batch from numpy seeds, the port's model carrying them, and the
comparison of the port's gradients (mapped back onto the reference's
stacked tree) with the reference's."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.models import (Transformer, load_reference_params,
                                param_tree, reference_tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread while a training test file runs: its ops are
    small, and the suite runs several worker processes on the machine's
    cores, where each one's thread pool spinning on the same cores made
    the 40-step loss test ~60x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **changes):
    import dataclasses
    return (dataclasses.replace(RC.smoke_config(arch), **changes),
            dataclasses.replace(TC.smoke_config(arch), **changes))


def ref_params(rcfg, seed=0):
    return ref_init_params(RT.model_pdefs(rcfg), jax.random.PRNGKey(seed))


def port_model(cfg, params) -> Transformer:
    model = Transformer(cfg, dtype=torch.float32, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return model.requires_grad_(True)


def batch(cfg, B, S, seed):
    """tokens, labels (B, S - npre) int32 and the prefix (B, npre,
    d_model) float32 or None, from numpy."""
    rng = np.random.default_rng(seed)
    npre = cfg.n_prefix_embeds
    toks = rng.integers(0, cfg.vocab, (B, S - npre)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (B, S - npre)).astype(np.int32)
    pre = ((rng.standard_normal((B, npre, cfg.d_model)) * 0.02)
           .astype(np.float32) if npre else None)
    return toks, labs, pre


def port_grads(model) -> dict:
    """The model's ``.grad``s on the reference's stacked tree (numpy)."""
    return reference_tree({k: [t.grad for t in v] if isinstance(v, list)
                           else v.grad for k, v in param_tree(model).items()})


def assert_trees_close(got, want, rtol, atol, path=""):
    """Every leaf of the reference's tree ``want`` in ``got`` within
    rtol/atol, and no leaf more or less."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k], np.float32),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{path}/{k}")
