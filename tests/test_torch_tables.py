"""Stencils past the CUDA encoder's old fixed tables, read on the CPU.

The kernels' tables (records and ops, constants, the field table, the
parameters) and their stack are sized by what each launch holds, in shared
memory; only a launch past a CTA's 227 KB is refused.  A K1 launch group
whose program passes ``cuda.K1_PROGRAM_BYTES`` is cut at a statement
boundary, and a K-blocked solver whose marching-previous reads K4's carry
and copy tables cannot hold marches whole-column on K2.

Each case below passes one limit the encoder had before (64 fields and
temporaries, 16 parameters, 1024 op words, 256 constants, a stack of 16,
K1's program of one launch, K4's tables), and one passes the kernels'
small kernel-parameter table (the stencils: ``TABLE_CASES`` in
``test_torch_cuda.py``, which runs them on the card).  Each stencil is
encoded through
``CudaStencil``, read in torch by ``_StreamEvaluator`` (the kernels'
reading of the stream, ``test_torch_cuda.py``) and held against the plain
lowering and the reference's jnp lowering of the same stencil at
rtol = atol = 1e-6, on inputs made from a numpy seed.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import stencil as RS
from repro.core.backend import compile_stencil as r_compile_stencil

from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.core.backend import cuda as C
from repro_torch.core import stencil as TS

from test_torch_cuda import (TABLE_BLOCKED, TABLE_CASES, TABLE_DOM,
                             _StreamEvaluator, _table_stencil)

@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _inputs(stencil, dom, seed):
    rng = np.random.default_rng(seed)
    fields = {f: rng.uniform(0.5, 1.5, (2,) + dom.padded_shape(
        stencil.is_interface(f))).astype(np.float32)
        for f in stencil.fields}
    params = {p: float(rng.uniform(0.5, 1.5)) for p in stencil.params}
    return fields, params


def _read(run, fields, params):
    """Every launch of ``run`` read as the kernels read it: the written
    fields."""
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    ev = _StreamEvaluator([env[n] for n in run.slot_names],
                          [float(params[p]) for p in run.stencil.params], [])
    for p in run.programs:
        ev.consts = torch.tensor(p.consts or [0.0], dtype=torch.float32)
        ev.launch(p)
    return {w: env[w] for w in run.written}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_stencils_past_the_old_tables_match_plain_and_reference(case):
    st = TABLE_CASES[case](TS)
    dom = TS.DomainSpec(**TABLE_DOM)
    blocked = case == "K4 tables"
    run = C.CudaStencil(st, dom, schedule=TS.Schedule(**TABLE_BLOCKED)
                        if blocked else None)
    programs = run.programs
    assert all(p.smem_bytes(C.copy_depth(p) if p.block_k else 1)
               <= C.SMEM_MAX for p in programs)
    if case == "70 fields":
        assert len(run.slot_names) == 70
        assert [p.kind for p in programs] == ["column"]
    elif case == "100 fields":
        words, _ = C.table_words(len(programs[0].prog), 100, 0,
                                 len(programs[0].consts))
        assert words > C.TABLE_SMALL
    elif case == "20 parameters":
        assert len(st.params) == 20
    elif case == "1024 op words":
        assert [len(p.prog) > 1024 for p in programs] == [True]
    elif case == "256 constants":
        assert [len(p.consts) for p in programs] == [300]
    elif case == "stack of 16":
        assert [p.stack > 31 for p in programs] == [True]
    elif case == "K1 group split":
        # one launch would keep tmp on the stack; the cut stores it
        enc = C.Encoder(run.stencil, dom)
        assert "tmp" in enc.parallel(list(st.computations[0].statements)).kept
        assert len(programs) >= 2
        assert all(4 * (len(p.prog) + len(p.consts)) <= C.K1_PROGRAM_BYTES
                   for p in programs)
        assert not any("tmp" in p.kept for p in programs)
    elif blocked:
        with pytest.raises(C.KBlockedTablesFull):
            C.Encoder(run.stencil, dom).kblocked(TABLE_BLOCKED["block_k"])
        assert [p.kind for p in programs] == ["column"]
        assert run.kblocked_refused
    fields, params = _inputs(run.stencil, dom,
                             seed=list(TABLE_CASES).index(case))
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    got = _read(run, tfields, params)
    want = run.plain(tfields, params)
    ref = r_compile_stencil(TABLE_CASES[case](RS),
                            RS.DomainSpec(**TABLE_DOM), backend="jnp")
    for t in range(2):
        rgot = ref({k: jnp.asarray(v[t]) for k, v in fields.items()}, params)
        for w in run.written:
            np.testing.assert_allclose(got[w][t].numpy(),
                                       np.asarray(rgot[w]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{case}: {w}")
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6,
                                   msg=f"{case}: {w}")


def test_only_a_launch_past_the_cards_shared_memory_is_refused():
    """A statement whose stack alone passes a K1 CTA's 227 KB."""
    S = TS
    e = S.FieldAccess("a")
    for n in range(C.SMEM_MAX // (4 * C.STRIP * C.K1_BLOCK) // 2 + 1):
        e = S.Where(S.FieldAccess("c") > 0.5, S.FieldAccess("b"), e)
    st = _table_stencil(S, "too_deep", [S.Assign("out", e)],
                        ["a", "b", "c", "out"])
    with pytest.raises(ValueError, match="227 KB of shared memory"):
        C.CudaStencil(st, S.DomainSpec(**TABLE_DOM))


def test_opt_report_counts_the_solvers_k4_refused():
    """A node whose schedule K-blocks a solver that K4's tables refuse runs
    on K2, and the optimizer's report counts it; the program computes what
    the plain backend computes."""
    from repro_torch.core.backend import compile_program
    from repro_torch.core.graph import StencilProgram

    dom = TS.DomainSpec(**TABLE_DOM)
    st = TABLE_CASES["K4 tables"](TS)
    p = StencilProgram("one", dom)
    for f in st.fields:
        p.declare(f)
    p.add(st, {f: f for f in st.fields})
    p.propagate_extents()
    blocked = {st.name: TS.Schedule(**TABLE_BLOCKED)}
    run = compile_program(p, "cuda", opt_level=1, device="cpu",
                          schedule_overrides=blocked)
    plain = compile_program(p, "torch", opt_level=1, device="cpu",
                            schedule_overrides=blocked)
    assert run.opt_report.kblocked_on_column == 1
    assert "K4's tables full" in run.opt_report.summary()
    assert plain.opt_report.kblocked_on_column == 0
    fields, _ = _inputs(st, dom, seed=11)
    fields = {k: torch.from_numpy(v[0]) for k, v in fields.items()}
    got, want = run(dict(fields)), plain(dict(fields))
    torch.testing.assert_close(got["x"], want["x"], rtol=0, atol=0)
