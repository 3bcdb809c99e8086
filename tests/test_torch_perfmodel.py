"""The port's §5 models (``repro_torch.core.perfmodel``) against the JAX
reference's: every predictor equal EXACTLY (``==`` on numpy float64) on the
same workload built from bit-identical port and JAX plans, with the paper's
``ABEL`` parameters and one made-up ``HardwareParams``.

Covers every gather and put rung × materialize {None, full, dest} ×
``use_kernel``, their component terms, the fused-window and scan
compositions, the decode floors, the Heat2D window/scan models,
``plan_build_time``, ``model_error`` / ``error_budget``, and the reference
module's doctest examples run on the port.
"""
import dataclasses
import doctest
import itertools

import numpy as np
import pytest

from repro.comm import plan as jplan
from repro.core import matrix as jmatrix
from repro.core import perfmodel as jpm
from repro_torch.comm import plan as tplan
from repro_torch.core import perfmodel as tpm

P = 8
N = 64 * P
R = 6
BLOCKSIZE = 16
RUNGS = ("replicate", "blockwise", "condensed", "overlap")
MATERIALIZE = (None, "full", "dest")
HW_FIELDS = dict(ABEL=None,
                 made_up=dict(w_private=3.1e11, w_remote=7.7e10, tau=2.3e-5,
                              cacheline=96, elem=4, idx=4))


def _hw(mod, which):
    return mod.ABEL if which == "ABEL" else mod.HardwareParams(
        **HW_FIELDS[which])


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan, JAX scatter plan, port scatter plan) of one
    mesh-like matrix, 2 ranks a node, with a Destination attached."""
    m = jmatrix.make_mesh_like_matrix(N, R, locality_window=N // 8,
                                      long_range_frac=0.1, seed=5)
    jt, tt = jplan.Topology(P, 2), tplan.Topology(P, 2)
    jp = jplan.build_comm_plan(m.cols, N, P, blocksize=BLOCKSIZE,
                               topology=jt)
    tp = tplan.build_comm_plan(m.cols, N, P, blocksize=BLOCKSIZE,
                               topology=tt)
    for f in dataclasses.fields(tp.counts):
        np.testing.assert_array_equal(getattr(tp.counts, f.name),
                                      getattr(jp.counts, f.name))
    return jp, tp, jplan.derive_scatter_plan(jp), tplan.derive_scatter_plan(tp)


def _workloads(plans, direction, materialize, use_kernel):
    jp, tp, js, ts = plans
    jsrc, tsrc = (js, ts) if direction == "put" else (jp, tp)
    kw = dict(materialize=materialize, use_kernel=use_kernel,
              dest_slots=(N // P) * R if materialize == "dest" else None)

    def make(mod, src):
        return mod.SpmvWorkload(n=src.n, r_nz=R, p=src.p,
                                blocksize=src.blocksize,
                                topology=src.topology, counts=src.counts,
                                m=src.m, **kw)
    return make(jpm, jsrc), make(tpm, tsrc)


def _same(a, b):
    """Exact equality of nested results (floats, arrays, dicts, tuples)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


CASES = list(itertools.product(RUNGS, ("get", "put"), MATERIALIZE,
                               (False, True), HW_FIELDS))


@pytest.mark.parametrize("rung,direction,materialize,use_kernel,hw", CASES)
def test_rung_predictors_equal(plans, rung, direction, materialize,
                               use_kernel, hw):
    jw, tw = _workloads(plans, direction, materialize, use_kernel)
    jh, th = _hw(jpm, hw), _hw(tpm, hw)
    table = "PUT_STRATEGY_PREDICTORS" if direction == "put" \
        else "STRATEGY_PREDICTORS"
    want = getattr(jpm, table)[rung](jw, jh)
    got = getattr(tpm, table)[rung](tw, th)
    assert got > 0 and np.isfinite(got)
    _same(float(want), float(got))
    _same(jpm.predict_decode_exchange(jw, jh, strategy=rung,
                                      direction=direction),
          tpm.predict_decode_exchange(tw, th, strategy=rung,
                                      direction=direction))
    _same(jpm.decode_floor(jw, jh, strategy=rung, direction=direction),
          tpm.decode_floor(tw, th, strategy=rung, direction=direction))


@pytest.mark.parametrize("materialize,use_kernel,hw", list(
    itertools.product(MATERIALIZE, (False, True), HW_FIELDS)))
def test_components_and_tables_equal(plans, materialize, use_kernel, hw):
    jh, th = _hw(jpm, hw), _hw(tpm, hw)
    jw, tw = _workloads(plans, "get", materialize, use_kernel)
    _same(jpm.v3_components(jw, jh), tpm.v3_components(tw, th))
    _same(jpm.t_comp_per_thread(jw, jh), tpm.t_comp_per_thread(tw, th))
    _same(jpm.predict_v1(jw, jh), tpm.predict_v1(tw, th))
    _same(jpm.predict_all(jw, jh), tpm.predict_all(tw, th))
    jw, tw = _workloads(plans, "put", materialize, use_kernel)
    _same(jpm.put_components(jw, jh), tpm.put_components(tw, th))
    _same(jpm.predict_put_all(jw, jh), tpm.predict_put_all(tw, th))
    assert set(jpm.STRATEGY_PREDICTORS) == set(tpm.STRATEGY_PREDICTORS)
    assert set(jpm.PUT_STRATEGY_PREDICTORS) == set(
        tpm.PUT_STRATEGY_PREDICTORS)


def _stages(plans, mod, rungs, use_kernel):
    jp, tp, js, ts = plans
    g, s = (jp, js) if mod is jpm else (tp, ts)

    def w(src, materialize):
        return mod.SpmvWorkload(
            n=src.n, r_nz=R, p=src.p, blocksize=src.blocksize,
            topology=src.topology, counts=src.counts, m=src.m,
            materialize=materialize, use_kernel=use_kernel,
            dest_slots=(N // P) * R if materialize == "dest" else None)
    return [("gather_x", "get", w(g, "dest"), rungs[0]),
            ("scatter_t", "put", w(s, None), rungs[1])]


@pytest.mark.parametrize("rungs", [("condensed", "condensed"),
                                   ("overlap", "blockwise"),
                                   ("replicate", None), (None, None)])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("hw", list(HW_FIELDS))
def test_schedule_compositions_equal(plans, rungs, use_kernel, hw):
    jh, th = _hw(jpm, hw), _hw(tpm, hw)
    js, ts = (_stages(plans, jpm, rungs, use_kernel),
              _stages(plans, tpm, rungs, use_kernel))
    _same(jpm.predict_schedule(js, jh), tpm.predict_schedule(ts, th))
    _same(jpm.predict_decode_step(js, jh), tpm.predict_decode_step(ts, th))
    for n_steps, credit in ((1, 0.0), (50, 0.0), (50, 1e-6)):
        _same(jpm.predict_scan_schedule(js, jh, n_steps,
                                        overlap_credit=credit),
              tpm.predict_scan_schedule(ts, th, n_steps,
                                        overlap_credit=credit))
    topo_j, topo_t = js[0][2].topology, ts[0][2].topology
    _same(jpm.window_setup_time(topo_j, jh), tpm.window_setup_time(topo_t,
                                                                   th))
    _same(jpm.scan_loop_cost(3e-4, 2e-5, 17, overlap_credit=1e-5),
          tpm.scan_loop_cost(3e-4, 2e-5, 17, overlap_credit=1e-5))


@pytest.mark.parametrize("grid", [(2, 4), (1, 8), (4, 4)])
@pytest.mark.parametrize("materialize", [None, "dest", "full"])
@pytest.mark.parametrize("hw", list(HW_FIELDS))
def test_heat2d_models_equal(grid, materialize, hw):
    jh, th = _hw(jpm, hw), _hw(tpm, hw)
    mprocs, nprocs = grid
    p = mprocs * nprocs

    def w(mod, topo_mod):
        return mod.Heat2DWorkload(big_m=4096, big_n=2048, mprocs=mprocs,
                                  nprocs=nprocs,
                                  topology=topo_mod.Topology(p, 4))
    jw, tw = w(jpm, jplan), w(tpm, tplan)
    for steps in (1, 10):
        _same(jpm.predict_heat2d(jw, jh, steps=steps,
                                 materialize=materialize),
              tpm.predict_heat2d(tw, th, steps=steps,
                                 materialize=materialize))
        _same(jpm.predict_heat2d_window(jw, jh, steps=steps,
                                        materialize=materialize),
              tpm.predict_heat2d_window(tw, th, steps=steps,
                                        materialize=materialize))
        _same(jpm.predict_heat2d_scan(jw, jh, steps,
                                      materialize=materialize),
              tpm.predict_heat2d_scan(tw, th, steps,
                                      materialize=materialize))
    _same(jpm.heat2d_edge_ring_comp(jw, jh), tpm.heat2d_edge_ring_comp(tw,
                                                                       th))
    _same(jpm.full_assembly_tax(4096 * 2048, jh),
          tpm.full_assembly_tax(4096 * 2048, th))


@pytest.mark.parametrize("source", jpm.PLAN_SOURCES)
@pytest.mark.parametrize("hw", list(HW_FIELDS))
def test_plan_build_time_equal(source, hw):
    assert tpm.PLAN_SOURCES == jpm.PLAN_SOURCES
    jh, th = _hw(jpm, hw), _hw(tpm, hw)
    for m, r in ((1, 1), (4096, 16), (1 << 22, 16)):
        _same(jpm.plan_build_time(m, r, jh, source=source),
              tpm.plan_build_time(m, r, th, source=source))
    _same(jpm.replan_break_even_steps(1e-3, 2e-4, 1e-4),
          tpm.replan_break_even_steps(1e-3, 2e-4, 1e-4))
    _same(jpm.replan_break_even_steps(1e-3, 1e-4, 2e-4),
          tpm.replan_break_even_steps(1e-3, 1e-4, 2e-4))
    with pytest.raises(ValueError, match="unknown plan source"):
        tpm.plan_build_time(4, 4, th, source="nowhere")


def test_model_error_and_budget_equal():
    for a, b in ((2.0, 1.0), (1.0, 2.0), (1.5, 1.5), (0.0, 0.0),
                 (0.0, 1e-3), (3.3e-4, 4.5e-4)):
        _same(jpm.model_error(a, b), tpm.model_error(a, b))
    with pytest.raises(ValueError):
        tpm.model_error(-1.0, 1.0)
    cells = [{}, {"rung": "condensed", "workload": "spmv",
                  "dtype": "float32", "mesh": [8]},
             {"strategy": "overlap", "workload": "spmv_kernel",
              "dtype": "bfloat16", "mesh": [2, 4]},
             {"rung": "auto", "workload": "unknown", "mesh": 8}]
    cells += [{"rung": r, "workload": w, "dtype": d, "mesh": m}
              for r in RUNGS for w in jpm.ERROR_BUDGET_WORKLOADS
              for d in jpm.ERROR_BUDGET_DTYPES for m in ([8], [2, 4])]
    for cell in cells:
        _same(jpm.error_budget(cell), tpm.error_budget(cell))
    assert tpm.ERROR_BUDGET_DEFAULT == jpm.ERROR_BUDGET_DEFAULT
    assert tpm.ERROR_BUDGET_RUNGS == jpm.ERROR_BUDGET_RUNGS


def test_constants_and_surface():
    """ABEL is the paper's Table-4 machine in both packages; the port keeps
    every public name of the reference but the TPU constants."""
    assert dataclasses.asdict(tpm.ABEL) == dataclasses.asdict(jpm.ABEL)
    assert not hasattr(tpm, "TPU_V5E")
    assert set(tpm.__all__) == set(jpm.__all__) - {"TPU_V5E"}
    assert tpm.HardwareParams(1.0, 2.0, 3.0, 4).replace(tau=5.0).tau == 5.0


def test_reference_doctests_run_on_port():
    """The reference module's doctest examples, run against the port's
    module: the same examples, and every one passes there."""
    finder = doctest.DocTestFinder()

    def examples(mod):
        out = {}
        for t in finder.find(mod):
            if t.examples:
                name = t.name.split(".")[-1]
                out[name] = [(e.source, e.want) for e in t.examples]
        return out

    want = examples(jpm)
    assert want and examples(tpm) == want
    result = doctest.testmod(tpm, verbose=False)
    assert result.failed == 0 and result.attempted == sum(
        len(v) for v in want.values())
