"""The port's autotuner (``comm.select``, ``core.tune`` and every
``strategy="auto"`` front door) against the JAX reference.

* ``rank_strategies`` / ``blocksize_sweep`` / ``choose_blocksize`` return
  the same lists as the reference on the same plans and parameters;
* with a fixed ``hw=``, ``IrregularGather`` / ``IrregularScatter`` /
  ``DistributedSpMV`` / ``Heat2D`` / ``normal_equations_step`` /
  ``ConjugateGradient`` resolve the same rung with the same
  ``predicted_times`` (and ``predicted_window`` / ``predicted_loop``) as the
  JAX front doors — the JAX side needs eight devices, so it runs once in a
  subprocess of this file (``python tests/test_torch_autotune.py OUT``);
* an auto engine's output equals the fixed-rung engine it resolved to, bit
  for bit;
* ``measure_hardware(LoopbackComm(8, device="cpu"))`` is memoized and sane,
  and a schedule calibrates once for all of its auto stages.
"""
import itertools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

P = 8
N = 64 * P
R = 4
BS = 16
HEAT_M, HEAT_N, MPROCS, NPROCS = 32, 64, 2, 4
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
HW_FIELDS = dict(ABEL=None,
                 made_up=dict(w_private=3.1e11, w_remote=7.7e10, tau=2.3e-5,
                              cacheline=96, elem=4, idx=4),
                 latency=dict(w_private=2e12, w_remote=4e11, tau=4e-4,
                              cacheline=32, elem=4, idx=4))
GATHER_CASES = list(itertools.product(HW_FIELDS, (False, True),
                                      (False, True)))
GATHER_EXTRAS = {"scan_steps": dict(scan_steps=20),
                 "blocksize_auto": dict(blocksize="auto")}
SPMV_CASES = list(itertools.product(HW_FIELDS, ("dest", "full", "t"),
                                    (False, True)))
HEAT_CASES = list(itertools.product(HW_FIELDS, ("dest", "full"),
                                    (None, 5)))
LOOP_CASES = list(itertools.product(HW_FIELDS, (None, 20)))


def _hw(pm, which):
    return pm.ABEL if which == "ABEL" else pm.HardwareParams(
        **HW_FIELDS[which])


def _matrix(matrix_mod, seed=5):
    """The reference's mesh-like matrix with small-integer values (every
    sum exact in any order)."""
    m0 = matrix_mod.make_mesh_like_matrix(N, R, locality_window=N // 8,
                                          long_range_frac=0.1, seed=seed)
    rng = np.random.default_rng(seed)
    return matrix_mod.EllpackMatrix(
        n=N, r_nz=R, diag=rng.integers(-3, 4, N).astype(np.float32),
        vals=rng.integers(-3, 4, (N, R)).astype(np.float32), cols=m0.cols)


def _slots(cols):
    """A Destination's slot table: every fourth row's first two reads."""
    return cols[::4, :2].reshape(P, -1).astype(np.int64)


def _gather_kw(case_hw, use_kernel, extra):
    kw = dict(strategy="auto", blocksize=BS, use_kernel=use_kernel)
    kw.update(GATHER_EXTRAS.get(extra, {}))
    return kw


def _json(obj):
    """JSON-friendly copy (tuples become lists; floats keep every bit)."""
    return json.loads(json.dumps(obj))


def run_reference(out_path: str) -> None:
    """Every JAX auto front door on the cases above (needs 8 devices)."""
    import jax

    from repro import compat
    from repro.comm.gather import IrregularGather
    from repro.comm.pattern import AccessPattern, Destination
    from repro.comm.scatter import IrregularScatter
    from repro.core import matrix as jmatrix
    from repro.core import perfmodel as pm
    from repro.core.heat2d import Heat2D
    from repro.core.solvers import ConjugateGradient
    from repro.core.spmv import DistributedSpMV, normal_equations_step

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    grid = compat.make_mesh((MPROCS, NPROCS), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    m = _matrix(jmatrix)
    pattern = AccessPattern.from_ellpack(m)
    dest = Destination.from_slots(s=_slots(m.cols))
    out = {}
    for hw, with_dest, uk in GATHER_CASES:
        for extra in (None,) + tuple(GATHER_EXTRAS):
            g = IrregularGather(pattern, mesh, hw=_hw(pm, hw),
                                destination=dest if with_dest else None,
                                **_gather_kw(hw, uk, extra))
            out[f"gather-{hw}-{with_dest}-{uk}-{extra}"] = dict(
                strategy=g.strategy, predicted=g.predicted_times,
                blocksize=g.plan.blocksize)
        s = IrregularScatter(pattern, mesh, strategy="auto", blocksize=BS,
                             hw=_hw(pm, hw), use_kernel=uk)
        out[f"scatter-{hw}-{with_dest}-{uk}"] = dict(
            strategy=s.strategy, predicted=s.predicted_times)
    for hw, mat, uk in SPMV_CASES:
        kw = (dict(transpose=True) if mat == "t"
              else dict(materialize=mat))
        e = DistributedSpMV(m, mesh, strategy="auto", blocksize=BS,
                            hw=_hw(pm, hw), use_kernel=uk, **kw)
        out[f"spmv-{hw}-{mat}-{uk}"] = dict(strategy=e.strategy,
                                            predicted=e.predicted_times)
    for hw, mat, hint in HEAT_CASES:
        h = Heat2D(grid, HEAT_M, HEAT_N, strategy="auto", materialize=mat,
                   hw=_hw(pm, hw), n_steps_hint=hint)
        out[f"heat-{hw}-{mat}-{hint}"] = dict(strategy=h.strategy,
                                              overlap=h.overlap,
                                              predicted=h.predicted_times)
    for hw, hint in LOOP_CASES:
        if hint is None:
            step = normal_equations_step(m, mesh, blocksize=BS,
                                         hw=_hw(pm, hw),
                                         use_plan_cache=False)
            out[f"ne-{hw}"] = dict(strategies=step.strategies,
                                   predicted=step.predicted_times,
                                   window=step.predicted_window)
        cg = ConjugateGradient(m, mesh, blocksize=BS, hw=_hw(pm, hw),
                               use_plan_cache=False, n_steps_hint=hint)
        sched = cg.schedule
        out[f"cg-{hw}-{hint}"] = dict(
            strategies=sched.strategies, predicted=sched.predicted_times,
            window=sched.predicted_window,
            loop=sched.predicted_loop(20),
            loop_credit=sched.predicted_loop(7, overlap_credit=1e-6))
    pathlib.Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_autotune") / "ref.json"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               REPRO_PLAN_CACHE="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.fixture(autouse=True)
def own_plan_cache(tmp_path, monkeypatch):
    from repro_torch.comm import plan_cache
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plan_cache.clear_memory_cache()
    yield
    plan_cache.clear_memory_cache()


@pytest.fixture(scope="module")
def comm():
    from repro_torch.comm.communicator import LoopbackComm
    return LoopbackComm(P, device="cpu")


@pytest.fixture(scope="module")
def grid_comm():
    from repro_torch.comm.communicator import LoopbackComm
    return LoopbackComm(MPROCS * NPROCS, device="cpu")


@pytest.fixture(scope="module")
def case():
    from repro_torch.comm.pattern import AccessPattern, Destination
    from repro_torch.core import matrix as tmatrix
    m = _matrix(tmatrix)
    return (m, AccessPattern.from_ellpack(m),
            Destination.from_slots(s=_slots(m.cols)))


# ---- select: the rankings themselves -----------------------------------

@pytest.fixture(scope="module")
def plan_pair():
    from repro.comm import plan as jplan
    from repro.core import matrix as jmatrix
    from repro_torch.comm import plan as tplan
    m = _matrix(jmatrix)
    jp = jplan.build_comm_plan(m.cols, N, P, blocksize=BS,
                               topology=jplan.Topology(P, 2))
    tp = tplan.build_comm_plan(m.cols, N, P, blocksize=BS,
                               topology=tplan.Topology(P, 2))
    return (m, jp, tp, jplan.derive_scatter_plan(jp),
            tplan.derive_scatter_plan(tp))


RANK_KW = [dict(), dict(materialize="full"), dict(materialize="dest",
                                                   dest_slots=96),
           dict(use_kernel=True), dict(materialize="dest", use_kernel=True),
           dict(scan_steps=30), dict(scan_steps=30, overlap_credit=1e-6),
           dict(plan_cost=2e-4), dict(decode=True),
           dict(candidates=("condensed", "overlap"))]


@pytest.mark.parametrize("kw", RANK_KW)
@pytest.mark.parametrize("direction", ["get", "put"])
@pytest.mark.parametrize("hw", list(HW_FIELDS))
def test_rank_strategies_equal_jax(plan_pair, kw, direction, hw):
    from repro.comm import select as jselect
    from repro.core import perfmodel as jpm
    from repro_torch.comm import select as tselect
    from repro_torch.core import perfmodel as tpm

    _, jp, tp, js, ts = plan_pair
    jplan_, tplan_ = (js, ts) if direction == "put" else (jp, tp)
    want = jselect.rank_strategies(jplan_, R, _hw(jpm, hw),
                                   direction=direction, **kw)
    got = tselect.rank_strategies(tplan_, R, _hw(tpm, hw),
                                  direction=direction, **kw)
    assert got == want
    assert [t for _, t in got] == sorted(t for _, t in got)
    choose_kw = {k: v for k, v in kw.items()
                 if k in ("candidates", "materialize", "dest_slots")}
    assert tselect.choose_strategy(
        tplan_, R, hw=_hw(tpm, hw), direction=direction,
        **choose_kw) == jselect.choose_strategy(
        jplan_, R, hw=_hw(jpm, hw), direction=direction, **choose_kw)


@pytest.mark.parametrize("hw", list(HW_FIELDS))
@pytest.mark.parametrize("spn", [2, 8])
def test_blocksize_selection_equal_jax(plan_pair, hw, spn):
    from repro.comm import plan as jplan
    from repro.comm import select as jselect
    from repro.core import perfmodel as jpm
    from repro_torch.comm import plan as tplan
    from repro_torch.comm import select as tselect
    from repro_torch.core import perfmodel as tpm

    m = plan_pair[0]
    jkw = dict(topology=jplan.Topology(P, spn), hw=_hw(jpm, hw))
    tkw = dict(topology=tplan.Topology(P, spn), hw=_hw(tpm, hw))
    assert tselect.blocksize_candidates(N // P) == \
        jselect.blocksize_candidates(N // P)
    want = jselect.blocksize_sweep(m.cols, N, P, **jkw)
    assert tselect.blocksize_sweep(m.cols, N, P, **tkw) == want
    assert tselect.choose_blocksize(m.cols, N, P, **tkw) == \
        jselect.choose_blocksize(m.cols, N, P, **jkw) == min(
            want, key=lambda kv: kv[1])[0]
    assert tselect.blocksize_sweep(m.cols, N, P, candidates=[8, 24, 64],
                                   **tkw) == jselect.blocksize_sweep(
        m.cols, N, P, candidates=[8, 24, 64], **jkw)


# ---- the front doors against the JAX front doors -----------------------

@pytest.mark.parametrize("hw,with_dest,use_kernel", GATHER_CASES)
def test_gather_and_scatter_resolve_as_jax(reference, comm, case, hw,
                                           with_dest, use_kernel):
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.core import perfmodel as tpm

    _, pattern, dest = case
    for extra in (None,) + tuple(GATHER_EXTRAS):
        g = IrregularGather(pattern, comm, hw=_hw(tpm, hw),
                            destination=dest if with_dest else None,
                            **_gather_kw(hw, use_kernel, extra))
        want = reference[f"gather-{hw}-{with_dest}-{use_kernel}-{extra}"]
        assert g.requested_strategy == "auto"
        assert g.strategy == want["strategy"], extra
        assert _json(g.predicted_times) == want["predicted"], extra
        assert g.plan.blocksize == want["blocksize"]
        assert g.predicted_times[g.strategy] == min(
            g.predicted_times.values())
    s = IrregularScatter(pattern, comm, strategy="auto", blocksize=BS,
                         hw=_hw(tpm, hw), use_kernel=use_kernel)
    want = reference[f"scatter-{hw}-{with_dest}-{use_kernel}"]
    assert s.strategy == want["strategy"]
    assert _json(s.predicted_times) == want["predicted"]


@pytest.mark.parametrize("hw,mat,use_kernel", SPMV_CASES)
def test_spmv_auto_resolves_as_jax_and_equals_its_rung(
        reference, comm, case, hw, mat, use_kernel):
    import torch

    from repro_torch.core import perfmodel as tpm
    from repro_torch.core.matrix import spmv_ref_np, spmv_t_ref_np
    from repro_torch.core.spmv import DistributedSpMV

    m = case[0]
    kw = dict(transpose=True) if mat == "t" else dict(materialize=mat)
    e = DistributedSpMV(m, comm, strategy="auto", blocksize=BS,
                        hw=_hw(tpm, hw), use_kernel=use_kernel, **kw)
    want = reference[f"spmv-{hw}-{mat}-{use_kernel}"]
    assert e.requested_strategy == "auto" and e.strategy == want["strategy"]
    assert _json(e.predicted_times) == want["predicted"]
    fixed = DistributedSpMV(m, comm, strategy=e.strategy, blocksize=BS,
                            use_kernel=use_kernel, **kw)
    x = np.random.default_rng(1).integers(-3, 4, N).astype(np.float32)
    y = e(e.shard_vector(x))
    assert torch.equal(y, fixed(fixed.shard_vector(x)))
    ref = spmv_t_ref_np(m, x) if mat == "t" else spmv_ref_np(m, x)
    np.testing.assert_array_equal(y.reshape(-1).numpy(), ref)


@pytest.mark.parametrize("hw,mat,hint", HEAT_CASES)
def test_heat2d_auto_resolves_as_jax_and_equals_its_rung(
        reference, grid_comm, hw, mat, hint):
    import torch

    from repro_torch.core import perfmodel as tpm
    from repro_torch.core.heat2d import Heat2D

    kw = dict(mprocs=MPROCS, nprocs=NPROCS, materialize=mat)
    h = Heat2D(grid_comm, HEAT_M, HEAT_N, strategy="auto", hw=_hw(tpm, hw),
               n_steps_hint=hint, **kw)
    want = reference[f"heat-{hw}-{mat}-{hint}"]
    assert h.strategy == want["strategy"] and h.overlap == want["overlap"]
    assert _json(h.predicted_times) == want["predicted"]
    fixed = Heat2D(grid_comm, HEAT_M, HEAT_N, strategy=h.strategy, **kw)
    phi = h.init_field(3)
    assert torch.equal(h.run(phi, 3), fixed.run(phi, 3))
    assert torch.equal(h.schedule(phi), fixed.schedule(phi))


@pytest.mark.parametrize("hw,hint", LOOP_CASES)
def test_schedules_resolve_and_price_as_jax(reference, comm, case, hw,
                                            hint):
    import torch

    from repro_torch.core import perfmodel as tpm
    from repro_torch.core.matrix import spmv_ref_np, spmv_t_ref_np
    from repro_torch.core.solvers import ConjugateGradient
    from repro_torch.core.spmv import normal_equations_step

    m = case[0]
    if hint is None:
        step = normal_equations_step(m, comm, blocksize=BS, hw=_hw(tpm, hw),
                                     use_plan_cache=False)
        want = reference[f"ne-{hw}"]
        assert step.strategies == want["strategies"]
        assert _json(step.predicted_times) == want["predicted"]
        assert _json(step.predicted_window) == want["window"]
        # small integers: z is exact whatever rungs the stages resolved to
        x = np.random.default_rng(2).integers(-3, 4, N).astype(np.float32)
        z = step(step.shard_vector(x)).reshape(-1).numpy()
        np.testing.assert_array_equal(z, spmv_t_ref_np(m, spmv_ref_np(m, x)))
        rungs = set(step.strategies.values())
        if len(rungs) == 1:
            fixed = normal_equations_step(m, comm, strategy=rungs.pop(),
                                          blocksize=BS)
            assert torch.equal(step(step.shard_vector(x)),
                               fixed(fixed.shard_vector(x)))
    cg = ConjugateGradient(m, comm, blocksize=BS, hw=_hw(tpm, hw),
                           use_plan_cache=False, n_steps_hint=hint)
    sched = cg.schedule
    want = reference[f"cg-{hw}-{hint}"]
    assert sched.strategies == want["strategies"]
    assert _json(sched.predicted_times) == want["predicted"]
    assert _json(sched.predicted_window) == want["window"]
    assert _json(sched.predicted_loop(20)) == want["loop"]
    assert _json(sched.predicted_loop(7, overlap_credit=1e-6)) == \
        want["loop_credit"]
    rungs = set(sched.strategies.values())
    if len(rungs) == 1:
        b = np.random.default_rng(0).standard_normal(N).astype(np.float32)
        fixed = ConjugateGradient(m, comm, strategy=rungs.pop(),
                                  blocksize=BS)
        assert torch.equal(cg.solve(b, 5), fixed.solve(b, 5))


def test_auto_defaults_run(comm, case, monkeypatch):
    """The front doors whose default is "auto" run without a named rung:
    one calibration serves every auto stage of a schedule, and the CPU
    calibration (host clock) is memoized and sane."""
    from repro_torch.comm import exchange
    from repro_torch.core import tune
    from repro_torch.core.matrix import spmv_ref_np, spmv_t_ref_np
    from repro_torch.core.solvers import cg_solve
    from repro_torch.core.spmv import normal_equations_step

    tune.clear_hardware_cache()
    hw1 = tune.measure_hardware(comm)
    assert tune.measure_hardware(comm) is hw1 is exchange.measure_hw(comm)
    assert hw1.w_private > 0 and hw1.w_remote > 0 and hw1.tau > 0
    assert np.isfinite([hw1.w_private, hw1.w_remote, hw1.tau]).all()
    assert 16 <= hw1.cacheline <= 4096 and hw1.elem == 4
    raw = tune.calibration(comm)
    assert raw["timing"] == "host clock" and raw["p"] == P
    assert raw["tau_wall_s"] == hw1.tau

    calls = []
    real = tune.measure_hardware

    def counted(c, **kw):
        calls.append(c)
        return real(c, **kw)

    monkeypatch.setattr(tune, "measure_hardware", counted)
    m = case[0]
    step = normal_equations_step(m, comm, blocksize=BS)
    assert len(calls) == 1 and step.hw is hw1
    assert step.predicted_window["total"] > 0
    x = np.random.default_rng(4).integers(-3, 4, N).astype(np.float32)
    np.testing.assert_array_equal(step(step.shard_vector(x)).reshape(-1)
                                  .numpy(),
                                  spmv_t_ref_np(m, spmv_ref_np(m, x)))
    b = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    x_cg = cg_solve(m, b, comm, n_steps=5, blocksize=BS)
    assert np.isfinite(x_cg).all() and len(calls) == 2

    exchange.clear_hw_memo()
    assert not tune._hw_cache


if __name__ == "__main__":
    run_reference(sys.argv[1])
