"""The port's schedule layer, normal-equations step and CG solver at P = 8.

``Schedule`` / ``ExchangeSchedule`` / ``ScanSchedule`` on CPU tensors with
``LoopbackComm(8, device="cpu")``: the builder's refusals, one-stage
schedules against the front doors (bit for bit), a gather → compute →
scatter chain and multi-carry scans against numpy, a scan against k calls
of the one-step schedule, and a double-buffered scan against the plain
scan.  ``normal_equations_step`` on all four rungs × ``use_kernel`` must
equal the JAX step and ``spmv_t_ref_np(m, spmv_ref_np(m, x))`` bit for bit
on integer data; ``ConjugateGradient`` must come within 1e-3 of
``numpy.linalg`` (the reference's own test) and within 1e-5 of the JAX
solver (float32 dots summed in another order).  The JAX side needs eight
devices, so it runs once in a subprocess of this file (``python
tests/test_torch_schedule.py OUT.npz``).
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

P = 8
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
NE_COMBOS = list(itertools.product(STRATEGIES, (False, True)))
CG_STEPS = 50


def _ne_case(matrix_mod):
    """The reference's normal-equations case (tests/test_schedule.py):
    small integers, so every sum is exact in any order."""
    n = 64 * P
    m0 = matrix_mod.make_mesh_like_matrix(n, 4, locality_window=n // 8,
                                          long_range_frac=0.1, seed=4)
    rng = np.random.default_rng(4)
    m = matrix_mod.EllpackMatrix(
        n=n, r_nz=m0.r_nz,
        diag=rng.integers(-3, 4, n).astype(np.float32),
        vals=rng.integers(-3, 4, (n, m0.r_nz)).astype(np.float32),
        cols=m0.cols)
    return m, rng.integers(-3, 4, n).astype(np.float32)


def _cg_case(matrix_mod):
    """The reference's CG case (tests/test_scan_schedule.py)."""
    m = matrix_mod.make_mesh_like_matrix(16 * P, 4, seed=3)
    b = np.random.default_rng(0).standard_normal(m.n).astype(np.float32)
    return m, b


def run_reference(out_path: str) -> None:
    """The JAX step and solver on every rung (needs 8 host devices)."""
    import jax

    from repro.core import matrix as jmatrix
    from repro.core.solvers import ConjugateGradient
    from repro.core.spmv import normal_equations_step

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    out = {}
    m, x = _ne_case(jmatrix)
    for strategy in STRATEGIES:
        step = normal_equations_step(m, mesh, strategy=strategy,
                                     blocksize=16, use_plan_cache=False)
        out[f"ne-{strategy}"] = np.asarray(step(step.shard_vector(x)))
    m, b = _cg_case(jmatrix)
    for strategy in STRATEGIES:
        cg = ConjugateGradient(m, mesh, strategy=strategy, blocksize=8,
                               use_plan_cache=False)
        out[f"cg-{strategy}"] = np.asarray(cg.solve(b, n_steps=CG_STEPS))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_schedule") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    yield
    assert not any(kops.launch_counts().values()), kops.launch_counts()


@pytest.fixture(scope="module")
def comm():
    from repro_torch.comm.communicator import LoopbackComm
    return LoopbackComm(P, device="cpu")


def _case(n, r=3, seed=0):
    from repro_torch.comm.pattern import AccessPattern
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, r)).astype(np.int32)
    vals = rng.integers(-4, 5, size=(n, r)).astype(np.float32)
    return AccessPattern.from_indices(idx, n=n), idx, vals


def _take(xc, rows):
    """Rank q's ``xc[q, rows[q]]`` (x_copy indexed with global ids)."""
    ranks = torch.arange(xc.shape[0]).reshape((-1,) + (1,) * (rows.dim() - 1))
    return xc[ranks, rows]


def _int_body(sched, pattern, idx):
    """x <- x_copy[idx].sum(-1) - 2x, exact on small integers."""
    x = sched.input("x")
    rows = sched.constant(idx)
    g = sched.gather(pattern, src=x)
    y = sched.compute(lambda xc, r, xl: _take(xc, r).sum(-1) - 2 * xl,
                      g, rows, x)
    return x, y


def _int_ref(xv, idx, steps):
    for _ in range(steps):
        xv = xv[idx].sum(-1) - 2 * xv
    return xv


# --------------------------------------------------------------------------
# one-stage schedules are the front doors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,use_kernel", NE_COMBOS)
def test_single_stage_gather_is_the_front_door(comm, strategy, use_kernel):
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.schedule import Schedule

    n = 32 * P
    pattern, _, _ = _case(n, seed=0)
    x = np.random.default_rng(0).integers(-4, 5, n).astype(np.float32)
    g = IrregularGather(pattern, comm, strategy=strategy, blocksize=8,
                        use_kernel=use_kernel)
    sched = Schedule()
    sched.gather(pattern, strategy=strategy)   # declares its input
    step = sched.compile(comm, blocksize=8, use_kernel=use_kernel)
    assert step.strategies == {"gather1": strategy}
    assert torch.equal(step(step.shard_input(x)), g(g.shard_vector(x)))


@pytest.mark.parametrize("strategy,use_kernel", NE_COMBOS)
def test_single_stage_scatter_is_the_front_door(comm, strategy, use_kernel):
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.comm.schedule import Schedule

    n = 32 * P
    pattern, idx, vals = _case(n, seed=1)
    s = IrregularScatter(pattern, comm, strategy=strategy, blocksize=8,
                         use_kernel=use_kernel)
    sched = Schedule()
    v = sched.input("vals")
    sched.scatter(pattern, v, reduce="add", strategy=strategy)
    step = sched.compile(comm, blocksize=8, use_kernel=use_kernel)
    got = step(step.shard_input(vals))
    assert torch.equal(got, s(s.shard_values(vals)))
    want = np.zeros(n, np.float32)
    np.add.at(want, idx.ravel(), vals.ravel())
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


# --------------------------------------------------------------------------
# chains, shared plans, scans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gather_rung", STRATEGIES)
def test_gather_compute_scatter_chain(comm, gather_rung):
    """gather → compute → scatter in one step, a per-stage rung override
    beating the schedule default, against numpy; the scatter derives its
    ScatterPlan from the gather's base plan."""
    from repro_torch.comm.schedule import Schedule, plan_key

    n = 32 * P
    pattern, idx, vals = _case(n, seed=6)
    x = np.random.default_rng(6).integers(-3, 4, n).astype(np.float32)
    sched = Schedule()
    x_ref = sched.input("x")
    rows = sched.constant(idx)
    v = sched.constant(vals)
    g = sched.gather(pattern, src=x_ref, strategy=gather_rung, name="g")
    c = sched.compute(lambda xc, r, vv: vv * _take(xc, r), g, rows, v)
    s = sched.scatter(pattern, c, reduce="add", name="s")
    step = sched.compile(comm, strategy="condensed", blocksize=8, output=s)
    assert step.strategies == {"g": gather_rung, "s": "condensed"}
    # fixed rungs and no hw=: no ranking and no window pricing, as in the
    # reference
    assert step.predicted_times == {"g": None, "s": None}
    assert step.predicted_window is None
    key = plan_key(pattern, P, 8, sched.exchange_of(g).plan.topology)
    assert set(step.plans) == {key, ("put", key)}
    assert sched.exchange_of(g).plan is step.plans[key]
    assert sched.exchange_of(s).splan.base is step.plans[key]
    want = np.zeros(n, np.float32)
    np.add.at(want, idx.ravel(), (vals * x[idx]).ravel())
    np.testing.assert_array_equal(
        step(step.shard_input(x)).reshape(-1).numpy(), want)


def test_plans_dict_is_shared_between_schedules(comm):
    from repro_torch.comm.schedule import Schedule

    n = 16 * P
    pattern, idx, _ = _case(n, seed=2)
    plans = {}
    steps = []
    for strategy in ("condensed", "blockwise"):
        sched = Schedule()
        _int_body(sched, pattern, idx)
        steps.append(sched.compile(comm, strategy=strategy, blocksize=8,
                                   plans=plans))
    assert len(plans) == 1
    (base,) = plans.values()
    # a pattern with the same content but another object shares it too
    from repro_torch.comm.pattern import AccessPattern
    twin = AccessPattern.from_indices(idx.copy(), n=n)
    sched = Schedule()
    g = sched.gather(twin)
    sched.compile(comm, strategy="condensed", blocksize=8, plans=plans)
    assert sched.exchange_of(g).plan is base and len(plans) == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scan_equals_repeated_steps(comm, strategy):
    from repro_torch.comm.schedule import Schedule

    n = 16 * P
    pattern, idx, _ = _case(n, seed=1)
    xv = np.random.default_rng(1).integers(-3, 4, n).astype(np.float32)
    sched = Schedule()
    _int_body(sched, pattern, idx)
    step = sched.compile(comm, strategy=strategy, blocksize=8)
    ref = step.shard_input(xv)
    for _ in range(5):
        ref = step(ref)
    sched2 = Schedule()
    x2, y2 = _int_body(sched2, pattern, idx)
    loop = sched2.scan(comm, carry=x2, output=y2, strategy=strategy,
                       blocksize=8)
    assert loop.predicted_loop(5) is None
    got = loop(loop.shard_input(xv), n_steps=5)
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  _int_ref(xv, idx, 5))
    assert torch.equal(loop(loop.shard_input(xv), n_steps=0),
                       loop.shard_input(xv))


def test_multi_carry_scan_matches_numpy(comm):
    from repro_torch.comm.schedule import Schedule

    n = 16 * P
    pattern, idx, _ = _case(n, seed=2)
    rng = np.random.default_rng(3)
    av = rng.integers(-3, 4, n).astype(np.float32)
    bv = rng.integers(-3, 4, n).astype(np.float32)
    sched = Schedule()
    a = sched.input("a")
    b = sched.input("b")
    rows = sched.constant(idx)
    g = sched.gather(pattern, src=a)
    a2 = sched.compute(lambda xc, r, bl: _take(xc, r).sum(-1) + bl, g, rows,
                       b)
    b2 = sched.compute(lambda bl: bl * 2.0, b)
    # carries in another order than declared: the call follows carry=
    loop = sched.scan(comm, carry=(b, a), output=(b2, a2),
                      strategy="condensed", blocksize=8)
    ra, rb = av.copy(), bv.copy()
    for _ in range(3):
        ra, rb = ra[idx].sum(-1) + rb, rb * 2.0
    fb, fa = loop(loop.shard_input(bv, 0), loop.shard_input(av, 1),
                  n_steps=3)
    np.testing.assert_array_equal(fa.reshape(-1).numpy(), ra)
    np.testing.assert_array_equal(fb.reshape(-1).numpy(), rb)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_double_buffer_scan_equals_plain_scan(comm, strategy, full):
    """Feeding the refreshed carry is bit-identical to gathering it in the
    body next iteration: the double-buffer value of iteration k IS the
    gather of output k-1 (with and without finish keywords)."""
    from repro_torch.comm.schedule import Schedule

    n = 16 * P
    pattern, idx, _ = _case(n, seed=1)
    xv = np.random.default_rng(1).integers(-3, 4, n).astype(np.float32)
    fk = dict(extra_slots=1, copy_own=True) if full else None

    sched = Schedule()
    x, y = _int_body(sched, pattern, idx)
    loop = sched.scan(comm, carry=x, output=y, strategy=strategy,
                      blocksize=8)
    want = loop(loop.shard_input(xv), n_steps=4)

    db = Schedule()
    xd = db.input("x")
    rows = db.constant(idx)
    gd = db.gather(pattern, double_buffer=True, prime=xd, finish_kwargs=fk)
    yd = db.compute(lambda xc, r, xl: _take(xc, r).sum(-1) - 2 * xl,
                    gd, rows, xd)
    db.feed(gd, yd)
    dloop = db.scan(comm, carry=xd, output=yd, strategy=strategy,
                    blocksize=8)
    assert torch.equal(dloop(dloop.shard_input(xv), n_steps=4), want)
    assert torch.equal(dloop(dloop.shard_input(xv), n_steps=0),
                       dloop.shard_input(xv))


def test_builder_refusals(comm):
    from repro_torch.comm.pattern import Destination
    from repro_torch.comm.schedule import Schedule

    n = 16 * P
    pattern, idx, _ = _case(n, r=2, seed=7)

    sched = Schedule()
    x = sched.input("x")
    with pytest.raises(ValueError, match="duplicate"):
        sched.input("x")
    other = Schedule()
    with pytest.raises(ValueError, match="different Schedule"):
        other.gather(pattern, src=x)
    with pytest.raises(TypeError, match="StageRef"):
        sched.compute(lambda a: a, "x")

    # a Destination gather delivers a dict: no exchange takes it
    dest = Destination.from_slots(rows=idx[:, :1].reshape(P, -1))
    g = sched.gather(pattern, src=x, destination=dest)
    with pytest.raises(ValueError, match="Destination"):
        sched.scatter(pattern, g)
    with pytest.raises(ValueError, match="Destination"):
        sched.compile(comm, strategy="condensed", output=g)
    with pytest.raises(ValueError, match="reduce"):
        sched.scatter(pattern, x, reduce="mean")

    empty = Schedule()
    empty.input("x")
    with pytest.raises(ValueError, match="at least one exchange"):
        empty.compile(comm, strategy="condensed")

    # "auto" (rung or blocksize) resolves instead of refusing; the window
    # is priced once hardware parameters are in scope
    from repro_torch.core.perfmodel import ABEL
    for kw in (dict(strategy="auto"), dict(strategy="condensed",
                                           blocksize="auto")):
        s = Schedule()
        g = s.gather(pattern)
        step = s.compile(comm, hw=ABEL, use_plan_cache=False, **kw)
        assert step.strategies[g.name] in STRATEGIES
        assert step.predicted_window["total"] > 0

    # compile keywords after resolve, a second compile, another comm
    s = Schedule()
    s.gather(pattern)
    s.resolve(comm, strategy="condensed", blocksize=8)
    with pytest.raises(ValueError, match="already resolved"):
        s.compile(strategy="replicate")
    from repro_torch.comm.communicator import LoopbackComm
    with pytest.raises(ValueError, match="different communicator"):
        s.compile(LoopbackComm(P, device="cpu"))
    s.compile()
    with pytest.raises(RuntimeError, match="compiled"):
        s.compile()
    with pytest.raises(RuntimeError, match="compiled"):
        s.input("late")

    # double-buffer stages: scan only, one feed each, prime required
    s = Schedule()
    x = s.input("x")
    g = s.gather(pattern, double_buffer=True, prime=x)
    s.feed(g, x)
    with pytest.raises(ValueError, match="feed"):
        s.feed(g, x)
    with pytest.raises(ValueError, match="scan"):
        s.compile(comm, strategy="condensed", blocksize=8)
    s = Schedule()
    x = s.input("x")
    g_plain = s.gather(pattern, src=x)
    with pytest.raises(ValueError, match="double_buffer"):
        s.feed(g_plain, x)
    with pytest.raises(ValueError, match="prime"):
        s.gather(pattern, double_buffer=True)
    with pytest.raises(ValueError, match="src"):
        s.gather(pattern, double_buffer=True, prime=x, src=x)
    with pytest.raises(ValueError, match="prime"):
        s.gather(pattern, src=x, prime=x)

    # a double-buffer gather needs its feed, and exchange-free prime
    s = Schedule()
    x = s.input("x")
    g = s.gather(pattern, double_buffer=True, prime=x)
    y = s.compute(lambda xc: xc[:, :n // P], g)
    with pytest.raises(ValueError, match="no feed"):
        s.scan(comm, carry=x, output=y, strategy="condensed", blocksize=8)
    s = Schedule()
    x = s.input("x")
    g0 = s.gather(pattern, src=x)
    tainted = s.compute(lambda xc: xc[:, :n // P], g0, name="tainted")
    g1 = s.gather(pattern, double_buffer=True, prime=tainted)
    y = s.compute(lambda xc: xc[:, :n // P], g1)
    s.feed(g1, y)
    with pytest.raises(ValueError, match="exchange"):
        s.scan(comm, carry=x, output=y, strategy="condensed", blocksize=8)

    # carries: inputs only, every input once, one output each
    def two_inputs():
        s = Schedule()
        a, b = s.input("a"), s.input("b")
        ga = s.gather(pattern, src=a)
        a2 = s.compute(lambda xc, bl: xc[:, :n // P] + bl, ga, b)
        return s, a, b, a2
    s, a, b, a2 = two_inputs()
    with pytest.raises(ValueError, match="every input"):
        s.scan(comm, carry=a, output=a2, strategy="condensed", blocksize=8)
    s, a, b, a2 = two_inputs()
    with pytest.raises(ValueError, match="input stages"):
        s.scan(comm, carry=(a, a2), output=(a2, a2), strategy="condensed",
               blocksize=8)
    s, a, b, a2 = two_inputs()
    with pytest.raises(ValueError, match="one stage per carry"):
        s.scan(comm, carry=(a, b), output=(a2,), strategy="condensed",
               blocksize=8)


# --------------------------------------------------------------------------
# normal equations and CG against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,use_kernel", NE_COMBOS)
def test_normal_equations_step_matches_jax_and_numpy(reference, comm,
                                                     strategy, use_kernel):
    from repro_torch.core import matrix as tmatrix
    from repro_torch.core.spmv import normal_equations_step

    m, x = _ne_case(tmatrix)
    step = normal_equations_step(m, comm, strategy=strategy, blocksize=16,
                                 use_kernel=use_kernel)
    assert step.strategies == {"gather_x": strategy, "scatter_t": strategy}
    assert len(step.plans) == 2     # one base plan and its ScatterPlan
    z = step(step.shard_vector(x)).reshape(-1).numpy()
    np.testing.assert_array_equal(z, reference[f"ne-{strategy}"])
    np.testing.assert_array_equal(
        z, tmatrix.spmv_t_ref_np(m, tmatrix.spmv_ref_np(m, x)))


def _dense(m):
    a = np.zeros((m.n, m.n), np.float64)
    rows = np.repeat(np.arange(m.n), m.cols.shape[1]).reshape(m.cols.shape)
    np.add.at(a, (rows, m.cols), m.vals.astype(np.float64))
    a[np.arange(m.n), np.arange(m.n)] += m.diag.astype(np.float64)
    return a


@pytest.mark.parametrize("strategy,use_kernel", NE_COMBOS)
def test_cg_matches_linalg_and_jax(reference, comm, strategy, use_kernel):
    from repro_torch.core import matrix as tmatrix
    from repro_torch.core.solvers import ConjugateGradient, cg_solve

    m, b = _cg_case(tmatrix)
    a = _dense(m)
    x_ref = np.linalg.solve(a.T @ a, b.astype(np.float64))
    cg = ConjugateGradient(m, comm, strategy=strategy, blocksize=8,
                           use_kernel=use_kernel)
    assert cg.strategies == {"gather_x": strategy, "scatter_t": strategy}
    assert cg.schedule.predicted_loop(CG_STEPS) is None
    x = cg.solve(b, n_steps=CG_STEPS).reshape(-1).numpy()
    rel = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert rel < 1e-3, (strategy, rel)
    resid = (a.T @ a) @ x.astype(np.float64) - b
    assert np.abs(resid).max() < 1e-3 * np.abs(b).max()
    jx = reference[f"cg-{strategy}"]
    assert np.abs(x - jx).max() / np.abs(jx).max() < 1e-5
    np.testing.assert_array_equal(
        cg_solve(m, b, comm, n_steps=CG_STEPS, strategy=strategy,
                 blocksize=8, use_kernel=use_kernel), x)


if __name__ == "__main__":
    run_reference(sys.argv[1])
