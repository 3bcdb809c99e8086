"""The port's ``Heat2D`` at a 2 × 4 rank grid against the JAX ``Heat2D``.

A 32 × 64 field (16 × 16 per tile), five steps, on every rung × {dest,
full} × the overlap split × ``use_kernel``, on CPU tensors with
``LoopbackComm(8, device="cpu")``.  The JAX solver needs eight devices, so
it runs once in a subprocess of this file (``python
tests/test_torch_heat2d.py OUT.npz`` with
``--xla_force_host_platform_device_count=8``, Pallas in interpret mode).

``Heat2D.run`` is jitted in the reference, which rounds the stencil's last
step as one fused multiply-add; the port reproduces that rounding, so the
two must agree bit for bit, and both equal the plain whole-field loop.  The
reference's eager ``Heat2D.reference`` rounds otherwise and is held at the
reference's own tolerance, 1e-5.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

P, MPROCS, NPROCS = 8, 2, 4
BIG_M, BIG_N = 32, 64
COEF, STEPS, SEED = 0.07, 5, 3
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
COMBOS = list(itertools.product(STRATEGIES, ("dest", "full"), (False, True),
                                (False, True)))


def _key(strategy, materialize, overlap, use_kernel):
    return f"{strategy}-{materialize}-{int(overlap)}-{int(use_kernel)}"


def run_reference(out_path: str) -> None:
    """The JAX solver on every combination (needs 8 host devices)."""
    import jax

    from repro import compat
    from repro.core.heat2d import Heat2D

    assert len(jax.devices()) == P, jax.devices()
    mesh = compat.make_mesh((MPROCS, NPROCS), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    out = {}
    for combo in COMBOS:
        strategy, materialize, overlap, use_kernel = combo
        h = Heat2D(mesh, BIG_M, BIG_N, coef=COEF, strategy=strategy,
                   materialize=materialize, overlap=overlap,
                   use_kernel=use_kernel)
        phi0 = h.init_field(SEED)
        out[_key(*combo)] = np.asarray(h.run(phi0, STEPS))
    out["phi0"] = np.asarray(phi0)
    out["eager"] = h.reference(np.asarray(phi0), STEPS, coef=COEF)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_heat2d") / "ref.npz"
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


def _heat(comm, **kw):
    from repro_torch.core.heat2d import Heat2D
    return Heat2D(comm, BIG_M, BIG_N, mprocs=MPROCS, nprocs=NPROCS,
                  coef=COEF, **kw)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("strategy,materialize,overlap,use_kernel", COMBOS)
def test_run_matches_jax_bit_for_bit(reference, comm, strategy, materialize,
                                     overlap, use_kernel):
    from repro_torch.core.heat2d import Heat2D

    h = _heat(comm, strategy=strategy, materialize=materialize,
              overlap=overlap, use_kernel=use_kernel)
    assert h.strategy == strategy
    assert h.overlap == (overlap or strategy == "overlap")
    phi0 = h.init_field(SEED)
    assert tuple(phi0.shape) == (P, BIG_M // MPROCS, BIG_N // NPROCS)
    np.testing.assert_array_equal(h.gather_field(phi0), reference["phi0"])
    got = h.gather_field(h.run(phi0, STEPS))
    np.testing.assert_array_equal(
        _bits(got), _bits(reference[_key(strategy, materialize, overlap,
                                          use_kernel)]))
    # the whole-field plain loop, and the one-step schedule twice
    want = Heat2D.reference(reference["phi0"], STEPS, COEF).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    two = h.gather_field(h.schedule(h.schedule(phi0)))
    np.testing.assert_array_equal(
        two, Heat2D.reference(reference["phi0"], 2, COEF).numpy())


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dest_equals_full_and_the_eager_reference(reference, comm, strategy,
                                                  overlap):
    runs = {}
    for materialize in ("dest", "full"):
        h = _heat(comm, strategy=strategy, materialize=materialize,
                  overlap=overlap)
        runs[materialize] = h.gather_field(h.run(h.init_field(SEED), STEPS))
    np.testing.assert_array_equal(_bits(runs["dest"]), _bits(runs["full"]))
    # the reference's own tolerance (tests/helpers/check_heat2d.py)
    np.testing.assert_allclose(runs["dest"], reference["eager"], rtol=1e-5,
                               atol=1e-5)


def test_zero_steps_and_layout(comm):
    h = _heat(comm)
    field = np.random.default_rng(SEED).standard_normal(
        (BIG_M, BIG_N)).astype(np.float32)
    phi = h.shard_field(field)
    np.testing.assert_array_equal(h.gather_field(phi), field)
    np.testing.assert_array_equal(h.gather_field(h.init_field(SEED)), field)
    # rank r = ip * nprocs + kp holds tile (ip, kp)
    m_loc, n_loc = BIG_M // MPROCS, BIG_N // NPROCS
    np.testing.assert_array_equal(phi[NPROCS + 2].numpy(),
                                  field[m_loc:, 2 * n_loc:3 * n_loc])
    np.testing.assert_array_equal(h.gather_field(h.run(phi, 0)), field)


def test_step_and_scan_share_one_base_plan(comm):
    from repro_torch.comm.plan import build_comm_plan, Topology
    from repro_torch.comm.pattern import AccessPattern

    pattern = AccessPattern.from_stencil5(BIG_M, BIG_N, MPROCS, NPROCS)
    base = build_comm_plan(pattern.indices, pattern.n, P,
                           topology=Topology(P, P))
    engines = [_heat(comm, strategy=s, materialize=m, pattern=pattern,
                     base_plan=base)
               for s in STRATEGIES for m in ("dest", "full")]
    for h in engines:
        assert h.pattern is pattern
        assert list(h.plans.values()) == [base]
        assert h.schedule.plans is h.scan_schedule.plans is h.plans
        assert h.counts is base.counts
    # an engine of its own builds the same plan
    alone = _heat(comm, strategy="condensed", materialize="full")
    np.testing.assert_array_equal(alone.gather.plan.send_local_idx,
                                  base.send_local_idx)
    phi = alone.init_field(SEED)
    for h in engines[:2]:
        np.testing.assert_array_equal(h.gather_field(h.run(phi, 3)),
                                      alone.gather_field(alone.run(phi, 3)))


def test_refusals(comm):
    from repro_torch.comm.plan import build_comm_plan
    from repro_torch.comm.pattern import AccessPattern

    from repro_torch.core.perfmodel import ABEL

    # "auto" resolves (the §5 window models) instead of refusing
    h = _heat(comm, strategy="auto", hw=ABEL)
    assert h.strategy == min(h.predicted_times, key=h.predicted_times.get)
    assert h.overlap == (h.strategy == "overlap")
    assert _heat(comm, blocksize="auto", hw=ABEL).strategy == "condensed"
    with pytest.raises(ValueError, match="materialize"):
        _heat(comm, materialize="slots")
    pattern = AccessPattern.from_stencil5(BIG_M, 2 * BIG_N, MPROCS, NPROCS)
    other = build_comm_plan(pattern.indices, pattern.n, P)
    with pytest.raises(ValueError, match="base_plan"):
        _heat(comm, base_plan=other)
    with pytest.raises(ValueError, match="stencil pattern"):
        _heat(comm, pattern=pattern)
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core.heat2d import Heat2D
    with pytest.raises(ValueError, match="ranks"):
        Heat2D(LoopbackComm(4, device="cpu"), BIG_M, BIG_N, mprocs=MPROCS,
               nprocs=NPROCS)


if __name__ == "__main__":
    run_reference(sys.argv[1])
