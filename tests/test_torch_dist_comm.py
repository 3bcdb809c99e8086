"""``DistComm`` between gloo processes on the CPU against ``LoopbackComm``.

Eight ranks held as world × p_local = 2 × 4, 4 × 2 and 8 × 1: every
process spawns from this file (``python tests/test_torch_dist_comm.py
RANK WORLD INIT_FILE OUT``), joins a gloo group through a ``file://``
init in the test's ``tmp_path`` (the suite runs files in parallel, so no
fixed port), and holds ``all_to_all``, ``all_gather`` and ``all_reduce``
(sum and max), sync and ``async_op``, in float32, bfloat16, int32 and
int8, bit for bit against ``LoopbackComm(8)``'s rows for its ranks on the
same inputs.  The inputs carry NaN, +0.0 and -0.0 where ``max`` must
follow XLA's rules.  Each process also holds the calibration's key and
parameters: the same on every rank (``core.tune``).

In process: the refusals (no group; a group whose backend does not serve
the device).

``run_ranks`` is the launcher the other multi-process tests of the port
use: one subprocess a rank, each with its own timeout; ``run_worlds``
runs it for several world sizes beside a JAX reference subprocess.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

P = 8
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int8)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(script, world: int, tmp_path, *args, timeout: float = 240):
    """Run ``python script RANK WORLD INIT_FILE *args`` as ``world``
    processes that meet in a gloo group through a ``file://`` init in
    ``tmp_path``; fail with a rank's stderr if any exits non-zero or
    outlives ``timeout`` seconds."""
    init = tmp_path / f"init-{world}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(init),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, f"rank {r}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def run_worlds(script, worlds, tmp_path, jax_args, here, *,
               timeout: float = 400):
    """Run ``script``'s ranks for each world size in ``worlds`` (through
    ``run_ranks``, each rank writing ``OUT-RANK.npz`` for its ``OUT``
    argument) and, at the same time, ``python script jax *jax_args`` on
    eight forced host devices, while ``here()`` runs in this process.
    Returns ``here()``'s result and, by world size, each rank's npz as a
    dict, in rank order."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")

    def spawn(world):
        tmp = tmp_path / f"world-{world}"
        tmp.mkdir()
        run_ranks(script, world, tmp, tmp / "r", timeout=timeout)
        return [dict(np.load(tmp / f"r-{r}.npz")) for r in range(world)]

    with ThreadPoolExecutor(len(worlds)) as pool:
        ranks = {w: pool.submit(spawn, w) for w in worlds}
        jax = subprocess.Popen(
            [sys.executable, str(script), "jax", *map(str, jax_args)],
            env=env, stderr=subprocess.PIPE, text=True)
        try:
            mine = here()
            _, err = jax.communicate(timeout=900)
        finally:
            if jax.poll() is None:
                jax.kill()
                jax.wait()
        assert jax.returncode == 0, err[-4000:]
        return mine, {w: f.result() for w, f in ranks.items()}


def init_gloo(rank: int, world: int, init: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)


def inputs(dtype, shape):
    """Seeded values with NaN, +0.0 and -0.0 planted in the float ones."""
    rng = np.random.default_rng(7)
    if dtype.is_floating_point:
        a = rng.standard_normal(shape).astype(np.float32) * 4
        flat = a.reshape(-1)
        flat[::7] = 0.0
        flat[3::7] = -0.0
        flat[::29] = np.nan
        return torch.from_numpy(a).to(dtype)
    lo, hi = (-100, 100) if dtype == torch.int8 else (-10 ** 6, 10 ** 6)
    return torch.from_numpy(rng.integers(lo, hi, shape)).to(dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits: NaN payloads and zero signs compared exactly."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]) if t.dtype in view else t


def _worker(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm, LoopbackComm
    from repro_torch.core import tune

    init_gloo(rank, world, init)
    comm = DistComm(P // world, device="cpu")
    loop = LoopbackComm(P, device="cpu")
    assert (comm.p, comm.world, comm.rank) == (P, world, rank)
    mine = comm.local_rows
    checked = 0
    for dtype in DTYPES:
        buf = inputs(dtype, (P, P, 3, 2))        # (P_src, P_dst, s, feat)
        vec = inputs(dtype, (P, 5, 2))           # (P, shard, feat)
        for async_op in (False, True):
            got = comm.all_to_all(buf[mine].clone(), async_op=async_op)
            want = loop.all_to_all(buf).wait()[mine]
            assert torch.equal(bits(got.wait()), bits(want)), dtype
            got = comm.all_gather(vec[mine].clone(), async_op=async_op)
            want = loop.all_gather(vec).wait()[mine]
            assert torch.equal(bits(got.wait()), bits(want)), dtype
            for op in ("sum", "max"):
                # 48 values a rank, and 10: slices of a world that do not
                # divide them
                for full in (buf, vec):
                    x = full[mine].clone()
                    got = comm.all_reduce(x, op, async_op=async_op).wait()
                    want = loop.all_reduce(full, op).wait()[mine]
                    assert torch.equal(bits(got), bits(want)), (dtype, op)
                    assert torch.equal(bits(x), bits(full[mine]))  # kept
                checked += 4
    # the calibration: its own key, the same parameters on every rank
    key = tune._key(comm, 4)
    assert key[:2] == ("dist", world) and key != tune._key(loop, 4)
    hw = tune.measure_hardware(comm)
    row = torch.tensor([[hw.w_private, hw.w_remote, hw.tau, hw.cacheline]],
                       dtype=torch.float64).expand(comm.p_local, 4)
    assert torch.equal(comm.all_reduce(row.contiguous(), "max").wait(),
                       row), "ranks calibrated differently"
    dist.destroy_process_group()
    pathlib.Path(out).write_text(f"{checked}\n")


@pytest.mark.parametrize("world", [2, 4, 8], ids=["2x4", "4x2", "8x1"])
def test_dist_comm_is_loopback_bit_for_bit(world, tmp_path):
    out = tmp_path / "out"
    run_ranks(__file__, world, tmp_path, out)
    # the last rank to finish wrote the count: 4 dtypes x sync/async x 4
    assert out.read_text().split() == [str(len(DTYPES) * 2 * 2 * 4)]


@pytest.mark.parametrize("shape", [(3,), (3, 7), (3, 5, 2)],
                         ids=["scalar", "odd", "matrix"])
def test_dist_all_reduce_in_a_one_process_group(shape, tmp_path):
    """A world-1 gloo group, three ranks in its process: ``all_reduce``'s
    reduce-scatter, ordered fold and gather, sync and async, equal
    ``LoopbackComm(3)``'s bit for bit, the float dtypes with NaN and
    +-0."""
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm, LoopbackComm
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        comm, loop = DistComm(3, device="cpu"), LoopbackComm(3, device="cpu")
        for dtype in DTYPES:
            x = inputs(dtype, shape)
            for op in ("sum", "max"):
                want = loop.all_reduce(x, op).wait()
                for async_op in (False, True):
                    got = comm.all_reduce(x.clone(), op,
                                          async_op=async_op).wait()
                    assert torch.equal(bits(got), bits(want)), (dtype, op)
    finally:
        dist.destroy_process_group()


def test_dist_comm_refuses_without_a_group():
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistComm(4, device="cpu")


def test_dist_comm_refuses_a_backend_that_does_not_serve_the_device(
        tmp_path):
    """A gloo group serves CPU tensors: a card DistComm over it raises (no
    fall back to the CPU), and a CPU one over it is taken."""
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        for device in (None, "cuda"):
            with pytest.raises(ValueError, match="needs a nccl group"):
                DistComm(1, device=device)
        comm = DistComm(3, device="cpu")
        assert (comm.p, comm.p_local, comm.rank_offset) == (3, 3, 0)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
