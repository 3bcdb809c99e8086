"""``Heat2D`` over a ``DistComm`` whose processes hold only some of the ranks.

``tests/test_torch_heat2d.py``'s case (a 32 × 64 field on the 2 × 4 rank
grid, coef 0.07, five steps) on every rung × {dest, full} × the overlap
split × ``use_kernel``, with the eight ranks held as world × p_local = 2 ×
4 (a process holds a grid row) and 4 × 2 (a process holds half of one)
gloo processes.  Each world spawns once from this file (``python
tests/test_torch_dist_heat2d.py RANK WORLD INIT OUT``); every process
builds the same stencil pattern and base plan, steps its own tiles and
writes them, and ``gather_field`` (one ``all_gather`` of the tiles) its
global field.

The processes' tiles, stacked, must be the ``LoopbackComm(8)`` engine's
bit for bit (run in this process while the ranks run), and every process's
global field the jitted JAX ``Heat2D.run``'s bit for bit: that file's own
``run_reference``, run once in an 8-device subprocess of this file
(``python tests/test_torch_dist_heat2d.py jax OUT``).
"""
import sys

import numpy as np
import pytest

import test_torch_heat2d as th
from test_torch_dist_comm import init_gloo, run_worlds

WORLDS = (2, 4)
WORLD_IDS = ["2x4", "4x2"]


def _results(comm) -> dict:
    """Every combination's tiles (``t-``) and global field (``g-``) after
    ``th.STEPS`` steps on ``comm``'s rows, by key."""
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology, build_comm_plan
    from repro_torch.core.heat2d import Heat2D

    pattern = AccessPattern.from_stencil5(th.BIG_M, th.BIG_N, th.MPROCS,
                                          th.NPROCS)
    base = build_comm_plan(pattern.indices, pattern.n, th.P,
                           topology=Topology(th.P, th.P))
    res = {}
    for combo in th.COMBOS:
        strategy, materialize, overlap, use_kernel = combo
        h = Heat2D(comm, th.BIG_M, th.BIG_N, mprocs=th.MPROCS,
                   nprocs=th.NPROCS, coef=th.COEF, strategy=strategy,
                   materialize=materialize, overlap=overlap,
                   use_kernel=use_kernel, pattern=pattern, base_plan=base)
        phi = h.init_field(th.SEED)
        assert phi.shape[0] == comm.p_local
        out = h.run(phi, th.STEPS)
        res["t-" + th._key(*combo)] = out.numpy()
        res["g-" + th._key(*combo)] = h.gather_field(out)
    return res


def _worker(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm

    init_gloo(rank, world, init)
    res = _results(DistComm(th.P // world, device="cpu"))
    dist.destroy_process_group()
    np.savez(f"{out}-{rank}.npz", **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, the ``LoopbackComm(8)`` results (run in this
    process while the ranks run) and the JAX field."""
    from repro_torch.comm.communicator import LoopbackComm

    tmp = tmp_path_factory.mktemp("dist_heat2d")
    ref = tmp / "ref.npz"
    loop, out = run_worlds(__file__, WORLDS, tmp, [ref], lambda: _results(
        LoopbackComm(th.P, device="cpu")))
    out.update(loopback=loop, jax=dict(np.load(ref)))
    return out


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("strategy,materialize,overlap,use_kernel",
                         th.COMBOS)
def test_dist_heat2d_is_loopback_and_jax(runs, world, strategy, materialize,
                                         overlap, use_kernel):
    key = th._key(strategy, materialize, overlap, use_kernel)
    ranks = runs[world]
    tiles = np.concatenate([r["t-" + key] for r in ranks])
    np.testing.assert_array_equal(th._bits(tiles),
                                  th._bits(runs["loopback"]["t-" + key]))
    want = th._bits(runs["jax"][key])
    np.testing.assert_array_equal(th._bits(runs["loopback"]["g-" + key]),
                                  want)
    for r in ranks:     # every process assembles the whole field
        np.testing.assert_array_equal(th._bits(r["g-" + key]), want)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        th.run_reference(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
