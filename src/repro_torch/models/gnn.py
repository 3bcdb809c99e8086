"""GNN-style neighbor aggregation on the comm API (a ``Schedule`` consumer).

Message passing over a fixed graph is the canonical irregular-exchange
chain: every node *gathers* its neighbors' features, *combines* them into
per-edge messages, and *scatter-adds* the messages back onto the nodes that
name it as a neighbor — gather → combine → scatter-update, one declarative
``Schedule``.  The scatter stage shares the gather stage's
``AccessPattern``, so its executor tables are a transpose-derived delta of
the same base plan (never a second O(edges) build) and the §5 window
composition prices both directions together.

The graph lives in ELL form — ``nbrs`` is ``(n, r)`` int32, row i naming
node i's r neighbors, rows with fewer neighbors padded with i itself (an
owned, zero-cost access whose message is identically zero).  That is the
index-set shape of SpMV's EllPack ``cols``: the planner, the strategy
ladder and the performance models are reused unchanged on a workload the
paper never ran.  The port's schedule runs on rank-stacked tensors over a
``LoopbackComm`` (``comm.schedule``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.pattern import AccessPattern
from repro_torch.comm.schedule import Schedule

__all__ = ["GNNNeighborAggregate", "gnn_ref_np", "random_neighbors"]


def random_neighbors(n: int, r: int, *, alpha: float = 0.0,
                     seed: int = 0) -> np.ndarray:
    """An ELL neighbor list, optionally with Zipf(``alpha``) hub nodes.

    ``alpha=0`` draws neighbors uniformly; larger ``alpha`` concentrates
    in-degree on a few hub nodes (``data.skewed``'s popularity law), the
    regime where the scatter direction's per-shard accumulate loads become
    badly imbalanced.  Self-edges are kept: they are owned accesses and
    their messages vanish in the combine.  The reference's arrays for the
    same arguments.
    """
    rng = np.random.default_rng(seed)
    if alpha > 0.0:
        from repro_torch.data.skewed import zipf_column_weights
        cdf = np.cumsum(zipf_column_weights(n, alpha, seed=seed + 1))
        cdf[-1] = 1.0
        nbrs = np.searchsorted(cdf, rng.random((n, r)), side="right")
    else:
        nbrs = rng.integers(0, n, size=(n, r))
    return np.ascontiguousarray(nbrs, dtype=np.int32)


def gnn_ref_np(h: np.ndarray, nbrs: np.ndarray,
               weight: float = 0.5) -> np.ndarray:
    """Ground-truth aggregation step in numpy.

    ``msg[i, s] = weight * (h[nbrs[i, s]] - h[i])`` and every message is
    pushed onto its *neighbor*: ``out[j] = h[j] + sum over {(i, s):
    nbrs[i, s] == j} msg[i, s]`` — a graph-Laplacian-flavored smoothing
    update (self-edges contribute exactly zero).
    """
    gathered = h[nbrs]                              # (n, r, d)
    msg = weight * (gathered - h[:, None, :])
    out = h.copy()
    np.add.at(out, nbrs.ravel(), msg.reshape(-1, h.shape[-1]))
    return out


class GNNNeighborAggregate:
    """One aggregation step as a gather→combine→scatter ``Schedule`` over
    rank-split node features.

    ``nbrs`` — (n, r) int32 ELL neighbor list (global node ids, self-id
    padding); features are (n, d), split over the communicator's ranks
    like every other consumer: ``shard_features`` gives ``(P, n / P, d)``,
    and a call returns the updated features in the same layout.
    ``strategy``/``blocksize``/``hw`` etc. forward to ``Schedule.resolve``
    — ``strategy="auto"`` ranks the ladder on the §5 models as SpMV does,
    and ``.predicted_window`` carries the two-exchange composition
    prediction.
    """

    def __init__(self, nbrs: np.ndarray, n: int, comm, *,
                 weight: float = 0.5, strategy: str = "auto",
                 blocksize=None, topology=None,
                 shards_per_node: int | None = None, hw=None,
                 use_plan_cache: bool = True):
        nbrs = np.ascontiguousarray(np.asarray(nbrs), dtype=np.int32)
        assert nbrs.ndim == 2 and nbrs.shape[0] == n, (
            f"nbrs must be (n, r) with n={n}, got {nbrs.shape}")
        self.nbrs = nbrs
        self.n = n
        self.weight = float(weight)
        pattern = AccessPattern.from_indices(nbrs, n=n)
        p = comm.p

        sched = Schedule()
        h = sched.input("h")
        rows = sched.constant(nbrs, name="nbrs")
        g = sched.gather(pattern, src=h, name="gather_nbrs")
        w = self.weight

        def combine(xc, rl, hl):
            ranks = torch.arange(p, device=xc.device)[:, None, None]
            # messages accumulate in float32 whatever the feature dtype: a
            # hub node sums thousands of same-sign contributions, which
            # low-precision accumulation drifts on
            return (w * (xc[ranks, rl] - hl[:, :, None, :])).float()

        msg = sched.compute(combine, g, rows, h, name="combine")
        agg = sched.scatter(pattern, msg, reduce="add", name="scatter_upd")
        sched.compute(lambda s, hl: hl + s.to(hl.dtype), agg, h,
                      name="update")
        self.schedule = sched.compile(
            comm, strategy=strategy, blocksize=blocksize, topology=topology,
            shards_per_node=shards_per_node, hw=hw,
            use_plan_cache=use_plan_cache)

    # the resolved rungs / §5 predictions, straight off the schedule
    @property
    def strategies(self) -> dict:
        return self.schedule.strategies

    @property
    def predicted_times(self) -> dict:
        return self.schedule.predicted_times

    @property
    def predicted_window(self):
        return self.schedule.predicted_window

    def shard_features(self, h):
        return self.schedule.shard_input(np.asarray(h))

    def __call__(self, h):
        return self.schedule(h)
