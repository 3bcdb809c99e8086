"""Power-law-skewed sparse access generators (the adversarial column mix).

``make_mesh_like_matrix`` draws columns from a locality band plus a uniform
long-range tail — kind to the blocksize model, because every remote shard is
touched about equally and the eq.-11 sweep sees a flat volume landscape.
Real irregular workloads are not flat: graph adjacency, trained MoE routers
and contact lists concentrate accesses on a few *hub* elements with a
power-law (Zipf) popularity tail.  Under that skew the needed-block counts
collapse onto the hubs' shards, so the BLOCKSIZE dial and the strategy
ladder both face a much sharper trade-off — exactly the regime the
benchmark matrix's ``spmv_skewed`` axis entry gates model error on.

Deterministic in ``seed`` (same contract as ``make_mesh_like_matrix``).
A numpy-only copy of ``repro.data.skewed``: the same seed gives the same
arrays in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.matrix import EllpackMatrix

__all__ = ["zipf_column_weights", "make_powerlaw_matrix", "skew_summary"]


def zipf_column_weights(n: int, alpha: float = 1.1, *,
                        seed: int = 0) -> np.ndarray:
    """Normalized Zipf popularity over ``n`` columns, hubs scattered.

    Rank k gets weight 1/k^alpha; ranks are then assigned to column ids by
    a seeded permutation so the hubs do NOT all live on shard 0 (which
    would make the skew trivially local for one lucky device).
    """
    assert n > 0 and alpha >= 0.0
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    w /= w.sum()
    perm = np.random.default_rng(seed).permutation(n)
    out = np.empty(n, np.float64)
    out[perm] = w
    return out


def make_powerlaw_matrix(
    n: int,
    r_nz: int = 16,
    *,
    alpha: float = 1.1,
    local_frac: float = 0.25,
    seed: int = 0,
    dtype=np.float32,
) -> EllpackMatrix:
    """EllPack matrix whose columns follow a Zipf(``alpha``) popularity law.

    Each row keeps a ``local_frac`` fraction of near-diagonal columns (the
    mesh-like residue — rows still touch their own neighborhood) and draws
    the rest from the global hub distribution via inverse-CDF sampling.
    Larger ``alpha`` sharpens the hubs; ``alpha=0`` degrades to uniform.
    """
    assert 0.0 <= local_frac <= 1.0
    rng = np.random.default_rng(seed)
    weights = zipf_column_weights(n, alpha, seed=seed + 1)
    cdf = np.cumsum(weights)
    cdf[-1] = 1.0  # guard the float tail so searchsorted stays in-range

    cols = np.searchsorted(cdf, rng.random((n, r_nz)),
                           side="right").astype(np.int64)
    # the mesh-like residue: a band draw, like make_mesh_like_matrix
    w_band = max(1, n // 256)
    offsets = rng.integers(-w_band, w_band + 1, size=(n, r_nz))
    offsets[offsets == 0] = 1
    band = np.clip(np.arange(n)[:, None] + offsets, 0, n - 1)
    local = rng.random((n, r_nz)) < local_frac
    cols = np.where(local, band, cols)

    vals = rng.standard_normal((n, r_nz)).astype(dtype) / r_nz
    diag = (np.abs(vals).sum(axis=1) + 1.0).astype(dtype)
    return EllpackMatrix(n=n, r_nz=r_nz, diag=diag, vals=vals,
                         cols=cols.astype(np.int32))


def skew_summary(cols: np.ndarray, n: int, p: int) -> dict:
    """How concentrated is this access pattern?  (diagnostic, not a model)

    Returns the fraction of all accesses landing on the hottest 1% of
    columns (``top1pct_frac``) and the max/mean per-shard access ratio
    (``shard_imbalance``) — uniform patterns sit near 0.01 and 1.0.
    """
    cols = np.asarray(cols).ravel()
    counts = np.bincount(cols, minlength=n).astype(np.float64)
    k = max(1, n // 100)
    top = np.sort(counts)[::-1][:k].sum() / counts.sum()
    per_shard = counts.reshape(p, n // p).sum(axis=1)
    return {"top1pct_frac": float(top),
            "shard_imbalance": float(per_shard.max() / per_shard.mean())}
