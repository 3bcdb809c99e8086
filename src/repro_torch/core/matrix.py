"""Synthetic EllPack sparse matrices with unstructured-mesh-like structure.

The paper's test problems are finite-volume discretizations over tetrahedral
meshes: every row has a fixed number of off-diagonal nonzeros (r_nz = 16) whose
column indices are irregular but — after mesh reordering — mostly *local*
(close to the diagonal), with occasional long-range couplings.  We reproduce
that structure synthetically and deterministically so that communication plans,
performance models and benchmarks are exactly repeatable.

A numpy-only copy of ``repro.core.matrix`` (the same seed gives the same
matrix, bit for bit), kept in the port so that it imports no JAX.

Storage follows the paper's *modified EllPack* format (Section 3.1):
  M = D + A,  D the main diagonal (length n),
  A the off-diagonal nonzeros: ``vals`` (n, r_nz) and column indices
  ``cols`` (n, r_nz).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EllpackMatrix", "make_mesh_like_matrix", "spmv_ref_np",
           "spmv_t_ref_np"]


@dataclasses.dataclass(frozen=True)
class EllpackMatrix:
    """Modified EllPack storage: M = diag(D) + A."""

    n: int
    r_nz: int
    diag: np.ndarray  # (n,)        float
    vals: np.ndarray  # (n, r_nz)   float
    cols: np.ndarray  # (n, r_nz)   int32, in [0, n)

    def __post_init__(self):
        assert self.diag.shape == (self.n,)
        assert self.vals.shape == (self.n, self.r_nz)
        assert self.cols.shape == (self.n, self.r_nz)
        assert self.cols.dtype == np.int32

    @property
    def nnz(self) -> int:
        return self.n * (self.r_nz + 1)

    def max_window_span(self, rows_per_block: int) -> int:
        """Max column span (hi-lo+1) over row blocks — sizes the kernel's
        VMEM x-window (see kernels/ellpack_spmv.py)."""
        n_blocks = self.n // rows_per_block
        cols = self.cols[: n_blocks * rows_per_block].reshape(
            n_blocks, rows_per_block * self.r_nz
        )
        span = cols.max(axis=1) - cols.min(axis=1) + 1
        return int(span.max())


def make_mesh_like_matrix(
    n: int,
    r_nz: int = 16,
    *,
    locality_window: int | None = None,
    long_range_frac: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> EllpackMatrix:
    """Build a synthetic matrix mimicking a reordered tetrahedral mesh.

    Off-diagonal columns for row ``i`` are drawn from a band
    ``[i - w, i + w]`` (w = ``locality_window``, default ``max(64, n // 256)``),
    with an optional ``long_range_frac`` fraction re-drawn uniformly over
    ``[0, n)`` to exercise non-neighbor communication.  Deterministic in
    ``seed``.
    """
    rng = np.random.default_rng(seed)
    if locality_window is None:
        locality_window = max(64, n // 256)
    w = int(locality_window)

    offsets = rng.integers(-w, w + 1, size=(n, r_nz), dtype=np.int64)
    # avoid offset 0 (the diagonal is stored separately)
    offsets[offsets == 0] = 1
    rows = np.arange(n, dtype=np.int64)[:, None]
    cols = np.clip(rows + offsets, 0, n - 1)

    if long_range_frac > 0.0:
        mask = rng.random(size=cols.shape) < long_range_frac
        cols[mask] = rng.integers(0, n, size=int(mask.sum()), dtype=np.int64)

    vals = rng.standard_normal((n, r_nz)).astype(dtype) / r_nz
    # diagonally dominant, as diffusion matrices are
    diag = (np.abs(vals).sum(axis=1) + 1.0).astype(dtype)
    return EllpackMatrix(
        n=n, r_nz=r_nz, diag=diag, vals=vals, cols=cols.astype(np.int32)
    )


def spmv_ref_np(m: EllpackMatrix, x: np.ndarray) -> np.ndarray:
    """Ground-truth SpMV in numpy (paper Listing 1)."""
    return m.diag * x + np.einsum("ij,ij->i", m.vals, x[m.cols])


def spmv_t_ref_np(m: EllpackMatrix, x: np.ndarray) -> np.ndarray:
    """Ground-truth transposed SpMV: y = (D + A)ᵀ x.

    Row i's off-diagonal entry (vals[i, j] at column cols[i, j]) becomes a
    *contribution* vals[i, j] * x[i] to y[cols[i, j]] — the push-direction
    dual of the gather-based forward product.
    """
    y = (m.diag * x).astype(x.dtype)
    np.add.at(y, m.cols.ravel(), (m.vals * x[:, None]).ravel())
    return y

