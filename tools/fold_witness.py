"""Repeatability of the plain scatter-add fold and of CG on one CUDA card.

    python3 tools/fold_witness.py

The plain fold (``kernels/ref.py``, ``accumulate_segments_ref``) is what
the push kernels B5/B6 are held against and what CG without kernels runs.
Its add on the card goes through ``ref._card_add``; this script swaps in
each candidate add in turn:

- ``index_add_``: PyTorch's atomic add, in another order every run;
- ``index_put_``: ``index_put_(accumulate=True)``, sorted by target (what
  ``_card_add`` does for float32);
- ``ordered``: ``ref.ordered_add``, ascending order and one rounding per
  add (what ``_card_add`` does for bfloat16).

Part ``fold``: each add folds 2 x 200,000 values of size 1e3 onto 64
targets three times, in float32 and bfloat16; it prints whether the runs
repeat and their largest difference from the CPU's sequential fold.

Part ``cg``: CG on the condensed rung at ``chip_smoke.py``'s n = 2^22, its
10 iterations, six times with the kernels and six times without them
for each float32 add.  Each run's final x is compared
with the first kernel run's and with its own group's first run as
``max|x - x0| / max|x0|``, the smoke's CG measure.

Prints one JSON object a line.  Needs a card; exits 1 without one.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPEATS = 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _atomic(flat, index, src):
    flat.index_add_(0, index, src)


def _sorted(flat, index, src):
    flat.index_put_((index,), src, accumulate=True)


def adds(kref):
    return {"index_add_": _atomic, "index_put_": _sorted,
            "ordered": kref.ordered_add}


def part_fold(torch, kref, dev):
    rng = np.random.default_rng(7)
    p, k, live = 2, 200_000, 64
    idx = torch.as_tensor(rng.integers(0, live, (p, k)), dtype=torch.int32)
    base = torch.as_tensor(rng.standard_normal((p, k)) * 1e3)
    saved = kref._card_add
    try:
        for dtype in (torch.float32, torch.bfloat16):
            vals = base.to(dtype)
            want = kref.accumulate_segments_ref(vals, idx, out_len=live)
            for name, add in adds(kref).items():
                kref._card_add = add
                t0 = time.perf_counter()
                runs = [kref.accumulate_segments_ref(
                    vals.to(dev), idx.to(dev), out_len=live).cpu()
                    for _ in range(3)]
                emit({"part": "fold", "dtype": str(dtype), "add": name,
                      "repeatable": all(torch.equal(r, runs[0])
                                        for r in runs),
                      "equal_cpu": torch.equal(runs[0], want),
                      "max_abs_diff_cpu": float(
                          (runs[0].float() - want.float()).abs().max()),
                      "max_abs": float(want.float().abs().max()),
                      "s_per_fold": (time.perf_counter() - t0) / 3})
    finally:
        kref._card_add = saved


def part_cg(torch, kref):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import (Topology, build_comm_plan,
                                       derive_scatter_plan)
    from repro_torch.comm.schedule import plan_key
    from repro_torch.core.matrix import make_mesh_like_matrix
    from repro_torch.core.solvers import ConjugateGradient

    t0 = time.perf_counter()
    matrix = make_mesh_like_matrix(cs.N, cs.R_NZ,
                                   locality_window=cs.N // 64,
                                   long_range_frac=0.02, seed=cs.SEED)
    topo = Topology(cs.P, cs.SHARDS_PER_NODE)
    base = build_comm_plan(matrix.cols, cs.N, cs.P, blocksize=cs.BLOCKSIZE,
                           topology=topo)
    key = plan_key(AccessPattern.from_ellpack(matrix), cs.P, cs.BLOCKSIZE,
                   topo)
    plans = {key: base, ("put", key): derive_scatter_plan(base)}
    comm = LoopbackComm(cs.P)
    cgs = {uk: ConjugateGradient(
        matrix, comm, strategy="condensed", use_kernel=uk,
        blocksize=cs.BLOCKSIZE, shards_per_node=cs.SHARDS_PER_NODE,
        plans=plans) for uk in (True, False)}
    b = np.random.default_rng(cs.SEED + 1).standard_normal(cs.N).astype(
        np.float32)
    torch.cuda.synchronize()
    emit({"part": "cg_setup", "n": cs.N, "iterations": cs.CG_ITERS,
          "s": round(time.perf_counter() - t0, 3)})

    def solve(cg):
        x = cg.schedule(*cg.carries(b), n_steps=cs.CG_ITERS)[0]
        torch.cuda.synchronize()
        return x.clone()

    def rel(x, x0):
        return float((x - x0).abs().max() / x0.abs().max())

    groups = [("kernels", True, None), ("plain index_put_", False,
                                        _sorted),
              ("plain index_add_", False, _atomic)]
    first_kernel = None
    saved = kref._card_add
    try:
        for name, uk, add in groups:
            if add is not None:
                kref._card_add = add
            t0 = time.perf_counter()
            xs = [solve(cgs[uk]) for _ in range(REPEATS)]
            if first_kernel is None:
                first_kernel = xs[0]
            emit({"part": "cg", "group": name, "runs": REPEATS,
                  "s_per_run": (time.perf_counter() - t0) / REPEATS,
                  "rel_vs_own_first": [rel(x, xs[0]) for x in xs],
                  "rel_vs_first_kernel_run": [rel(x, first_kernel)
                                              for x in xs]})
            kref._card_add = saved
    finally:
        kref._card_add = saved


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("fold_witness: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref as kref
    part_fold(torch, kref, torch.device("cuda"))
    part_cg(torch, kref)


if __name__ == "__main__":
    main()
