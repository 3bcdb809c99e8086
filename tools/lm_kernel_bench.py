#!/usr/bin/env python3
"""Time B8 (decode_attention) and B9 (selective_scan) on one NVIDIA GPU over
their launch layouts, at the shapes chip_smoke.py gives them.

    python3 tools/lm_kernel_bench.py [--src DIR] [--only b8|b9]

``--src`` names the ``src`` directory of the checkout whose kernels are
timed (default: this checkout's).  A checkout whose wrappers lack the
split planner's constants (``TARGET_BLOCKS``, ``MAX_TILES``) is timed at
its defaults only, so an older tree unpacked beside this one can be timed
in the same run.

Prints one JSON line per measurement, each with the card's name and power
limit:

- ``build``: nvcc seconds and ptxas's registers and spills of every B8/B9
  instantiation;
- ``b8``: llama3-8b's decode step as in chip_smoke.py (8 lanes, 32/8 heads
  of 128, a bfloat16 ring of 2080 slots, lengths from [1025, 2080]) and
  decode_32k's cache (32768 slots, lengths from [16385, 32768], batch cut
  to 8), for each split-planner setting: device ms (chip_smoke.cuda_ms),
  the device time of each launched kernel (torch.profiler), the bound,
  and SDPA's ms;
- ``b9``: one falcon-mamba-7b layer at L = 32768 (di 8192, st 16), held
  against the plain recurrence at 2e-4.

Every layout is held against the plain version before it is timed.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("b8", "b9"),
                    help="time one kernel only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("lm_kernel_bench: no CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    import repro_torch.kernels.decode_attention as kda

    card = cs.phase_card(torch)
    src = str(pathlib.Path(kops.__file__).resolve().parents[2])
    _build.load()
    info = _build.build_info()
    emit = cs.emit
    emit({"bench": "build", "src": src, "nvcc_seconds": info["seconds"],
          "ptxas": cs.ptxas_usage(info["log"], ("decode", "selective")),
          "card": card})
    dev = torch.device("cuda")

    shapes = (("serve", 2080, 1025), ("32k", 32768, 16385))
    for shape, s, lo in shapes if args.only != "b9" else ():
        q, k, v, lengths, sdpa, bnd = cs.decode_inputs(torch, dev, s, lo)
        want = kref.decode_attention_ref(q.float(), k, v, lengths)
        plans = [{}]
        if hasattr(kda, "MAX_TILES"):
            plans = [dict(TARGET_BLOCKS=n, MAX_TILES=m)
                     for n in (528, 660, 1056) for m in (8, 16)]
        for plan in plans:
            saved = {key: getattr(kda, key) for key in plan}
            for key, val in plan.items():
                setattr(kda, key, val)
            try:
                def fn():
                    return kops.decode_attention(q, k, v, lengths)
                got = fn()
                ok = bool(torch.allclose(got.float(), want,
                                         **cs.BF16_OUT_TOL))
                emit({"bench": "b8", "src": src, "shape": shape,
                      "plan": plan, "chunk": (kda.plan_chunk(8, s, 8)
                                              if plan else None),
                      "ok": ok, "ms": cs.cuda_ms(torch, fn),
                      "kernels": cs.kernel_split(torch, fn),
                      "bound_ms": bnd[0], "card": card})
            finally:
                for key, val in saved.items():
                    setattr(kda, key, val)
        emit({"bench": "b8_sdpa", "shape": shape,
              "ms": cs.cuda_ms(torch, sdpa), "card": card})
        del q, k, v, want
        torch.cuda.empty_cache()

    if args.only == "b8":
        return
    x = cs.scan_inputs(torch, dev, cs.SSM_L)
    want = kref.selective_scan_ref(*x)
    got = kops.selective_scan(*x)
    emit({"bench": "b9", "src": src,
          "max_abs_err": float((got - want).abs().max()),
          "ok": bool(torch.allclose(got, want, **cs.MODEL_TOL)),
          "ms": cs.cuda_ms(torch, lambda: kops.selective_scan(*x)),
          "kernels": cs.kernel_split(
              torch, lambda: kops.selective_scan(*x), iters=3),
          "card": card})


if __name__ == "__main__":
    main()
