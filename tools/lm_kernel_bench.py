#!/usr/bin/env python3
"""Time B8 (decode_attention), B9 (selective_scan), B9's backward and the
bf16-payload scan B9b with its backward B9b′ on one NVIDIA GPU over their
launch layouts, at the shapes chip_smoke.py gives them.

    python3 tools/lm_kernel_bench.py [--src DIR] [--only b8|b9|b9bwd|b9b]

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
  against the plain recurrence at 2e-4;
- ``b9bwd``: B9's backward (``selective_scan_bwd``) at the train
  microbatches of falcon-mamba-7b and hymba-1.5b (B 2, L 4096, st 16, di
  8192 and 3200), on inputs from the seed: every gradient within 2e-4 of
  the plain backward's largest element and a second launch bit for bit,
  then device ms beside the bound (chip_smoke.scan_bwd_bound) and, where
  the checkout's library reports it (``rt_selective_scan_bwd_occupancy``),
  a block's shared memory, resident blocks and warps an SM and whether the
  wide-register build or the narrow one launched; the build line carries
  ptxas's registers of each backward instantiation.  ``--src`` of an
  older checkout times its backward in the same call, so two designs
  compare on one card;
- ``b9b``: B9b's serving entry at falcon-mamba-7b's 32k prefill (B 1, L
  32768, di 8192) and hymba-1.5b's (L 4096, di 3200), its checkpointing
  entry and B9b′ at both train microbatches (B 2, L 4096), chunk 256,
  st 16, on inputs from the seed: the chunks' entering states bit for
  bit and y within 2e-4 of max |y| against the plain version on the first
  4096 steps, B9b′'s gradients within 2e-4 of the plain backward's
  largest elements and a second launch bit for bit, then device ms
  beside the bound and each kernel's device time (torch.profiler).
  ``--src`` of an older checkout times its B9b and B9b′ in the same call.

Every layout is held against the plain version before it is timed.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("b8", "b9", "b9bwd", "b9b"),
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
          "ptxas": cs.ptxas_usage(info["log"], ("decode", "selective",
                                                 "scan_bf16")),
          "card": card})
    dev = torch.device("cuda")

    shapes = (("serve", 2080, 1025), ("32k", 32768, 16385))
    for shape, s, lo in shapes if args.only in (None, "b8") else ():
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

    if args.only in (None, "b9"):
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
        del x, want, got
        torch.cuda.empty_cache()
    if args.only in (None, "b9bwd"):
        b9_bwd(torch, cs, card, src, _build.load())
    if args.only in (None, "b9b"):
        b9b(torch, cs, card, src)


def b9_bwd(torch, cs, card, src, lib) -> None:
    """The ``b9bwd`` lines (see the module's docstring)."""
    import ctypes

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9

    def occupancy(b, di, st):
        if not hasattr(lib, "rt_selective_scan_bwd_occupancy"):
            return None
        out = (ctypes.c_int * 3)()
        status = lib.rt_selective_scan_bwd_occupancy(
            b, di, st, ctypes.cast(out, ctypes.c_void_p))
        return None if status else {"smem_bytes": out[0],
                                    "blocks_per_sm": out[1],
                                    "warps_per_sm": out[1] * 256 // 32,
                                    "wide_registers": bool(out[2])}

    dev = torch.device("cuda")
    b, l, st = 2, 4096, 16
    for shape, di in (("falcon", 8192), ("hymba", 3200)):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        x = torch.randn((b, l, di), generator=gen, device=dev) * 0.3
        dt = torch.nn.functional.softplus(torch.randn(
            (b, l, di), generator=gen, device=dev))
        bm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
        cm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
        a = -torch.exp(torch.randn((di, st), generator=gen, device=dev)
                       * 0.3)
        dy = torch.randn((b, l, di), generator=gen, device=dev)
        _, hck = b9.selective_scan_ckpt(x, dt, bm, cm, a)
        want = kref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy)
        args = (x, dt, bm, cm, a, hck, dy)
        got = b9.selective_scan_bwd(*args)
        again = b9.selective_scan_bwd(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want)]
        del got, again
        ms = cs.cuda_ms(torch, lambda: b9.selective_scan_bwd(*args),
                        warmup=2, iters=10)
        bnd = cs.scan_bwd_bound(b, l, di, st)
        cs.emit({"bench": "b9bwd", "src": src, "shape": shape,
                 "b_l_di_st": [b, l, di, st],
                 "occupancy": occupancy(b, di, st),
                 "ok": same and max(rel) <= cs.SCAN_BWD_TOL,
                 "bit_identical_repeat": same, "rel_err": max(rel),
                 "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                 "card": card})
        del x, dt, bm, cm, a, dy, hck, want, args
        torch.cuda.empty_cache()


def b9b(torch, cs, card, src) -> None:
    """The ``b9b`` lines (see the module's docstring)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9

    dev = torch.device("cuda")
    st, chunk, check_l = 16, 256, 4096

    def inputs(b, l, di):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        x = torch.randn((b, l, di), generator=gen, device=dev) * 0.3
        dt = torch.nn.functional.softplus(torch.randn(
            (b, l, di), generator=gen, device=dev))
        bm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
        cm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
        a = -torch.exp(torch.randn((di, st), generator=gen, device=dev)
                       * 0.3)
        dy = torch.randn((b, l, di), generator=gen, device=dev)
        return (x, dt, bm, cm, a), dy

    def fwd_line(shape, b, l, di, ckpt):
        args, _ = inputs(b, l, di)
        y, hck = b9.selective_scan_bf16_ckpt(*args, chunk=chunk)
        lc = min(l, check_l)
        short = tuple(t[:, :lc] if t.dim() == 3 else t for t in args)
        want_y, want_h = kref.selective_scan_bf16_states_ref(*short,
                                                             chunk=chunk)
        states = bool(torch.equal(hck[:, :lc // chunk], want_h))
        err = float((y[:, :lc] - want_y).abs().max()) / max(
            float(want_y.abs().max()), 1e-30)
        del y, hck, want_y, want_h
        fn = ((lambda: b9.selective_scan_bf16_ckpt(*args, chunk=chunk))
              if ckpt else (lambda: b9.selective_scan_bf16(*args,
                                                           chunk=chunk)))
        bnd, _ = cs.scan_bf16_bound(b, l, di, st, chunk, ckpt=ckpt)
        cs.emit({"bench": "b9b", "src": src, "shape": shape, "entry": "ckpt" if ckpt else "serving",
                 "b_l_di_st": [b, l, di, st], "ok": states and err <= 2e-4,
                 "states_bit_identical": states, "y_rel_err": err,
                 "ms": cs.cuda_ms(torch, fn, warmup=1, iters=5),
                 "kernels": cs.kernel_split(torch, fn, iters=3),
                 "bound_ms": bnd[0], "bound_by": bnd[1], "card": card})
        del args
        torch.cuda.empty_cache()

    def bwd_line(shape, b, l, di):
        args, dy = inputs(b, l, di)
        _, hck = b9.selective_scan_bf16_ckpt(*args, chunk=chunk)
        got = b9.selective_scan_bf16_bwd(*args, hck, dy, chunk=chunk)
        again = b9.selective_scan_bf16_bwd(*args, hck, dy, chunk=chunk)
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        want = kref.selective_scan_bf16_bwd_ref(*args, dy, chunk=chunk)
        rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want)]
        del got, again, want

        def fn():
            return b9.selective_scan_bf16_bwd(*args, hck, dy, chunk=chunk)
        bnd = cs.scan_bwd_bound(b, l, di, st, nseg=l // chunk)
        cs.emit({"bench": "b9b_bwd", "src": src, "shape": shape, "b_l_di_st": [b, l, di, st],
                 "ok": same and max(rel) <= cs.SCAN_BWD_TOL,
                 "bit_identical_repeat": same, "rel_err": max(rel),
                 "ms": cs.cuda_ms(torch, fn, warmup=1, iters=5),
                 "kernels": cs.kernel_split(torch, fn, iters=3),
                 "bound_ms": bnd[0], "bound_by": bnd[1], "card": card})
        del args, dy, hck
        torch.cuda.empty_cache()

    fwd_line("falcon_prefill", 1, cs.SSM_L, 8192, False)
    fwd_line("hymba_prefill", 1, 4096, 3200, False)
    fwd_line("falcon_train", 2, 4096, 8192, True)
    bwd_line("falcon_train", 2, 4096, 8192)
    bwd_line("hymba_train", 2, 4096, 3200)


if __name__ == "__main__":
    main()
