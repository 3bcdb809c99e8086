#!/usr/bin/env python3
"""Time B4 (ellpack_spmv_windowed) and B5/B6 (the segment folds) on one
NVIDIA GPU at the shapes chip_smoke.py gives them, beside probes that say
whether streaming or gathering sets each kernel's time.

    python3 tools/spmv_kernel_bench.py [--src DIR] [--only b4|b5] [--tag T]

``--src`` names the ``src`` directory of the checkout whose kernels are
timed (default: this checkout's), so an older tree unpacked beside this
one can be timed in the same call; ``--tag`` is copied into every line.
The matrix, plans and inputs are chip_smoke.py's: n = 2^22, r_nz 16, band
n/64, 2% long-range columns, eight ranks on one card.

Prints one JSON line per measurement, each with the card's name and power
limit (device ms from chip_smoke.cuda_ms):

- ``build``: nvcc seconds and ptxas's registers and spills of the B4/B5
  kernels;
- ``b4``: the on-copy SpMV of the full rungs, float32, through the
  wrapper (the kernel the path runs), held against the plain version at
  chip_smoke.SPMV_TOL, with the probe ``no_spread_ms`` (every column set to
  the row's own index: the stream, with gathers that all hit one line);
  where the tree has both B4 kernels, ``b4_row_order`` times the row-order
  one on the same inputs;
- ``b4_gathers_only`` (tools/spmv_probes.cu): the same spread of gathers
  with the stream cut to a table in L1;
  ``b4_gather_list``: the matrix's gathers as a list of positions, in row
  order and sorted by column inside groups of ``SORT_GROUP_ROWS`` rows;
  then bfloat16 where the tree's kernel takes it, and CSR ``sparse.mm``;
- ``b5``: every push site: ``ms`` (the wrapper, both kernels),
  ``short_ms`` (short rows alone), ``long_ms`` (long rows alone),
  ``identity_ms`` (short rows with perm the identity: contiguous value
  reads, the streaming floor), ``chain_ms`` (one add chain as long as the
  site's longest row) and the bound;
- ``b5_step``: the transposed SpMV step of the replicate, blockwise and
  condensed rungs (chip_smoke.time_steps and profile_steps: ms, busy
  share, kernel ms), where the short and long rows must run side by side.

The wrapper's result at every site is held bit for bit against the plain
version run on the CPU.
"""
import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATHER_TABLE_ROWS = 4096
SORT_GROUP_ROWS = (1024, 2048, 4096, 8192, 16384, 1 << 19)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("b4", "b5"), help="one kernel only")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("spmv_kernel_bench: no CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.plan import (Topology, build_comm_plan,
                                       derive_scatter_plan)
    from repro_torch.core.matrix import make_mesh_like_matrix
    from repro_torch.core.spmv import DistributedSpMV
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    card = cs.phase_card(torch)
    src = str(pathlib.Path(kops.__file__).resolve().parents[2])
    _build.load()
    info = _build.build_info()
    # the probes build through the timed tree's _build (trees from before
    # build_library time no probes: they do not depend on the tree)
    probes = cs.load_probes()[0] if hasattr(_build, "build_library") else None

    def emit(obj):
        cs.emit({**obj, "tag": args.tag, "src": src, "card": card})

    emit({"bench": "build", "nvcc_seconds": info["seconds"],
          "ptxas": cs.ptxas_usage(info["log"], ("ellpack", "fold"))})
    dev = torch.device("cuda")
    matrix = make_mesh_like_matrix(cs.N, cs.R_NZ, locality_window=cs.N // 64,
                                   long_range_frac=0.02, seed=cs.SEED)
    x_host = np.random.default_rng(cs.SEED).standard_normal(cs.N).astype(
        np.float32)
    shard = cs.N // cs.P
    stream = torch.cuda.current_stream

    if args.only != "b5":
        local_fn, (diag, vals, win_blk, cols_rel, own_rel), window, rpb = \
            cs.spmv_inputs(torch, matrix, dev)
        x_copy = torch.zeros((cs.P, cs.N + 1), device=dev)
        x_copy[:, :cs.N] = torch.as_tensor(x_host).to(dev)
        no_spread = own_rel[:, :, None].expand(-1, -1, cs.R_NZ).contiguous()
        want = kref.ellpack_spmv_ref(diag, vals, cols_rel, own_rel, win_blk,
                                     x_copy, window=window,
                                     rows_per_block=rpb)
        x_read = cs.spmv_x_read(torch, win_blk, cols_rel, window, rpb)
        bnd = cs.bound(cs.P * shard * (12 + cs.R_NZ * 8)
                       + win_blk.numel() * 4 + x_read * 4)
        got = local_fn(diag, vals, x_copy, win_blk, cols_rel, own_rel)
        emit({"bench": "b4",
              "ok": bool(torch.allclose(got, want, **cs.SPMV_TOL)),
              "max_abs_err": float((got - want).abs().max()),
              "ms": cs.cuda_ms(torch, lambda: local_fn(
                  diag, vals, x_copy, win_blk, cols_rel, own_rel)),
              "no_spread_ms": cs.cuda_ms(torch, lambda: local_fn(
                  diag, vals, x_copy, win_blk, no_spread, own_rel)),
              "bound_ms": bnd[0]})
        if "rt_ellpack_spmv_sorted" in _build._SIGNATURES:
            y_row = torch.empty_like(got)

            def row_order():
                _build.launch(
                    None, "rt_ellpack_spmv", dev, diag.data_ptr(),
                    vals.data_ptr(), cols_rel.data_ptr(), own_rel.data_ptr(),
                    win_blk.data_ptr(), x_copy.data_ptr(), y_row.data_ptr(),
                    cs.P, shard, cs.R_NZ, rpb, window, x_copy.stride(0), 0, 0)
            row_order()
            emit({"bench": "b4_row_order",
                  "ok": bool(torch.allclose(y_row, want, **cs.SPMV_TOL)),
                  "ms": cs.cuda_ms(torch, row_order), "bound_ms": bnd[0]})
        # the gathers alone: offsets of rank 0's middle rows, in L1
        mid = shard // 2
        rows = np.arange(mid, mid + GATHER_TABLE_ROWS)
        off = torch.as_tensor((matrix.cols[rows] - rows[:, None]).astype(
            np.int32)).to(dev)
        y = torch.empty((cs.P, shard), device=dev)

        def gathers():
            status = probes.probe_spmv_gathers(
                off.data_ptr(), x_copy.data_ptr(), y.data_ptr(), cs.P, shard,
                shard, cs.N, x_copy.stride(0), GATHER_TABLE_ROWS,
                stream().cuda_stream)
            cs.check(status == 0, f"probe_spmv_gathers: {status}")
        if probes is not None:
            emit({"bench": "b4_gathers_only",
                  "ms": cs.cuda_ms(torch, gathers),
                  "bound_ms": cs.bound(cs.P * shard * 4 + x_read * 4)[0]})
        # the same gathers as a position list, in row order and sorted by
        # column inside groups of rows
        if probes is not None:
            base = (win_blk.long() * window).repeat_interleave(rpb, dim=1)
            pos = (base[:, :, None] + cols_rel + (torch.arange(
                cs.P, device=dev) * x_copy.stride(0))[:, None, None])
            row = torch.arange(shard, device=dev)[None, :, None].expand_as(pos)
            out = torch.empty(pos.numel() // 8, device=dev)
            for group in (None,) + SORT_GROUP_ROWS:
                if group is None:
                    lst = pos.reshape(-1).to(torch.int32)
                else:
                    key = (torch.arange(cs.P, device=dev)[:, None, None]
                           * (shard // group) + row // group) * (1 << 32) + pos
                    lst = torch.sort(key.reshape(-1)).values.remainder(
                        1 << 32).to(torch.int32)

                def listed():
                    status = probes.probe_gather_list(
                        lst.data_ptr(), x_copy.data_ptr(), out.data_ptr(),
                        out.numel(), stream().cuda_stream)
                    cs.check(status == 0, f"probe_gather_list: {status}")
                emit({"bench": "b4_gather_list", "sorted_rows": group,
                      "ms": cs.cuda_ms(torch, listed)})
                del lst
            del pos, row, out
        bf = [t.to(torch.bfloat16) for t in (diag, vals, x_copy)]
        try:
            got = local_fn(bf[0], bf[1], bf[2], win_blk, cols_rel, own_rel)
        except TypeError as exc:
            emit({"bench": "b4_bf16", "refused": str(exc)})
        else:
            want16 = kref.ellpack_spmv_ref(
                bf[0].float(), bf[1].float(), cols_rel, own_rel, win_blk,
                bf[2].float(), window=window, rows_per_block=rpb)
            emit({"bench": "b4_bf16",
                  "ok": bool(torch.allclose(got.float(), want16,
                                            **cs.BF16_OUT_TOL)),
                  "ms": cs.cuda_ms(torch, lambda: local_fn(
                      bf[0], bf[1], bf[2], win_blk, cols_rel, own_rel)),
                  "bound_ms": cs.bound(cs.P * shard * (8 + cs.R_NZ * 6)
                                       + win_blk.numel() * 4
                                       + x_read * 2)[0]})
        csr = cs._csr_d_plus_a(torch, matrix, dev)
        x_col = x_copy[0, :cs.N, None]
        emit({"bench": "b4_library", "what": "CSR sparse.mm",
              "ms": cs.cuda_ms(torch, lambda: torch.sparse.mm(csr, x_col))})
        del bf, csr, x_copy, want, no_spread
        torch.cuda.empty_cache()

    if args.only == "b4":
        return
    base = build_comm_plan(matrix.cols, cs.N, cs.P, blocksize=cs.BLOCKSIZE,
                           topology=Topology(cs.P, cs.SHARDS_PER_NODE))
    splan = derive_scatter_plan(base)
    comm = LoopbackComm(cs.P)
    t_engines = {s: DistributedSpMV(
        matrix, comm, strategy=s, shards_per_node=cs.SHARDS_PER_NODE,
        use_kernel=True, transpose=True, base_plan=base, scatter_plan=splan)
        for s in ("condensed", "blockwise", "replicate")}
    sites, own_cpu = cs.push_sites(torch, matrix, x_host, t_engines)
    dtypes = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
    gated = "rt_fold_gate" in _build._SIGNATURES     # a start counter
    for site, (name, init, vals_s, idx, table, out_len) in sites.items():
        live = table.live_len

        def fold(tab):
            if init is None:
                return kops.accumulate_segments(vals_s, idx, out_len=out_len,
                                                table=tab)
            return kops.accumulate_into(init, vals_s, idx, table=tab)
        if init is None:
            want = kref.accumulate_segments_ref(vals_s.cpu(), idx.cpu(),
                                                out_len=out_len)
        else:
            want = kref.accumulate_into_ref(own_cpu, vals_s.cpu(), idx.cpu())
        got = fold(table)
        ok = torch.equal(got[:, :live].cpu().view(torch.int32),
                         want[:, :live].view(torch.int32))
        short = dataclasses.replace(table, long_rows=table.long_rows[:0])
        ident = dataclasses.replace(short, perm=torch.arange(
            idx.shape[1], dtype=torch.int32, device=dev).repeat(cs.P, 1))
        n_long = table.long_rows.numel() if vals_s.dim() == 2 else 0
        out = torch.empty_like(got)

        def long_rows():
            _build.launch(
                None, "rt_fold_long_rows", dev,
                None if init is None else init.data_ptr(), vals_s.data_ptr(),
                table.perm.data_ptr(), table.seg_ptr.data_ptr(),
                None if table.pad_rows is None else table.pad_rows.data_ptr(),
                table.long_rows.data_ptr(), out.data_ptr(), cs.P,
                idx.shape[1], live, out_len, n_long, dtypes[vals_s.dtype], 0,
                *((None,) if gated else ()))
        line = {"bench": "b5", "site": site, "kernel": name, "ok": ok,
                "ms": cs.cuda_ms(torch, lambda: fold(table)),
                "short_ms": cs.cuda_ms(torch, lambda: fold(short)),
                "long_ms": cs.cuda_ms(torch, long_rows) if n_long else None,
                "identity_ms": cs.cuda_ms(torch, lambda: fold(ident)),
                "chain_ms": (cs.chain_ms(torch, probes, table.longest())
                             if probes is not None else None),
                "longest": table.longest(), "n_long": n_long,
                "bound_ms": cs.push_bound(table, vals_s, init)[0][0]}
        emit(line)
    for strategy, eng in t_engines.items():
        x = eng.shard_vector(x_host)
        emit({"bench": "b5_step", "strategy": strategy,
              **cs.time_steps(torch, lambda: eng(x)),
              **cs.profile_steps(torch, lambda: eng(x))})


if __name__ == "__main__":
    main()
