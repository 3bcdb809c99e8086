#!/usr/bin/env python3
"""Time B4 (ellpack_spmv_windowed), B5/B6 (the segment folds), B3
(unpack_dest, and its fusion with the slot product) and B2
(unpack_scatter_set) on one NVIDIA GPU at the shapes chip_smoke.py gives
them, beside probes that say whether streaming or gathering sets each
kernel's time, and the SpMV steps that run them.

    python3 tools/spmv_kernel_bench.py [--src DIR] [--only K[,K...]] [--tag T]

``--only`` takes any of b4, b5, b3, b2, b2_heat2d, steps (default: all).

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
  share, kernel ms), where the short and long rows must run side by side;
- ``b3``: every rung's targeted unpack on its own landed exchange: the
  kernel that reads the plan's arrays (``arrays_ms``), and where
  the tree has the dest table ``table_ms`` (the path's kernel: sorted
  codes), the probes ``sorted_arrays_ms`` (layout a alone: the plan's
  arrays permuted into the table's order, staged) and ``codes_ms``
  (layout b alone: codes in slot order), and the bounds on 14 and on 10
  bytes a slot; held bit for bit against the plain version;
- ``b3_group``: at the condensed rung, B3 and its fusion through dest
  tables of ``DEST_GROUPS`` slots a group;
- ``b3_fused``: the same rungs' slot product: ``composed_ms`` (B3 then
  the plain product, the dest step without the fusion), and where the
  tree has it ``unpack_dest_spmv`` through the table, held against the
  plain composition at chip_smoke.SPMV_TOL;
- ``b2``: the full unpack at the condensed rung (own rows copied), the
  overlap rung (no own rows, one zero slot) and the blockwise rung (1024-
  wide block rows): ``three_phase_ms`` (without a table) and, where the
  tree has the tile table, ``tiles_ms``; ``zero_fill_ms`` (the output
  zeroed, the floor of its writes) and the bound; held against the plain
  version outside the dump row; ``b2_tile``: the condensed unpack through tile
  tables of ``TILE_SIZES`` bytes a tile;
- ``b2_heat2d``: Heat2D's blockwise full unpack (8 MB rows, chip_smoke.py's
  field and grid) on the inputs its step gives it, ``wide_rows_ms``
  (through the tile table) and ``three_phase_ms`` (without one), each
  twice in the order A B B A, with the zero fill and the bound;
- ``step``: the forward SpMV step of every rung x {dest, full}.

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
# B3's dest table: slots a group (its sort and its shared memory); B2's
# tile table: bytes a tile
DEST_GROUPS = (4096, 8192, 16384, 32768, 49152)
TILE_SIZES = (4096, 8192, 16384, 32768, 49152)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", default="b4,b5,b3,b2,b2_heat2d,steps",
                    help="comma-separated: b4, b5, b3, b2, b2_heat2d, "
                         "steps")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    only = set(args.only.split(","))
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
          "ptxas": cs.ptxas_usage(info["log"], ("ellpack", "fold", "dest",
                                                     "tiles"))})
    dev = torch.device("cuda")
    matrix = make_mesh_like_matrix(cs.N, cs.R_NZ, locality_window=cs.N // 64,
                                   long_range_frac=0.02, seed=cs.SEED)
    x_host = np.random.default_rng(cs.SEED).standard_normal(cs.N).astype(
        np.float32)
    shard = cs.N // cs.P
    stream = torch.cuda.current_stream

    if "b4" in only:
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

    base = build_comm_plan(matrix.cols, cs.N, cs.P, blocksize=cs.BLOCKSIZE,
                           topology=Topology(cs.P, cs.SHARDS_PER_NODE))
    comm = LoopbackComm(cs.P)
    if "b2_heat2d" in only and hasattr(kops, "ScatterTiles"):
        heat2d_unpack(emit, cs, torch, comm)
    if only & {"b3", "b2", "steps"}:
        exchange_bench(emit, cs, torch, matrix, x_host, base, comm, probes,
                       only)
    if "b5" not in only:
        return
    splan = derive_scatter_plan(base)
    t_engines = {s: DistributedSpMV(
        matrix, comm, strategy=s, shards_per_node=cs.SHARDS_PER_NODE,
        use_kernel=True, transpose=True, base_plan=base, scatter_plan=splan)
        for s in ("condensed", "blockwise", "replicate")}
    sites, own_cpu = cs.push_sites(torch, matrix, x_host, t_engines)
    dtypes = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
    gated = "rt_fold_gate" in _build._SIGNATURES     # a start counter
    # a tree whose fold reads live counts from the device takes a null for
    # a host-built table
    counts = (None,) * (len(_build._SIGNATURES["rt_fold_long_rows"]) == 17)
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
                table.long_rows.data_ptr(), *counts, out.data_ptr(), cs.P,
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


def exchange_bench(emit, cs, torch, matrix, x_host, base, comm, probes,
                   only) -> None:
    """The ``b3``, ``b3_fused``, ``b2`` and ``step`` lines (see the module
    docstring)."""
    import numpy as np

    from repro_torch.core.spmv import DistributedSpMV
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    stream = torch.cuda.current_stream
    p, n, shard = cs.P, cs.N, cs.N // cs.P
    tables = hasattr(kops, "DestOrder")
    engines = {(s, mat): DistributedSpMV(
        matrix, comm, strategy=s, shards_per_node=cs.SHARDS_PER_NODE,
        use_kernel=True, materialize=mat, base_plan=base)
        for s in cs.STRATEGIES for mat in ("dest", "full")}

    def landed(eng):
        """The rank-stacked landed exchange of ``eng`` and x."""
        x = eng.shard_vector(x_host)
        args = eng.gather.plan_args
        recv = eng.gather._start(x, *args).wait()
        return x, recv.reshape(p, -1), args

    for strategy in cs.STRATEGIES if only & {"b3"} else ():
        eng = engines[(strategy, "dest")]
        x, recv, args = landed(eng)
        dest = tuple(args[-4:])
        dargs = (recv, x) + dest
        want = kref.unpack_dest_ref(*dargs)
        slots = dest[0].shape[1]
        reads = (cs.unique_rows(torch, dest[0], dest[3])
                 + cs.unique_rows(torch, dest[1], dest[2])) * 4
        line = {"bench": "b3", "strategy": strategy, "slots": slots,
                "ok": bool(torch.equal(kops.unpack_dest(*dargs), want)),
                "arrays_ms": cs.cuda_ms(torch, lambda: kops.unpack_dest(
                    *dargs)),
                "bound_14_ms": cs.bound(p * slots * 14 + reads)[0],
                "bound_10_ms": cs.bound(p * slots * 10 + reads)[0]}
        r = slots // shard
        rows_vals = (torch.as_tensor(matrix.vals).to(x.device).reshape(
            p, shard, -1) if strategy != "overlap" else torch.ones(
                (p, shard, r), device=x.device))
        diag = (torch.as_tensor(matrix.diag).to(x.device).reshape(p, shard)
                if strategy != "overlap" else None)

        def composed():
            s_ = kops.unpack_dest(*dargs).reshape(p, shard, r)
            acc = (rows_vals * s_).sum(-1)
            return acc if diag is None else diag * x + acc
        fused = {"bench": "b3_fused", "strategy": strategy,
                 "composed_ms": cs.cuda_ms(torch, composed)}
        if tables:
            from repro_torch.kernels import pack_gather as kpg
            table = kops.DestOrder()(*dest)
            line["table_ok"] = bool(torch.equal(
                kops.unpack_dest(*dargs, table=table), want))
            line["table_ms"] = cs.cuda_ms(torch, lambda: kops.unpack_dest(
                *dargs, table=table))
            out = torch.empty_like(want)
            start = (torch.arange(slots, device=x.device) // table.group
                     * table.group)
            at = start + table.slot.long() % (1 << 16)
            perm = [a.gather(1, at).contiguous() for a in dest]
            slot16 = table.slot
            code, shift = kpg.dest_codes(*dest)

            def sorted_arrays():
                cs.check(probes.probe_dest_sorted_arrays(
                    recv.data_ptr(), x.data_ptr(),
                    *(a.data_ptr() for a in perm), slot16.data_ptr(),
                    out.data_ptr(), p, recv.shape[1], shard, slots,
                    table.group, stream().cuda_stream) == 0,
                    "probe_dest_sorted_arrays")

            def codes():
                cs.check(probes.probe_dest_codes(
                    recv.data_ptr(), x.data_ptr(), code.data_ptr(),
                    None if shift is None else shift.data_ptr(),
                    out.data_ptr(), p, recv.shape[1], shard, slots,
                    stream().cuda_stream) == 0, "probe_dest_codes")
            for name, fn in (("sorted_arrays", sorted_arrays),
                             ("codes", codes)):
                fn()
                line[f"{name}_ok"] = bool(torch.equal(out, want))
                line[f"{name}_ms"] = cs.cuda_ms(torch, fn)
            del perm, out, code
            if strategy == "condensed":      # the group size, swept
                for group in DEST_GROUPS:
                    g = kpg.dest_table(*dest, group=group)
                    gf = kpg.dest_table(*dest, group=group // r * r)
                    emit({"bench": "b3_group", "group": group,
                          "ms": cs.cuda_ms(torch, lambda: kops.unpack_dest(
                              *dargs, table=g)),
                          "fused_ms": cs.cuda_ms(
                              torch, lambda: kops.unpack_dest_spmv(
                                  *dargs, rows_vals, diag, table=gf))})
                    del g, gf
            ftab = kops.DestOrder(row=r)(*dest)
            plain = kref.unpack_dest_spmv_ref(*dargs, rows_vals, diag)
            y = kops.unpack_dest_spmv(*dargs, rows_vals, diag, table=ftab)
            fused["table_ok"] = bool(torch.allclose(y, plain, **cs.SPMV_TOL))
            fused["table_ms"] = cs.cuda_ms(
                torch, lambda: kops.unpack_dest_spmv(*dargs, rows_vals, diag,
                                                     table=ftab))
        emit(line)
        emit(fused)
        del dargs, want, recv
        torch.cuda.empty_cache()

    for strategy in ("condensed", "overlap", "blockwise") if "b2" in only \
            else ():
        if strategy == "condensed" and tables:
            tile_sweep(emit, cs, torch, engines[(strategy, "full")], landed)
        eng = engines[(strategy, "full")]
        x, recv, args = landed(eng)
        if strategy == "blockwise":
            bs = cs.BLOCKSIZE
            recv = recv.reshape(p, -1, bs)
            idx = args[1].reshape(p, -1)
            x_own = x.reshape(p, -1, bs)
            out_len, copy_own = n // bs + 1, True
        else:
            idx, x_own = args[1].reshape(p, -1), x
            out_len = n + 1 if strategy == "condensed" else n + 2
            copy_own = strategy == "condensed"
        rows_own = x_own.shape[1]
        offsets = torch.arange(0, p * rows_own, rows_own, dtype=torch.int32,
                               device=x.device)
        kw = dict(out_len=out_len, copy_own=copy_own)
        uargs = (recv, idx, x_own, offsets)
        want = kref.unpack_scatter_set_ref(*uargs, **kw)
        live = out_len - 1 if strategy == "condensed" else n // (
            cs.BLOCKSIZE if strategy == "blockwise" else 1)
        row_bytes = x_own[0, 0].numel() * 4
        line = {"bench": "b2", "strategy": strategy, "out_len": out_len,
                "copy_own": copy_own,
                "ok": bool(torch.equal(kops.unpack_scatter_set(
                    *uargs, **kw)[:, :live], want[:, :live])),
                "three_phase_ms": cs.cuda_ms(
                    torch, lambda: kops.unpack_scatter_set(*uargs, **kw)),
                "zero_fill_ms": cs.cuda_ms(torch, lambda: want.zero_()),
                "bound_ms": cs.bound(
                    p * idx.shape[1] * (row_bytes + 4)
                    + (p * rows_own * row_bytes if copy_own else 0)
                    + p * out_len * row_bytes)[0]}
        want = kref.unpack_scatter_set_ref(*uargs, **kw)
        if tables:
            table = kops.ScatterTiles()(idx, out_len=out_len,
                                        row_bytes=row_bytes)
            line["tiles_ok"] = bool(torch.equal(kops.unpack_scatter_set(
                *uargs, table=table, **kw)[:, :live], want[:, :live]))
            line["tiles_ms"] = cs.cuda_ms(
                torch, lambda: kops.unpack_scatter_set(*uargs, table=table,
                                                       **kw))
        emit(line)
        del uargs, want, recv
        torch.cuda.empty_cache()

    if "steps" not in only:
        return
    from repro_torch.core.matrix import spmv_ref_np
    y_ref = spmv_ref_np(matrix, x_host)
    for (strategy, mat), eng in engines.items():
        x = eng.shard_vector(x_host)
        y = eng(x)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        timing = cs.time_steps(torch, lambda: eng(x))
        after = torch.cuda.memory_stats()
        emit({"bench": "step", "strategy": strategy, "materialize": mat,
              "ok": bool(np.allclose(y.reshape(-1).cpu().numpy(), y_ref,
                                     **cs.Y_TOL)),
              **timing,
              # the caching allocator's device allocations and frees during
              # the timed steps (each one a host-side cudaMalloc/cudaFree)
              "allocator": {k: after.get(k, 0) - before.get(k, 0) for k in (
                  "num_device_alloc", "num_device_free", "num_alloc_retries",
                  "segment.all.allocated", "segment.all.freed")},
              "reserved_gb": after.get("reserved_bytes.all.current", 0) / 1e9,
              **cs.profile_steps(torch, lambda: eng(x))})


def heat2d_unpack(emit, cs, torch, comm) -> None:
    """The ``b2_heat2d`` line: Heat2D's blockwise full unpack (rows of one
    whole 8 MB tile) on the inputs its step gives it, through the tile
    table (a tile a row: the wide-row kernel) and without one (three
    phases), timed in the order A B B A."""
    from repro_torch.core.heat2d import Heat2D
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    h = Heat2D(comm, cs.HEAT_N, cs.HEAT_N, mprocs=cs.MPROCS,
               nprocs=cs.NPROCS, coef=cs.HEAT_COEF, strategy="blockwise",
               materialize="full", use_kernel=True,
               shards_per_node=cs.SHARDS_PER_NODE)
    calls, unpack = [], kops.unpack_scatter_set

    def record(*a, **kw):        # the step's own call, its inputs kept
        calls.append((a, kw))
        return unpack(*a, **kw)
    kops.unpack_scatter_set = record
    try:
        h.run(h.shard_field(cs.heat_field()), 1)
        torch.cuda.synchronize()
    finally:
        kops.unpack_scatter_set = unpack
    (recv, idx, x_own, offsets), kw = calls[0]
    table = kw.pop("table")
    cs.check(table is not None, "Heat2D's blockwise unpack got no table")
    live = cs.HEAT_N * cs.HEAT_N // x_own[0, 0].numel()
    want = kref.unpack_scatter_set_ref(recv, idx, x_own, offsets, **kw)
    fns = {"wide_rows": lambda: unpack(recv, idx, x_own, offsets,
                                       table=table, **kw),
           "three_phase": lambda: unpack(recv, idx, x_own, offsets, **kw)}
    line = {"bench": "b2_heat2d", "rows": list(recv.shape),
            "row_bytes": table.row_bytes, "tile_rows": table.tile_rows,
            "out_len": kw["out_len"], "copy_own": kw.get("copy_own", True)}
    for name, fn in fns.items():
        line[f"{name}_ok"] = bool(torch.equal(fn()[:, :live],
                                              want[:, :live]))
    times = {name: [] for name in fns}
    for name in ("wide_rows", "three_phase", "three_phase", "wide_rows"):
        times[name].append(cs.cuda_ms(torch, fns[name]))
    # the least it must move: the index array, one landed row for each
    # distinct target (the last of a target's rows is what stays), the own
    # rows where they are copied, and the output once
    p, n_recv = idx.shape
    row_bytes = table.row_bytes
    landed_rows = sum(int(torch.unique(idx[q]).numel()) for q in range(p))
    emit({**line, **{f"{k}_ms": v for k, v in times.items()},
          "zero_fill_ms": cs.cuda_ms(torch, lambda: want.zero_()),
          "landed_rows": landed_rows,
          "bound_ms": cs.bound(
              p * n_recv * 4 + landed_rows * row_bytes
              + (p * x_own.shape[1] * row_bytes
                 if kw.get("copy_own", True) else 0)
              + p * kw["out_len"] * row_bytes)[0]})
    del calls, recv, want, h
    torch.cuda.empty_cache()


def tile_sweep(emit, cs, torch, eng, landed) -> None:
    """``b2_tile`` lines: the condensed full unpack through tile tables of
    ``TILE_SIZES`` bytes."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pack_gather as kpg
    p, n = cs.P, cs.N
    x, recv, args = landed(eng)
    idx = args[1].reshape(p, -1)
    offsets = torch.arange(0, n, n // p, dtype=torch.int32, device=x.device)
    for size in TILE_SIZES:
        kpg.TILE_BYTES, keep = size, kpg.TILE_BYTES
        table = kpg.tile_table(idx, out_len=n + 1, row_bytes=4)
        kpg.TILE_BYTES = keep
        emit({"bench": "b2_tile", "tile_bytes": size,
              "ms": cs.cuda_ms(torch, lambda: kops.unpack_scatter_set(
                  recv, idx, x, offsets, out_len=n + 1, table=table))})


if __name__ == "__main__":
    main()
