"""The card kernels under a per-batch pattern: the tables they read,
derived on the device with no host sync, and the front doors that run them.

* ``kernels.derive_segment_table`` and ``kernels.derive_tile_order`` equal
  the host-built ``segment_table`` / ``tile_table`` of the same index array
  bit for bit on every live entry (``perm``, ``seg_ptr``, ``pad_rows``, the
  counted prefixes of ``runs`` and ``long_rows``; ``tgt``, ``perm``,
  ``tile_ptr``), over the tables a ``DynamicPattern``'s condensed exchange
  derives (p ∈ {2, 4, 8}, the routings of ``tests/test_torch_dynamic.py``,
  r ∈ {1, 2}, the ``"into"`` fold's padding lanes, an ``s_max`` below the
  routing's need) and over adversarial arrays (every lane on one target,
  all targets distinct, rows that straddle the ``RUN_ROWS`` and
  ``RUN_LANES`` cuts, the most long rows a rank can hold); no count
  exceeds its capacity (``run_capacity``, ``long_capacity``);
* ``IrregularGather`` / ``IrregularScatter`` over a ``DynamicPattern`` with
  ``use_kernel=True`` (on the CPU the kernels' plain versions) against the
  JAX front doors with ``use_kernel=True`` (Pallas in interpret mode) fed
  the same batches' ``derive_plan_args``, bit for bit in float32 and int32:
  add, max and set, condensed and overlap, two routings each.  The JAX
  side needs eight devices, so it runs once in a subprocess of this file
  (``python tests/test_torch_dynamic_kernels.py OUT.npz`` with
  ``--xla_force_host_platform_device_count=8``);
* a per-batch kernel exchange refuses plan args without its derived
  tables rather than build them on the host.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

P = 8
N_TOK = 128
# (num_experts, capacity, k) of tests/test_torch_dynamic.py
ROUTINGS = [(8, 4, 1), (16, 16, 2), (32, 8, 4), (8, 16, 2)]
# the front doors: a template routing and two batches of one shape
FRONT = (16, 16, 2)
TEMPLATE_SEED, BATCH_SEEDS = 10, (11, 12)
STRATEGIES = ("condensed", "overlap")
REDUCES = ("add", "max", "set")
DTYPES = ("float32", "int32")
GATHER_COMBOS = list(itertools.product(STRATEGIES, DTYPES))
SCATTER_COMBOS = list(itertools.product(STRATEGIES, REDUCES, DTYPES))


def _routing(num_experts, capacity, k, seed, p, r=1):
    """A seeded zipf routing's slot→token table, rows of ``r`` slots."""
    from repro_torch.models.moe import moe_dispatch_pattern, random_router

    top_e, _ = random_router(seed, N_TOK, num_experts, k)
    idx, _ = moe_dispatch_pattern(top_e, N_TOK, num_experts, capacity, p)
    return idx.reshape(-1, r)


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, shape).astype(dtype)


# ---- the derived tables against the host-built ones ------------------------

def _assert_segment_tables(derived, host):
    """Equal on every live entry; the capacity tails are zero."""
    import torch

    from repro_torch.kernels import pack_gather as kpg

    assert derived.live_len == host.live_len
    assert derived.out_len == host.out_len
    assert host.live_counts is None
    for name in ("perm", "seg_ptr"):
        got, want = getattr(derived, name), getattr(host, name)
        assert got.dtype == want.dtype == torch.int32, name
        assert torch.equal(got, want), name
    assert (derived.pad_rows is None) == (host.pad_rows is None)
    if host.pad_rows is not None:
        assert derived.pad_rows.dtype == torch.int8
        assert torch.equal(derived.pad_rows, host.pad_rows)
    p, k = host.idx.shape
    n_runs, n_long = derived.live_counts.tolist()
    assert derived.live_counts.dtype == torch.int32
    assert n_runs == host.runs.shape[0] and n_long == host.long_rows.numel()
    r_cap = derived.runs.shape[0]
    l_cap = derived.long_rows.numel()
    assert r_cap == kpg.run_capacity(p, k, host.live_len)
    assert l_cap == kpg.long_capacity(p, k, host.live_len)
    assert n_runs <= r_cap and n_long <= l_cap
    assert torch.equal(derived.runs[:n_runs], host.runs)
    assert torch.equal(derived.long_rows[:n_long], host.long_rows)
    assert not derived.runs[n_runs:].any()
    assert not derived.long_rows[n_long:].any()
    assert derived.runs.dtype == derived.long_rows.dtype == torch.int32


def _check_segment(idx, *, out_len, live_len=None, pad=None):
    from repro_torch.kernels import pack_gather as kpg

    derived = kpg.derive_segment_table(idx, out_len=out_len,
                                       live_len=live_len, pad=pad)
    host = kpg.segment_table(idx, out_len=out_len, live_len=live_len,
                             pad=pad)
    _assert_segment_tables(derived, host)
    return derived, host


def _check_tiles(idx, out_len):
    import torch

    from repro_torch.kernels import pack_gather as kpg

    order = kpg.derive_tile_order(idx)
    for row_bytes in (4, 4096, 65536):
        got = order.table(out_len=out_len, row_bytes=row_bytes)
        want = kpg.tile_table(idx, out_len=out_len, row_bytes=row_bytes)
        assert got.idx is idx and got.tile_rows == want.tile_rows
        assert (got.out_len, got.row_bytes) == (want.out_len,
                                                want.row_bytes)
        assert torch.equal(got.tile_ptr, want.tile_ptr)
        assert torch.equal(got.perm, want.perm)
        assert got.tgt.dtype == got.perm.dtype == torch.int32
        for q in range(idx.shape[0]):
            kept = int(want.tile_ptr[q, -1])
            assert torch.equal(got.tgt[q, :kept], want.tgt[q, :kept])


def _check_exchange_tables(cols, n, p, s_max):
    """Every table a condensed kernel exchange derives from ``cols``, held
    against the host builds of the same arrays; returns the derived
    scatter tables."""
    import torch

    from repro_torch.comm import dynamic as tdyn
    from repro_torch.comm import strategies as strat

    cols = torch.as_tensor(cols)
    g = tdyn.derive_gather_tables(cols, n, p, s_max)
    s = tdyn.derive_scatter_tables(cols, n, p, s_max, gather=g)
    shard, live = n // p, p * s_max
    _check_tiles(g.recv_global_idx.reshape(p, -1), n + 1)
    _check_tiles(g.recv_global_idx.reshape(p, -1), n + 3)
    msg = s.cond_msg_idx.reshape(p, -1)
    own = s.own_tgt_idx.reshape(p, -1)
    unpack = g.send_local_idx.reshape(p, -1)
    _check_segment(msg, out_len=live + 1, live_len=live)
    _check_segment(own, out_len=shard + 1, live_len=shard)
    pad = strat._padding_lanes(g.send_counts, s_max, "cpu")
    host_pad = strat._padding_lanes(g.send_counts.numpy(), s_max, "cpu")
    assert torch.equal(pad, host_pad)
    _, into = _check_segment(unpack, out_len=shard + 1, live_len=shard,
                             pad=pad)
    assert into.pad_rows is not None
    return g, s


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("num_experts,capacity,k", ROUTINGS)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_derived_tables_equal_the_host_builds(p, num_experts, capacity, k,
                                              r):
    from repro_torch.comm import dynamic as tdyn

    for seed in (0, 1):
        cols = _routing(num_experts, capacity, k, seed, p, r)
        env = tdyn.envelope_s_max(cols.shape[0], r, N_TOK, p)
        _check_exchange_tables(cols, N_TOK, p, env)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_derived_tables_below_the_routing_need(p):
    """An ``s_max`` below the routing's need: the overflow lands in the
    dump slot, and the tables of those arrays still equal the host builds
    (padding lanes included: the send counts clamp at ``s_max``)."""
    from repro_torch.comm.plan import build_comm_plan

    cols = _routing(16, 16, 2, 3, p)
    natural = build_comm_plan(cols, N_TOK, p).s_max
    assert natural > 1
    for s_max in sorted({1, natural // 2, natural - 1}):
        _check_exchange_tables(cols, N_TOK, p, max(1, s_max))


def test_derived_scatter_tables_equal_the_plan_tables():
    """``derive_scatter_segment_tables`` on a batch's derived plan args
    equals ``scatter_segment_tables`` on a host-planned ScatterPlan of the
    same routing at the envelope ``s_max``."""
    import torch

    from repro_torch.comm import dynamic as tdyn
    from repro_torch.comm import strategies as strat
    from repro_torch.comm.plan import build_comm_plan, derive_scatter_plan

    cols = _routing(*FRONT, 4, P)
    s_max = tdyn.envelope_s_max(cols.shape[0], 1, N_TOK, P)
    splan = derive_scatter_plan(build_comm_plan(cols, N_TOK, P,
                                                s_max=s_max))
    host_args = strat.to_device(
        strat.scatter_plan_device_args(splan, "condensed"), "cpu")
    host = strat.scatter_segment_tables(splan, "condensed", host_args)
    g = tdyn.derive_gather_tables(torch.as_tensor(cols), N_TOK, P, s_max)
    for a, b in zip(host_args, (splan.cond_msg_idx, g.send_local_idx)):
        assert torch.equal(torch.as_tensor(b).reshape(a.shape), a)
    derived = strat.derive_scatter_segment_tables(splan, host_args,
                                                  g.send_counts)
    assert set(derived) == set(host) == {"pack", "own", "into"}
    for name in host:
        _assert_segment_tables(derived[name], host[name])


def _lanes_for(counts, p=2, seed=0):
    """``(P, K)`` int32 targets whose rows get ``counts[t]`` lanes each,
    the lanes shuffled."""
    import torch

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(counts)), counts)
    idx = np.stack([rng.permutation(rows) for _ in range(p)])
    return torch.as_tensor(idx.astype(np.int32))


def test_adversarial_segment_tables():
    import torch

    from repro_torch.kernels import pack_gather as kpg

    rl, rr, ll = kpg.RUN_LANES, kpg.RUN_ROWS, kpg.LONG_LANES
    rng = np.random.default_rng(7)
    # every lane on one target (one long row a rank), and on the dump row
    for k in (ll, ll + 1, 3 * rl):
        ones = torch.zeros((4, k), dtype=torch.int32)
        d, _ = _check_segment(ones, out_len=5)
        assert d.live_counts.tolist()[1] == (4 if k > ll else 0)
        _check_segment(ones + 4, out_len=5, live_len=4)
    # every target distinct: one lane a row, runs cut at each multiple of
    # RUN_ROWS (4 a rank) and of RUN_LANES - LONG_LANES lanes (3 a rank)
    live = 3 * rr + 5
    distinct = torch.as_tensor(np.stack([rng.permutation(live)
                                         for _ in range(3)]).astype(np.int32))
    d, _ = _check_segment(distinct, out_len=live)
    assert d.live_counts.tolist() == [3 * (4 + 3), 0]
    # rows of 63, 64 and 65 lanes, the run lane cut, RUN_LANES - 1 lanes
    straddle = [ll - 1, ll, ll + 1, 1, 0, 2] * 40 + [rl - 1] + [0] * rr \
        + [3] * (rr + 7)
    _check_segment(_lanes_for(straddle), out_len=len(straddle))
    # long rows each followed by a short one: a run after every long row
    alt = [ll + 1, 1] * 300
    d, _ = _check_segment(_lanes_for(alt, p=3), out_len=len(alt))
    assert d.live_counts.tolist() == [3 * 300, 3 * 300]
    # as many long rows as the lanes allow: the capacity is reached
    full = [ll + 1] * 200
    d, _ = _check_segment(_lanes_for(full), out_len=200)
    assert d.live_counts.tolist()[1] == d.long_rows.numel() == 2 * 200
    # padding lanes, some on dump rows, and random rows beside the cuts
    k = 5 * rl
    idx = torch.as_tensor(rng.integers(0, rr + 40, (4, k)).astype(np.int32))
    pad = torch.as_tensor(rng.random((4, k)) < 0.3)
    _check_segment(idx, out_len=rr + 40, live_len=rr + 17, pad=pad)
    _check_segment(idx, out_len=rr + 40, pad=pad)
    # no lanes (one run of empty rows a rank), and no live rows
    for shape, out_len, live, runs in [((2, 0), 3, None, 2),
                                       ((2, 5), 3, 0, 0)]:
        empty = torch.zeros(shape, dtype=torch.int32)
        d, _ = _check_segment(empty, out_len=out_len, live_len=live)
        assert d.live_counts.tolist() == [runs, 0]
        _check_tiles(empty, out_len)
    # tile orders: duplicates, a dump row, rows wider than a tile
    dup = torch.as_tensor(rng.integers(0, 50, (3, 400)).astype(np.int32))
    _check_tiles(dup, 50)
    _check_tiles(dup, 60)


def test_capacities_bound_every_count():
    """Random tables of every shape class: no count exceeds its
    capacity, and the capacities are those of the comments."""
    import torch

    from repro_torch.kernels import pack_gather as kpg

    assert kpg.long_capacity(8, 1 << 20, 65536) == 8 * ((1 << 20) // 65)
    assert kpg.run_capacity(2, 100, 7) == 2 * (1 + 100 // 65)
    assert kpg.run_capacity(2, 1000, 7) == 2 * 7
    assert kpg.run_capacity(1, 4096, 5000) == 3 + 4096 // 65 + 4096 // 1984
    rng = np.random.default_rng(11)
    for trial in range(6):
        p = int(rng.integers(1, 5))
        live = int(rng.integers(1, 6000))
        k = int(rng.integers(1, 12000))
        zipf = np.minimum(rng.zipf(1.3, (p, k)) - 1, live - 1)
        idx = torch.as_tensor(zipf.astype(np.int32))
        d, h = _check_segment(idx, out_len=live)
        assert h.runs.shape[0] <= kpg.run_capacity(p, k, live)
        assert h.long_rows.numel() <= kpg.long_capacity(p, k, live)


def test_derived_tables_refuse_out_of_range_on_the_device_check():
    """The derivations check the range on the device
    (``torch._assert_async``), which on the CPU raises at once."""
    import torch

    from repro_torch.kernels import pack_gather as kpg

    bad = torch.tensor([[0, 5]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="out_len"):
        kpg.derive_segment_table(bad, out_len=5)
    with pytest.raises(RuntimeError, match="out_len"):
        kpg.derive_tile_order(bad).table(out_len=5, row_bytes=4)
    with pytest.raises(RuntimeError, match="out_len"):
        kpg.derive_tile_order(-bad - 1)


@pytest.mark.parametrize("alpha", [0.0, 1.1])
def test_random_neighbors_on_a_device_equal_the_host_draw(alpha):
    """The per-batch graphs are drawn with ``random_neighbors(...,
    device=)``: the same array as the host draw (and the reference's)."""
    from repro.models.gnn import random_neighbors as j_neighbors
    from repro_torch.models.gnn import random_neighbors

    for seed in (2, 3):
        got = random_neighbors(4096, 16, alpha=alpha, seed=seed,
                               device="cpu")
        want = random_neighbors(4096, 16, alpha=alpha, seed=seed)
        assert str(got.dtype) == "torch.int32"
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, j_neighbors(4096, 16,
                                                        alpha=alpha,
                                                        seed=seed))


# ---- the front doors against the JAX front doors ---------------------------

def _gkey(strategy, dtype, seed):
    return f"g-{strategy}-{dtype}-{seed}"


def _skey(strategy, reduce, dtype, seed):
    return f"s-{strategy}-{reduce}-{dtype}-{seed}"


def run_reference(out_path: str) -> None:
    """The JAX dynamic front doors with use_kernel=True, each batch's tables
    from ``derive_plan_args`` inside the jit (needs 8 host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from repro import compat
    from repro.comm import dynamic as jd
    from repro.comm.gather import IrregularGather as JGather
    from repro.comm.pattern import AccessPattern as JPattern
    from repro.comm.scatter import IrregularScatter as JScatter

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    template = _routing(*FRONT, TEMPLATE_SEED, P)
    jdp = jd.DynamicPattern.from_template(
        JPattern.from_indices(template, n=N_TOK), P)
    out = {}

    def runner(ex, local):
        def run(v, cols):
            args = ex.derive_plan_args(cols)
            return compat.shard_map(
                local, mesh=mesh, in_specs=(PS("data"),) + ex.in_specs,
                out_specs=PS("data"), check_vma=False)(v, *args)
        return jax.jit(run)

    for strategy, dtype in GATHER_COMBOS:
        g = JGather(jdp, mesh, strategy=strategy, use_kernel=True)
        run = runner(g, lambda x, *a, g=g: g.local(
            x, *a, materialize="full")[None])
        for seed in BATCH_SEEDS:
            cols = _routing(*FRONT, seed, P)
            x = g.shard_vector(_values(dtype, N_TOK, seed))
            out[_gkey(strategy, dtype, seed)] = np.asarray(
                run(x, jnp.asarray(cols)))
    for strategy, reduce, dtype in SCATTER_COMBOS:
        s = JScatter(jdp, mesh, strategy=strategy, reduce=reduce,
                     use_kernel=True)
        run = runner(s, s.local)
        for seed in BATCH_SEEDS:
            cols = _routing(*FRONT, seed, P)
            vals = s.shard_values(_values(dtype, cols.shape, seed + 100))
            out[_skey(strategy, reduce, dtype, seed)] = np.asarray(
                run(vals, jnp.asarray(cols)))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dynamic") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def dyn_pattern():
    from repro_torch.comm import dynamic as tdyn
    from repro_torch.comm.pattern import AccessPattern

    template = _routing(*FRONT, TEMPLATE_SEED, P)
    return tdyn.DynamicPattern.from_template(
        AccessPattern.from_indices(template, n=N_TOK), P)


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    from repro_torch.comm import plan_cache

    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plan_cache.clear_memory_cache()
    yield
    plan_cache.clear_memory_cache()


@pytest.mark.parametrize("strategy,dtype", GATHER_COMBOS)
def test_dynamic_gather_with_kernels_matches_jax(reference, dyn_pattern,
                                                 strategy, dtype):
    import torch

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.kernels import ops as kops

    g = IrregularGather(dyn_pattern, LoopbackComm(P, device="cpu"),
                        strategy=strategy, use_kernel=True)
    assert len(g.plan_args) == 3
    kops.reset_launch_counts()
    for seed in BATCH_SEEDS:
        cols = torch.as_tensor(_routing(*FRONT, seed, P))
        args = g.derive_plan_args(cols)
        assert len(args) == 3 and isinstance(args[2], kops.TileOrder)
        x = g.shard_vector(_values(dtype, N_TOK, seed))
        if strategy == "overlap":
            got = g.start_local(x, *args).finish()
        else:
            got = g.local(x, *args)
        want = reference[_gkey(strategy, dtype, seed)]
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got[:, :N_TOK].numpy(),
                                      want[:, :N_TOK])
        plain = IrregularGather(dyn_pattern, LoopbackComm(P, device="cpu"),
                                strategy=strategy)
        assert torch.equal(plain.local(x, *plain.derive_plan_args(cols))[
            :, :N_TOK], got[:, :N_TOK])
    assert not any(kops.launch_counts().values())     # CPU: plain versions


@pytest.mark.parametrize("strategy,reduce,dtype", SCATTER_COMBOS)
def test_dynamic_scatter_with_kernels_matches_jax(reference, dyn_pattern,
                                                  strategy, reduce, dtype):
    import torch

    from repro_torch.comm import dynamic as tdyn
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.kernels import ops as kops

    comm = LoopbackComm(P, device="cpu")
    s = IrregularScatter(dyn_pattern, comm, strategy=strategy, reduce=reduce,
                         use_kernel=True)
    assert len(s.plan_args) == 6 and s.plan_args[5] is s.tables
    kops.reset_launch_counts()
    for seed in BATCH_SEEDS:
        cols = torch.as_tensor(_routing(*FRONT, seed, P))
        g = tdyn.derive_gather_tables(cols, N_TOK, P, dyn_pattern.s_max)
        args = s.derive_plan_args(cols, gather_tables=g)
        alone = s.derive_plan_args(cols)
        assert len(args) == len(alone) == 6
        for a, b in zip(args[:5], alone[:5]):
            assert torch.equal(a, b)
        host = _host_scatter_tables(args, g.send_counts.numpy(),
                                    dyn_pattern.s_max)
        assert set(args[5]) == set(host)
        for name, table in args[5].items():
            _assert_segment_tables(table, host[name])
        vals = s.shard_values(_values(dtype, tuple(cols.shape), seed + 100))
        if strategy == "overlap":
            got = s.start_local(vals, *args).finish()
        else:
            got = s.local(vals, *args)
        want = reference[_skey(strategy, reduce, dtype, seed)]
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
        plain = IrregularScatter(dyn_pattern, comm, strategy=strategy,
                                 reduce=reduce)
        assert torch.equal(plain.local(vals, *plain.derive_plan_args(cols)),
                           got)
    assert not any(kops.launch_counts().values())     # CPU: plain versions


def _host_scatter_tables(args, send_counts, s_max):
    """The three tables of a condensed scatter's plan args built on the
    host (``segment_table``), the ``"into"`` padding from this batch's
    ``send_counts``."""
    from repro_torch.comm import strategies as strat
    from repro_torch.kernels import pack_gather as kpg

    msg, unpack, own = (a.reshape(P, -1) for a in args[:3])
    shard, live = N_TOK // P, P * s_max
    return {"pack": kpg.segment_table(msg, out_len=live + 1, live_len=live),
            "own": kpg.segment_table(own, out_len=shard + 1,
                                     live_len=shard),
            "into": kpg.segment_table(
                unpack, out_len=shard + 1, live_len=shard,
                pad=strat._padding_lanes(send_counts, s_max, "cpu"))}


def test_per_batch_kernel_exchanges_take_only_their_derived_tables(
        dyn_pattern):
    """A per-batch kernel exchange given the condensed tables alone raises
    instead of building the kernels' tables on the host; its template's
    plan args are ``derive_plan_args`` of the template."""
    import torch

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter

    comm = LoopbackComm(P, device="cpu")
    g = IrregularGather(dyn_pattern, comm, strategy="condensed",
                        use_kernel=True)
    s = IrregularScatter(dyn_pattern, comm, strategy="overlap",
                         use_kernel=True)
    tcols = torch.as_tensor(dyn_pattern.indices)
    gargs, sargs = g.derive_plan_args(tcols), s.derive_plan_args(tcols)
    for a, b in zip(gargs[:2], g.plan_args[:2]):
        assert torch.equal(a, b)
    assert torch.equal(gargs[2].perm, g.plan_args[2].perm)
    for a, b in zip(sargs[:5], s.plan_args[:5]):
        assert torch.equal(a, b.to(a.dtype))
    for name in ("pack", "own", "into"):
        a, b = sargs[5][name], s.plan_args[5][name]
        for field in ("perm", "seg_ptr", "pad_rows", "runs", "long_rows",
                      "live_counts"):
            x_, y_ = getattr(a, field), getattr(b, field)
            assert (x_ is None and y_ is None) or torch.equal(x_, y_), field
    x = g.shard_vector(_values("float32", N_TOK, 0))
    with pytest.raises(ValueError, match="derive_plan_args"):
        g.local(x, *gargs[:2])
    vals = s.shard_values(_values("float32", tcols.shape, 1))
    with pytest.raises(ValueError, match="derive_plan_args"):
        s.local(vals, *sargs[:5])
    with pytest.raises(ValueError, match="derive_plan_args"):
        s.start_local(vals, *sargs[:5])


if __name__ == "__main__":
    run_reference(sys.argv[1])
