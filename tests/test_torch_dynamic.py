"""The port's dynamic patterns (``repro_torch.comm.dynamic``), the plan
cache's envelope tier and the front doors' per-batch surface against the
JAX reference.

* the device derivation's tables equal the JAX ``derive_gather_tables`` /
  ``derive_scatter_tables`` and the host planner (``build_comm_plan`` at
  the same ``s_max``, then ``derive_scatter_plan``) bit for bit, over
  p ∈ {2, 4, 8}, expert counts, capacities, k and seeds, with ``r > 1``
  and with an ``s_max`` below the routing's need (overflow into the dump
  slot, which only the JAX derivation computes: the host planner refuses);
* ``_quantized_pattern_stats`` and ``envelope_plan_key`` equal the
  reference's, and ``get_envelope_plan`` reuses its bucket;
* the front doors take a ``DynamicPattern`` and refuse what the
  reference refuses (a rung outside ``DYNAMIC_STRATEGIES``, ``candidates``
  naming one, a ``Destination``); the JAX front doors run on a one-device
  mesh in this process;
* ``Schedule`` accepts a ``DynamicPattern`` (its template).
"""
import numpy as np
import pytest

from repro.comm import dynamic as jdyn
from repro.comm import plan_cache as jcache
from repro.models.moe import moe_dispatch_pattern as j_dispatch_pattern
from repro.models.moe import random_router as j_random_router
from repro_torch.comm import dynamic as tdyn
from repro_torch.comm import plan_cache
from repro_torch.comm import telemetry
from repro_torch.comm.communicator import LoopbackComm
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import (Topology, build_comm_plan,
                                   derive_scatter_plan)
from repro_torch.core import perfmodel as pm
from repro_torch.models.moe import moe_dispatch_pattern, random_router

GATHER_FIELDS = ("send_local_idx", "recv_global_idx", "send_counts")
SCATTER_FIELDS = ("cond_msg_idx", "own_tgt_idx", "win_mask", "touched")
ROUTINGS = [(8, 4, 1), (16, 16, 2), (32, 8, 4), (8, 16, 2)]


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    plan_cache.clear_memory_cache()
    plan_cache.stats.reset()
    yield
    plan_cache.clear_memory_cache()


def _routing_cols(num_experts, capacity, k, seed, p, n_tok=128):
    """The MoE slot→token table of a seeded zipf routing."""
    top_e, _ = random_router(seed, n_tok, num_experts, k)
    idx, _ = moe_dispatch_pattern(top_e, n_tok, num_experts, capacity, p)
    return idx.reshape(-1, 1), n_tok


def _assert_tables(cols, n, p, s_max, *, host=True, ref=True):
    """Both directions, all seven tables: the port's derivation against
    (``ref``) the JAX derivation and (``host``) the host planner, bit for
    bit."""
    g = tdyn.derive_gather_tables(cols, n, p, s_max)
    s = tdyn.derive_scatter_tables(cols, n, p, s_max, gather=g)
    # without the gather tables the scatter derivation sorts on its own
    alone = tdyn.derive_scatter_tables(cols, n, p, s_max)
    for name in SCATTER_FIELDS:
        np.testing.assert_array_equal(getattr(alone, name).numpy(),
                                      getattr(s, name).numpy())
    if ref:
        _assert_reference(g, s, cols, n, p, s_max)
    if not host:
        return
    plan = build_comm_plan(cols, n, p, s_max=s_max)
    splan = derive_scatter_plan(plan)
    for name in GATHER_FIELDS:
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      getattr(plan, name), err_msg=name)
    for name in SCATTER_FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      getattr(splan, name), err_msg=name)


def _assert_reference(g, s, cols, n, p, s_max):
    jg = jdyn.derive_gather_tables(cols, n, p, s_max)
    js = jdyn.derive_scatter_tables(cols, n, p, s_max, gather=jg)
    for name in GATHER_FIELDS:
        want = np.asarray(getattr(jg, name))
        got = getattr(g, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in SCATTER_FIELDS:
        want = np.asarray(getattr(js, name))
        got = getattr(s, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_experts,capacity,k", ROUTINGS)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_derived_tables_bit_identical(p, num_experts, capacity, k, seed):
    cols, n = _routing_cols(num_experts, capacity, k, seed, p)
    env = tdyn.envelope_s_max(cols.shape[0], 1, n, p)
    _assert_tables(cols, n, p, env)
    # anything wider than the natural maximum is pure dump padding
    natural = build_comm_plan(cols, n, p).s_max
    _assert_tables(cols, n, p, natural, ref=False)
    _assert_tables(cols, n, p, env + 3, ref=False)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_envelope_overflow_lands_in_the_dump_slot(p):
    """An ``s_max`` below the routing's need: ranks past it drop into the
    dump slot instead of a neighbor's segment, as the JAX derivation does
    (the host planner refuses to narrow)."""
    cols, n = _routing_cols(16, 16, 2, 3, p)
    natural = build_comm_plan(cols, n, p).s_max
    assert natural > 1
    for s_max in sorted({1, natural // 2, natural - 1}):
        _assert_tables(cols, n, p, max(1, s_max), host=False)
    with pytest.raises(AssertionError, match="widening-only"):
        build_comm_plan(cols, n, p, s_max=natural - 1)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_multi_r_patterns(p, r):
    """r > 1 rows (SpMV-like) derive identically too."""
    rng = np.random.default_rng(5 + r)
    n = 64 * p
    cols = rng.integers(0, n, size=(16 * p, r)).astype(np.int32)
    _assert_tables(cols, n, p, tdyn.envelope_s_max(16 * p, r, n, p))


def test_envelope_s_max_and_pattern_surface():
    for args in [(64, 1, 1024, 8), (4096, 2, 64, 8), (8, 1, 8, 8),
                 (96, 3, 48, 4)]:
        assert tdyn.envelope_s_max(*args) == jdyn.envelope_s_max(*args)
    assert tdyn.DYNAMIC_STRATEGIES == jdyn.DYNAMIC_STRATEGIES
    cols, n = _routing_cols(8, 8, 2, 0, 4)
    dp = tdyn.DynamicPattern.from_template(
        AccessPattern.from_indices(cols, n=n), 4)
    assert dp.s_max == tdyn.envelope_s_max(cols.shape[0], 1, n, 4)
    assert (dp.n, dp.m, dp.r) == (n, cols.shape[0], 1)
    np.testing.assert_array_equal(dp.indices, cols)
    with pytest.raises(AssertionError, match="envelope"):
        tdyn.DynamicPattern.from_template(dp.template, 4, s_max=dp.s_max + 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_dispatch_pattern_and_router_equal_the_reference(seed):
    te, tw = random_router(seed, 64, 8, 2)
    jte, jtw = j_random_router(seed, 64, 8, 2)
    np.testing.assert_array_equal(te, jte)
    np.testing.assert_array_equal(tw, jtw)
    for p in (2, 4, 8):
        idx, valid = moe_dispatch_pattern(te, 64, 8, 8, p)
        jidx, jvalid = j_dispatch_pattern(jte, 64, 8, 8, p)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)


# ---- the envelope tier of the plan cache ----------------------------------

def _envelope_case(seed=0, n=256, p=4, m_rows=128, r=2):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, size=(m_rows, r)).astype(np.int32)
    return cols, n, p


@pytest.mark.parametrize("bucket", [1, 4, 8, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_envelope_key_and_stats_equal_the_reference(seed, bucket):
    from repro.comm.plan import Topology as JTopology

    cols, n, p = _envelope_case(seed)
    np.testing.assert_array_equal(
        plan_cache._quantized_pattern_stats(cols, n, p, bucket),
        jcache._quantized_pattern_stats(cols, n, p, bucket))
    for bs, spn, s_max in [(16, 2, n // p), (32, 4, n // p // 2)]:
        assert plan_cache.envelope_plan_key(
            cols, n, p, bs, Topology(p, spn), s_max, bucket) == \
            jcache.envelope_plan_key(cols, n, p, bs, JTopology(p, spn),
                                     s_max, bucket)
    moe, n_tok = _routing_cols(8, 8, 2, seed, 4)
    assert plan_cache.envelope_plan_key(
        moe, n_tok, 4, n_tok // 4, Topology(4, 4), 8, bucket) == \
        jcache.envelope_plan_key(moe, n_tok, 4, n_tok // 4,
                                 JTopology(4, 4), 8, bucket)


def test_envelope_plan_bucket_reuse_hits_and_misses():
    """Two routings whose quantized per-(reader, owner) stats round up to
    the same bucket boundaries share ONE envelope entry; a routing whose
    load crosses a bucket boundary founds a new one."""
    cols, n, p = _envelope_case(seed=0)
    with telemetry.isolated() as tel:
        p1 = plan_cache.get_envelope_plan(cols, n, p, blocksize=16,
                                          s_max=n // p, bucket=n)
        assert plan_cache.stats.misses == 1
        assert tel.sources["host-build"] == 1
        cols2, _, _ = _envelope_case(seed=1)
        p2 = plan_cache.get_envelope_plan(cols2, n, p, blocksize=16,
                                          s_max=n // p, bucket=n)
        assert plan_cache.stats.misses == 1
        assert plan_cache.stats.memory_hits == 1
        assert tel.sources["bucket-reuse"] == 1
        assert p2 is p1  # the founding entry, verbatim
        assert p2.s_max == n // p

        # fine buckets separate routings with different load envelopes
        plan_cache.get_envelope_plan(cols, n, p, blocksize=16,
                                     s_max=n // p, bucket=1)
        assert plan_cache.stats.misses == 2
        assert tel.sources["host-build"] == 2

        # disk tier: evicting memory still avoids the host rebuild
        plan_cache.clear_memory_cache()
        p3 = plan_cache.get_envelope_plan(cols2, n, p, blocksize=16,
                                          s_max=n // p, bucket=n)
        assert plan_cache.stats.misses == 2
        assert plan_cache.stats.disk_hits == 1
        assert tel.sources["bucket-reuse"] == 2
        for name in GATHER_FIELDS:
            np.testing.assert_array_equal(getattr(p3, name),
                                          getattr(p1, name))


def test_envelope_plan_key_sensitivity():
    cols, n, p = _envelope_case(seed=0)
    topo = Topology(p, 2)
    k0 = plan_cache.envelope_plan_key(cols, n, p, 16, topo, n // p, bucket=8)
    assert k0 == plan_cache.envelope_plan_key(cols.copy(), n, p, 16, topo,
                                              n // p, bucket=8)
    for other in [(32, topo, n // p, 8), (16, topo, n // p // 2, 8),
                  (16, topo, n // p, 4), (16, Topology(p, p), n // p, 8)]:
        bs, tp, s_max, bucket = other
        assert k0 != plan_cache.envelope_plan_key(cols, n, p, bs, tp, s_max,
                                                  bucket=bucket)
    heavy = cols.copy()
    heavy[: len(heavy) // 2] = 0  # pile half the reads onto owner 0
    assert k0 != plan_cache.envelope_plan_key(heavy, n, p, 16, topo, n // p,
                                              bucket=8)


def test_envelope_plan_uncached_builds_at_the_envelope():
    cols, n, p = _envelope_case(seed=2)
    with telemetry.isolated() as tel:
        plan = plan_cache.get_envelope_plan(cols, n, p, cache=False)
        assert tel.sources["host-build"] == 1
    assert plan.s_max == tdyn.envelope_s_max(cols.shape[0], 2, n, p)
    ref = build_comm_plan(cols, n, p, s_max=plan.s_max)
    for name in GATHER_FIELDS:
        np.testing.assert_array_equal(getattr(plan, name), getattr(ref, name))


# ---- the front doors -------------------------------------------------------

def _dyn_case(p, seed=0, rows_per_shard=32, r=2, shard=64):
    rng = np.random.default_rng(seed)
    n = shard * p
    cols = rng.integers(0, n, size=(rows_per_shard * p, r)).astype(np.int32)
    template = AccessPattern.from_indices(cols, n=n)
    return template, tdyn.DynamicPattern.from_template(template, p), n


@pytest.mark.parametrize("p", [1, 4, 8])
def test_front_doors_accept_dynamic_pattern(p):
    """Gather and scatter take a DynamicPattern wherever they take an
    AccessPattern; auto restricts the ladder to the dynamic rungs; results
    match a statically host-planned exchange of the same pattern."""
    import torch

    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter

    comm = LoopbackComm(p, device="cpu")
    template, dp, n = _dyn_case(p)
    rng = np.random.default_rng(1)
    gather = IrregularGather(dp, comm, strategy="auto", hw=pm.ABEL)
    assert gather.strategy in tdyn.DYNAMIC_STRATEGIES
    assert set(gather.predicted_times) == set(tdyn.DYNAMIC_STRATEGIES)
    static_g = IrregularGather(template, comm, strategy=gather.strategy,
                               hw=pm.ABEL)
    x = rng.standard_normal(n).astype(np.float32)
    # the n real entries: the dump slot differs between s_max's
    assert torch.equal(gather(gather.shard_vector(x))[:, :n],
                       static_g(static_g.shard_vector(x))[:, :n])
    scatter = IrregularScatter(dp, comm, strategy="auto", reduce="add",
                               hw=pm.ABEL)
    assert scatter.strategy in tdyn.DYNAMIC_STRATEGIES
    static_s = IrregularScatter(template, comm, strategy=scatter.strategy,
                                reduce="add", hw=pm.ABEL)
    vals = rng.standard_normal(template.indices.shape).astype(np.float32)
    assert torch.equal(scatter(scatter.shard_values(vals)),
                       static_s(static_s.shard_values(vals)))


@pytest.mark.parametrize("reduce", ["add", "set", "max"])
@pytest.mark.parametrize("strategy", ["condensed", "overlap"])
def test_derive_plan_args_serve_every_batch(strategy, reduce):
    """One exchange built on a template serves other routings of the same
    shape through ``derive_plan_args``: the same numbers as an exchange
    host-planned for each routing, in both directions, and the derived
    tables of the template equal the ``plan_args`` it was built with."""
    import torch

    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter

    p = 8
    comm = LoopbackComm(p, device="cpu")
    template, dp, n = _dyn_case(p, seed=3)
    gather = IrregularGather(dp, comm, strategy=strategy)
    scatter = IrregularScatter(dp, comm, strategy=strategy, reduce=reduce)
    tcols = torch.as_tensor(template.indices)
    for a, b in zip(gather.derive_plan_args(tcols), gather.plan_args):
        assert torch.equal(a, b)
    for a, b in zip(scatter.derive_plan_args(tcols), scatter.plan_args):
        assert torch.equal(a, b.to(a.dtype)) and a.shape == b.shape
    rng = np.random.default_rng(4)
    for seed in (5, 6):
        other, _, _ = _dyn_case(p, seed=seed)
        cols = torch.as_tensor(other.indices)
        g_tables = tdyn.derive_gather_tables(cols, n, p, dp.s_max)
        gargs = gather.derive_plan_args(cols)
        sargs = scatter.derive_plan_args(cols, gather_tables=g_tables)
        assert all(torch.equal(a, b) for a, b in zip(
            sargs, scatter.derive_plan_args(cols)))
        x = gather.shard_vector(rng.integers(-4, 5, n).astype(np.float32))
        ref_g = IrregularGather(other, comm, strategy=strategy,
                                use_plan_cache=False)
        assert torch.equal(gather.local(x, *gargs)[:, :n], ref_g(x)[:, :n])
        vals = scatter.shard_values(rng.integers(
            -4, 5, other.indices.shape).astype(np.float32))
        ref_s = IrregularScatter(other, comm, strategy=strategy,
                                 reduce=reduce, use_plan_cache=False)
        assert torch.equal(scatter.local(vals, *sargs), ref_s(vals))


def test_dynamic_pattern_refusals_match_the_reference():
    """A rung outside DYNAMIC_STRATEGIES, auto candidates naming one, and a
    host-precomputed Destination are refused by both packages' front doors
    (the JAX ones on a one-device mesh), with the same exception type; a
    static blockwise exchange refuses ``derive_plan_args``."""
    import jax

    from repro.comm import dynamic as jd
    from repro.comm.gather import IrregularGather as JGather
    from repro.comm.pattern import AccessPattern as JPattern
    from repro.comm.pattern import Destination as JDestination
    from repro.comm.scatter import IrregularScatter as JScatter
    from repro.core import perfmodel as jpm
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter

    p = 1
    mesh = jax.make_mesh((p,), ("data",))
    comm = LoopbackComm(p, device="cpu")
    template, dp, n = _dyn_case(p)
    jdp = jd.DynamicPattern.from_template(
        JPattern.from_indices(template.indices, n=n), p)
    slots = np.zeros((p, 4), np.int64)
    cases = [
        (lambda: IrregularGather(dp, comm, strategy="blockwise", hw=pm.ABEL),
         lambda: JGather(jdp, mesh, strategy="blockwise", hw=jpm.ABEL),
         "DynamicPattern"),
        (lambda: IrregularScatter(dp, comm, strategy="replicate",
                                  reduce="add", hw=pm.ABEL),
         lambda: JScatter(jdp, mesh, strategy="replicate", reduce="add",
                          hw=jpm.ABEL),
         "DynamicPattern"),
        (lambda: IrregularGather(dp, comm, strategy="auto", hw=pm.ABEL,
                                 candidates=("blockwise", "condensed")),
         lambda: JGather(jdp, mesh, strategy="auto", hw=jpm.ABEL,
                         candidates=("blockwise", "condensed")),
         "candidates"),
        (lambda: IrregularGather(dp, comm, strategy="condensed", hw=pm.ABEL,
                                 destination=Destination.from_slots(s=slots)),
         lambda: JGather(jdp, mesh, strategy="condensed", hw=jpm.ABEL,
                         destination=JDestination.from_slots(s=slots)),
         "Destination"),
    ]
    for port, ref, match in cases:
        with pytest.raises(ValueError, match=match):
            ref()
        with pytest.raises(ValueError, match=match):
            port()
    jtemplate = JPattern.from_indices(template.indices, n=n)
    with pytest.raises(ValueError, match="derive_plan_args"):
        JGather(jtemplate, mesh, strategy="blockwise",
                hw=jpm.ABEL).derive_plan_args(jtemplate.indices)
    with pytest.raises(ValueError, match="derive_plan_args"):
        IrregularGather(template, comm, strategy="blockwise",
                        hw=pm.ABEL).derive_plan_args(template.indices)
    with pytest.raises(ValueError, match="derive_plan_args"):
        IrregularScatter(template, comm, strategy="replicate",
                         hw=pm.ABEL).derive_plan_args(template.indices)
    # auto with candidates inside the dynamic ladder resolves among them
    g = IrregularGather(dp, comm, strategy="auto", hw=pm.ABEL,
                        candidates=("overlap",))
    assert g.strategy == "overlap" and set(g.predicted_times) == {"overlap"}


def test_dynamic_pattern_refuses_the_kernels():
    """The kernels' tables are built on the host from the index tensor they
    run on, which a per-batch pattern cannot have without a sync: a
    DynamicPattern with use_kernel=True, and ``derive_plan_args`` of a
    scatter built with use_kernel=True, raise naming the ROADMAP item."""
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.scatter import IrregularScatter

    p = 4
    comm = LoopbackComm(p, device="cpu")
    template, dp, n = _dyn_case(p)
    with pytest.raises(NotImplementedError, match="A17"):
        IrregularGather(dp, comm, strategy="condensed", use_kernel=True)
    with pytest.raises(NotImplementedError, match="A17"):
        IrregularScatter(dp, comm, strategy="condensed", use_kernel=True)
    s = IrregularScatter(template, comm, strategy="condensed",
                         use_kernel=True)
    with pytest.raises(NotImplementedError, match="A17"):
        s.derive_plan_args(template.indices)


def test_dynamic_front_doors_price_decode_and_plan_cost():
    """``decode=`` prices the rungs on the decode floors and ``plan_cost=``
    adds T_plan to each, as ``select.rank_strategies`` does."""
    from repro_torch.comm import select
    from repro_torch.comm.gather import IrregularGather

    p = 8
    comm = LoopbackComm(p, device="cpu")
    _, dp, _ = _dyn_case(p)
    cost = 3e-6
    g = IrregularGather(dp, comm, strategy="auto", hw=pm.ABEL, decode=True,
                        plan_cost=cost)
    want = dict(select.rank_strategies(
        g.plan, dp.r, pm.ABEL, candidates=tdyn.DYNAMIC_STRATEGIES,
        decode=True, plan_cost=cost))
    assert g.predicted_times == want and g.decode
    plain = IrregularGather(dp, comm, strategy="auto", hw=pm.ABEL)
    assert plain.predicted_times != g.predicted_times


def test_schedule_accepts_a_dynamic_pattern():
    """A Schedule stage over a DynamicPattern runs on its template: the
    same numbers as the schedule over the template itself."""
    import torch

    from repro_torch.comm.schedule import Schedule

    p = 4
    comm = LoopbackComm(p, device="cpu")
    template, dp, n = _dyn_case(p, seed=7)
    outs = []
    for pattern in (dp, template):
        sched = Schedule()
        x = sched.input("x")
        rows = sched.constant(template.indices)
        g = sched.gather(pattern, src=x)

        def take(xc, r):
            ranks = torch.arange(xc.shape[0])[:, None, None]
            return xc[ranks, r]

        v = sched.compute(take, g, rows)
        sched.scatter(pattern, v, reduce="add")
        step = sched.compile(comm, strategy="condensed")
        xv = np.random.default_rng(8).integers(-4, 5, n).astype(np.float32)
        outs.append(step(step.shard_input(xv)))
    assert torch.equal(outs[0], outs[1])
