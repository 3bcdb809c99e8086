"""The port's persistent CommPlan cache (``repro_torch.comm.plan_cache``):
the reference's plan-cache cases (content addressing, hit/miss accounting,
the LRU and disk tiers, destination and scatter deltas, entries of
another format, concurrent writers, engine-level reuse) on the port,
minus the envelope tier (dynamic patterns, ROADMAP A9) and the
reference's migration of its own older formats; plus ``plan_key`` equal to the JAX
``plan_key`` on the same inputs, and cached plans equal to the JAX
``build_comm_plan``'s bit for bit.  The cache lives in ``tmp_path``.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core.matrix import make_mesh_like_matrix
from repro_torch.comm.plan import Topology, build_comm_plan
from repro_torch.comm import plan_cache

P = 8


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_MEM_ENTRIES", raising=False)
    plan_cache.clear_memory_cache()
    plan_cache.stats.reset()
    yield
    plan_cache.clear_memory_cache()


def _case(seed=0, n=256, p=4, bs=16):
    m = make_mesh_like_matrix(n, 4, locality_window=n // 4,
                              long_range_frac=0.1, seed=seed)
    return m, n, p, bs, Topology(p, 2)


def _assert_plans_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "counts":
            for cf in dataclasses.fields(va):
                np.testing.assert_array_equal(getattr(va, cf.name),
                                              getattr(vb, cf.name))
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f.name


def test_memory_and_disk_hits():
    m, n, p, bs, topo = _case()
    p1 = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.misses == 1
    p2 = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.memory_hits == 1 and plan_cache.stats.misses == 1
    _assert_plans_equal(p1, p2)

    plan_cache.clear_memory_cache()
    p3 = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.disk_hits == 1 and plan_cache.stats.misses == 1
    _assert_plans_equal(p1, p3)
    # round-tripped plan is bit-identical to a fresh host-side build
    fresh = build_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    _assert_plans_equal(p3, fresh)


def test_key_sensitivity():
    m, n, p, bs, topo = _case()
    base = plan_cache.plan_key(m.cols, n, p, bs, topo)
    assert base == plan_cache.plan_key(m.cols.copy(), n, p, bs, topo)
    assert base != plan_cache.plan_key(m.cols, n, p, bs * 2, topo)
    assert base != plan_cache.plan_key(m.cols, n, p, bs, Topology(p, p))
    cols2 = m.cols.copy()
    cols2[0, 0] = (cols2[0, 0] + 1) % n
    assert base != plan_cache.plan_key(cols2, n, p, bs, topo)


def test_different_matrices_do_not_collide():
    m1, n, p, bs, topo = _case(seed=1)
    m2 = make_mesh_like_matrix(n, 4, locality_window=n // 4,
                               long_range_frac=0.1, seed=2)
    p1 = plan_cache.get_comm_plan(m1.cols, n, p, blocksize=bs, topology=topo)
    p2 = plan_cache.get_comm_plan(m2.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.misses == 2
    assert not np.array_equal(p1.send_counts, p2.send_counts) or \
        not np.array_equal(p1.recv_global_idx, p2.recv_global_idx)


def test_memory_lru_eviction(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_MEM_ENTRIES", "2")
    n, p, bs = 256, 4, 16
    topo = Topology(p, 2)
    mats = [make_mesh_like_matrix(n, 4, locality_window=n // 4,
                                  long_range_frac=0.1, seed=s)
            for s in range(3)]
    for m in mats:
        plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert len(plan_cache._memory) == 2  # oldest evicted
    # evicted entry falls back to the disk tier, not a rebuild
    plan_cache.get_comm_plan(mats[0].cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.misses == 3 and plan_cache.stats.disk_hits == 1


def test_disable_via_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", "0")
    m, n, p, bs, topo = _case()
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.misses == 2 and plan_cache.stats.hits == 0


def test_corrupt_disk_entry_degrades_to_rebuild(tmp_path):
    m, n, p, bs, topo = _case()
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    key = plan_cache.plan_key(m.cols, n, p, bs, topo)
    path = plan_cache._disk_path(key)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    plan_cache.clear_memory_cache()
    plan = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs,
                                    topology=topo)
    assert plan_cache.stats.misses == 2  # corrupt entry -> rebuild
    fresh = build_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    _assert_plans_equal(plan, fresh)


def test_destination_plans_round_trip_and_reuse_base():
    """v3 entries carry the targeted-unpack arrays; attaching a Destination
    to an already-planned pattern reuses the cached base plan (no second
    O(nnz) build)."""
    from repro_torch.comm.pattern import Destination

    m, n, p, bs, topo = _case()
    slots = m.cols[::4, :2].reshape(p, -1).astype(np.int64).copy()
    slots[:, -1] = Destination.ZERO
    dest = Destination.from_slots(s=slots)

    base = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert plan_cache.stats.misses == 1
    p1 = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo,
                                  destination=dest)
    # the destination entry was derived from the cached base, not rebuilt
    assert plan_cache.stats.misses == 1
    assert p1.dest_len == slots.shape[1] and base.dest_len == 0
    assert p1.dest_own_idx is not None

    # disk round trip is bit-identical, including the dest arrays
    plan_cache.clear_memory_cache()
    p2 = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo,
                                  destination=dest)
    assert plan_cache.stats.disk_hits >= 1
    _assert_plans_equal(p1, p2)
    # distinct destinations get distinct keys
    k0 = plan_cache.plan_key(m.cols, n, p, bs, topo)
    k1 = plan_cache.plan_key(m.cols, n, p, bs, topo, dest)
    slots2 = slots.copy()
    slots2[0, 0] = (slots2[0, 0] + 1) % n
    k2 = plan_cache.plan_key(m.cols, n, p, bs, topo,
                             Destination.from_slots(s=slots2))
    assert len({k0, k1, k2}) == 3


@pytest.mark.parametrize("found", [2, 3, 4, 6])
def test_stale_format_meta_rejected_by_deserialize(found):
    """An entry whose meta carries another format stamp (however it got
    under the current key) is refused with a warning and rebuilt — never
    reinterpreted as a current-format plan."""
    m, n, p, bs, topo = _case()
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    path = plan_cache._disk_path(plan_cache.plan_key(m.cols, n, p, bs, topo))
    with np.load(path) as data:
        entries = {k: data[k] for k in data.files}
    meta = entries["meta"].copy()
    meta[0] = found  # same field set, another format stamp
    entries["meta"] = meta
    np.savez_compressed(path, **entries)

    plan_cache.clear_memory_cache()
    with pytest.warns(UserWarning, match=f"format v{found}.*v5"):
        plan = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs,
                                        topology=topo)
    assert plan_cache.stats.misses == 2  # stale entry -> rebuild
    fresh = build_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    _assert_plans_equal(plan, fresh)


def test_cache_stats_snapshot_and_isolated():
    """CacheStats is capture-safe: snapshot() detaches, isolated() swaps a
    fresh module-global in and restores the old one (counts untouched)."""
    m, n, p, bs, topo = _case()
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    before = plan_cache.stats.snapshot()
    assert before["misses"] == 1 and before["derives"] == 0
    with plan_cache.isolated() as inner:
        assert plan_cache.stats is inner
        assert inner.misses == 0  # fresh counters inside the context
        plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
        assert inner.memory_hits == 1 and inner.misses == 0
    assert plan_cache.stats.snapshot() == before  # outer stats untouched
    # snapshot is a detached copy, not a live view
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    assert before["memory_hits"] == 0


def _assert_scatter_plans_equal(a, b):
    _assert_plans_equal(a.base, b.base)
    for name in ("tgt_global", "cond_msg_idx", "blk_msg_idx", "own_tgt_idx",
                 "win_mask", "touched"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for cf in dataclasses.fields(a.counts):
        np.testing.assert_array_equal(getattr(a.counts, cf.name),
                                      getattr(b.counts, cf.name))


def test_scatter_plan_round_trip_and_reuse_base():
    """v4 scatter entries are O(m*r) deltas referencing the base plan: the
    gather and the scatter of one pattern share a single O(nnz) build, and
    the disk round trip reconstructs the transpose bit-identically."""
    from repro_torch.comm.plan import derive_scatter_plan

    m, n, p, bs, topo = _case()
    base = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    s1 = plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs,
                                     topology=topo)
    assert plan_cache.stats.misses == 1 and plan_cache.stats.derives == 1
    _assert_scatter_plans_equal(s1, derive_scatter_plan(base))
    # transpose round-trips onto the cached base
    assert s1.transpose() is s1.base
    _assert_plans_equal(s1.transpose(), base)

    plan_cache.clear_memory_cache()
    s2 = plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs,
                                     topology=topo)
    assert plan_cache.stats.disk_hits >= 1
    assert plan_cache.stats.derives == 1  # no re-derivation
    _assert_scatter_plans_equal(s1, s2)
    # scatter and gather keys never collide
    assert plan_cache.plan_key(m.cols, n, p, bs, topo) != \
        plan_cache.plan_key(m.cols, n, p, bs, topo, scatter=True)


def test_concurrent_writers_no_torn_reads():
    """The write-to-temp + atomic-rename protocol must keep every reader
    seeing either a complete entry or a miss — never torn bytes — while
    several threads build/load the same plans concurrently."""
    import threading

    m, n, p, bs, topo = _case()
    fresh = build_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    fresh_s = fresh.transpose()
    errors = []

    def worker():
        try:
            for _ in range(6):
                plan = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs,
                                                topology=topo)
                _assert_plans_equal(plan, fresh)
                splan = plan_cache.get_scatter_plan(m.cols, n, p,
                                                    blocksize=bs,
                                                    topology=topo)
                _assert_scatter_plans_equal(splan, fresh_s)
                plan_cache.clear_memory_cache()  # force the disk tier
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # the cache directory holds only complete entries (no leftover temps
    # visible under the entry names) and both load cleanly
    plan_cache.clear_memory_cache()
    _assert_plans_equal(
        plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo),
        fresh)
    _assert_scatter_plans_equal(
        plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs,
                                    topology=topo),
        fresh_s)




def test_spmv_auto_dest_attaches_exactly_one_destination():
    """strategy="auto" with targeted unpack must not persist a throwaway
    destination entry: the strategy resolves against the base plan first,
    then exactly one Destination (the one the step actually runs) is
    attached and cached — one base entry + one dest entry on disk."""
    import glob
    import os

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.spmv import DistributedSpMV

    comm = LoopbackComm(P, device="cpu")
    n = 128 * P
    m = make_mesh_like_matrix(n, 4, locality_window=n // 4,
                              long_range_frac=0.1, seed=9)
    eng = DistributedSpMV(m, comm, strategy="auto", blocksize=32, hw=pm.ABEL)
    assert eng.materialize == "dest" and eng.requested_strategy == "auto"
    files = glob.glob(os.path.join(plan_cache.cache_dir(), "*.npz"))
    assert len(files) == 2, files      # base plan + the one used Destination
    assert plan_cache.stats.misses == 1  # one O(nnz) build total


def test_engine_second_construction_hits_cache():
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core.matrix import spmv_ref_np
    from repro_torch.core.spmv import DistributedSpMV

    comm = LoopbackComm(P, device="cpu")
    n = 128 * P
    m = make_mesh_like_matrix(n, 4, locality_window=n // 4,
                              long_range_frac=0.1, seed=3)
    e1 = DistributedSpMV(m, comm, strategy="condensed", blocksize=32)
    assert plan_cache.stats.misses == 1
    e2 = DistributedSpMV(m, comm, strategy="condensed", blocksize=32)
    assert plan_cache.stats.misses == 1 and plan_cache.stats.hits >= 1
    _assert_plans_equal(e1.plan, e2.plan)
    # cached-plan engine still computes the right answer
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(e2(e2.shard_vector(x)).reshape(-1).numpy(),
                               spmv_ref_np(m, x), rtol=2e-4, atol=2e-4)


def test_given_base_is_the_base_of_every_hit():
    """A caller-supplied ``base`` is the base of the plan returned, even
    where the entry was cached on another copy of the same base plan."""
    from repro_torch.comm.pattern import Destination

    m, n, p, bs, topo = _case()
    dest = Destination.from_slots(
        s=m.cols[::4, :2].reshape(p, -1).astype(np.int64))
    plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs, topology=topo,
                             destination=dest)
    plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs, topology=topo)
    mine = build_comm_plan(m.cols, n, p, blocksize=bs, topology=topo)
    for clear in (False, True):     # the memory tier, then the disk tier
        if clear:
            plan_cache.clear_memory_cache()
        got = plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs,
                                       topology=topo, destination=dest,
                                       base=mine)
        assert got.counts is mine.counts
        assert got.send_local_idx is mine.send_local_idx
        splan = plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs,
                                            topology=topo, base=mine)
        assert splan.base is mine
    assert plan_cache.stats.misses == 1


# ---- the port against the JAX reference --------------------------------

def _jax_case(seed=0, n=256, p=4, bs=16):
    from repro.comm import plan as jplan
    m, n, p, bs, topo = _case(seed, n, p, bs)
    return m, n, p, bs, topo, jplan.Topology(p, topo.shards_per_node)


@pytest.mark.parametrize("dest,scatter", [(False, False), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("bs", [16, 64])
def test_plan_key_equals_jax(dest, scatter, bs):
    from repro.comm import pattern as jpattern
    from repro.comm import plan_cache as jcache
    from repro_torch.comm.pattern import Destination

    m, n, p, _, topo, jtopo = _jax_case(bs=bs)
    slots = m.cols[::4, :2].reshape(p, -1).astype(np.int64)
    td = Destination.from_slots(s=slots) if dest else None
    jd = jpattern.Destination.from_slots(s=slots) if dest else None
    got = plan_cache.plan_key(m.cols, n, p, bs, topo, td, scatter=scatter)
    want = jcache.plan_key(m.cols, n, p, bs, jtopo, jd, scatter=scatter)
    assert got == want
    if dest:
        assert td.key_bytes() == jd.key_bytes()


def _assert_same_as_jax(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b) and not isinstance(b, type):
            if f.name == "topology":
                assert (a.num_shards, a.shards_per_node) == (
                    b.num_shards, b.shards_per_node)
            else:
                _assert_same_as_jax(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("tier", ["build", "memory", "disk"])
def test_cached_plans_equal_jax_build(tier):
    """Every tier hands back the JAX ``build_comm_plan`` /
    ``derive_scatter_plan`` result, bit for bit, destination attached."""
    from repro.comm import pattern as jpattern
    from repro.comm import plan as jplan
    from repro_torch.comm.pattern import Destination

    m, n, p, bs, topo, jtopo = _jax_case(seed=7)
    slots = m.cols[1::4, :3].reshape(p, -1).astype(np.int64)
    slots[:, 0] = Destination.ZERO
    jd = jpattern.Destination.from_slots(s=slots)
    want = jplan.build_comm_plan(m.cols, n, p, blocksize=bs, topology=jtopo)
    want_d = jplan.build_comm_plan(m.cols, n, p, blocksize=bs,
                                   topology=jtopo, destination=jd)
    want_s = jplan.derive_scatter_plan(want)

    def get():
        return (plan_cache.get_comm_plan(m.cols, n, p, blocksize=bs,
                                         topology=topo),
                plan_cache.get_comm_plan(
                    m.cols, n, p, blocksize=bs, topology=topo,
                    destination=Destination.from_slots(s=slots)),
                plan_cache.get_scatter_plan(m.cols, n, p, blocksize=bs,
                                            topology=topo))

    got = get()
    if tier != "build":
        if tier == "disk":
            plan_cache.clear_memory_cache()
        got = get()
        hits = plan_cache.stats.memory_hits if tier == "memory" \
            else plan_cache.stats.disk_hits
        assert hits >= 3 and plan_cache.stats.misses == 1
    _assert_same_as_jax(got[0], want)
    _assert_same_as_jax(got[1], want_d)
    _assert_same_as_jax(got[2], want_s)
