"""The port's serving stack against the JAX reference on the CPU: queue and
slots, the fused prefill against the sequential decode oracle, the
``ServeEngine`` token for token against the JAX ``ServeEngine`` (slot
reuse, a ring wrap) and against its own ``generate_batch_loop``, the
``launch.serve`` entry point, and the prefix property B8's ``lengths``
rest on.

Greedy tokens are compared exactly; logits and caches at rtol/atol 2e-4
(float32 sums in other orders).  The fused prefill is held to the
sequential oracle at that tolerance, not bit for bit: the reference's own
bit-for-bit test of it fails on this tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import registry as jregistry
from repro.launch.serve import prefill_into_cache as jprefill_into_cache
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.serve import (Request, RequestQueue, ServeEngine,
                               SlotManager, generate_batch_loop)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def llama_cfg():
    """Reduced llama3-8b with G = 2 query heads per KV head."""
    return dataclasses.replace(
        jregistry.get_config("llama3-8b", reduced=True), num_kv_heads=2)


@pytest.fixture(scope="module")
def pair():
    cfg = llama_cfg()
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm, tp


def trace(cfg, n, *, seed, plen, gen, per_tick=2):
    rng = np.random.default_rng(seed)
    return [dict(id=f"r{i}", prompt=rng.integers(
        0, cfg.vocab_size, (int(rng.integers(*plen)),)).tolist(),
        max_new_tokens=gen, arrival_time=float(i // per_tick))
        for i in range(n)]


def run_both(pair, reqs, **kw):
    _, jm, jp, tm, tp = pair
    je = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    te = ServeEngine(tm, tp, cache_dtype=torch.float32, **kw)
    for r in reqs:
        je.submit(JRequest(**r))
        te.submit(Request(**r))
    return je.run(), te.run()


# -- queue and slots, as tests/test_serve.py holds the reference's --

def test_queue_fifo_and_arrival_gating():
    q = RequestQueue()
    q.submit(Request(id="late", prompt=[1], max_new_tokens=1,
                     arrival_time=5.0))
    q.submit(Request(id="a", prompt=[1], max_new_tokens=1, arrival_time=0.0))
    q.submit(Request(id="b", prompt=[1], max_new_tokens=1, arrival_time=0.0))
    assert q.pop_ready(-1.0) is None
    assert [r.id for r in q.ready(0.0)] == ["a", "b"]
    assert q.pop_ready(0.0).id == "a"
    assert q.pop_ready(0.0).id == "b"
    assert len(q) == 1 and q.pop_ready(4.9) is None
    assert q.next_arrival() == 5.0
    assert q.pop_ready(5.0).id == "late"
    assert not q


def test_slot_manager_lifecycle():
    sm = SlotManager(2)
    assert (sm.allocate("r0", max_new_tokens=4),
            sm.allocate("r1", max_new_tokens=4)) == (0, 1)
    assert sm.allocate("r2") is None
    assert [s.index for s in sm.active()] == [0, 1]
    sm.release(0)
    assert sm.num_free == 1 and sm[0].free
    assert sm.allocate("r2", max_new_tokens=1) == 0
    assert sm[0].request_id == "r2" and sm[0].generated == 0
    with pytest.raises(ValueError):
        SlotManager(0)


# -- fused prefill against the sequential decode oracle --

def test_fused_prefill_matches_sequential_oracle(pair):
    cfg, jm, jp, tm, tp = pair
    b, s, clen = 2, 6, 12
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    c_seq, l_seq = tserve.prefill_into_cache(
        tm, tp, tm.init_cache(b, clen, dtype=torch.float32),
        torch.from_numpy(toks))
    l_fused, c_fused = tm.prefill(
        tp, tm.init_cache(b, clen, dtype=torch.float32),
        torch.from_numpy(toks))
    torch.testing.assert_close(l_fused, l_seq, **TOL)
    for leaf in ("k", "v"):
        torch.testing.assert_close(c_fused["layers"][leaf],
                                   c_seq["layers"][leaf], **TOL)
    assert torch.equal(c_fused["layers"]["slot_pos"],
                       c_seq["layers"]["slot_pos"])
    jc, jl = jprefill_into_cache(jm, jp, jm.init_cache(
        b, clen, dtype=jnp.float32), jnp.asarray(toks))
    np.testing.assert_allclose(l_seq.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(c_seq["layers"]["k"].numpy(),
                               np.asarray(jc["layers"]["k"]), **TOL)


# -- the engine --

def test_engine_matches_jax_engine_with_slot_reuse(pair):
    cfg, _, _, tm, tp = pair
    reqs = trace(cfg, 5, seed=1, plen=(3, 7), gen=3)
    jrep, trep = run_both(pair, reqs, num_slots=2, cache_len=12,
                          prefill_chunk=3)
    assert trep.outputs == jrep.outputs           # greedy tokens, exactly
    assert trep.slot_of == jrep.slot_of and trep.completed == jrep.completed
    assert set(trep.slot_of.values()) == {0, 1} and len(trep.slot_of) == 5
    assert trep.ticks == jrep.ticks
    assert trep.telemetry["decode_steps"] == len(trep.tick_seconds) > 0
    assert trep.telemetry["prefill_chunks"] >= len(reqs)
    assert trep.total_tokens == sum(r["max_new_tokens"] for r in reqs)
    assert set(trep.ttft_seconds) == {r["id"] for r in reqs}
    base = generate_batch_loop(tm, tp, [Request(**r) for r in reqs],
                               cache_len=12, prefill_chunk=3,
                               cache_dtype=torch.float32)
    assert trep.outputs == base


def test_engine_matches_jax_engine_across_a_ring_wrap(pair):
    """Decode runs past ``cache_len``: the ring wraps, every slot is valid
    and B8's lengths saturate at ``cache_len``."""
    cfg = pair[0]
    reqs = trace(cfg, 4, seed=2, plen=(3, 7), gen=7)
    jrep, trep = run_both(pair, reqs, num_slots=2, cache_len=8,
                          prefill_chunk=4)
    assert max(len(r["prompt"]) for r in reqs) + 7 - 1 >= 8
    assert trep.outputs == jrep.outputs
    assert trep.completed == jrep.completed


def test_engine_submit_validation(pair):
    _, _, _, tm, tp = pair
    engine = ServeEngine(tm, tp, num_slots=1, cache_len=4,
                         cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(Request(id="x", prompt=[1], max_new_tokens=0))
    with pytest.raises(ValueError, match="prompt length"):
        engine.submit(Request(id="x", prompt=[1] * 5, max_new_tokens=1))
    with pytest.raises(ValueError, match="prompt length"):
        engine.submit(Request(id="x", prompt=[], max_new_tokens=1))
    with pytest.raises(NotImplementedError, match="A10"):
        ServeEngine(tm, tp, num_slots=2, cache_len=8, moe_layer=object())


# -- the command-line entry point --

def test_launch_serve_runs_both_paths_on_the_cpu():
    rep = tserve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                       "--requests", "5", "--slots", "2", "--prompt-len",
                       "12", "--gen", "4", "--prefill-chunk", "5"])
    assert len(rep.completed) == 5 and rep.total_tokens == 20
    seq = tserve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
                       "3"])
    assert tuple(seq.shape) == (2, 3)
    with pytest.raises(NotImplementedError, match="A10"):
        tserve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                     "--moe-comm"])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "llama3-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(llama_cfg())


# -- the fact B8's lengths rest on --

@settings(max_examples=6, deadline=None)
@given(data=st.data())
def test_valid_slots_are_a_prefix_along_a_jax_engine_run(pair, data):
    """Along a JAX engine run whose ring wraps, every lane's valid mask
    ``0 <= slot_pos <= pos`` at each decode step is exactly the prefix of
    length ``min(pos + 1, cache_len)``."""
    cfg, jm, jp, _, _ = pair
    clen = data.draw(st.integers(4, 8), label="cache_len")
    slots = data.draw(st.integers(1, 3), label="slots")
    n = data.draw(st.integers(1, 4), label="requests")
    plens = data.draw(st.lists(st.integers(1, clen), min_size=n,
                               max_size=n), label="prompt lengths")
    gens = data.draw(st.lists(st.integers(1, 6), min_size=n, max_size=n),
                     label="gens")
    gens[0] = max(gens[0], clen + 2 - plens[0])       # lane 0 wraps
    rng = np.random.default_rng(n)
    engine = JServeEngine(jm, jp, num_slots=slots, cache_len=clen,
                          prefill_chunk=2, cache_dtype=jnp.float32)
    for i in range(n):
        engine.submit(JRequest(
            id=i, prompt=rng.integers(0, cfg.vocab_size, plens[i]).tolist(),
            max_new_tokens=gens[i], arrival_time=float(i)))
    wrapped = False
    while len(engine.queue) or engine.slots.active():
        ticks = len(engine._tick_seconds)
        engine.step()
        if len(engine._tick_seconds) == ticks:
            continue                                  # no decode this tick
        p = np.asarray(engine.cache["pos"]) - 1       # the step's positions
        spos = np.asarray(engine.cache["layers"]["slot_pos"])  # (L, B, C)
        valid = (spos >= 0) & (spos <= p[None, :, None])
        prefix = np.arange(clen)[None, :] < np.minimum(p + 1, clen)[:, None]
        np.testing.assert_array_equal(valid, np.broadcast_to(
            prefix, valid.shape))
        wrapped |= bool((p >= clen).any())
    assert wrapped
