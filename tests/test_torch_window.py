"""Sliding-window serving past the window, the port against the JAX
reference on the CPU.

The reference masks ``slot_pos > pos − window`` in decode and prefill and
cuts the ring to ``cache_len <= swa_window``; the port's decode attention
(B8, its plain version here) reads the prefix ``min(pos + 1, cache_len)``
of each lane instead, and its prefill masks as the reference does.  Held
here, token for token and at 2e-4 on the logits (the port sums in other
orders, as ``tests/test_torch_models.py`` says), over every case where the
two could part: a ring equal to the window that wraps, a ring shorter
than the window, a prefill chunk that overwrites, before its own queries
read them, ring slots that a true sliding window would still show them
(the reference writes first and masks after), a per-slot engine whose
idle lanes keep advancing past the window, and the hybrid stack's ring.
The mixtral engine with the MoE decode hook served past its window is in
``tests/test_torch_serve_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch.serve import prefill_into_cache as jprefill_into_cache
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import registry as tregistry
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)
KEY = jax.random.PRNGKey(0)
WINDOW = 8


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _pair(cfg):
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    jp = jm.init_params(KEY)
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def llama():
    """Reduced llama3-8b (2 KV heads) with a window of 8."""
    cfg = dataclasses.replace(
        jregistry.get_config("llama3-8b", reduced=True), num_kv_heads=2,
        swa_window=WINDOW)
    return (cfg,) + _pair(cfg)


def _decode_both(jm, jp, jc, tm, tp, tc, jl, tl, steps):
    """Greedy decode ``steps`` tokens on both sides from their last
    logits, holding the logits at TOL and the tokens equal."""
    for _ in range(steps):
        nj = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
        nt = torch.argmax(tl[:, -1], -1).to(torch.int32)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        jl, jc = jm.decode_step(jp, jc, nj[:, None])
        tl, tc = tm.decode_step(tp, tc, nt[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    return jc, tc


# (cache_len asked for, prompt chunks, decode steps): the ring is
# min(cache_len, WINDOW)
CASES = {
    "ring_is_the_window_and_wraps": (32, (6,), 14),
    "ring_under_the_window": (5, (4,), 12),
    "chunk_overwrites_slots_its_queries_would_see": (8, (5, 7), 6),
}


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_prefill_and_decode_match_jax(llama, case, per_slot):
    cfg, jm, jp, tm, tp = llama
    clen, chunks, steps = CASES[case]
    b = 2
    jc = jm.init_cache(b, clen, dtype=jnp.float32, per_slot=per_slot)
    tc = tm.init_cache(b, clen, dtype=torch.float32, per_slot=per_slot)
    ring = min(clen, WINDOW)
    assert tc["layers"]["k"].shape[2] == ring
    toks = np.random.default_rng(len(case)).integers(
        0, cfg.vocab_size, (b, sum(chunks))).astype(np.int32)
    lo = 0
    for n in chunks:
        jl, jc = jm.prefill(jp, jc, jnp.asarray(toks[:, lo:lo + n]))
        tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks[:, lo:lo + n]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lo += n
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    if len(chunks) > 1:
        # the second chunk wrote positions 8..11 over slots 0..3 before its
        # queries at 5..7 read them: the sequential prefill, which reads
        # them first, gives other logits, so the case is exercised
        seq_c = jm.init_cache(b, clen, dtype=jnp.float32)
        _, seq_l = jprefill_into_cache(jm, jp, seq_c, jnp.asarray(toks))
        assert np.abs(np.asarray(seq_l) - tl.numpy()).max() > 1e-3
    _, tc = _decode_both(jm, jp, jc, tm, tp, tc, jl, tl, steps)
    assert int(tc["pos"].max()) >= 2 * WINDOW


def test_windowed_engine_matches_jax_engine_past_the_window(llama):
    """Three lanes, a ring of 8 (the engine's cache_len 12 cut to the
    window, which also bounds a prompt), prompts of 3 to 8 in chunks of 3,
    up to 9 tokens each: lanes run past the window, and idle lanes keep
    advancing between requests."""
    cfg, jm, jp, tm, tp = llama
    rng = np.random.default_rng(4)
    reqs = [dict(id=f"r{i}", prompt=rng.integers(
        0, cfg.vocab_size, (int(rng.integers(3, 9)),)).tolist(),
        max_new_tokens=int(rng.integers(4, 10)), arrival_time=float(3 * i))
        for i in range(5)]
    kw = dict(num_slots=3, cache_len=12, prefill_chunk=3)
    je = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    te = ServeEngine(tm, tp, cache_dtype=torch.float32, **kw)
    for r in reqs:
        je.submit(JRequest(**r))
        te.submit(Request(**r))
    jrep, trep = je.run(), te.run()
    assert trep.outputs == jrep.outputs
    assert trep.completed == jrep.completed
    assert te.cache["layers"]["k"].shape[2] == WINDOW
    assert int(te.cache["pos"].max()) > 2 * WINDOW


def test_hybrid_ring_under_the_window_matches_jax():
    """Reduced hymba-1.5b (window 16) on a ring of 10: the prompt of 12
    prefilled token by token wraps it, then 10 tokens decode."""
    cfg = jregistry.get_config("hymba-1.5b", reduced=True)
    jm, jp, tm, tp = _pair(cfg)
    jc = jm.init_cache(2, 10, dtype=jnp.float32)
    tc = tm.init_cache(2, 10, dtype=torch.float32)
    assert tc["layers"]["k"].shape[2] == 10 < cfg.swa_window
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc, jl = jprefill_into_cache(jm, jp, jc, jnp.asarray(toks))
    tc, tl = tserve.prefill_into_cache(tm, tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _decode_both(jm, jp, jc, tm, tp, tc, jl, tl, 10)


def test_swa_ring_cache_equals_full_window():
    """The port's counterpart of the reference's test of the same name:
    the ring cache (clamped to mixtral's window of 16) decodes 12 tokens
    one at a time to the forward's logits (2e-3, the reference's
    tolerance), a capacity large enough that no MoE drop differs."""
    cfg = dataclasses.replace(
        tregistry.get_config("mixtral-8x22b", reduced=True),
        capacity_factor=16.0)
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 12)), dtype=torch.int32)
    full = model.forward(params, tokens)
    cache = model.init_cache(1, 64, dtype=torch.float32)
    assert cache["layers"]["k"].shape[2] == cfg.swa_window
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
