"""B8 (decode attention) and B9 (selective scan): the port's plain versions
and ``ops`` wrappers on CPU tensors against the JAX Pallas kernels in
interpret mode and the JAX oracles; and torch-eager models of the card
kernels' decompositions (B8's split planner, tile-wise softmax and
log-sum-exp merge; B9's state layout, zero-padded chunks and transposed
butterfly) against the same Pallas kernels, which checks the algorithms
here, where the CUDA kernels cannot run.

Same numpy inputs on both sides, on the parametrisations of
``tests/test_kernels.py``.  Tolerance rtol/atol 2e-4, the reference's own
for these kernels: both sum in float32 in another order than XLA.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)
FNS = {"plain": tref.decode_attention_ref, "wrapper": tops.decode_attention}
SCANS = {"plain": tref.selective_scan_ref, "wrapper": tops.selective_scan}


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _attn_inputs(b, h, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, lengths


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(a) for a in arrays))
    return out.numpy()


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("b,h,hkv,d,s,chunk", [
    (2, 8, 4, 32, 1024, 256), (1, 4, 4, 64, 512, 512), (3, 6, 2, 16, 768, 128),
])
def test_decode_attention_matches_jax(fn, b, h, hkv, d, s, chunk):
    q, k, v, lengths = _attn_inputs(b, h, hkv, d, s, seed=s + h)
    got = _port(FNS[fn], q, k, v, lengths)
    kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_chunk=chunk))
    np.testing.assert_allclose(got, kernel, **TOL)
    # the reference test's oracle: each lane's valid prefix, dense attention
    oracle = np.stack([np.asarray(jref.decode_attention_ref(
        jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1, :lengths[i]]),
        jnp.asarray(v[i:i + 1, :lengths[i]])))[0] for i in range(b)])
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_decode_attention_length_zero_matches_jax(fn):
    """Length 0 (the model never passes it): every slot masked alike, so
    the JAX kernel and the port give the mean of V over all S slots."""
    q, k, v, _ = _attn_inputs(2, 4, 2, 16, 256, seed=7)
    lengths = np.array([0, 100], np.int32)
    got = _port(FNS[fn], q, k, v, lengths)
    kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_chunk=128))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got[0], np.repeat(v[0].mean(0), 2, axis=0),
                               **TOL)


def _scan_inputs(b, l, di, st, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, di)) * 0.3).astype(np.float32)
    z = rng.standard_normal((b, l, di))
    dt = np.log1p(np.exp(z)).astype(np.float32)          # softplus
    bm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
    return x, dt, bm, cm, a


@pytest.mark.parametrize("fn", sorted(SCANS))
@pytest.mark.parametrize("b,l,di,st,tile,chunk", [
    (2, 128, 16, 4, 8, 64), (1, 256, 32, 8, 32, 256), (2, 64, 8, 16, 8, 32),
])
def test_selective_scan_matches_jax(fn, b, l, di, st, tile, chunk):
    args = _scan_inputs(b, l, di, st, seed=l + di)
    got = _port(SCANS[fn], *args)
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jops.selective_scan(*jargs, tile_di=tile,
                                            chunk_l=chunk))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.selective_scan_ref(*jargs)), **TOL)


def test_wrappers_refuse_shapes_they_do_not_take():
    q, k, v, lengths = (torch.from_numpy(a) for a in
                        _attn_inputs(2, 6, 4, 16, 32, seed=1))
    with pytest.raises(ValueError):          # H not a multiple of Hkv
        tops.decode_attention(q, k, v, lengths)
    x, dt, bm, cm, a = (torch.from_numpy(t) for t in
                        _scan_inputs(1, 8, 16, 4, seed=2))
    with pytest.raises(ValueError):          # L = 0
        tops.selective_scan(x[:, :0], dt[:, :0], bm[:, :0], cm[:, :0], a)
    with pytest.raises(ValueError):          # a is not (di, st)
        tops.selective_scan(x, dt, bm, cm, a.T)


# -- models of the card kernels' decompositions --

def _split_model(q, k, v, lengths, chunk, tile):
    """csrc/decode_attention.cu in float32 torch: per (lane, KV head) the
    splits of ``chunk`` slots, tiles of ``tile`` slots with one max, one
    rescale and ex2 in log2 units a tile, a (max, sum, accumulator) partial
    a split, and the log-sum-exp merge (a lone split divides directly)."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale2 = d ** -0.5 * math.log2(math.e)
    qg = q.reshape(b, hkv, g, d).float()
    out = torch.empty((b, hkv, g, d))
    for lane in range(b):
        masked = int(lengths[lane]) <= 0
        n = s if masked else min(int(lengths[lane]), s)
        live = -(-n // chunk)
        for kvh in range(hkv):
            parts = []
            for j in range(live):
                m = torch.full((g,), -1e30)
                l, acc = torch.zeros(g), torch.zeros((g, d))
                for t0 in range(j * chunk, min((j + 1) * chunk, n), tile):
                    t1 = min(t0 + tile, (j + 1) * chunk, n)
                    kt = k[lane, t0:t1, kvh].float()
                    logits = (qg[lane, kvh] @ kt.T) * scale2
                    if masked:
                        logits = torch.full_like(logits, -1e30)
                    m_new = torch.maximum(m, logits.max(-1).values)
                    p = torch.exp2(logits - m_new[:, None])
                    corr = torch.exp2(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p @ v[lane, t0:t1, kvh].float()
                    m = m_new
                parts.append((m, l, acc))
            if live == 1:
                m, l, acc = parts[0]
                out[lane, kvh] = acc / torch.clamp(l, min=1e-30)[:, None]
                continue
            ms = torch.stack([pm for pm, _, _ in parts])
            w = torch.exp2(ms - ms.max(0).values)          # (live, g)
            total = (w * torch.stack([pl for _, pl, _ in parts])).sum(0)
            acc = (w[..., None] * torch.stack([pa for _, _, pa in parts])
                   ).sum(0)
            out[lane, kvh] = acc / torch.clamp(total, min=1e-30)[:, None]
    return out.reshape(b, h, d)


@pytest.mark.parametrize("chunk", ["planned", 32, 80])
@pytest.mark.parametrize("b,h,hkv,d,s,kv_chunk", [
    (4, 2, 2, 16, 320, 64), (4, 6, 2, 80, 256, 128), (4, 5, 1, 32, 192, 64),
    (4, 14, 2, 16, 128, 128), (4, 8, 4, 64, 512, 256)])
def test_split_model_matches_jax(chunk, b, h, hkv, d, s, kv_chunk):
    """G of 1, 3, 5 and 7, D of 16, 32, 64 and 80, lengths 0, 1, S and
    S + 7; the planner's splits, one-tile splits, and splits of two and a
    half tiles (one ending inside a tile)."""
    q, k, v, _ = _attn_inputs(b, h, hkv, d, s, seed=s + h + d)
    lengths = np.array([0, 1, s, s + 7], np.int32)
    kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_chunk=kv_chunk))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lengths))
    if chunk == "planned":
        chunk = tda.plan_chunk(b, s, hkv)
    got = _split_model(tq, tk, tv, tl, chunk, tda.TILE).numpy()
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("b,s,hkv", [
    (1, 1, 1), (8, 2080, 8), (8, 32768, 8), (64, 2080, 8), (1, 33, 1),
    (4, 257, 2), (2, 4096, 1), (3, 65, 48), (128, 131072, 8)])
def test_plan_chunk_covers_each_live_slot_once(b, s, hkv):
    """Whatever a lane attends (n slots, 1 <= n <= S), the splits below
    ceil(n / chunk) take every slot exactly once and stay inside the grid;
    the planner reaches its block count where the cache allows and keeps
    every split to MAX_TILES tiles."""
    chunk = tda.plan_chunk(b, s, hkv)
    nsplit = -(-s // chunk)
    assert chunk % tda.TILE == 0 and chunk <= tda.MAX_TILES * tda.TILE
    assert b * hkv * nsplit >= min(tda.TARGET_BLOCKS,
                                   b * hkv * -(-s // tda.TILE))
    for n in sorted({1, 2, chunk - 1, chunk, chunk + 1, s // 2, s - 1, s}):
        if not 1 <= n <= s:
            continue
        seen = np.zeros(n, np.int64)
        live = -(-n // chunk)
        assert live <= nsplit
        for j in range(live):
            seen[j * chunk:min((j + 1) * chunk, n)] += 1
        assert (seen == 1).all(), (n, chunk)


def _transpose_sum(p):
    """The kernel's transposed butterfly over the n = p.shape[0] lanes of a
    channel: p[j, s] is lane j's part of y at step s of n; each round a
    lane keeps the steps whose bit m matches its own, adds what its partner
    j ^ m sends, and sends the others.  Returns lane j's result."""
    n = p.shape[0]
    cur, m = p, n // 2
    while m >= 1:
        nxt = torch.empty((n, m) + tuple(p.shape[2:]))
        for j in range(n):
            partner = j ^ m
            for i in range(m):
                mine = cur[j, i + m] if j & m else cur[j, i]
                sent = cur[partner, i] if partner & m else cur[partner, i + m]
                nxt[j, i] = mine + sent
        cur, m = nxt, m // 2
    return cur[:, 0]


def _scan_model(x, dt, bm, cm, a, spt, steps):
    """csrc/selective_scan.cu in float32 torch: st padded to spt * tpc
    states (a = B = C = 0 past st), L padded with zero steps to whole
    chunks of ``steps`` (dt = 0 leaves h as it was), one ex2 a
    state-step, each lane's spt states summed in order and the lanes met in
    the transposed butterfly, lane j keeping step j of every tpc."""
    bsz, l, di = x.shape
    st = bm.shape[2]
    tpc = 1 << max(0, math.ceil(math.log2(-(-st // spt))))
    w, lp = spt * tpc, -(-l // steps) * steps
    pad = lambda t, n: torch.nn.functional.pad(t, (0, n))  # noqa: E731
    a2 = pad(a, w - st) * math.log2(math.e)
    bm, cm = (torch.nn.functional.pad(t, (0, w - st, 0, lp - l))
              for t in (bm, cm))
    x, dt = (torch.nn.functional.pad(t, (0, 0, 0, lp - l)) for t in (x, dt))
    h = torch.zeros((bsz, di, w))
    y = torch.empty((bsz, lp, di))
    for t0 in range(0, lp, tpc):
        parts = torch.empty((tpc, tpc, bsz, di))      # (lane, step, ...)
        for k in range(tpc):
            t = t0 + k
            h = (torch.exp2(dt[:, t, :, None] * a2) * h
                 + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
            parts[:, k] = (h * cm[:, t, None, :]).reshape(
                bsz, di, tpc, spt).sum(-1).permute(2, 0, 1)
        y[:, t0:t0 + tpc] = _transpose_sum(parts).permute(1, 0, 2)
    return y[:, :l]


def test_transpose_sum_gives_each_lane_its_step():
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 8, 16):
        p = torch.from_numpy(rng.integers(-9, 10, (n, n, 3)).astype(
            np.float32))
        torch.testing.assert_close(_transpose_sum(p), p.sum(0), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("spt", [2, 4, 8])
@pytest.mark.parametrize("b,l,di,st,steps", [
    (2, 129, 16, 16, 128), (1, 127, 8, 16, 128), (2, 65, 8, 5, 64),
    (1, 40, 8, 32, 128), (1, 33, 8, 1, 32)])
def test_scan_model_matches_jax(spt, b, l, di, st, steps):
    """L at a chunk +- 1, B > 1, st from 1 to 32 (ragged against the
    layout), every states-a-thread layout."""
    args = _scan_inputs(b, l, di, st, seed=l * st)
    got = _scan_model(*(torch.from_numpy(t) for t in args), spt, steps)
    lp = -(-l // 8) * 8                   # the JAX kernel wants whole chunks
    padded = [np.pad(t, ((0, 0), (0, lp - l), (0, 0))) for t in args[:4]]
    kernel = np.asarray(jops.selective_scan(
        *(jnp.asarray(t) for t in padded), jnp.asarray(args[4]),
        tile_di=8, chunk_l=8))[:, :l]
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)


def test_scan_model_carry_underflows():
    """A strongly decaying ``a``: the carry underflows to 0 within a step
    or two, in the model as in the JAX kernel."""
    x, dt, bm, cm, a = _scan_inputs(2, 64, 16, 16, seed=3)
    a = a * 200.0
    got = _scan_model(*(torch.from_numpy(t) for t in (x, dt, bm, cm, a)),
                      4, 128)
    kernel = np.asarray(jops.selective_scan(
        *(jnp.asarray(t) for t in (x, dt, bm, cm, a)), tile_di=8,
        chunk_l=32))
    assert np.isfinite(kernel).all()
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
