"""The selective scan with a bfloat16 payload (the reference's
``ssm_fwd(..., scan_dtype=bfloat16)``) on the CPU, against the JAX
reference.

The port's chunk tree (``kref.scan_chunk_bf16``) against
``repro.models.ssm._selective_scan_chunk`` on the same bf16 inputs, and its
``torch.autograd`` VJP against ``jax.vjp`` of it, bit for bit (values:
``-0.0 == 0.0``).  A torch model of the card kernels' schedule
(``csrc/selective_scan_bf16.cu``: the tree as a walk in time over blocks
of 16 or 8 steps, the counter's upper levels from the block's number, the
backward's reverse walk with one pending cotangent a level) against the
plain tree and its VJP, bit for bit.  ``ssm_fwd`` against the reference's
at 5e-4 of max |y| (torch's ``exp`` and XLA's differ in an ulp now and
then, which flips a bf16 rounding of the payload), with the float32 path
held more than 1e-3 away so that the check sees the rounding; its
gradients against ``jax.grad`` at 2e-3 of each gradient's largest element
(the float32 path's distance, 4e-3 and more, reported beside it); and
``build_prefill`` (logits at 2e-3) and one train step (the leaves'
gradients at 1e-2 relative L2; a float32 ulp on either side flips a bf16
rounding of the payload, and the float32 payload is more than twice as far)
of reduced falcon-mamba-7b and hymba-1.5b with ``RunCtx.ssm_scan_dtype``
bfloat16 against the JAX models.
Inputs are numpy arrays made from a seed, handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as JS
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.runtime import steps as jsteps
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import selective_scan as b9
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.runtime import steps as tsteps

KEY = jax.random.PRNGKey(0)
Y_TOL = 5e-4               # of max |y|, ssm_fwd against the reference
F32_GAP = 1e-3             # the float32 path is at least this far
GRAD_TOL = 2e-3            # of each gradient's largest element
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
STEP_L2 = 1e-2             # a train step's leaves, relative L2
CHUNKS = [256, 100, 7, 1]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _f(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _chunk_inputs(c, lanes=(8, 16), seed=0):
    """A chunk's bf16 payload (da in (0, 1], dbx), entering state and C."""
    rng = np.random.default_rng(seed + c)
    da = np.exp(-np.abs(rng.standard_normal((2, c) + lanes)) * 0.5)
    dbx = rng.standard_normal((2, c) + lanes) * 0.3
    h0 = rng.standard_normal((2,) + lanes)
    cc = rng.standard_normal((2, c, lanes[1]))
    g = rng.standard_normal((2, c) + lanes)
    gl = rng.standard_normal((2,) + lanes)
    return [a.astype(np.float32) for a in (da, dbx, h0, cc, g, gl)]


@pytest.mark.parametrize("c", CHUNKS)
def test_chunk_tree_is_the_reference_bit_for_bit(c):
    """States and last state of one chunk, the reference jitted."""
    da, dbx, h0, cc, _, _ = _chunk_inputs(c)
    jh, jl = jax.jit(JS._selective_scan_chunk)(
        *(jnp.asarray(v, jnp.bfloat16) for v in (h0, da, dbx)),
        jnp.asarray(cc))
    th, tl = kref.scan_chunk_bf16(*(torch.from_numpy(v).bfloat16()
                                    for v in (h0, da, dbx)))
    assert th.dtype == tl.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(th), _f(jh))
    np.testing.assert_array_equal(_f(tl), _f(jl))


@pytest.mark.parametrize("c", CHUNKS)
def test_chunk_vjp_is_the_reference_bit_for_bit(c):
    """The h0, da and dbx cotangents of one chunk for cotangents on the
    states and the last state."""
    da, dbx, h0, cc, g, gl = _chunk_inputs(c, seed=1)
    jin = [jnp.asarray(v, jnp.bfloat16) for v in (h0, da, dbx)]
    _, vjp = jax.vjp(lambda *t: JS._selective_scan_chunk(
        *t, jnp.asarray(cc)), *jin)
    want = vjp((jnp.asarray(g, jnp.bfloat16), jnp.asarray(gl, jnp.bfloat16)))
    leaves = [torch.from_numpy(v).bfloat16().requires_grad_()
              for v in (h0, da, dbx)]
    hs, hl = kref.scan_chunk_bf16(*leaves)
    got = torch.autograd.grad([hs, hl], leaves,
                              [torch.from_numpy(g).bfloat16(),
                               torch.from_numpy(gl).bfloat16()])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_f(a), _f(b))


# -- a torch model of the card kernels' schedule --

def _rnd(v):
    return v.to(torch.bfloat16).float()


def _comb(x, y):
    return (_rnd(x[0] * y[0]), _rnd(_rnd(x[1] * y[0]) + y[1]))


def _comb_b(f, y):
    return _rnd(_rnd(f * y[0]) + y[1])


def _tz(v):
    return (v & -v).bit_length() - 1


def _block_fwd(ct, m, da, dbx, h0, low):
    """One block of 2^low steps of the kernel's forward walk
    (``block_fwd``): ``ct`` the counter (low entries, upper entries, pin),
    updated; returns each step's record (carries, merge inputs, the state
    its final combine reads, its state) and the last step's up-value."""
    kb, kup = 1 << low, 8 - low
    lo, lof, up, upf = ct["lo"], ct["lof"], ct["up"], ct["upf"]
    rec = []
    for r in range(kb):
        car = (da[r], dbx[r])
        if r == 0 and m == 0:
            car = (torch.ones_like(h0), _rnd(dbx[0] + _rnd(da[0] * h0)))
        cars, xs = [car], []
        for d in range(min(_tz(r + 1), low)):
            xs.append(lo[d])
            car = _comb(lo[d], car)
            cars.append(car)
        if r < kb - 1:
            dd, rest = _tz(r + 1), (r + 1) & r
            fq = lof[_tz(rest)] if rest else (ct["pin"] if m else None)
            fv = car[1] if fq is None else _comb_b(fq, car)
            lo[dd], lof[dd] = car, fv
        else:
            nm = min(_tz(~m), kup)
            for k in range(nm):
                xs.append(up[k])
                car = _comb(up[k], car)
                cars.append(car)
            restm = (m + 1) & m
            fq = upf[_tz(restm)] if restm else None
            fv = car[1] if fq is None else _comb_b(fq, car)
            if nm < kup:
                up[nm], upf[nm] = car, fv
            ct["pin"] = fv
        rec.append((cars, xs, fq, fv))
    return rec, car


def _counter(low):
    return {"lo": [None] * low, "lof": [None] * low, "up": [None] * (8 - low),
            "upf": [None] * (8 - low), "pin": None}


def _pad(da, dbx, n, kb):
    """The chunk's payload padded to whole blocks as the kernel stages it:
    dt = 0 past the chunk, so da 1 and dbx 0."""
    extra = -n % kb
    return (list(da) + [torch.ones_like(da[0])] * extra,
            list(dbx) + [torch.zeros_like(dbx[0])] * extra)


def _fwd_model(da, dbx, h0, low=4):
    """The forward kernel's walk over one chunk: its states."""
    n, kb = len(da), 1 << low
    da, dbx = _pad(da, dbx, n, kb)
    ct, hs = _counter(low), []
    for m in range(len(da) // kb):
        rec, _ = _block_fwd(ct, m, da[m * kb:], dbx[m * kb:], h0, low)
        hs += [r[3] for r in rec]
    return hs[:n]


def _ends_model(da, dbx, h0, low=3):
    """The backward's first pass over one chunk (B9b′'s ends kernel, which
    runs every chunk at once): the forward walk from the chunk's entering
    state, keeping every block's last up-value and state."""
    n, kb = len(da), 1 << low
    da, dbx = _pad(da, dbx, n, kb)
    ct, ends = _counter(low), []
    for m in range(len(da) // kb):
        _, top = _block_fwd(ct, m, da[m * kb:], dbx[m * kb:], h0, low)
        ends.append((top, ct["pin"]))
    return ends


def _rev_model(da, dbx, h0, g, ends, low=3):
    """The backward's reverse walk over one chunk from its ends: the blocks
    last first, each one's upper entries and pin rebuilt from the ends,
    walked forward again and transposed in reverse with one pending
    cotangent a level (sw: for a state a final combine read; su: for an
    up-value a merge read).  Returns the cotangents of (da, dbx) (step 0's
    are dbx'_0's for dbx and da_0's through the fold) and of h0."""
    n, kb = len(da), 1 << low
    da0 = da[0]
    da, dbx = _pad(da, dbx, n, kb)
    g = list(g) + [torch.zeros_like(h0)] * (len(da) - n)
    nblk = len(da) // kb
    zero = torch.zeros_like(h0)
    sw, su = [zero] * 9, [(zero, zero)] * 9
    ga, gb = [None] * len(da), [None] * len(da)
    for m in range(nblk - 1, -1, -1):
        ct = _counter(low)
        for k in range(8 - low):
            if (m >> k) & 1:
                e = ((m >> k) << k) - 1
                ct["up"][k], ct["upf"][k] = ends[e]
        ct["pin"] = ends[m - 1][1] if m else None
        rec, _ = _block_fwd(ct, m, da[m * kb:], dbx[m * kb:], h0, low)
        for r in range(kb - 1, -1, -1):
            cars, xs, fq, _ = rec[r]
            dd = len(xs)
            w = g[m * kb + r]
            for k in range(dd):
                w = _rnd(w + sw[k])
            gua = zero
            if fq is not None:
                gua = _rnd(w * fq)
                sw[dd] = _rnd(w * cars[dd][0])
            gua, gub = _rnd(gua + su[dd][0]), _rnd(w + su[dd][1])
            su[dd] = (zero, zero)
            for d in range(dd, 0, -1):
                x, ya = xs[d - 1], cars[d - 1][0]
                su[d - 1] = (_rnd(gua * ya), _rnd(gub * ya))
                gua = _rnd(_rnd(gua * x[0]) + _rnd(gub * x[1]))
            ga[m * kb + r], gb[m * kb + r] = gua, gub
    ga[0] = _rnd(gb[0] * h0)
    return ga[:n], gb[:n], _rnd(gb[0] * da0)


def _bwd_model(da, dbx, h0, g, low=3):
    """The backward kernel on one chunk: its ends, then its reverse
    walk."""
    return _rev_model(da, dbx, h0, g, _ends_model(da, dbx, h0, low), low)


@pytest.mark.parametrize("c", CHUNKS + [16, 17, 32, 48, 129, 255])
def test_kernel_walk_model_is_the_tree_bit_for_bit(c):
    """The forward walk (blocks of 16 and of 8 steps) gives the tree's
    states, and the backward's reverse walk its VJP, bit for bit: every
    chunk length's last block part-empty or whole, every upper level."""
    da, dbx, h0, _, g, _ = _chunk_inputs(c, lanes=(3, 5), seed=2)
    tda, tdbx, th0, tg = (torch.from_numpy(v).bfloat16()
                          for v in (da, dbx, h0, g))
    hs, _ = kref.scan_chunk_bf16(th0, tda, tdbx)
    steps = [[t[:, i].float() for i in range(c)] for t in (tda, tdbx, tg)]
    for low in (4, 3):
        got = _fwd_model(steps[0], steps[1], th0.float(), low)
        for i in range(c):
            assert torch.equal(got[i], hs[:, i].float()), (low, i)
    leaves = [t.clone().requires_grad_() for t in (th0, tda, tdbx)]
    hs2, _ = kref.scan_chunk_bf16(*leaves)
    gh0, gda, gdbx = torch.autograd.grad([hs2], leaves, [tg])
    ga, gb, gh = _bwd_model(steps[0], steps[1], th0.float(), steps[2])
    assert torch.equal(gh, gh0.float())
    for i in range(c):
        assert torch.equal(ga[i], gda[:, i].float()), i
        assert torch.equal(gb[i], gdbx[:, i].float()), i


# -- a forward split at the chunks, and B9b′'s two kernels --
#
# The split is a model of a scheme the card does not run: its bits are the
# sequential walk's, but on the card it was slower wherever the lanes fill
# the SMs, as every configuration's do (PERF.md §6).  The model keeps the
# proof that it is exact for the day a configuration leaves SMs idle.

def _link_index(n, c):
    """Where a link ends at step n - 1 of a chunk of c steps, or None: the
    spine's links end where n is a power of two (link log2 n: the fold at n
    = 1, then the right sibling of each spine merge), the digits' links
    where n is a prefix of c's binary digits (c with its low bits cleared)
    of two or more bits, after the spine's log2 of c's top bit."""
    if n > c:
        return None
    top = c.bit_length() - 1
    if n & (n - 1) == 0:
        return n.bit_length() - 1
    if (c >> _tz(n)) << _tz(n) == n:
        return top + bin(n).count("1") - 1
    return None


def _links_model(da, dbx, low=4):
    """B9b's first kernel on one chunk: the walk's up-sweep over the raw
    payload in blocks of 2^low steps (no fold, no states), keeping the
    chain's links, each a tree product over a range that does not hold step
    0: the raw step 0, each spine merge's right operand (the carry before
    its last merge) and the up-value ending each further binary digit of
    c.  These do not depend on the chunk's entering state."""
    n, kb = len(da), 1 << low
    da, dbx = _pad(da, dbx, n, kb)
    nl = (n.bit_length() - 1) + bin(n).count("1")
    links = [None] * nl
    lo, up = [None] * low, [None] * (8 - low)
    for m in range(len(da) // kb):
        for r in range(kb):
            t = m * kb + r
            car = (da[t], dbx[t])
            idx = _link_index(t + 1, n)
            spine = idx is not None and (t + 1) & t == 0
            merges = [lo[d] for d in range(min(_tz(t + 1), low))]
            if r == kb - 1:
                merges += up[:min(_tz(~m), 8 - low)]
            if spine and not merges:
                links[idx] = car
            for i, x in enumerate(merges):
                if spine and i == len(merges) - 1:
                    links[idx] = car
                car = _comb(x, car)
            if idx is not None and not spine:
                links[idx] = car
            if r < kb - 1:
                lo[_tz(t + 1)] = car
            elif len(merges) - low < 8 - low:
                up[len(merges) - low] = car
    assert all(lk is not None for lk in links) and nl <= 2 * 8 + 1
    return links


def _chain(h, links):
    """B9b's second kernel on one chunk: its entering state (a bf16 value)
    through the links, ``h = bf16(bf16(h·A) + B)`` each — the fold first,
    then the spine, then the digits — which is the chunk's last state."""
    for a, b in links:
        h = _comb_b(h, (a, b))
    return h


def _chunked(c, nch, lanes=(3, 5), seed=0):
    """A payload of nch chunks of c steps, cotangents on every state."""
    rng = np.random.default_rng(seed + 7 * c + nch)
    da = np.exp(-np.abs(rng.standard_normal((2, nch * c) + lanes)) * 0.5)
    dbx = rng.standard_normal((2, nch * c) + lanes) * 0.3
    g = rng.standard_normal((2, nch * c) + lanes)
    return [torch.from_numpy(v.astype(np.float32)).bfloat16()
            for v in (da, dbx, g)]


def _jax_chunks(da, dbx, c):
    """The reference's chunk loop on a bf16 payload (ssm_fwd's body
    without the y sum): each chunk through ``_selective_scan_chunk`` from
    the last state, which crosses the boundary as float32.  Returns the
    states (bf16) and the chunks' entering states (float32)."""
    nch = da.shape[1] // c
    chunk = jax.jit(JS._selective_scan_chunk)
    h = jnp.zeros((da.shape[0],) + da.shape[2:], jnp.float32)
    hs, hck = [], []
    for k in range(nch):
        hck.append(h)
        hk, hl = chunk(h.astype(jnp.bfloat16), da[:, k * c:(k + 1) * c],
                       dbx[:, k * c:(k + 1) * c], None)
        hs.append(hk)
        h = hl.astype(jnp.float32)
    return jnp.concatenate(hs, axis=1), jnp.stack(hck, axis=1)


CHUNKED = [(c, nch) for c in (16, 96, 129, 255, 256) for nch in (1, 3)] + [
    (1, 5), (7, 4), (100, 2)]


@pytest.mark.parametrize("c,nch", CHUNKED)
def test_split_forward_model_is_the_reference_bit_for_bit(c, nch):
    """The split forward on nch chunks of c steps, 5 states: the links of
    every chunk at once, their chains carrying the state over the chunks in
    order, then every chunk's walk from its own entering state.  The
    entering states and every state are the reference's chunk loop's bit
    for bit (jax's ``_selective_scan_chunk`` and ``kref.scan_chunk_bf16``),
    and each chain ends at its walk's last state."""
    da, dbx, _ = _chunked(c, nch)
    jh, jck = _jax_chunks(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (da, dbx)), c)
    steps = [[t[:, i].float() for i in range(nch * c)] for t in (da, dbx)]
    links = [_links_model(steps[0][k * c:(k + 1) * c],
                          steps[1][k * c:(k + 1) * c]) for k in range(nch)]
    h, hck = torch.zeros_like(steps[0][0]), []
    for k in range(nch):
        hck.append(h)
        h = _chain(h, links[k])
    np.testing.assert_array_equal(torch.stack(hck, 1).numpy(), _f(jck))
    for k in range(nch):
        sl = slice(k * c, (k + 1) * c)
        got = _fwd_model(steps[0][sl], steps[1][sl], hck[k])
        want, last = kref.scan_chunk_bf16(hck[k].bfloat16(), da[:, sl],
                                          dbx[:, sl])
        assert torch.equal(got[-1], _chain(hck[k], links[k]))
        assert torch.equal(got[-1], last.float())
        for i in range(c):
            assert torch.equal(got[i], want[:, i].float()), (k, i)
        np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                      _f(jh[:, sl]))


@pytest.mark.parametrize("c,nch", CHUNKED)
def test_two_kernel_backward_model_is_the_vjp_bit_for_bit(c, nch):
    """The backward as two kernels on nch chunks of c steps, from the
    entering states the forward walk hands on: every chunk's block ends
    from its entering state at once (in blocks of 8 steps),
    then the reverse walk, chunks last first, rebuilding each block from
    those ends, the cotangent of a chunk's entering state added (a bf16
    add) to the previous chunk's last state's.  The payload's cotangents
    are ``jax.vjp``'s of the reference's chunk loop and ``kref``'s
    autograd through ``scan_chunk_bf16``, bit for bit."""
    da, dbx, g = _chunked(c, nch, seed=1)
    jin = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (da, dbx)]
    _, vjp = jax.vjp(lambda a, b: _jax_chunks(a, b, c)[0], *jin)
    jga, jgb = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    leaves = [t.clone().requires_grad_() for t in (da, dbx)]
    h, outs = torch.zeros_like(da[:, 0]), []
    for k in range(nch):
        hk, hl = kref.scan_chunk_bf16(h, leaves[0][:, k * c:(k + 1) * c],
                                      leaves[1][:, k * c:(k + 1) * c])
        outs.append(hk)
        h = hl.float().bfloat16()
    tga, tgb = torch.autograd.grad([torch.cat(outs, 1)], leaves, [g])
    steps = [[t[:, i].float() for i in range(nch * c)] for t in (da, dbx, g)]
    hck, h = [], torch.zeros_like(steps[0][0])
    for k in range(nch):
        hck.append(h)
        h = _fwd_model(steps[0][k * c:(k + 1) * c],
                       steps[1][k * c:(k + 1) * c], h)[-1]
    ends = [_ends_model(steps[0][k * c:(k + 1) * c],
                        steps[1][k * c:(k + 1) * c], hck[k])
            for k in range(nch)]
    ga, gb, carry = [None] * (nch * c), [None] * (nch * c), None
    for k in range(nch - 1, -1, -1):
        sl = slice(k * c, (k + 1) * c)
        gk = list(steps[2][sl])
        if carry is not None:
            gk[-1] = _rnd(gk[-1] + carry)
        ga[sl], gb[sl], carry = _rev_model(steps[0][sl], steps[1][sl],
                                           hck[k], gk, ends[k])
    for i in range(nch * c):
        assert torch.equal(ga[i], tga[:, i].float()), i
        assert torch.equal(gb[i], tgb[:, i].float()), i
    np.testing.assert_array_equal(torch.stack(ga, 1).numpy(), _f(jga))
    np.testing.assert_array_equal(torch.stack(gb, 1).numpy(), _f(jgb))


# -- the plain versions and the wrappers --

def _scan_inputs(b, l, di, st, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, di)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)))).astype(np.float32)
    bm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
    dy = rng.standard_normal((b, l, di)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, bm, cm, a, dy)]


def test_plain_states_enter_each_chunk_as_the_last_state_left():
    """``hck[:, k]`` is the float32 state the chunk k - 1 left (bf16
    values), zero for the first; the wrappers' CPU arms are the plain
    versions; a chunk that does not divide L is refused."""
    *args, dy = _scan_inputs(2, 96, 6, 5, seed=3)
    y, hck = kref.selective_scan_bf16_states_ref(*args, chunk=32)
    assert hck.shape == (2, 3, 6, 5) and not hck[:, 0].any()
    assert torch.equal(hck, hck.bfloat16().float())
    y1, hck1 = kref.selective_scan_bf16_states_ref(*[t[:, :64] if t.dim() == 3
                                                     else t for t in args],
                                                   chunk=32)
    assert torch.equal(y1, y[:, :64]) and torch.equal(hck1, hck[:, :2])
    assert torch.equal(b9.selective_scan_bf16(*args, chunk=32), y)
    yc, hc = b9.selective_scan_bf16_ckpt(*args, chunk=32)
    assert torch.equal(yc, y) and torch.equal(hc, hck)
    assert all(torch.equal(g, w) for g, w in zip(
        b9.selective_scan_bf16_bwd(*args, hck, dy, chunk=32),
        kref.selective_scan_bf16_bwd_ref(*args, dy, chunk=32)))
    with pytest.raises(ValueError, match="divide"):
        kref.selective_scan_bf16_ref(*args, chunk=40)


def test_ops_scan_bf16_payload_routes_and_has_its_backward():
    """``ops.selective_scan(payload=bfloat16)``: the plain bf16 scan, and
    in grad mode its autograd Function, whose gradients are the plain
    backward's; another payload is refused."""
    *args, dy = _scan_inputs(2, 64, 6, 5, seed=4)
    want = kref.selective_scan_bf16_ref(*args, chunk=16)
    assert torch.equal(tops.selective_scan(*args, payload=torch.bfloat16,
                                           chunk=16), want)
    ins = [t.clone().requires_grad_() for t in args]
    y = tops.selective_scan(*ins, payload=torch.bfloat16, chunk=16)
    assert torch.equal(y.detach(), want)
    got = torch.autograd.grad(y, ins, dy)
    for g, w in zip(got, kref.selective_scan_bf16_bwd_ref(*args, dy,
                                                          chunk=16)):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError, match="payload"):
        tops.selective_scan(*args, payload=torch.float16)


def test_plain_backward_is_autograd_through_the_whole_scan():
    """The chunk-at-a-time backward equals autograd through the whole
    plain forward (the carried cotangent crosses the chunks)."""
    *args, dy = _scan_inputs(1, 48, 4, 3, seed=5)
    ins = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(kref.selective_scan_bf16_ref(*ins, chunk=16),
                               ins, dy)
    got = kref.selective_scan_bf16_bwd_ref(*args, dy, chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# -- the mamba block against the reference --

def _ssm_cfg():
    """Reduced falcon-mamba-7b at d_inner 64 and 16 states."""
    return dataclasses.replace(
        jregistry.get_config("falcon-mamba-7b", reduced=True), d_model=32,
        ssm_state=16)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("l", [1024, 100])
def test_ssm_fwd_bf16_matches_the_reference(l):
    """B 2, d_inner 64, st 16, chunk 256: four chunks at L 1024, one at L
    100.  The float32 payload misses the reference's bf16 answer."""
    cfg = _ssm_cfg()
    assert cfg.d_inner == 64 and cfg.ssm_state == 16
    jp = jax.tree.map(np.asarray, JS.init_ssm(KEY, cfg))
    u = np.random.default_rng(l).standard_normal(
        (2, l, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: JS.ssm_fwd(
        p, x, cfg, scan_dtype=jnp.bfloat16))(jp, jnp.asarray(u)))
    tp = TT.tree_map(lambda t: torch.from_numpy(np.array(t)), jp)
    with torch.no_grad():
        got = TS.ssm_fwd(tp, torch.from_numpy(u), cfg,
                         scan_dtype=torch.bfloat16).numpy()
        f32 = TS.ssm_fwd(tp, torch.from_numpy(u), cfg).numpy()
    assert _rel(got, want) <= Y_TOL, _rel(got, want)
    assert _rel(f32, want) > F32_GAP, _rel(f32, want)


def test_ssm_fwd_bf16_gradients_match_jax_grad():
    """Every parameter's and the input's gradient at B 2, L 512 (two
    chunks), within GRAD_TOL of each gradient's largest element; the
    float32 payload's distance from the same reference is reported."""
    cfg = _ssm_cfg()
    jp = jax.tree.map(np.asarray, JS.init_ssm(KEY, cfg))
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 512, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 512, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JS.ssm_fwd(p, x, cfg, scan_dtype=jnp.bfloat16) * ct)

    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgu)]
    dist = {}
    for name, sd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        tp = TT.tree_map(lambda t: torch.from_numpy(np.array(t))
                         .requires_grad_(True), jp)
        tu = torch.from_numpy(u).requires_grad_(True)
        (TS.ssm_fwd(tp, tu, cfg, scan_dtype=sd)
         * torch.from_numpy(ct)).sum().backward()
        got = [t.grad.numpy() for t in TT.tree_leaves(tp)] + [
            tu.grad.numpy()]
        dist[name] = max(_rel(g, w) for g, w in zip(got, want)
                         if np.abs(w).max() > 0)
    print(f"largest relative gradient distance from jax.grad of the bf16 "
          f"path: {dist}")
    assert dist["bf16"] <= GRAD_TOL, dist
    assert dist["f32"] > dist["bf16"], dist


# -- the models --

def _models(name, **ctx):
    cfg = jregistry.get_config(name, reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32,
                             ssm_scan_dtype=jnp.bfloat16))
    tm = TT.Model(cfg, TT.RunCtx(act_dtype=torch.float32,
                                 ssm_scan_dtype=torch.bfloat16, **ctx),
                  device="cpu")
    jp = jm.init_params(KEY)
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm, tp


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b"])
def test_build_prefill_with_bf16_payload_matches_jax(name):
    """Last-position logits at L 512 (two chunks of the payload) against
    the JAX model with the same ``ssm_scan_dtype``."""
    cfg, jm, jp, tm, tp = _models(name)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32)
    want = np.asarray(jsteps.build_prefill(jm)(jp, jnp.asarray(toks)))
    got = tsteps.build_prefill(tm)(tp, torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b"])
def test_train_step_gradients_with_bf16_payload_match_jax(name):
    """One train step's gradient half (``build_grad_fn``, remat full: the
    autograd Function's forward runs twice) against ``jax.value_and_grad``
    of the JAX model's loss: the loss within 1e-4 and every leaf within
    STEP_L2 relative L2.  A float32 ulp that one side's matmuls or
    convolution give and the other's do not flips a bf16 rounding of the
    payload, so the leaves' largest elements can differ by 1e-2; their L2
    stays within a fifth of the float32 payload's distance from the same
    reference, which the test also holds."""
    cfg, jm, jp, tm, tp = _models(name, remat="full")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels)))(jp)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    batch = (torch.from_numpy(tokens), torch.from_numpy(labels))
    dist = {}
    for payload in (torch.bfloat16, torch.float32):
        tm.ctx = dataclasses.replace(tm.ctx, ssm_scan_dtype=payload)
        grads, loss = tsteps.build_grad_fn(tm)(tp, batch)
        got = [t.float().numpy() for t in TT.tree_leaves(grads)]
        assert len(got) == len(want)
        dist[payload] = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                            for g, w in zip(got, want) if np.any(w))
        if payload == torch.bfloat16:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                       atol=1e-4)
    print(f"{name}: largest leaf's relative L2 distance from jax.grad of "
          f"the bf16 payload: {dist}")
    assert dist[torch.bfloat16] <= STEP_L2, dist
    assert dist[torch.float32] > 2 * dist[torch.bfloat16], dist
