"""The port's int8 error-feedback compression against the reference's.

``quantize_int8`` / ``dequantize_int8`` bit for bit with the reference's
on the same inputs.  ``compressed_psum`` over ``LoopbackComm(1)`` against
the reference's under a one-device ``shard_map``, looped over 50
error-feedback steps as ``tests/test_substrates.py``'s test loops: every
step's mean and residual bit for bit.  Then over ``LoopbackComm(4)`` and
over a ``DistComm`` of 4 gloo processes (``python
tests/test_torch_compress.py RANK 4 INIT OUT``) against a numpy
transcription of the formula: a scale shared through the ranks' max, the
int8 payloads summed in int32, the mean and each rank's residual (rounded
once, as the reference's jitted ``gf - q * scale``, a fused multiply-add
in XLA).
"""
import sys

import numpy as np
import pytest
import torch

from test_torch_dist_comm import init_gloo, run_ranks

RANKS = 4


def _grads(p: int, n: int = 128, seed: int = 0) -> np.ndarray:
    """``(steps, p, n)`` float32 gradients of different scales a rank."""
    rng = np.random.default_rng(seed)
    scale = np.array([1e-3 * 4.0 ** q for q in range(p)], np.float32)
    return (rng.standard_normal((5, p, n)) * scale[None, :, None]).astype(
        np.float32)


def numpy_psum(g: np.ndarray, residual: np.ndarray):
    """The formula, rank-stacked ``(P, n)``, in numpy float32."""
    gf = g.astype(np.float32) + residual
    local = (np.abs(gf).max(axis=1) / np.float32(127.0)
             + np.float32(1e-12)).astype(np.float32)
    scale = local.max()
    q = np.clip(np.round(gf / scale), -127, 127).astype(np.int8)
    # gf - q * scale rounded once (XLA's multiply-add): exact in float64,
    # since |the residual| <= scale / 2 and the product has 32 bits
    new_res = (gf.astype(np.float64) - q.astype(np.float64)
               * np.float64(scale)).astype(np.float32)
    summed = q.astype(np.int32).sum(axis=0)
    mean = (summed.astype(np.float32) * scale / np.float32(g.shape[0]))
    return np.broadcast_to(mean, g.shape), new_res


def _run_steps(comm, grads: np.ndarray):
    """Every step's (mean, residual) of ``comm``'s local rows."""
    from repro_torch.optim.compress import compressed_psum
    rows = comm.local_rows
    res = torch.zeros(grads[0][rows].shape)
    out = []
    for g in grads:
        mean, res = compressed_psum(torch.from_numpy(g[rows].copy()), res,
                                    comm)
        out.append((mean.numpy(), res.numpy()))
    return out


def _numpy_steps(grads: np.ndarray):
    res = np.zeros_like(grads[0])
    out = []
    for g in grads:
        mean, res = numpy_psum(g, res)
        out.append((mean, res))
    return out


def test_quantize_is_the_reference_bit_for_bit():
    import jax.numpy as jnp

    from repro.optim import compress as jc
    from repro_torch.optim import compress as tc

    x = np.random.default_rng(1).standard_normal((7, 33)).astype(
        np.float32) * 3
    x[0, 0] = 0.5 * (np.abs(x).max() / 127 + 1e-12)   # a tie at .5
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and float(ts) == float(js)
    np.testing.assert_array_equal(
        tc.dequantize_int8(tq, ts).numpy(),
        np.asarray(jc.dequantize_int8(jq, js)))


def test_compressed_psum_is_the_reference_over_50_steps():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.optim.compress import compressed_psum
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.optim import compress as tc

    mesh = compat.make_mesh((1,), ("data",),
                            axis_types=compat.auto_axis_types(1))
    f = jax.jit(compat.shard_map(
        lambda gg, rr: compressed_psum(gg, rr, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))
    g = (np.random.default_rng(0).standard_normal(128) * 1e-3).astype(
        np.float32)
    jr = jnp.zeros_like(jnp.asarray(g))
    comm = LoopbackComm(1, device="cpu")
    tr = torch.zeros((1, 128))
    tg = torch.from_numpy(g)[None]
    total_true, total_deq = np.zeros_like(g), np.zeros_like(g)
    for _ in range(50):
        jout, jr = f(jnp.asarray(g), jr)
        tout, tr = tc.compressed_psum(tg, tr, comm)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr))
        total_deq += tout[0].numpy()
        total_true += g
    # error feedback: the running sum tracks the true one
    assert np.abs(total_deq - total_true).max() / np.abs(
        total_true).max() < 0.02


def test_compressed_psum_over_loopback_is_the_formula():
    from repro_torch.comm.communicator import LoopbackComm

    grads = _grads(RANKS)
    got = _run_steps(LoopbackComm(RANKS, device="cpu"), grads)
    for (mean, res), (wmean, wres) in zip(got, _numpy_steps(grads)):
        np.testing.assert_array_equal(mean, wmean)
        np.testing.assert_array_equal(res, wres)


def _worker(rank, world, init, out):
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm

    init_gloo(rank, world, init)
    got = _run_steps(DistComm(1, device="cpu"), _grads(RANKS))
    dist.destroy_process_group()
    np.savez(f"{out}-{rank}.npz", mean=np.stack([m for m, _ in got]),
             res=np.stack([r for _, r in got]))


def test_compressed_psum_over_gloo_ranks_is_the_formula(tmp_path):
    run_ranks(__file__, RANKS, tmp_path, tmp_path / "rank")
    want = _numpy_steps(_grads(RANKS))
    for r in range(RANKS):
        got = np.load(tmp_path / f"rank-{r}.npz")
        for step, (wmean, wres) in enumerate(want):
            np.testing.assert_array_equal(got["mean"][step], wmean[r:r + 1])
            np.testing.assert_array_equal(got["res"][step], wres[r:r + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_takes_the_gradient_dtype(dtype):
    from repro_torch.optim.compress import quantize_int8
    q, s = quantize_int8(torch.linspace(-2, 2, 9).to(dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.tolist() == [-127, -95, -64, -32, 0, 32, 64, 95, 127]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
