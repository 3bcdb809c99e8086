"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; on the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.communicator import LoopbackComm
from repro_torch.core.matrix import make_mesh_like_matrix, spmv_ref_np
from repro_torch.core.spmv import DistributedSpMV
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.cuda

TOL = dict(rtol=3e-5, atol=3e-5)   # float32 sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("feat", [(), (3,), (4,), (1024,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.int8])
def test_pack_gather_bit_exact(dev, feat, dtype):
    rng = np.random.default_rng(0)
    p, shard, m = 4, 37, 53
    x = _rand(rng, (p, shard) + feat, torch.float32, dev).mul(100).to(dtype)
    idx = torch.as_tensor(rng.integers(0, shard, (p, m)), dtype=torch.int32,
                          device=dev)
    before = kops.launch_counts()["pack_gather"]
    got = kops.pack_gather(x, idx)
    torch.cuda.synchronize()
    assert kops.launch_counts()["pack_gather"] == before + 1
    assert torch.equal(got, kref.pack_gather_ref(x, idx))


@pytest.mark.parametrize("copy_own", [True, False])
@pytest.mark.parametrize("feat", [(), (3,), (64,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_scatter_set_bit_exact(dev, copy_own, feat, dtype):
    rng = np.random.default_rng(1)
    p, rows, n_recv = 4, 16, 30
    n = p * rows
    out_len = n + 2                       # dump row n, zero slot n + 1
    idx = np.full((p, n_recv), n, np.int32)
    for q in range(p):
        foreign = np.setdiff1d(np.arange(n), np.arange(q * rows,
                                                       (q + 1) * rows))
        k = 20
        idx[q, :k] = rng.choice(foreign, k, replace=False)
        idx[q, k:k + 3] = q * rows + np.arange(3)   # own-range targets lose
    idx = torch.as_tensor(idx, device=dev)
    recv = _rand(rng, (p, n_recv) + feat, dtype, dev)
    x_own = _rand(rng, (p, rows) + feat, dtype, dev)
    offsets = torch.arange(0, n, rows, dtype=torch.int32, device=dev)
    got = kops.unpack_scatter_set(recv, idx, x_own, offsets, out_len=out_len,
                                  copy_own=copy_own)
    want = kref.unpack_scatter_set_ref(recv, idx, x_own, offsets,
                                       out_len=out_len, copy_own=copy_own)
    keep = [i for i in range(out_len) if i != n]    # dump row unspecified
    assert torch.equal(got[:, keep], want[:, keep])
    assert not got[:, n + 1].any()


@pytest.mark.parametrize("feat", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_dest_bit_exact(dev, feat, dtype):
    rng = np.random.default_rng(2)
    p, n_recv, shard, slots = 4, 40, 24, 101
    recv = _rand(rng, (p, n_recv) + feat, dtype, dev)
    x = _rand(rng, (p, shard) + feat, dtype, dev)
    # -0.0, inf and NaN must pass through the two products and the add
    recv.view(-1)[:3] = torch.tensor([-0.0, float("inf"), float("nan")],
                                     dtype=dtype, device=dev)
    x.view(-1)[:3] = torch.tensor([-0.0, float("-inf"), 1.0], dtype=dtype,
                                  device=dev)
    kind = rng.integers(0, 3, (p, slots))               # own / foreign / zero
    src = torch.as_tensor(rng.integers(0, n_recv, (p, slots)),
                          dtype=torch.int32, device=dev)
    own = torch.as_tensor(rng.integers(0, shard, (p, slots)),
                          dtype=torch.int32, device=dev)
    src[:, :3] = torch.arange(3, device=dev)
    own[:, :3] = torch.arange(3, device=dev)
    own_m = torch.as_tensor(kind == 0, dtype=torch.int8, device=dev)
    rem_m = torch.as_tensor(kind == 1, dtype=torch.int8, device=dev)
    got = kops.unpack_dest(recv, x, src, own, own_m, rem_m)
    want = kref.unpack_dest_ref(recv, x, src, own, own_m, rem_m)
    assert torch.equal(got.isnan(), want.isnan())
    same = ~want.isnan()
    assert torch.equal(got[same].view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                       want[same].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32))


@pytest.mark.parametrize("r_nz", [1, 3, 8, 16, 33])
@pytest.mark.parametrize("with_diag", [True, False])
def test_ellpack_spmv_matches_plain(dev, r_nz, with_diag):
    rng = np.random.default_rng(3)
    p, rows, rpb, window = 3, 512, 128, 256
    nblk = rows // rpb
    x = _rand(rng, (p, 4 * window + 7), torch.float32, dev)
    win_blk = torch.as_tensor(rng.integers(0, 3, (p, nblk)),
                              dtype=torch.int32, device=dev)
    cols_rel = torch.as_tensor(rng.integers(0, 2 * window, (p, rows, r_nz)),
                               dtype=torch.int32, device=dev)
    own_rel = torch.as_tensor(rng.integers(0, 2 * window, (p, rows)),
                              dtype=torch.int32, device=dev)
    vals = _rand(rng, (p, rows, r_nz), torch.float32, dev)
    diag = _rand(rng, (p, rows), torch.float32, dev) if with_diag else None
    args = (diag, vals, cols_rel, own_rel if with_diag else None, win_blk,
            x[:, :-7])                         # a strided view of x
    got = kops.ellpack_spmv_windowed(*args, window=window,
                                     rows_per_block=rpb)
    want = kref.ellpack_spmv_ref(*args, window=window, rows_per_block=rpb)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
@pytest.mark.parametrize("materialize", ["full", "dest"])
def test_spmv_engine_on_card(dev, strategy, materialize):
    n = 8 * 1024
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=1)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    eng = DistributedSpMV(m, LoopbackComm(8, device=dev), strategy=strategy,
                          blocksize=64, shards_per_node=4, use_kernel=True,
                          materialize=materialize)
    kops.reset_launch_counts()
    y = eng(eng.shard_vector(x))
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(), spmv_ref_np(m, x),
                               rtol=2e-4, atol=2e-4)
    if strategy != "replicate":
        assert counts["pack_gather"] == 1
    if materialize == "dest":
        assert counts["unpack_dest"] == 1
    else:
        assert counts["ellpack_spmv_windowed"] == (
            2 if strategy == "overlap" else 1)
        assert counts["unpack_scatter_set"] == (
            0 if strategy == "replicate" else 1)
