// Modified-EllPack SpMV for Hopper (sm_90a), every rank in one launch:
//   y[q, i] = diag[q, i] * x[q, base + own_rel[q, i]]
//             + sum_j vals[q, i, j] * x[q, base + cols_rel[q, i, j]],
//   base = win_blk[q, i / rows_per_block] * window,
// summed in float32.
//
// Replaces the Pallas TPU kernel ellpack_spmv_windowed of
// src/repro/kernels/ellpack_spmv.py (pallas_call at :79), reached through
// repro.kernels.ops._spmv_call, make_spmv_on_copy_sharded and both partials
// of make_spmv_overlap_sharded.
//
// What bounds it on this card: bytes.  Per row it reads r_nz values and
// column indices (8 bytes each), the diagonal, the own index and the
// gathered x values, and writes one float, for 2 * (r_nz + 1) flops: well
// under one flop per byte.
//
// The TPU kernel DMA'd a planned column window of x (two adjacent window
// tiles) into VMEM for each row block, so the irregular gather stayed on
// chip, and the caller padded every x_copy to a whole number of windows for
// it.  Here x is read in place from device memory through the read-only
// cache (__ldg) at the same absolute positions win_blk * window + cols_rel:
// rows that are close in a reordered mesh touch neighbouring columns, so the
// 50 MB L2 serves most of the reuse that the window gave on the TPU, and no
// padded copy of x is made.  The caller guarantees, from the host-side plan,
// that every position lies inside x.
//
// A group of `lanes` threads (a power of two, at most 32) works on one row:
// where r_nz is a multiple of 4, lane j reads vals[i, 4j..4j+3] and
// cols_rel[i, 4j..4j+3] with one 16-byte load each and has four gathers in
// flight (r_nz / 4 lanes per row); otherwise lane j reads entry j (r_nz
// lanes).  A warp reads whole contiguous rows of vals and cols_rel, and the
// group's partial sums meet through warp shuffles.  `diag` may be null (the foreign partial
// of the overlap rung has no diagonal term); then `own_rel` is not read.
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int kVec>
__global__ void ellpack_spmv_kernel(
    const float* __restrict__ diag, const float* __restrict__ vals,
    const int32_t* __restrict__ cols_rel, const int32_t* __restrict__ own_rel,
    const int32_t* __restrict__ win_blk, const float* __restrict__ x,
    float* __restrict__ y, unsigned rows, int r_nz, unsigned rows_per_block,
    long long window, long long x_stride, int lanes) {
  // 32-bit row math inside a rank (rows < 2^31, checked by the host): a
  // 64-bit division is a long software routine on the GPU
  const size_t rank = blockIdx.y;
  const int sub = threadIdx.x & (lanes - 1);
  const unsigned row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool active = row < rows;
  const unsigned nblk = rows / rows_per_block;
  const float* xr = x + rank * x_stride;
  long long base = 0;
  float acc = 0.0f;
  if (active) {
    base = static_cast<long long>(win_blk[rank * nblk + row / rows_per_block]) *
           window;
    const float* xb = xr + base;
    const size_t off = (rank * rows + row) * r_nz;
    if (kVec == 4) {
      // 16-byte loads: four values and four columns per lane, then four
      // independent gathers in flight
      const float4* v4 = reinterpret_cast<const float4*>(vals + off);
      const int4* c4 = reinterpret_cast<const int4*>(cols_rel + off);
      for (int j = sub; j < r_nz / 4; j += lanes) {
        const float4 v = __ldg(v4 + j);
        const int4 c = __ldg(c4 + j);
        const float g0 = __ldg(xb + c.x), g1 = __ldg(xb + c.y);
        const float g2 = __ldg(xb + c.z), g3 = __ldg(xb + c.w);
        acc += v.x * g0 + v.y * g1 + v.z * g2 + v.w * g3;
      }
    } else {
      for (int j = sub; j < r_nz; j += lanes) {
        acc += vals[off + j] * __ldg(xb + cols_rel[off + j]);
      }
    }
  }
  // every lane of the warp takes part, inactive rows with acc = 0
  for (int s = lanes >> 1; s > 0; s >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, s, lanes);
  }
  if (active && sub == 0) {
    const size_t i = rank * rows + row;
    if (diag != nullptr) {
      acc = diag[i] * __ldg(xr + base + own_rel[i]) + acc;
    }
    y[i] = acc;
  }
}

}  // namespace

extern "C" {

int rt_ellpack_spmv_f32(const void* diag, const void* vals,
                        const void* cols_rel, const void* own_rel,
                        const void* win_blk, const void* x, void* y,
                        long long p, long long rows, long long r_nz,
                        long long rows_per_block, long long window,
                        long long x_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || rows == 0) return cudaGetLastError();
  if (rows >= (1LL << 31) || rows_per_block <= 0 || rows % rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows of a multiple of 4 entries, 16-byte aligned: 16-byte loads
  const bool vec4 = r_nz % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cols_rel) % 16 == 0;
  const long long per_lane = vec4 ? r_nz / 4 : r_nz;
  int lanes = 1;
  while (lanes < per_lane && lanes < 32) lanes <<= 1;
  const long long rows_per_cta = kThreads / lanes;
  const dim3 grid(static_cast<unsigned>((rows + rows_per_cta - 1) / rows_per_cta),
                  static_cast<unsigned>(p));
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(diag), static_cast<const float*>(vals),
        static_cast<const int32_t*>(cols_rel),
        static_cast<const int32_t*>(own_rel),
        static_cast<const int32_t*>(win_blk), static_cast<const float*>(x),
        static_cast<float*>(y), static_cast<unsigned>(rows),
        static_cast<int>(r_nz), static_cast<unsigned>(rows_per_block), window,
        x_stride, lanes);
  };
  if (vec4) go(ellpack_spmv_kernel<4>);
  else go(ellpack_spmv_kernel<1>);
  return cudaGetLastError();
}

}  // extern "C"
