// 5-point Jacobi stencil for Hopper (sm_90a), every slice of a batch in one
// launch:
//   out[b, i, j] = mid + coef * lap,
//   lap = ((up + down) + left) + right - 4 * mid
// on the interior 1 <= i < m-1, 1 <= j < n-1 of each (m, n) slice; boundary
// rows and columns are copied.
//
// Replaces the Pallas TPU kernel stencil2d of src/repro/kernels/stencil2d.py
// (pallas_call at :60), reached through repro.kernels.ops.stencil2d from
// Heat2D's whole-tile, interior and ring-strip stencils.
//
// What bounds it on this card: bytes.  Each cell is read and written once
// (8 bytes) for 7 flops.  The TPU kernel walked row bands of 8 through
// VMEM, three bands per step (BlockSpecs cannot overlap, so the halo rows
// came from the neighbouring bands), and the wrapper padded the rows to a
// band multiple.  Here a block of 128 threads owns 128 adjacent columns of
// a run of kRows rows: each thread slides up/mid/down down its column in
// registers, so every row is read from memory about (kRows + 2) / kRows
// times, and takes left/right from the neighbouring threads' loads through
// the L1.  Any m, n >= 1 works and no padding is made; a slice with m < 3
// or n < 3 is all boundary.
//
// Rounding: the adds are __fadd_rn in the order above and the last step is
// one __fmaf_rn(coef, lap, mid), so nvcc's default --fmad=true cannot
// contract them another way.  That is the rounding of the reference's
// jitted stencil and of its Pallas kernel; 4 * mid is exact.
//
// The input may be a strided view (Heat2D's ring strips are): x_sb and x_sr
// are the element strides between slices and between rows; columns have
// unit stride.  The output is contiguous (b, m, n).
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;

__global__ void stencil2d_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int m, int n,
                                 long long x_sb, long long x_sr,
                                 unsigned col_tiles, float coef) {
  const unsigned row_tile = blockIdx.x / col_tiles;
  const unsigned col_tile = blockIdx.x - row_tile * col_tiles;
  const int col = static_cast<int>(col_tile) * kThreads + threadIdx.x;
  if (col >= n) return;
  const int r0 = static_cast<int>(row_tile) * kRows;
  const int r1 = min(r0 + kRows, m);
  const float* xs = x + static_cast<long long>(blockIdx.y) * x_sb;
  float* os = out + static_cast<long long>(blockIdx.y) * m * n;
  const bool inner_col = col > 0 && col < n - 1;
  float up = (r0 > 0) ? __ldg(xs + (r0 - 1) * x_sr + col) : 0.0f;
  float mid = __ldg(xs + r0 * x_sr + col);
  for (int r = r0; r < r1; ++r) {
    const float down = (r + 1 < m) ? __ldg(xs + (r + 1) * x_sr + col) : 0.0f;
    float v = mid;
    if (inner_col && r > 0 && r < m - 1) {
      const float* row = xs + r * x_sr + col;
      const float left = __ldg(row - 1);
      const float right = __ldg(row + 1);
      const float sum = __fadd_rn(__fadd_rn(__fadd_rn(up, down), left), right);
      const float lap = __fsub_rn(sum, __fmul_rn(4.0f, mid));
      v = __fmaf_rn(coef, lap, mid);
    }
    os[static_cast<long long>(r) * n + col] = v;
    up = mid;
    mid = down;
  }
}

}  // namespace

extern "C" {

// out[b] = one Jacobi step of x[b] for every slice b < batch.
int rt_stencil2d_f32(const void* x, void* out, long long batch, long long m,
                     long long n, long long x_sb, long long x_sr, float coef,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m == 0 || n == 0) return cudaGetLastError();
  if (m >= (1LL << 31) || n >= (1LL << 31) || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long col_tiles = (n + kThreads - 1) / kThreads;
  const long long row_tiles = (m + kRows - 1) / kRows;
  if (col_tiles * row_tiles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles * row_tiles),
                  static_cast<unsigned>(batch));
  stencil2d_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int>(m), static_cast<int>(n), x_sb, x_sr,
      static_cast<unsigned>(col_tiles), coef);
  return cudaGetLastError();
}

}  // extern "C"
