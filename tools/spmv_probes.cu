// Probe kernels for tools/spmv_kernel_bench.py and chip_smoke.py: they time
// what bounds the SpMV (B4) and segment-fold (B5) kernels on the card, and
// are no part of the port.  Built with the port's nvcc flags by
// repro_torch.kernels._build.build_library; every entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// One thread adds n values one after another, each add waiting on the one
// before it: the least time a fold of an n-lane row in lane order can take.
// The addends are immediates of 16 unrolled adds (rounded adds do not
// merge), so the loop's own instructions stay off the chain.
__global__ void add_chain_kernel(float* out, long long n) {
  float acc = 0.0f;
  long long i = 0;
  for (; i + 16 <= n; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, 1.0f + u * 0.0625f);
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, 1.0f);
  out[0] = acc;
}

// B4's gathers without its stream: row i of rank q (4 lanes, 4 entries
// each, as the SpMV kernel's vec-4 path) gathers x[q, c] at
// c = q * shard + i + off[i % r0, j], clamped into [0, x_len), where off is
// a small table of column offsets (r0 rows of 16, taken from the real
// matrix) that stays in L1; it writes the sum of the 16 values.  So the
// gathers keep the matrix's spread while the streamed bytes all but vanish.
__global__ void spmv_gathers_kernel(const int32_t* off, const float* x,
                                    float* y, unsigned rows, long long shard,
                                    long long x_len, long long x_stride,
                                    unsigned r0) {
  const size_t rank = blockIdx.y;
  const int sub = threadIdx.x & 3;
  const unsigned row = blockIdx.x * 64 + threadIdx.x / 4;
  float acc = 0.0f;
  if (row < rows) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(off) + (row % r0) * 4 +
                         sub);
    const long long at = static_cast<long long>(rank) * shard + row;
    const float* xr = x + rank * x_stride;
    const long long top = x_len - 1;
    const float g0 = __ldg(xr + max(0LL, min(top, at + c.x)));
    const float g1 = __ldg(xr + max(0LL, min(top, at + c.y)));
    const float g2 = __ldg(xr + max(0LL, min(top, at + c.z)));
    const float g3 = __ldg(xr + max(0LL, min(top, at + c.w)));
    acc = (g0 + g1) + (g2 + g3);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 2, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1, 4);
  if (row < rows && sub == 0) y[rank * rows + row] = acc;
}

// x gathered at a list of positions, eight a thread: out[i] is the sum of
// x[pos[8 i .. 8 i + 7]].  Fed the SpMV's columns in row order and sorted by
// column inside groups of rows, it says how much sorting saves the gathers.
__global__ void gather_list_kernel(const int32_t* pos, const float* x,
                                   float* out, long long n8) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n8) return;
  const int4 a = __ldcs(reinterpret_cast<const int4*>(pos) + 2 * i);
  const int4 b = __ldcs(reinterpret_cast<const int4*>(pos) + 2 * i + 1);
  out[i] = ((__ldg(x + a.x) + __ldg(x + a.y)) + (__ldg(x + a.z) + __ldg(x + a.w))) +
           ((__ldg(x + b.x) + __ldg(x + b.y)) + (__ldg(x + b.z) + __ldg(x + b.w)));
}

}  // namespace

extern "C" {

int probe_add_chain(void* out, long long n, void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n);
  return cudaGetLastError();
}

// off (r0, 16) int32, x (p, x_stride) float32 with x_len valid entries a
// rank, y (p, rows) float32.
int probe_spmv_gathers(const void* off, const void* x, void* y, long long p,
                       long long rows, long long shard, long long x_len,
                       long long x_stride, long long r0, void* stream) {
  if (p == 0 || rows == 0) return cudaGetLastError();
  if (rows >= (1LL << 31) || r0 < 1 || p > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + 63) / 64),
                  static_cast<unsigned>(p));
  spmv_gathers_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(off), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<unsigned>(rows), shard, x_len,
      x_stride, static_cast<unsigned>(r0));
  return cudaGetLastError();
}

// pos (8 n8,) int32 positions into x, out (n8,) float32.
int probe_gather_list(const void* pos, const void* x, void* out, long long n8,
                      void* stream) {
  if (n8 == 0) return cudaGetLastError();
  gather_list_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const float*>(x),
      static_cast<float*>(out), n8);
  return cudaGetLastError();
}

}  // extern "C"
