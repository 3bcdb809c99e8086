// Probe kernels for tools/spmv_kernel_bench.py and chip_smoke.py: they time
// what bounds the SpMV (B4), segment-fold (B5) and targeted-unpack (B3)
// kernels on the card, and are no part of the port.  Built with the port's
// nvcc flags by repro_torch.kernels._build.build_library; every entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
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

// B3's two layouts one at a time (the port's kernel combines them), float32:
//   * sorted arrays (layout a alone): the plan's src, own and masks, and
//     each entry's slot, permuted into the dest table's sorted order; a
//     block stages a group of `group` slots in shared memory and writes it
//     out in slot order;
//   * codes (layout b alone): one int32 code a slot in slot order (the dest
//     table's code before its sort), no staging.
__device__ __forceinline__ float dest_value(const float* rr, const float* xr,
                                            int c, int shift) {
  const bool rem = c >= 0, own = !rem && c != INT_MIN;
  const int ia = rem ? c : (own && shift >= 0 ? ~c + shift : 0);
  const float a = __ldg(rr + ia), b = __ldg(xr + (own ? ~c : 0));
  return __fadd_rn(__fmul_rn(a, rem ? 1.0f : 0.0f),
                   __fmul_rn(b, own ? 1.0f : 0.0f));
}

__global__ void __launch_bounds__(1024)
    dest_sorted_arrays_kernel(const float* recv, const float* x,
                              const int32_t* src, const int32_t* own,
                              const int8_t* own_m, const int8_t* rem_m,
                              const uint16_t* slot, float* out,
                              long long n_recv, long long shard,
                              long long slots, unsigned group,
                              unsigned per_rank) {
  extern __shared__ float parked[];
  const size_t rank = blockIdx.x / per_rank;
  const size_t g0 = static_cast<size_t>(blockIdx.x - rank * per_rank) * group;
  const size_t left = static_cast<size_t>(slots) - g0;
  const unsigned n = left < group ? static_cast<unsigned>(left) : group;
  const size_t e0 = rank * slots + g0;
  const float* rr = recv + rank * n_recv;
  const float* xr = x + rank * shard;
  for (unsigned u0 = threadIdx.x; u0 < n; u0 += 8 * 1024) {
    float v[8];
    unsigned sl[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned u = u0 + k * 1024;
      if (u < n) {
        const size_t e = e0 + u;
        sl[k] = __ldcs(slot + e);
        const float a = __ldg(rr + __ldcs(src + e));
        const float b = __ldg(xr + __ldcs(own + e));
        v[k] = __fadd_rn(__fmul_rn(a, static_cast<float>(__ldcs(rem_m + e))),
                         __fmul_rn(b, static_cast<float>(__ldcs(own_m + e))));
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (u0 + k * 1024 < n) parked[sl[k]] = v[k];
    }
  }
  __syncthreads();
  for (unsigned s = threadIdx.x; s < n; s += 1024) out[e0 + s] = parked[s];
}

__global__ void dest_codes_kernel(const float* recv, const float* x,
                                  const int32_t* code, const int32_t* shift,
                                  float* out, long long n_recv,
                                  long long shard, long long slots) {
  const size_t rank = blockIdx.y;
  const float* rr = recv + rank * n_recv;
  const float* xr = x + rank * shard;
  const int sh = shift == nullptr ? -1 : shift[rank];
  const size_t base = rank * slots;
  const unsigned start = blockIdx.x * 1024 + threadIdx.x;
  int c[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned l = start + u * 256;
    c[u] = l < slots ? __ldcs(code + base + l) : INT_MIN;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const unsigned l = start + u * 256;
    if (l < slots) out[base + l] = dest_value(rr, xr, c[u], sh);
  }
}

}  // namespace

extern "C" {

// recv (p, n_recv), x (p, shard), the four arrays (p, slots) and slot (p,
// slots) uint16 in the dest table's order, out (p, slots); float32.
int probe_dest_sorted_arrays(const void* recv, const void* x, const void* src,
                             const void* own, const void* own_m,
                             const void* rem_m, const void* slot, void* out,
                             long long p, long long n_recv, long long shard,
                             long long slots, long long group, void* stream) {
  if (p == 0 || slots == 0) return cudaGetLastError();
  if (group < 1 || group > 57344)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_rank = (slots + group - 1) / group;
  const int smem = static_cast<int>(group * 4);
  cudaFuncSetAttribute(dest_sorted_arrays_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dest_sorted_arrays_kernel<<<static_cast<unsigned>(per_rank * p), 1024, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(recv), static_cast<const float*>(x),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(own),
      static_cast<const int8_t*>(own_m), static_cast<const int8_t*>(rem_m),
      static_cast<const uint16_t*>(slot), static_cast<float*>(out), n_recv,
      shard, slots, static_cast<unsigned>(group),
      static_cast<unsigned>(per_rank));
  return cudaGetLastError();
}

// code (p, slots) int32 in slot order, shift (p,) int32 or null.
int probe_dest_codes(const void* recv, const void* x, const void* code,
                     const void* shift, void* out, long long p,
                     long long n_recv, long long shard, long long slots,
                     void* stream) {
  if (p == 0 || slots == 0) return cudaGetLastError();
  const dim3 grid(static_cast<unsigned>((slots + 1023) / 1024),
                  static_cast<unsigned>(p));
  dest_codes_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(recv), static_cast<const float*>(x),
      static_cast<const int32_t*>(code), static_cast<const int32_t*>(shift),
      static_cast<float*>(out), n_recv, shard, slots);
  return cudaGetLastError();
}

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
