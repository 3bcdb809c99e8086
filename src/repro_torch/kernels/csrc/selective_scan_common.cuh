// The helpers and constants that the selective scan's forward
// (selective_scan.cu) and backward (selective_scan_bwd.cu) share; each
// source takes its own copy (an anonymous namespace).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxState = 32;
constexpr int kSpt = 4;          // states a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCkptSteps = 128;  // steps between the backward's checkpoints

__device__ __forceinline__ float ex2(float x) {   // one MUFU op, 2 ulp
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy kBytes (4 or 16) from global to shared memory without waiting;
// `in` false fills zeros (src is then not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  const int n = in ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The transposed butterfly: p[s] is this thread's part of y at step s of
// kN; lanes j ^ m (m < kN) serve the same channel.  Returns the sum over
// the kN lanes of step (lane % kN).
template <int kN>
__device__ __forceinline__ float transpose_sum(float (&p)[kN], int j) {
  if constexpr (kN == 1) {
    return p[0];
  } else {
    constexpr int m = kN / 2;
    const bool hi = (j & m) != 0;
    float q[m];
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float mine = hi ? p[i + m] : p[i];
      const float other = hi ? p[i] : p[i + m];
      q[i] = mine + __shfl_xor_sync(0xffffffffu, other, m);
    }
    return transpose_sum<m>(q, j);
  }
}

template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[kV]) {
  if constexpr (kV == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    r[0] = u.x; r[1] = u.y; r[2] = u.z; r[3] = u.w;
  } else if constexpr (kV == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    r[0] = u.x; r[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) r[i] = p[i];
  }
}

bool bad_shape(long long b, long long l, long long di, long long st) {
  return b < 1 || l < 1 || di < 1 || st < 1 || st > kMaxState ||
         b > 65535 || l >= (1LL << 31) || di >= (1LL << 31);
}

}  // namespace
