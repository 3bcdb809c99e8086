// The mamba-1 selective scan for Hopper (sm_90a), float32:
//   h[b, c, n] = exp(dt[b, t, c] * a[c, n]) * h + (dt[b, t, c] * x[b, t, c])
//                * B[b, t, n],
//   y[b, t, c] = sum_n h[b, c, n] * C[b, t, n],
// from h = 0, one step after another over t < L.
//
// Replaces the Pallas TPU kernel selective_scan of
// src/repro/kernels/selective_scan.py (pallas_call at :71), reached through
// repro.kernels.ops.selective_scan; in the port it is the recurrence of
// every mamba-1 layer's forward (models/ssm.py, ssm_fwd).
//
// What bounds it on this card: bytes, and the chain of L dependent steps.
// The state (B, di, st) never leaves the chip: memory sees x, dt and y (di
// floats a step each), B and C (st floats a step each) and a, once.  The
// TPU kernel held a (tile of channels, state) block of h in VMEM across the
// sequential sequence axis of its grid.  Here one thread owns one (lane b,
// channel c, state n) and keeps its h in a register for all L steps;
// kTpc = the next power of two >= st threads serve a channel (16 for
// st = 16), so a warp holds 32 / kTpc channels and y is a kTpc-lane
// shuffle sum.  A block serves kChannels channels of one lane.  The decay
// is one ex2 a step: exp(dt * a) = exp2(dt * (a * log2 e)), a scaled once.
// The threads of a channel all read that channel's x and dt, and every
// thread reads the step's B and C: kSteps steps of each are staged in
// shared memory at a time with coalesced loads, and y is staged there and
// written back the same way.  Any di, L >= 1 and st <= 32 work; the TPU kernel's
// tile and chunk divisibility does not apply.
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 16;   // channels of one block
constexpr int kSteps = 64;      // steps staged in shared memory at a time
constexpr int kMaxState = 32;
constexpr float kLog2e = 1.4426950408889634f;

// kTpc threads per channel (a power of two >= st); the block is
// kChannels * kTpc threads.
template <int kTpc>
__global__ void __launch_bounds__(kChannels * kTpc) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, float* __restrict__ y, int l, int di,
    int st) {
  constexpr int kThreads = kChannels * kTpc;
  __shared__ float xs[kSteps][kChannels];
  __shared__ float dts[kSteps][kChannels];
  __shared__ float ys[kSteps][kChannels];
  __shared__ float bs[kSteps][kMaxState];
  __shared__ float cs[kSteps][kMaxState];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int cl = tid / kTpc;
  const int n = tid - cl * kTpc;
  const bool live = c0 + cl < di && n < st;
  // exp(dt * a) as exp2(dt * a * log2 e): one ex2 per step, 2 ulp
  const float a2 =
      live ? a[static_cast<long long>(c0 + cl) * st + n] * kLog2e : 0.0f;
  const long long xb = static_cast<long long>(b) * l * di + c0;
  const long long bb = static_cast<long long>(b) * l * st;
  float h = 0.0f;
  for (int t0 = 0; t0 < l; t0 += kSteps) {
    const int steps = min(kSteps, l - t0);
    __syncthreads();                          // the last chunk is written
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      const bool in = c0 + c < di;
      const long long off = xb + static_cast<long long>(t0 + t) * di + c;
      xs[t][c] = in ? x[off] : 0.0f;
      dts[t][c] = in ? dt[off] : 0.0f;
    }
    for (int i = tid; i < steps * st; i += kThreads) {
      const int t = i / st;
      const int j = i - t * st;
      const long long off = bb + static_cast<long long>(t0 + t) * st + j;
      bs[t][j] = bm[off];
      cs[t][j] = cm[off];
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t][cl];
      const float bv = n < st ? bs[t][n] : 0.0f;
      const float cv = n < st ? cs[t][n] : 0.0f;
      h = exp2f(dtv * a2) * h + (dtv * xs[t][cl]) * bv;
      float yv = h * cv;
#pragma unroll
      for (int off = kTpc / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off, kTpc);
      if (n == 0) ys[t][cl] = yv;
    }
    __syncthreads();
    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int c = i - t * kChannels;
      if (c0 + c < di)
        y[xb + static_cast<long long>(t0 + t) * di + c] = ys[t][c];
    }
  }
}

template <int kTpc>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, void* y, long long b, long long l, long long di,
           long long st, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(b));
  selective_scan_kernel<kTpc><<<grid, kChannels * kTpc, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<int>(l), static_cast<int>(di), static_cast<int>(st));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x/dt/y (b, l, di), bm/cm (b, l, st), a (di, st), all float32 and
// contiguous.
int rt_selective_scan_f32(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* a, void* y, long long b,
                          long long l, long long di, long long st,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || l < 1 || di < 1 || st < 1 || st > kMaxState ||
      b > 65535 || l >= (1LL << 31) || di >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (st <= 1) return launch<1>(x, dt, bm, cm, a, y, b, l, di, st, s);
  if (st <= 2) return launch<2>(x, dt, bm, cm, a, y, b, l, di, st, s);
  if (st <= 4) return launch<4>(x, dt, bm, cm, a, y, b, l, di, st, s);
  if (st <= 8) return launch<8>(x, dt, bm, cm, a, y, b, l, di, st, s);
  if (st <= 16) return launch<16>(x, dt, bm, cm, a, y, b, l, di, st, s);
  return launch<32>(x, dt, bm, cm, a, y, b, l, di, st, s);
}

}  // extern "C"
