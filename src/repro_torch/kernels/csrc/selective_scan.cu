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
// What bounds it on this card.  Memory sees x, dt and y (di floats a step
// each), B and C (st floats a step each) and a once: at falcon-mamba-7b's
// 32k prefill (di 8192, st 16) 3.2 GB, 0.96 ms at 3.35 TB/s.  The state
// never leaves the chip.  Every (step, channel, state) needs one
// exponential and four float32 operations: 4.3e9 ex2 a layer, ~1.1 ms of
// the SM's 16 special-function lanes a clock, and about as long again of
// instruction issue at one warp-instruction a clock per scheduler.  The
// bytes hide under those; what is left to the design is keeping the
// schedulers issuing.
//
// Design.  A thread owns kSpt = 4 states of one channel and keeps their h
// in registers for all L steps; kTpc threads (kSpt * kTpc >= st) serve a
// channel, a block of 128 threads serves 128 / kTpc channels of one lane.
// Per step a thread reads the step's B and C as one 16-byte broadcast each
// from shared memory and dt and x as two scalar broadcasts, does kSpt ex2
// (exp(dt * a) = exp2(dt * (a * log2 e)), a scaled once) and 4 * kSpt + 1
// float32 operations, and sums its part of y in registers.  The kTpc parts
// of y meet in a transposed butterfly: over kTpc steps, log2(kTpc) rounds
// of shuffles halve the values a thread holds, and each thread ends with
// the whole y of one of those steps, so a step costs (kTpc - 1) / kTpc
// shuffles instead of log2(kTpc), and the y stores of a warp cover kTpc
// rows of contiguous channels.  x, dt, B and C reach shared memory in
// chunks of 128 steps (at st 16; 96 KB a block, two blocks an SM) through
// cp.async, double-buffered: the next chunk is in flight while the current
// one computes, and a chunk's copies and two barriers are paid once a 128
// steps.  Steps past L are zero-filled:
// dt = 0 leaves h as it was, and their y is not stored.  kUnroll = 8 groups
// of kTpc steps are unrolled (32 steps at st 16), so the scheduler finds
// independent ex2 and loads of later steps behind each dependent one: at B
// = 1 the layout gives 1024 warps, two a scheduler, too few to hide the
// latencies by themselves.
//
// Why no split of L.  More warps would come from splitting L into chunks
// with a carry pass, but the carry's correction of y needs the per-step
// decays exp(a * cumsum dt) a second time, doubling the exponentials and
// the issue that bound the kernel.  Measured instead (tools/
// lm_kernel_bench.py): 2 states a thread (four warps a scheduler, more
// instructions a state), 8 states a thread (one warp a scheduler), two
// channels a thread, a quarter or half of the exponentials on the FMA
// pipe (a degree-5 polynomial) and y summed through shared memory were all
// slower.
//
// Any B, L >= 1, di >= 1 and 1 <= st <= 32 work; the TPU kernel's tile and
// chunk divisibility does not apply.  Launches on the given stream and
// returns cudaGetLastError().
//
// The backward kernel of this scan is in selective_scan_bwd.cu; both take
// the helpers and constants of selective_scan_common.cuh.

#include "selective_scan_common.cuh"

namespace {

constexpr int kThreads = 128;    // a block of the forward
constexpr int kUnroll = 8;       // groups of kTpc steps unrolled

// kTpc threads a channel; a block of 128 threads serves 128 / kTpc
// channels.
template <int kTpc>
struct Shape {
  static constexpr int kChannels = kThreads / kTpc;       // of one block
  static constexpr int kWidth = kSpt * kTpc;              // B/C row, padded
  // steps a chunk: 4096 channel-steps of x and of dt, 16..128 steps
  static constexpr int kSteps =
      4096 / kChannels < 16 ? 16 : (4096 / kChannels > 128 ? 128
                                                           : 4096 / kChannels);
  static constexpr int kStage = kSteps * (2 * kChannels + 2 * kWidth);
  static constexpr int kSmemBytes = 2 * kStage * 4;
};

// kCkpt: also write h as it enters every kCkptSteps-th step to hck (B,
// nseg, di, st), the checkpoints the backward restarts from
template <int kTpc, bool kCkpt>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, float* __restrict__ y,
    float* __restrict__ hck, int l, int di, int st, int nseg, bool vec_x,
    bool vec_bc) {
  using S = Shape<kTpc>;
  constexpr int kC = S::kChannels, kW = S::kWidth, kK = S::kSteps;
  static_assert(kCkptSteps % kK == 0, "a chunk never straddles a segment");
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kC;
  const int tid = threadIdx.x;
  const int cl = tid / kTpc;              // channel within the block
  const int j = tid - cl * kTpc;          // part of the channel's states
  const int c = c0 + cl;
  const long long xb = static_cast<long long>(b) * l * di;
  const long long bb = static_cast<long long>(b) * l * st;

  float a2[kSpt], h[kSpt];
#pragma unroll
  for (int i = 0; i < kSpt; ++i) {
    const int n = j * kSpt + i;
    a2[i] = c < di && n < st ? a[static_cast<long long>(c) * st + n] * kLog2e
                             : 0.0f;
    h[i] = 0.0f;
  }
  // B/C columns past st stay zero in both stages (cp.async never writes
  // them), so those states keep h = 0
  if (st < kW) {
    for (int i = tid; i < 2 * 2 * kK * kW; i += kThreads) {
      const int stage = i / (2 * kK * kW);
      smem[stage * S::kStage + 2 * kK * kC + i % (2 * kK * kW)] = 0.0f;
    }
    __syncthreads();
  }

  auto load_chunk = [&](int t0, int stage) {
    float* xs = smem + stage * S::kStage;
    float* dts = xs + kK * kC;
    float* bs = dts + kK * kC;
    float* cs = bs + kK * kW;
    if (vec_x) {
      constexpr int kQ = kC / 4;                  // 16-byte words a row
      for (int i = tid; i < kK * kQ; i += kThreads) {
        const int t = i / kQ;
        const int w = i - t * kQ;
        const bool in = t0 + t < l && c0 + 4 * w < di;
        const long long off =
            in ? xb + static_cast<long long>(t0 + t) * di + c0 + 4 * w : 0;
        cp_async<16>(xs + t * kC + 4 * w, x + off, in);
        cp_async<16>(dts + t * kC + 4 * w, dt + off, in);
      }
    } else {
      for (int i = tid; i < kK * kC; i += kThreads) {
        const int t = i / kC;
        const int cc = i - t * kC;
        const bool in = t0 + t < l && c0 + cc < di;
        const long long off =
            in ? xb + static_cast<long long>(t0 + t) * di + c0 + cc : 0;
        cp_async<4>(xs + i, x + off, in);
        cp_async<4>(dts + i, dt + off, in);
      }
    }
    if (vec_bc) {
      const int q = st / 4;
      for (int i = tid; i < kK * q; i += kThreads) {
        const int t = i / q;
        const int w = i - t * q;
        const bool in = t0 + t < l;
        const long long off =
            in ? bb + static_cast<long long>(t0 + t) * st + 4 * w : 0;
        cp_async<16>(bs + t * kW + 4 * w, bm + off, in);
        cp_async<16>(cs + t * kW + 4 * w, cm + off, in);
      }
    } else {
      for (int i = tid; i < kK * st; i += kThreads) {
        const int t = i / st;
        const int n = i - t * st;
        const bool in = t0 + t < l;
        const long long off =
            in ? bb + static_cast<long long>(t0 + t) * st + n : 0;
        cp_async<4>(bs + t * kW + n, bm + off, in);
        cp_async<4>(cs + t * kW + n, cm + off, in);
      }
    }
    cp_commit();
  };

  const int chunks = (l + kK - 1) / kK;
  load_chunk(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kK;
    if (ch + 1 < chunks) {
      load_chunk(t0 + kK, (ch + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                      // chunk ch is in shared memory
    if constexpr (kCkpt) {
      if (t0 % kCkptSteps == 0 && c < di) {
        float* hp = hck + ((static_cast<long long>(b) * nseg +
                            t0 / kCkptSteps) * di + c) * st;
#pragma unroll
        for (int i = 0; i < kSpt; ++i)
          if (j * kSpt + i < st) hp[j * kSpt + i] = h[i];
      }
    }
    const float* xs = smem + (ch & 1) * S::kStage;
    const float* dts = xs + kK * kC;
    const float* bs = dts + kK * kC;
    const float* cs = bs + kK * kW;
    // y of step t0 + t + j of channel c, kTpc rows apart a round
    float* yp = y + xb + static_cast<long long>(t0 + j) * di + c;
    const long long ystep = static_cast<long long>(kTpc) * di;
#pragma unroll (kUnroll)
    for (int t = 0; t < kK; t += kTpc, yp += ystep) {
      float p[kTpc];
#pragma unroll
      for (int k = 0; k < kTpc; ++k) {
        const int tt = t + k;
        const float dtv = dts[tt * kC + cl];
        const float dtx = dtv * xs[tt * kC + cl];
        float bv[kSpt], cv[kSpt];
        load_vec<kSpt>(bs + tt * kW + j * kSpt, bv);
        load_vec<kSpt>(cs + tt * kW + j * kSpt, cv);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kSpt; ++i) {
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bv[i]);
          acc = fmaf(h[i], cv[i], acc);
        }
        p[k] = acc;
      }
      const float yv = transpose_sum<kTpc>(p, j);
      if (t0 + t + j < l && c < di) *yp = yv;
    }
    __syncthreads();                      // stage ch & 1 may be refilled
  }
}

template <int kTpc, bool kCkpt>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, float* y, float* hck, int b, int l, int di,
           int st, cudaStream_t s) {
  using S = Shape<kTpc>;
  auto kern = selective_scan_kernel<kTpc, kCkpt>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec_x = di % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(dt)) %
                                            16 == 0;
  const bool vec_bc = st % 4 == 0 && (reinterpret_cast<uintptr_t>(bm) |
                                      reinterpret_cast<uintptr_t>(cm)) %
                                             16 == 0;
  const dim3 grid(static_cast<unsigned>((di + S::kChannels - 1) /
                                        S::kChannels),
                  static_cast<unsigned>(b));
  const int nseg = (l + kCkptSteps - 1) / kCkptSteps;
  kern<<<grid, kThreads, S::kSmemBytes, s>>>(x, dt, bm, cm, a, y, hck, l,
                                              di, st, nseg, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCkpt>
int forward(const void* x, const void* dt, const void* bm, const void* cm,
            const void* a, void* y, void* hck, long long b, long long l,
            long long di, long long st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(hck);
  const int bi = static_cast<int>(b), li = static_cast<int>(l),
            dii = static_cast<int>(di), sti = static_cast<int>(st);
  // kTpc: the power of two that covers st with kSpt states a thread
  if (st <= kSpt)
    return launch<1, kCkpt>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, s);
  if (st <= 2 * kSpt)
    return launch<2, kCkpt>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, s);
  if (st <= 4 * kSpt)
    return launch<4, kCkpt>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, s);
  return launch<8, kCkpt>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, s);
}

}  // namespace


extern "C" {

// x/dt/y (b, l, di), bm/cm (b, l, st), a (di, st), all float32 and
// contiguous.
int rt_selective_scan_f32(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* a, void* y, long long b,
                          long long l, long long di, long long st,
                          void* stream) {
  return forward<false>(x, dt, bm, cm, a, y, nullptr, b, l, di, st, stream);
}

// The same, and h entering every 128th step (from step 0) to hck (b,
// ceil(l / 128), di, st): the forward the backward needs.
int rt_selective_scan_ckpt_f32(const void* x, const void* dt, const void* bm,
                               const void* cm, const void* a, void* y,
                               void* hck, long long b, long long l,
                               long long di, long long st, void* stream) {
  return forward<true>(x, dt, bm, cm, a, y, hck, b, l, di, st, stream);
}

}  // extern "C"
