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
// The backward (rt_selective_scan_bwd_f32) replaces what the reference gets
// from jax.grad of its chunked associative scan (src/repro/models/ssm.py:67).
// With dA_t = exp(dt_t a) and g_t the gradient reaching h_t:
//   g_t = dy_t C_t + dA_{t+1} g_{t+1},  dC_t = sum_c dy_t h_t,
//   dB_t = sum_c g_t dt_t x_t,  dx_t = dt_t sum_n g_t B_t,
//   ddt_t = sum_n g_t (x_t B_t + a dA_t h_{t-1}),
//   dA = sum_{b,t} g_t dA_t h_{t-1} dt_t.
// What bounds it: it reads x, dt, dy and writes dx, ddt (di floats a step
// each), reads the checkpoints and B, C, writes dB/dC partials; and it needs
// two exponentials a (step, channel, state), one to rebuild h from the
// checkpoints and one for the decays of the reverse walk.
//
// h in reverse time.  Keeping every h is (B, L, di, st) floats, 4.3 GB a
// layer at a falcon-mamba train microbatch; running the recurrence backwards
// divides by exp(dt a), which underflows.  So the autograd forward
// (rt_selective_scan_ckpt_f32, the forward kernel with kCkpt) writes h as it
// enters every kCkptSteps-th step, 1/128 of that, and the backward takes
// the segments last first: from the segment's checkpoint it runs the
// forward's own recurrence (the same ex2 and fmaf, so the same bits) and
// keeps h entering every kSub-th step in shared memory (pass 1); then it
// takes the sub-chunks last first, rebuilds each one's kSub states and
// decays in registers and walks them in reverse, carrying
// q = dA_{t+1} g_{t+1} across sub-chunks and segments.
//
// Sums across threads and blocks, none with atomics (two runs give the same
// bits).  dx and ddt sum over a channel's states: the kTpc lanes meet in
// the forward's transposed butterfly.  dB and dC sum over channels, spread
// over lanes and blocks: each sub-chunk's per-lane terms go to shared
// memory and are summed in channel order into a per-block partial
// (B, nblk, L, st); a second kernel sums the partials in block order.  dA
// sums over B and L: in registers over L, then over B through a (B, di, st)
// partial that the second kernel sums in order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 32;
constexpr int kSpt = 4;          // states a thread
constexpr int kUnroll = 8;       // groups of kTpc steps unrolled
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCkptSteps = 128;  // steps between the backward's checkpoints
constexpr int kSub = 8;          // steps the backward keeps in registers

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

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

// kTpc threads a channel as in the forward; a stage holds kSteps steps of
// x, dt, dy (kChannels each) and of B, C (kWidth each)
template <int kTpc>
struct BwdShape {
  static constexpr int kChannels = kThreads / kTpc;
  static constexpr int kWidth = kSpt * kTpc;
  // 2048 channel-steps of each channel array, 16..64 steps
  static constexpr int kSteps =
      2048 / kChannels < 2 * kSub ? 2 * kSub
                                  : (2048 / kChannels > 64 ? 64
                                                           : 2048 / kChannels);
  static constexpr int kStage = kSteps * (3 * kChannels + 2 * kWidth);
  static constexpr int kSubs = kCkptSteps / kSub;   // sub-checkpoints
  static constexpr int kSubFloats = kSubs * kThreads * kSpt;
  static constexpr int kRedFloats = kSub * kThreads * kSpt;  // dB or dC
  static constexpr int kSmemBytes =
      (kStage + kSubFloats + 2 * kRedFloats) * 4;
  static_assert(kCkptSteps % kSteps == 0 && kSteps % kSub == 0,
                "stages tile a segment and sub-chunks tile a stage");
  static_assert(kSub % kTpc == 0, "a sub-chunk holds whole butterflies");
};

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) p[i] = r[i];
  }
}

// One block: kChannels channels of lane b, every step, last segment first.
// dx, ddt (b, l, di) written; pb, pc (B, nblk, l, st) get this block's sum
// of dB, dC over its channels; pa (B, di, st) this lane's dA.
template <int kTpc>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ hck,
    const float* __restrict__ dy, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pb, float* __restrict__ pc,
    float* __restrict__ pa, int l, int di, int st, int nseg, bool vec_x,
    bool vec_bc) {
  using S = BwdShape<kTpc>;
  constexpr int kC = S::kChannels, kW = S::kWidth, kK = S::kSteps;
  constexpr int kLane = kThreads * kSpt;             // floats a step of red
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* dts = xs + kK * kC;
  float* dys = dts + kK * kC;
  float* bs = dys + kK * kC;
  float* cs = bs + kK * kW;
  float* subs = smem + S::kStage;           // (kSubs, kThreads, kSpt)
  float* red = subs + S::kSubFloats;        // (2, kSub, kThreads * kSpt)
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int c0 = blk * kC;
  const int tid = threadIdx.x;
  const int cl = tid / kTpc;
  const int j = tid - cl * kTpc;
  const int c = c0 + cl;
  const long long xb = static_cast<long long>(b) * l * di;
  const long long bb = static_cast<long long>(b) * l * st;

  float av[kSpt], a2[kSpt], q[kSpt], dacc[kSpt];
#pragma unroll
  for (int i = 0; i < kSpt; ++i) {
    const int n = j * kSpt + i;
    av[i] = c < di && n < st ? a[static_cast<long long>(c) * st + n] : 0.0f;
    a2[i] = av[i] * kLog2e;              // the forward's exponent, bit for bit
    q[i] = 0.0f;                         // exp(dt[t+1] a) g[t+1]
    dacc[i] = 0.0f;
  }
  // B/C columns past st stay zero (cp.async never writes them)
  if (st < kW)
    for (int i = tid; i < 2 * kK * kW; i += kThreads) bs[i] = 0.0f;

  auto load_stage = [&](int t0) {
    __syncthreads();                      // nobody reads the stage any more
    if (vec_x) {
      constexpr int kQ = kC / 4;
      for (int i = tid; i < kK * kQ; i += kThreads) {
        const int t = i / kQ;
        const int w = i - t * kQ;
        const bool in = t0 + t < l && c0 + 4 * w < di;
        const long long off =
            in ? xb + static_cast<long long>(t0 + t) * di + c0 + 4 * w : 0;
        cp_async<16>(xs + t * kC + 4 * w, x + off, in);
        cp_async<16>(dts + t * kC + 4 * w, dt + off, in);
        cp_async<16>(dys + t * kC + 4 * w, dy + off, in);
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
        cp_async<4>(dys + i, dy + off, in);
      }
    }
    if (vec_bc) {
      const int qn = st / 4;
      for (int i = tid; i < kK * qn; i += kThreads) {
        const int t = i / qn;
        const int w = i - t * qn;
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
    cp_wait<0>();
    __syncthreads();                      // the stage is in shared memory
  };

  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int s0 = seg * kCkptSteps;
    const int seg_steps = min(kCkptSteps, l - s0);
    const int nst = (seg_steps + kK - 1) / kK;   // stages with a step < l
    float h[kSpt];
    {
      const float* hp =
          hck + ((static_cast<long long>(b) * nseg + seg) * di + c) * st;
#pragma unroll
      for (int i = 0; i < kSpt; ++i)
        h[i] = c < di && j * kSpt + i < st ? hp[j * kSpt + i] : 0.0f;
    }
    // pass 1: from the checkpoint forward, h entering every kSub-th step
    // to subs (each thread its own kSpt states: no barrier needed)
    for (int sg = 0; sg < nst; ++sg) {
      load_stage(s0 + sg * kK);
      for (int u = 0; u < kK / kSub; ++u) {
        store_vec<kSpt>(subs + ((sg * (kK / kSub) + u) * kThreads + tid) *
                                   kSpt, h);
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          const int tt = u * kSub + k;
          const float dtv = dts[tt * kC + cl];
          const float dtx = dtv * xs[tt * kC + cl];
          float bv[kSpt];
          load_vec<kSpt>(bs + tt * kW + j * kSpt, bv);
#pragma unroll
          for (int i = 0; i < kSpt; ++i)
            h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bv[i]);
        }
      }
    }
    // pass 2: the stages and their sub-chunks in reverse; the last stage
    // of pass 1 is still in shared memory
    for (int sg = nst - 1; sg >= 0; --sg) {
      if (sg != nst - 1) load_stage(s0 + sg * kK);
      for (int u = kK / kSub - 1; u >= 0; --u) {
        const int tu = s0 + sg * kK + u * kSub;  // the sub-chunk's first step
        if (tu >= l) continue;                   // the same for the block
        // rebuild h and the decays of the sub-chunk from its checkpoint
        float hs[kSub + 1][kSpt], da[kSub][kSpt];
        load_vec<kSpt>(subs + ((sg * (kK / kSub) + u) * kThreads + tid) *
                                  kSpt, hs[0]);
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          const int tt = u * kSub + k;
          const float dtv = dts[tt * kC + cl];
          const float dtx = dtv * xs[tt * kC + cl];
          float bv[kSpt];
          load_vec<kSpt>(bs + tt * kW + j * kSpt, bv);
#pragma unroll
          for (int i = 0; i < kSpt; ++i) {
            da[k][i] = ex2(dtv * a2[i]);
            hs[k + 1][i] = fmaf(da[k][i], hs[k][i], dtx * bv[i]);
          }
        }
        // the reverse walk: g = dy C + exp(dt[t+1] a) g[t+1]
        float pdx[kSub], pddt[kSub];
#pragma unroll
        for (int k = kSub - 1; k >= 0; --k) {
          const int tt = u * kSub + k;
          const float dtv = dts[tt * kC + cl];
          const float xv = xs[tt * kC + cl];
          const float dyv = dys[tt * kC + cl];
          const float dtx = dtv * xv;
          float bv[kSpt], cv[kSpt], gb[kSpt], hc[kSpt];
          load_vec<kSpt>(bs + tt * kW + j * kSpt, bv);
          load_vec<kSpt>(cs + tt * kW + j * kSpt, cv);
          float sx = 0.0f, sdt = 0.0f;
#pragma unroll
          for (int i = 0; i < kSpt; ++i) {
            const float g = fmaf(dyv, cv[i], q[i]);
            const float dh = da[k][i] * hs[k][i];     // exp(dt a) h[t-1]
            sx = fmaf(g, bv[i], sx);
            sdt = fmaf(g, fmaf(av[i], dh, xv * bv[i]), sdt);
            dacc[i] = fmaf(g * dtv, dh, dacc[i]);
            gb[i] = g * dtx;
            hc[i] = dyv * hs[k + 1][i];
            q[i] = da[k][i] * g;
          }
          store_vec<kSpt>(red + k * kLane + tid * kSpt, gb);
          store_vec<kSpt>(red + (kSub + k) * kLane + tid * kSpt, hc);
          pdx[k] = sx * dtv;
          pddt[k] = sdt;
        }
        // dx and ddt: a channel's kTpc lanes meet in the transposed
        // butterfly, lane j keeping step j of every kTpc
#pragma unroll
        for (int g0 = 0; g0 < kSub; g0 += kTpc) {
          float px[kTpc], pt[kTpc];
#pragma unroll
          for (int m = 0; m < kTpc; ++m) {
            px[m] = pdx[g0 + m];
            pt[m] = pddt[g0 + m];
          }
          const float vx = transpose_sum<kTpc>(px, j);
          const float vt = transpose_sum<kTpc>(pt, j);
          const int t = tu + g0 + j;
          if (t < l && c < di) {
            const long long o = xb + static_cast<long long>(t) * di + c;
            dx[o] = vx;
            ddt[o] = vt;
          }
        }
        __syncthreads();                  // the sub-chunk's red is whole
        // dB and dC of the sub-chunk's steps over this block's channels,
        // summed in channel order
        for (int o = tid; o < 2 * kSub * st; o += kThreads) {
          const int which = o / (kSub * st);
          const int r = o - which * kSub * st;
          const int k = r / st;
          const int n = r - k * st;
          const int t = tu + k;
          if (t < l) {
            const float* src = red + (which * kSub + k) * kLane + n;
            float sum = 0.0f;
#pragma unroll 4
            for (int cc = 0; cc < kC; ++cc) sum += src[cc * kW];
            float* dst = which ? pc : pb;
            dst[((static_cast<long long>(b) * nblk + blk) * l + t) * st + n] =
                sum;
          }
        }
        __syncthreads();                  // red may be written again
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSpt; ++i)
    if (c < di && j * kSpt + i < st)
      pa[(static_cast<long long>(b) * di + c) * st + j * kSpt + i] = dacc[i];
}

// The partials summed in a fixed order: dB, dC over the channel blocks,
// dA over the lanes.  One thread an output.
__global__ void selective_scan_bwd_reduce(
    const float* __restrict__ pb, const float* __restrict__ pc,
    const float* __restrict__ pa, float* __restrict__ db,
    float* __restrict__ dc, float* __restrict__ da, int bsz, int nblk,
    long long lst, long long dist) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < bsz * lst) {
    const long long b = i / lst;
    const long long off = b * nblk * lst + (i - b * lst);
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      sb += pb[off + k * lst];
      sc += pc[off + k * lst];
    }
    db[i] = sb;
    dc[i] = sc;
  }
  if (i < dist) {
    float s = 0.0f;
    for (int b = 0; b < bsz; ++b) s += pa[b * dist + i];
    da[i] = s;
  }
}

template <int kTpc>
int launch_bwd(const float* x, const float* dt, const float* bm,
               const float* cm, const float* a, const float* hck,
               const float* dy, float* dx, float* ddt, float* db, float* dc,
               float* da, float* pb, float* pc, float* pa, int b, int l,
               int di, int st, int nblk, cudaStream_t s) {
  using S = BwdShape<kTpc>;
  if (nblk != (di + S::kChannels - 1) / S::kChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = selective_scan_bwd_kernel<kTpc>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec_x = di % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(dt) |
                                     reinterpret_cast<uintptr_t>(dy)) %
                                            16 == 0;
  const bool vec_bc = st % 4 == 0 && (reinterpret_cast<uintptr_t>(bm) |
                                      reinterpret_cast<uintptr_t>(cm)) %
                                             16 == 0;
  const int nseg = (l + kCkptSteps - 1) / kCkptSteps;
  kern<<<dim3(static_cast<unsigned>(nblk), static_cast<unsigned>(b)),
         kThreads, S::kSmemBytes, s>>>(x, dt, bm, cm, a, hck, dy, dx, ddt,
                                       pb, pc, pa, l, di, st, nseg, vec_x,
                                       vec_bc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lst = static_cast<long long>(l) * st;
  const long long dist = static_cast<long long>(di) * st;
  const long long outs = b * lst > dist ? b * lst : dist;
  selective_scan_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256,
                              0, s>>>(pb, pc, pa, db, dc, da, b, nblk, lst,
                                      dist);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long b, long long l, long long di, long long st) {
  return b < 1 || l < 1 || di < 1 || st < 1 || st > kMaxState ||
         b > 65535 || l >= (1LL << 31) || di >= (1LL << 31);
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

// The gradients of y = scan(x, dt, bm, cm, a) for the cotangent dy (b, l,
// di): dx, ddt (b, l, di), db, dc (b, l, st), da (di, st), from hck as
// rt_selective_scan_ckpt_f32 wrote it.  Workspace: pb, pc (b, nblk, l,
// st) and pa (b, di, st), nblk = ceil(di / (128 / tpc)) with tpc the
// power of two that covers st with 4 states a thread (refused unless so).
int rt_selective_scan_bwd_f32(const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, const void* hck,
                              const void* dy, void* dx, void* ddt, void* db,
                              void* dc, void* da, void* pb, void* pc,
                              void* pa, long long b, long long l,
                              long long di, long long st, long long nblk,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st) || nblk < 1 || nblk >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(hck);
  const auto* dyf = static_cast<const float*>(dy);
  auto* dxf = static_cast<float*>(dx);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dbf = static_cast<float*>(db);
  auto* dcf = static_cast<float*>(dc);
  auto* daf = static_cast<float*>(da);
  auto* pbf = static_cast<float*>(pb);
  auto* pcf = static_cast<float*>(pc);
  auto* paf = static_cast<float*>(pa);
  const int bi = static_cast<int>(b), li = static_cast<int>(l),
            dii = static_cast<int>(di), sti = static_cast<int>(st),
            nb = static_cast<int>(nblk);
#define RT_BWD(T)                                                          \
  return launch_bwd<T>(xf, dtf, bf, cf, af, hf, dyf, dxf, ddtf, dbf, dcf,  \
                       daf, pbf, pcf, paf, bi, li, dii, sti, nb, s)
  if (st <= kSpt) RT_BWD(1);
  if (st <= 2 * kSpt) RT_BWD(2);
  if (st <= 4 * kSpt) RT_BWD(4);
  RT_BWD(8);
#undef RT_BWD
}

}  // extern "C"
