// The backward of the mamba-1 selective scan of selective_scan.cu, for
// Hopper (sm_90a), float32.
//
// The backward (rt_selective_scan_bwd_f32) replaces what the reference gets
// from jax.grad of its chunked associative scan (src/repro/models/ssm.py:67).
// With dA_t = exp(dt_t a) and g_t the gradient reaching h_t:
//   g_t = dy_t C_t + dA_{t+1} g_{t+1},  dC_t = sum_c dy_t h_t,
//   dB_t = sum_c g_t dt_t x_t,  dx_t = dt_t sum_n g_t B_t,
//   ddt_t = sum_n g_t (x_t B_t + a dA_t h_{t-1}),
//   dA = sum_{b,t} g_t dA_t h_{t-1} dt_t.
// What bounds it: it reads x, dt, dy and writes dx, ddt (di floats a step
// each), reads the checkpoints and B, C and writes dB, dC: at a
// falcon-mamba-7b train microbatch (B 2, L 4096, di 8192, st 16) 1.38 GB,
// 0.41 ms at 3.35 TB/s.  It needs two exponentials a (step, channel,
// state), one to rebuild h from the checkpoints and one for the decays of
// the reverse walk (2.15e9 there, ~0.5 ms of the special-function lanes),
// and about 150 warp-instructions a (warp, step) in all (~1.2 ms of issue
// there).  What the card shows is neither: at 16 warps an SM the schedulers
// issue about half the time, the rest stalls on the walk's dependent
// shuffles and loads and on the per-thread copies (tools/lm_kernel_bench.py
// --only b9bwd; PERF.md).
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
// Design.  A block of 256 threads serves 256 / kTpc channels of one lane.
// x, dt, dy, B and C come through a ring of two slots of kSub steps each,
// by cp.async: a sub-chunk's copy is in flight while the one before it
// computes, one barrier a sub-chunk, in both passes; pass 1 copies x, dt
// and B only, except for its last two sub-chunks, which stay in their
// slots for pass 2.  The walk's dB and dC terms of kHalf steps meet in
// registers: a transposed butterfly over the warp's channel lanes
// (channel_sums; 7 shuffles a step), the four steps' rounds side by side.
// A warp's sums go to a small static buffer; at the next sub-chunk's
// barrier the block sums them over its warps and writes its partial (B,
// nblk, L, st).  Shared memory is the ring, 2 KB a warp of
// sub-checkpoints and 2 KB a warp of sums, so two blocks fit an SM: 16
// warps at <= 128 registers (the narrow build).  Where the card holds the
// whole grid at one block an SM (hymba-1.5b's d_inner 3200: 100 blocks),
// the wide build runs instead, up to 255 registers a thread, chosen at
// launch from the runtime's occupancy: the walk's registers, not the
// warps, bound it there.
//
// Sums across threads and blocks, none with atomics (two runs give the same
// bits), each in a fixed order.  dx and ddt of a (step, channel): each
// lane's kSpt states in order (sx = sum g B, sa = sum g exp(dt a) h a; dx =
// sx dt, ddt = x sx + sa), then the channel's kTpc lanes in the forward's
// transposed butterfly.  dB and dC of a (step, state): a warp's channels by
// the butterfly over the lane bits above log2(kTpc), highest bit first; then
// the block's warps in warp order; then a second kernel sums the blocks'
// partials in order.  dA: in registers over the steps, last first, then
// over the lanes in order.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; the old design
// took 2.877 ms at falcon's microbatch and 1.421 at hymba-1.5b's di 3200):
// 256-thread blocks beat 128 (2.535 / 1.432 ms), 512 (128 channels, 2.497)
// and 64 or 32 (4.3-5.7) at both train shapes.  Thread-block clusters that
// sum their blocks' partials through distributed shared memory before
// writing one were slower at every size: 2, 4 and 8 blocks 2.419, 4.09 and
// 4.259 ms at falcon against 2.372 for one (a cluster of 8 or 4 needs a
// second wave, and the cluster barrier costs more than the partials'
// bytes it saves).  Holding the sums in registers until the walk's end, or
// all the loads in one warp, or bulk copies of each row (cp.async.bulk, 26
// a sub-chunk), or pass 1 reading x, dt and B from global memory a
// sub-chunk ahead in registers were slower; at falcon's grid 168 or 255
// registers cost more warps than they gave, and at hymba's the narrow
// build's 128 spill.

#include "selective_scan_common.cuh"

namespace {

constexpr int kSub = 8;          // steps the backward keeps in registers
constexpr int kHalf = 4;         // steps whose dB/dC sums meet together

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) p[i] = r[i];
  }
}

constexpr int kThreads = 256;    // a block of the backward

// kTpc threads a channel as in the forward.  A ring slot holds kSub steps
// of x, dt, dy (kChannels each) and of B, C (kWidth each); a block keeps
// two slots, the segment's sub-checkpoints, two sub-chunks of its warps'
// dB/dC sums and the segment's checkpoint.
template <int kTpc>
struct BwdShape {
  static constexpr int kChannels = kThreads / kTpc;
  static constexpr int kWidth = kSpt * kTpc;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kOut = 2 * kWidth;             // dB, dC terms a step
  static constexpr int kSlot = kSub * (3 * kChannels + 2 * kWidth);
  static constexpr int kSubs = kCkptSteps / kSub;     // sub-checkpoints
  static constexpr int kSubFloats = kSubs * kThreads * kSpt;
  static constexpr int kTerms = kSub * kOut;          // (step, term)
  static constexpr int kWsum = kWarps * kTerms;       // (warp, step, term)
  static constexpr int kHck = kChannels * kWidth;
  // the ring, sub-checkpoints and checkpoint in dynamic shared memory, the
  // sums in static arrays of their own (so that the walk's stores to them
  // never hold back the next step's loads from the ring)
  static constexpr int kDynBytes = (2 * kSlot + kSubFloats + kHck) * 4;
  static constexpr int kSmemBytes = kDynBytes + 2 * kWsum * 4;
  static_assert(kCkptSteps % kSub == 0 && kSub % kTpc == 0,
                "sub-chunks tile a segment and hold whole butterflies");
  static_assert(kChannels % 4 == 0 && kThreads % 32 == 0, "16-byte rows");
};

// One round of the transposed butterfly over lane bit `mask`: lanes with
// the bit set keep the upper half of p, the others the lower half, and
// each adds its partner's copy of the half it keeps.
template <int kN>
__device__ __forceinline__ void transpose_round(const float (&p)[kN],
                                                float (&r)[kN / 2], int lane,
                                                int mask) {
  constexpr int m = kN / 2;
  const bool hi = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < m; ++i) {
    const float mine = hi ? p[i + m] : p[i];
    const float other = hi ? p[i] : p[i + m];
    r[i] = mine + __shfl_xor_sync(0xffffffffu, other, mask);
  }
}

// dB/dC values a lane holds a step after channel_sums
template <int kTpc>
constexpr int kLaneOut = kTpc == 8 ? 2 : 1;

// kN steps' dB terms v[s][0, kSpt) and dC terms v[s][kSpt, 2 kSpt) of
// this thread's states, each summed over the warp's 32 / kTpc channels
// (the lane bits above log2(kTpc)) into r[s], the terms channel_slot
// names.  The channel bits are taken highest first: three transposed
// rounds over lane bits 16, 8, 4 halve a step's eight values (dB/dC, then
// the state's upper and lower bit), then plain rounds over lane bits 2 and
// 1 where those are channel bits too (kTpc < 4).  At kTpc 8 lane bit 4 is
// not a channel's, and the two rounds leave two values a lane.  The kN
// steps' shuffles of a round are independent and issue back to back.
template <int kTpc, int kN>
__device__ __forceinline__ void channel_sums(const float (&v)[kN][2 * kSpt],
                                             int lane,
                                             float (&r)[kN][kLaneOut<kTpc>]) {
  static_assert(kSpt == 4, "eight terms a thread a step");
  float v4[kN][4], v2[kN][2];
#pragma unroll
  for (int s = 0; s < kN; ++s) transpose_round<8>(v[s], v4[s], lane, 16);
#pragma unroll
  for (int s = 0; s < kN; ++s) transpose_round<4>(v4[s], v2[s], lane, 8);
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    if constexpr (kTpc == 8) {
      r[s][0] = v2[s][0];
      r[s][1] = v2[s][1];
    } else {
      float v1[1];
      transpose_round<2>(v2[s], v1, lane, 4);
      r[s][0] = v1[0];
    }
  }
  if constexpr (kTpc <= 2) {
#pragma unroll
    for (int s = 0; s < kN; ++s)
      r[s][0] += __shfl_xor_sync(0xffffffffu, r[s][0], 2);
  }
  if constexpr (kTpc == 1) {
#pragma unroll
    for (int s = 0; s < kN; ++s)
      r[s][0] += __shfl_xor_sync(0xffffffffu, r[s][0], 1);
  }
}

// The term (which * kWidth + n) of channel_sums' first value in this lane
// (at kTpc < 4 lanes that differ in the plain rounds' bits hold the same
// sum of the same term)
template <int kTpc>
__device__ __forceinline__ int channel_slot(int lane) {
  if constexpr (kTpc == 8)
    return ((lane >> 4) & 1) * 32 + (lane & 7) * kSpt + ((lane >> 3) & 1) * 2;
  const int w = (lane >> 2) & 7;                   // which * kSpt + i
  return (w >> 2) * kSpt * kTpc + (lane & (kTpc - 1)) * kSpt + (w & 3);
}

// *p = v where `pred`, without a branch (a branch would end the unrolled
// walk's basic block and with it the scheduler's view across steps)
__device__ __forceinline__ void st_global_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(pred)));
}

// One block: kChannels channels of lane b, every step, last segment first.
// dx, ddt (b, l, di) written; pb, pc (B, nblk, l, st) get this block's sum
// of dB, dC over its channels; pa (B, di, st) this lane's dA.  The narrow
// build keeps two blocks an SM (at most 128 registers a thread), the wide
// one (kWide) one (up to 255).
template <int kTpc, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
    selective_scan_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ hck,
        const float* __restrict__ dy, float* __restrict__ dx,
        float* __restrict__ ddt, float* __restrict__ pb,
        float* __restrict__ pc, float* __restrict__ pa, int l, int di,
        int st, int nseg, bool vec_x, bool vec_bc, bool vec_h) {
  using S = BwdShape<kTpc>;
  constexpr int kC = S::kChannels, kW = S::kWidth, kO = S::kOut;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float wsum[2 * S::kWsum];  // 2 x (warp, k, term)
  float* ring = smem;                        // 2 x kSlot
  float* subs = ring + 2 * S::kSlot;         // (kSubs, kThreads, kSpt)
  float* hbuf = subs + S::kSubFloats;        // (kChannels, kWidth)
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int c0 = blk * kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = tid / kTpc;
  const int j = tid - cl * kTpc;
  const int c = c0 + cl;
  const int slot = channel_slot<kTpc>(lane);
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
  // B/C and checkpoint columns past st stay zero (cp.async never writes
  // them), so those states keep h = 0 and add nothing
  if (st < kW) {
    for (int i = tid; i < 2 * 2 * kSub * kW; i += kThreads)
      ring[(i / (2 * kSub * kW)) * S::kSlot + 3 * kSub * kC +
           i % (2 * kSub * kW)] = 0.0f;
    for (int i = tid; i < S::kHck; i += kThreads) hbuf[i] = 0.0f;
  }
  __syncthreads();

  // Sub-chunk u (steps seg * kCkptSteps + u * kSub on) into ring slot
  // (u + seg) & 1 as one cp.async group: x, dt and B, and dy and C if
  // `full` (pass 2 reads them); `with_h` also the segment's checkpoint.
  auto load = [&](int seg, int u, bool full, bool with_h) {
    const int t0 = seg * kCkptSteps + u * kSub;
    float* xs = ring + ((u + seg) & 1) * S::kSlot;
    float* dts = xs + kSub * kC;
    float* dys = dts + kSub * kC;
    float* bs = dys + kSub * kC;
    float* cs = bs + kSub * kW;
    const long long xrow = xb + static_cast<long long>(t0) * di + c0;
    const long long brow = bb + static_cast<long long>(t0) * st;
    if (vec_x) {
      constexpr int kQ = kC / 4;                   // 16-byte words a row
      for (int i = tid; i < kSub * kQ; i += kThreads) {
        const int t = i / kQ;
        const int w = i - t * kQ;
        const bool in = t0 + t < l && c0 + 4 * w < di;
        const long long off =
            in ? xrow + static_cast<long long>(t) * di + 4 * w : 0;
        cp_async<16>(xs + t * kC + 4 * w, x + off, in);
        cp_async<16>(dts + t * kC + 4 * w, dt + off, in);
        if (full) cp_async<16>(dys + t * kC + 4 * w, dy + off, in);
      }
    } else {
      for (int i = tid; i < kSub * kC; i += kThreads) {
        const int t = i / kC;
        const int cc = i - t * kC;
        const bool in = t0 + t < l && c0 + cc < di;
        const long long off =
            in ? xrow + static_cast<long long>(t) * di + cc : 0;
        cp_async<4>(xs + i, x + off, in);
        cp_async<4>(dts + i, dt + off, in);
        if (full) cp_async<4>(dys + i, dy + off, in);
      }
    }
    if (vec_bc) {
      constexpr int kQ = kW / 4;       // columns past st are zero-filled
      for (int i = tid; i < kSub * kQ; i += kThreads) {
        const int t = i / kQ;
        const int w = i - t * kQ;
        const bool in = t0 + t < l && 4 * w < st;
        const long long off = in ? brow + t * st + 4 * w : 0;
        cp_async<16>(bs + t * kW + 4 * w, bm + off, in);
        if (full) cp_async<16>(cs + t * kW + 4 * w, cm + off, in);
      }
    } else {
      for (int i = tid; i < kSub * st; i += kThreads) {
        const int t = i / st;
        const int n = i - t * st;
        const bool in = t0 + t < l;
        const long long off = in ? brow + i : 0;
        cp_async<4>(bs + t * kW + n, bm + off, in);
        if (full) cp_async<4>(cs + t * kW + n, cm + off, in);
      }
    }
    if (with_h) {
      const long long hb =
          ((static_cast<long long>(b) * nseg + seg) * di + c0) * st;
      if (vec_h) {
        constexpr int kQ = kW / 4;
        for (int i = tid; i < kC * kQ; i += kThreads) {
          const int cc = i / kQ;
          const int w = i - cc * kQ;
          const bool in = c0 + cc < di && 4 * w < st;
          cp_async<16>(hbuf + cc * kW + 4 * w,
                       hck + (in ? hb + cc * st + 4 * w : 0), in);
        }
      } else {
        for (int i = tid; i < kC * st; i += kThreads) {
          const int cc = i / st;
          const int n = i - cc * st;
          const bool in = c0 + cc < di;
          cp_async<4>(hbuf + cc * kW + n, hck + (in ? hb + i : 0), in);
        }
      }
    }
    cp_commit();
  };

  // the warps' sums of sub-chunk parity p (steps t0 on), in warp order,
  // to this block's partial
  auto block_sum = [&](int p, int t0) {
    const float* ws = wsum + p * S::kWsum;
    for (int i = tid; i < S::kTerms; i += kThreads) {
      const int k = i / kO;
      const int o = i - k * kO;
      const int which = o >= kW;
      const int n = o - which * kW;
      const int t = t0 + k;
      if (n < st && t < l) {
        float s = ws[i];
#pragma unroll
        for (int w = 1; w < S::kWarps; ++w) s += ws[w * S::kTerms + i];
        (which ? pc : pb)[((static_cast<long long>(b) * nblk + blk) * l + t) *
                              st + n] = s;
      }
    }
  };

  // sub-chunks with a step < l in segment seg
  auto subchunks = [&](int seg) {
    return (min(kCkptSteps, l - seg * kCkptSteps) + kSub - 1) / kSub;
  };

  // The ring walks pass 1 of a segment (sub-chunks 0 .. n-1), then pass 2
  // (n-1 .. 0; n-1 and n-2 are still in their slots), then the next
  // segment's pass 1.  At each sub-chunk one barrier: its copies have
  // landed and everyone is done with the slot the next copy goes to; that
  // copy then runs while this sub-chunk computes.
  load(nseg - 1, 0, subchunks(nseg - 1) <= 2, true);
  int it = 0;                      // pass-2 sub-chunks done
  int prev_t0 = 0;                 // the first step of the last of them
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int s0 = seg * kCkptSteps;
    const int n = subchunks(seg);
    // pass 1: from the checkpoint forward, h entering every sub-chunk to
    // subs (each thread its own kSpt states: no barrier needed)
    float h[kSpt];
    for (int u = 0; u < n; ++u) {
      cp_wait<0>();
      __syncthreads();
      if (u + 1 < n) load(seg, u + 1, u + 1 >= n - 2, false);
      const float* xs = ring + ((u + seg) & 1) * S::kSlot;
      const float* dts = xs + kSub * kC;
      const float* bs = dts + 2 * kSub * kC;
      if (u == 0) load_vec<kSpt>(hbuf + cl * kW + j * kSpt, h);
      store_vec<kSpt>(subs + (u * kThreads + tid) * kSpt, h);
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float dtv = dts[k * kC + cl];
        const float dtx = dtv * xs[k * kC + cl];
        float bv[kSpt];
        load_vec<kSpt>(bs + k * kW + j * kSpt, bv);
#pragma unroll
        for (int i = 0; i < kSpt; ++i)
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bv[i]);
      }
    }
    // pass 2: the sub-chunks in reverse
    for (int u = n - 1; u >= 0; --u) {
      cp_wait<0>();
      __syncthreads();
      if (u > 0) {
        if (u - 1 < n - 2) load(seg, u - 1, true, false);
      } else if (seg > 0) {
        load(seg - 1, 0, false, true);
      }
      if (it > 0)                  // the last sub-chunk's sums, whose
        block_sum((it - 1) & 1, prev_t0);  // warps' writes the barrier ended
      const float* xs = ring + ((u + seg) & 1) * S::kSlot;
      const float* dts = xs + kSub * kC;
      const float* dys = dts + kSub * kC;
      const float* bs = dys + kSub * kC;
      const float* cs = bs + kSub * kW;
      const int tu = s0 + u * kSub;          // the sub-chunk's first step
      // rebuild h and the decays of the sub-chunk from its checkpoint
      float hs[kSub + 1][kSpt], da[kSub][kSpt];
      load_vec<kSpt>(subs + (u * kThreads + tid) * kSpt, hs[0]);
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float dtv = dts[k * kC + cl];
        const float dtx = dtv * xs[k * kC + cl];
        float bv[kSpt];
        load_vec<kSpt>(bs + k * kW + j * kSpt, bv);
#pragma unroll
        for (int i = 0; i < kSpt; ++i) {
          da[k][i] = ex2(dtv * a2[i]);
          hs[k + 1][i] = fmaf(da[k][i], hs[k][i], dtx * bv[i]);
        }
      }
      // the reverse walk: g = dy C + exp(dt[t+1] a) g[t+1], in halves of
      // kHalf steps; a half's dB/dC terms meet in the butterfly side by
      // side once the half is walked (the registers of its states and
      // decays hold them), so the shuffles' latency is paid once a half
      float* ws = wsum + (it & 1) * S::kWsum + warp * S::kTerms + slot;
      float pdx[kTpc], pddt[kTpc];
#pragma unroll
      for (int k0 = kSub - kHalf; k0 >= 0; k0 -= kHalf) {
        float v[kHalf][2 * kSpt];
#pragma unroll
        for (int k = k0 + kHalf - 1; k >= k0; --k) {
          const float dtv = dts[k * kC + cl];
          const float xv = xs[k * kC + cl];
          const float dyv = dys[k * kC + cl];
          const float dtx = dtv * xv;
          float bv[kSpt], cv[kSpt];
          load_vec<kSpt>(bs + k * kW + j * kSpt, bv);
          load_vec<kSpt>(cs + k * kW + j * kSpt, cv);
          float sx = 0.0f, sa = 0.0f;
#pragma unroll
          for (int i = 0; i < kSpt; ++i) {
            const float g = fmaf(dyv, cv[i], q[i]);
            const float e = g * (da[k][i] * hs[k][i]);  // g exp(dt a) h[t-1]
            sx = fmaf(g, bv[i], sx);
            sa = fmaf(e, av[i], sa);
            dacc[i] = fmaf(e, dtv, dacc[i]);
            v[k - k0][i] = g * dtx;                     // dB's term
            v[k - k0][kSpt + i] = dyv * hs[k + 1][i];   // dC's term
            q[i] = da[k][i] * g;
          }
          pdx[k % kTpc] = sx * dtv;
          pddt[k % kTpc] = fmaf(xv, sx, sa);
          // dx and ddt: a channel's kTpc lanes meet in the transposed
          // butterfly, lane j keeping step j of every kTpc
          if (k % kTpc == 0) {
            const float vx = transpose_sum<kTpc>(pdx, j);
            const float vt = transpose_sum<kTpc>(pddt, j);
            const int t = tu + k + j;
            const long long o = xb + static_cast<long long>(t) * di + c;
            st_global_if(dx + o, vx, t < l && c < di);
            st_global_if(ddt + o, vt, t < l && c < di);
          }
        }
        float r[kHalf][kLaneOut<kTpc>];
        channel_sums<kTpc>(v, lane, r);
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          if constexpr (kTpc == 8)
            *reinterpret_cast<float2*>(ws + (k0 + k) * kO) =
                make_float2(r[k][0], r[k][1]);
          else                   // at kTpc < 4 copies write the same bits
            ws[(k0 + k) * kO] = r[k][0];
        }
      }
      prev_t0 = tu;
      ++it;
    }
  }
  __syncthreads();
  block_sum((it - 1) & 1, prev_t0);
#pragma unroll
  for (int i = 0; i < kSpt; ++i)
    if (c < di && j * kSpt + i < st)
      pa[(static_cast<long long>(b) * di + c) * st + j * kSpt + i] = dacc[i];
}

// The partials summed in a fixed order: dB, dC over the blocks, dA over
// the lanes.  One thread an output.
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
    float sb = pb[off], sc = pc[off];
    for (int k = 1; k < nblk; ++k) {
      sb += pb[off + k * lst];
      sc += pc[off + k * lst];
    }
    db[i] = sb;
    dc[i] = sc;
  }
  if (i < dist) {
    float s = pa[i];
    for (int b = 1; b < bsz; ++b) s += pa[b * dist + i];
    da[i] = s;
  }
}

// The backward's build at b lanes of di channels: the wide one where the
// card holds the whole grid at once with it.  *wide says which, *per_sm
// that build's blocks resident on an SM.
template <int kTpc>
cudaError_t pick_build(int b, int di, bool* wide, int* per_sm) {
  using S = BwdShape<kTpc>;
  const auto prepare = [](auto kernel) {   // the shared memory it asks for
    if (S::kSmemBytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDynBytes);
  };
  cudaError_t e = prepare(selective_scan_bwd_kernel<kTpc, true>);
  if (e == cudaSuccess)
    e = prepare(selective_scan_bwd_kernel<kTpc, false>);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, selective_scan_bwd_kernel<kTpc, true>, kThreads,
        S::kDynBytes);
  if (e != cudaSuccess) return e;
  const long long nblk = (di + S::kChannels - 1) / S::kChannels;
  *wide = static_cast<long long>(*per_sm) * sms >= nblk * b;
  if (*wide) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, selective_scan_bwd_kernel<kTpc, false>, kThreads, S::kDynBytes);
}

template <int kTpc>
int launch_bwd(const float* x, const float* dt, const float* bm,
               const float* cm, const float* a, const float* hck,
               const float* dy, float* dx, float* ddt, float* db, float* dc,
               float* da, float* pb, float* pc, float* pa, int b, int l,
               int di, int st, cudaStream_t s) {
  using S = BwdShape<kTpc>;
  const bool vec_x = di % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(dt) |
                                     reinterpret_cast<uintptr_t>(dy)) %
                                            16 == 0;
  const bool vec_bc = st % 4 == 0 && (reinterpret_cast<uintptr_t>(bm) |
                                      reinterpret_cast<uintptr_t>(cm)) %
                                             16 == 0;
  const bool vec_h = st % 4 == 0 && reinterpret_cast<uintptr_t>(hck) % 16 == 0;
  const int nseg = (l + kCkptSteps - 1) / kCkptSteps;
  const int nblk = (di + S::kChannels - 1) / S::kChannels;
  bool wide = false;
  int per_sm = 0;
  cudaError_t e = pick_build<kTpc>(b, di, &wide, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(b));
  const auto kernel = wide ? selective_scan_bwd_kernel<kTpc, true>
                           : selective_scan_bwd_kernel<kTpc, false>;
  kernel<<<grid, kThreads, S::kDynBytes, s>>>(x, dt, bm, cm, a, hck, dy, dx,
                                              ddt, pb, pc, pa, l, di, st,
                                              nseg, vec_x, vec_bc, vec_h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lst = static_cast<long long>(l) * st;
  const long long dist = static_cast<long long>(di) * st;
  const long long outs = b * lst > dist ? b * lst : dist;
  selective_scan_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256,
                              0, s>>>(pb, pc, pa, db, dc, da, b, nblk, lst,
                                      dist);
  return static_cast<int>(cudaGetLastError());
}

// The backward's layout as the runtime sees it at b lanes of di channels:
// out[0] a block's shared memory in bytes, out[1] the blocks of the build
// it launches resident on an SM at once, out[2] 1 for the wide build.
template <int kTpc>
int occupancy_bwd(int b, int di, int* out) {
  bool wide = false;
  const cudaError_t e = pick_build<kTpc>(b, di, &wide, &out[1]);
  out[0] = BwdShape<kTpc>::kSmemBytes;
  out[2] = wide;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// The gradients of y = scan(x, dt, bm, cm, a) for the cotangent dy (b, l,
// di): dx, ddt (b, l, di), db, dc (b, l, st), da (di, st), from hck as
// rt_selective_scan_ckpt_f32 wrote it.  Workspace: pb, pc (b, nblk, l, st)
// and pa (b, di, st), nblk = ceil(di / (256 / tpc)) with tpc the power of
// two that covers st with 4 states a thread.
int rt_selective_scan_bwd_f32(const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, const void* hck,
                              const void* dy, void* dx, void* ddt, void* db,
                              void* dc, void* da, void* pb, void* pc,
                              void* pa, long long b, long long l,
                              long long di, long long st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st)) return static_cast<int>(cudaErrorInvalidValue);
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
            dii = static_cast<int>(di), sti = static_cast<int>(st);
#define RT_BWD(T)                                                        \
  return launch_bwd<T>(xf, dtf, bf, cf, af, hf, dyf, dxf, ddtf, dbf, dcf, \
                       daf, pbf, pcf, paf, bi, li, dii, sti, s)
  if (st <= kSpt) RT_BWD(1);
  if (st <= 2 * kSpt) RT_BWD(2);
  if (st <= 4 * kSpt) RT_BWD(4);
  RT_BWD(8);
#undef RT_BWD
}

// rt_selective_scan_bwd_f32's layout at b lanes, di channels and st
// states: three ints to out (occupancy_bwd).
int rt_selective_scan_bwd_occupancy(long long b, long long di, long long st,
                                    void* out) {
  if (bad_shape(b, 1, di, st)) return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<int*>(out);
  const int bi = static_cast<int>(b), dii = static_cast<int>(di);
  if (st <= kSpt) return occupancy_bwd<1>(bi, dii, o);
  if (st <= 2 * kSpt) return occupancy_bwd<2>(bi, dii, o);
  if (st <= 4 * kSpt) return occupancy_bwd<4>(bi, dii, o);
  return occupancy_bwd<8>(bi, dii, o);
}

}  // extern "C"
