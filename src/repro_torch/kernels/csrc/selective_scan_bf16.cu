// The mamba-1 selective scan with a bfloat16 payload, and its backward, for
// Hopper (sm_90a): the reference's ssm_fwd(..., scan_dtype=bfloat16)
// (src/repro/models/ssm.py:67-116).  Per chunk of c = min(chunk, L) steps:
//   da_t = bf16(exp(dt_t a)),  dbx_t = bf16((dt_t x_t) B_t),
//   step 0 takes da'_0 = 1 and dbx'_0 = bf16(dbx_0 + bf16(da_0 bf16(h_in))),
//   h = the states of jax.lax.associative_scan of the combine
//       (a1, b1) o (a2, b2) = (bf16(a1 a2), bf16(bf16(b1 a2) + b2)),
//   y_t = sum_s float(h_t[s]) C_t[s] in float32,
// and the next chunk enters at float(h_last).
//
// Replaces no Pallas kernel: the reference computes this in jnp
// (_selective_scan_chunk, ssm.py:50-64, inside ssm_fwd's lax.scan at
// :97-105) and differentiates it with jax.grad.  It is another function
// than the float32 scan of selective_scan.cu: the tree rounds at other
// places than a step-by-step walk, so every rounding of jax's odd/even
// recursion is reproduced here bit for bit.
//
// The tree as a walk in time.  jax's recursion combines the pairs (0, 1),
// (2, 3), ..., scans those recursively and forms each even position from
// its odd neighbour's prefix.  Its in-place form is Brent-Kung's: after
// the up-sweep position t holds up[t], the tree's product of the 2^D
// elements ending at t (D = trailing zeros of t + 1, bracketed as a
// balanced tree), and the down-sweep gives the state
//   h[t] = up[t].b                            where t + 1 is a power of 2,
//   h[t] = comb_b(h[t - 2^D], up[t])          otherwise.
// Neither depends on the chunk's length, and each needs only earlier
// positions, so one thread walks its (channel, state) lane in time keeping
// the binary counter's entries: up[] and h at the end of each pending run
// of 1, 2, 4, ... steps.  The walk does the recursion's combines and no
// others (n - 1 up-sweep combines and fewer than n down-sweep ones a
// chunk), in the same bracketing, so it gives its bits.
//
// Layout.  Steps come in blocks of 2^kLow: within a block every counter
// level below kLow is known at compile time (the block's steps unrolled,
// its entries in registers); the kUp = 8 - kLow levels above change once a
// block and are updated under predicates from the block's number.  So
// chunks up to 256 steps, the reference's default, are taken (a longer
// chunk is refused).  A thread owns one state of one channel; kTpc threads
// (the power of two >= st) serve a channel.  A block's steps of x, dt (and
// dy), B, C are staged in shared memory, one barrier pair a block of steps.
//
// The forward (rt_selective_scan_bf16, and rt_selective_scan_bf16_ckpt,
// which also writes the float32 state entering every chunk, (B, L / c, di,
// st): the reference's boundary states) keeps h in its register from chunk
// to chunk; y's kTpc parts meet in the transposed butterfly, whose order
// (the states paired from the highest bit of their index down) the plain
// version takes too: y is its bits, so a model's next layer sees the same
// payload roundings.
//
// The backward (rt_selective_scan_bf16_bwd), chunks last first.  Pass 1
// runs the chunk's walk again from its saved entering state and keeps, for
// every block of 8 steps, the up-value and state at its last step (in
// shared memory, as bf16: they are bf16 values).  Pass 2 takes the blocks
// last first: it rebuilds the block's upper entries from those, walks its
// 8 steps forward again keeping every combine's inputs in registers, then
// runs the transposed combines in reverse, in bf16 operations rounded as
// the reference's VJP rounds them: a product's cotangent rounded once, a
// value used twice summed with one bf16 add, the cotangent of a state that
// several later states read summed from the lowest level up (jax's
// transpose adds them level by level).  The cotangents waiting for an
// earlier position sit in one register a counter level (a level never has
// two pending).  The states' cotangent is bf16(dy C), the chunk's last step
// adding the carried one.  Then float32: da's cotangent through exp, dbx's
// through the two products, into dx, ddt, dA and the dB/dC terms.  Sums
// across threads and blocks use no atomics (two runs give the same bits):
// dx and ddt over a channel's lanes in the transposed butterfly; dB and dC
// over a warp's channels by xor shuffles from the low channel bit up, then
// the block's warps in order into one partial a block, then the partials
// in order (a second kernel); dA in a register over the steps, then over
// the lanes in order.
//
// What bounds it.  The forward reads x, dt (di floats a step) and B, C and
// writes y: at falcon-mamba-7b's 32k prefill (di 8192, st 16) 3.2 GB, 0.96
// ms at 3.35 TB/s, as the float32 scan; its 8.4e9 tree combines (each
// three products and an add, every one rounded to bf16 and widened back)
// and the rest are 4.7e10 float32 operations, ~0.7 ms at the 67 TFLOP/s
// float32 peak.  The backward walks every
// chunk twice forwards and once in reverse.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md): 12.8 ms there and 20.0 ms for the backward
// at falcon's train microbatch, set by neither: a block's step is
// latency-bound (the stage's load-and-barrier round trip, the butterfly's
// dependent shuffles), flat across occupancy, and the time follows the
// waves the grid takes.  Both are slower than the float32 scan's kernels.

#include <cuda_bf16.h>

#include <utility>

#include "selective_scan_common.cuh"

namespace {

constexpr int kLevels = 8;             // a chunk of at most 2^8 steps
constexpr int kMaxChunk = 1 << kLevels;
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kFwdLow = 4;             // the forward's blocks of 16 steps
constexpr int kBwdLow = 3;             // the backward's blocks of 8

__host__ __device__ constexpr int ctz_c(int v) {
  int k = 0;
  while (!(v & 1)) {
    v >>= 1;
    ++k;
  }
  return k;
}

template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// round to the nearest bfloat16 (ties to even) and widen back: every value
// of the tree is a bf16 value held in a float
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Pair {
  float a, b;
};

// the combine: the product of two bf16 values is exact in float32, and the
// sum of two is correctly rounded by float32's add then the rounding
__device__ __forceinline__ Pair comb(Pair x, Pair y) {
  return {rnd(x.a * y.a), rnd(rnd(x.b * y.a) + y.b)};
}
__device__ __forceinline__ float comb_b(float f, Pair y) {
  return rnd(rnd(f * y.a) + y.b);
}

// A lane's counter: the low levels' entries (up-value, state at its end)
// and the upper levels', and pin, the state at the step before the block.
template <int kLow>
struct Counter {
  Pair lo[kLow];
  float lof[kLow];
  Pair up[kLevels - kLow];
  float upf[kLevels - kLow];
  float pin;
};

// What the backward keeps of a block's forward walk: ca[r][d], the a of
// step r's carry after d merges (d = D(r) is its up-value's), cb[r] the b
// of its up-value, f[r] its state; for the block's last step the a after
// each upper merge (cu), how many there were (nm) and the state its final
// combine reads (fq, where has_fq).
template <int kLow>
struct BlockRec {
  float ca[1 << kLow][kLow + 1];
  float cb[1 << kLow];
  float f[1 << kLow];
  float cu[kLevels - kLow];
  int nm;
  bool has_fq;
  float fq;
};

// One block (number m of its chunk) of the forward walk over the payload
// (da[r], dbx[r]); first: the chunk's first block, whose step 0 folds h0.
// Writes each step's state to f; kRec also fills rec.  Returns the last
// step's up-value after its upper merges.
template <int kLow, bool kRec>
__device__ __forceinline__ Pair block_fwd(Counter<kLow>& ct, int m,
                                          const float (&da)[1 << kLow],
                                          const float (&dbx)[1 << kLow],
                                          float h0, float (&f)[1 << kLow],
                                          BlockRec<kLow>& rec) {
  constexpr int kB = 1 << kLow;
  constexpr int kUp = kLevels - kLow;
  Pair top{0.0f, 0.0f};
  static_for<kB>([&](auto R) {
    constexpr int r = decltype(R)::value;
    Pair car{da[r], dbx[r]};
    if constexpr (r == 0) {
      if (m == 0) car = Pair{1.0f, rnd(dbx[0] + rnd(da[0] * h0))};
    }
    if constexpr (r < kB - 1) {
      constexpr int D = ctz_c(r + 1);
      static_for<D>([&](auto Dd) {
        constexpr int d = decltype(Dd)::value;
        if constexpr (kRec) rec.ca[r][d] = car.a;
        car = comb(ct.lo[d], car);
      });
      if constexpr (kRec) {
        rec.ca[r][D] = car.a;
        rec.cb[r] = car.b;
      }
      constexpr int rest = (r + 1) & r;
      float fv;
      if constexpr (rest == 0)
        fv = m > 0 ? comb_b(ct.pin, car) : car.b;
      else
        fv = comb_b(ct.lof[ctz_c(rest)], car);
      ct.lo[D] = car;
      ct.lof[D] = fv;
      f[r] = fv;
      if constexpr (kRec) rec.f[r] = fv;
    } else {
      static_for<kLow>([&](auto Dd) {
        constexpr int d = decltype(Dd)::value;
        if constexpr (kRec) rec.ca[r][d] = car.a;
        car = comb(ct.lo[d], car);
      });
      if constexpr (kRec) {
        rec.ca[r][kLow] = car.a;
        rec.cb[r] = car.b;
      }
      // the upper levels: merge with the entries of m's trailing ones
      const int nm = min(__ffs(~m) - 1, kUp);
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k < nm) {
          car = comb(ct.up[k], car);
          if constexpr (kRec) rec.cu[k] = car.a;
        }
      });
      const int restm = (m + 1) & m;
      const int tzr = __ffs(restm) - 1;
      float fq = 0.0f;
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == tzr) fq = ct.upf[k];
      });
      const float fv = restm != 0 ? comb_b(fq, car) : car.b;
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == nm) {
          ct.up[k] = car;
          ct.upf[k] = fv;
        }
      });
      ct.pin = fv;
      f[r] = fv;
      top = car;
      if constexpr (kRec) {
        rec.nm = nm;
        rec.has_fq = restm != 0;
        rec.fq = fq;
      }
    }
  });
  return top;
}

// The transposed block: the states' cotangents g[r] in, the payload's
// cotangents (ga[r], gb[r]) out (step 0 of the chunk: those of (da'_0,
// dbx'_0)); ct the block's entering counter (upper entries and pin);
// sw[k] the cotangent waiting for the state a level-k step's final
// combine read, su[k] the one waiting for the up-value a level-(k+1)
// merge read.
template <int kLow>
__device__ __forceinline__ void block_bwd(const Counter<kLow>& ct, int m,
                                          const BlockRec<kLow>& rec,
                                          const float (&g)[1 << kLow],
                                          float (&sw)[kLevels + 1],
                                          Pair (&su)[kLevels + 1],
                                          float (&ga)[1 << kLow],
                                          float (&gb)[1 << kLow]) {
  constexpr int kB = 1 << kLow;
  constexpr int kUp = kLevels - kLow;
  static_for<kB>([&](auto I) {
    constexpr int r = kB - 1 - decltype(I)::value;
    if constexpr (r < kB - 1) {
      constexpr int D = ctz_c(r + 1);
      float w = g[r];
      static_for<D>([&](auto K) { w = rnd(w + sw[decltype(K)::value]); });
      constexpr int rest = (r + 1) & r;
      float gua = 0.0f;
      if constexpr (rest != 0) {
        gua = rnd(w * rec.f[rest - 1]);
        sw[D] = rnd(w * rec.ca[r][D]);
      } else {
        if (m > 0) {
          gua = rnd(w * ct.pin);
          sw[D] = rnd(w * rec.ca[r][D]);
        }
      }
      float gub = w;
      gua = rnd(gua + su[D].a);
      gub = rnd(gub + su[D].b);
      su[D] = Pair{0.0f, 0.0f};
      static_for<D>([&](auto J) {
        constexpr int d = D - decltype(J)::value;     // D .. 1
        constexpr int p = r - (1 << (d - 1));
        const float ya = rec.ca[r][d - 1];
        su[d - 1] = Pair{rnd(gua * ya), rnd(gub * ya)};
        gua = rnd(rnd(gua * rec.ca[p][d - 1]) + rnd(gub * rec.cb[p]));
      });
      ga[r] = gua;
      gb[r] = gub;
    } else {
      const int nm = rec.nm;
      float w = g[r];
      static_for<kLow>([&](auto K) { w = rnd(w + sw[decltype(K)::value]); });
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k < nm) w = rnd(w + sw[kLow + k]);
      });
      float top_a = rec.ca[r][kLow];
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == nm - 1) top_a = rec.cu[k];
      });
      float gua = 0.0f;
      const float c = rnd(w * top_a);
      if (rec.has_fq) gua = rnd(w * rec.fq);
      float gub = w;
      static_for<kUp + 1>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == nm) {
          if (rec.has_fq) sw[kLow + k] = c;
          gua = rnd(gua + su[kLow + k].a);
          gub = rnd(gub + su[kLow + k].b);
          su[kLow + k] = Pair{0.0f, 0.0f};
        }
      });
      static_for<kUp>([&](auto J) {
        constexpr int j = kUp - 1 - decltype(J)::value;  // kUp - 1 .. 0
        if (j < nm) {
          float ya;
          if constexpr (j == 0)
            ya = rec.ca[r][kLow];
          else
            ya = rec.cu[j - 1];
          su[kLow + j] = Pair{rnd(gua * ya), rnd(gub * ya)};
          gua = rnd(rnd(gua * ct.up[j].a) + rnd(gub * ct.up[j].b));
        }
      });
      static_for<kLow>([&](auto J) {
        constexpr int d = kLow - decltype(J)::value;  // kLow .. 1
        constexpr int p = r - (1 << (d - 1));
        const float ya = rec.ca[r][d - 1];
        su[d - 1] = Pair{rnd(gua * ya), rnd(gub * ya)};
        gua = rnd(rnd(gua * rec.ca[p][d - 1]) + rnd(gub * rec.cb[p]));
      });
      ga[r] = gua;
      gb[r] = gub;
    }
  });
}

// The sums over a channel's kTpc lanes of kB steps' values p: store(step,
// sum) for the steps this lane ends with (the transposed butterfly; where
// kTpc > kB, plain rounds over the lane bits above kB first, and only the
// lanes below kB store).
template <int kTpc, int kB, class Store>
__device__ __forceinline__ void lane_sums(float (&p)[kB], int j,
                                          Store&& store) {
  if constexpr (kTpc <= kB) {
#pragma unroll
    for (int g = 0; g < kB / kTpc; ++g) {
      float q[kTpc];
#pragma unroll
      for (int i = 0; i < kTpc; ++i) q[i] = p[g * kTpc + i];
      store(g * kTpc + j, transpose_sum<kTpc>(q, j));
    }
  } else {
#pragma unroll
    for (int mask = kTpc / 2; mask >= kB; mask /= 2) {
#pragma unroll
      for (int i = 0; i < kB; ++i)
        p[i] += __shfl_xor_sync(0xffffffffu, p[i], mask);
    }
    const float v = transpose_sum<kB>(p, j);
    if (j < kB) store(j, v);
  }
}

// A block of the threads' staged steps: kB rows of kC channels (x, dt and,
// in the backward, dy) and of kTpc states (B, C; zero past st).
template <int kC, int kTpc, int kB>
struct Stage {
  float dt[kB][kC], x[kB][kC], dy[kB][kC];
  float bm[kB][kTpc], cm[kB][kTpc];
};

// Rows t0 .. t0 + nv - 1 of lane b into the stage, zeros past them (dt = 0
// there makes da 1 and dbx 0: steps past a chunk change nothing it keeps).
template <int kThreads, int kC, int kTpc, int kB, bool kDy, bool kC_>
__device__ __forceinline__ void stage_rows(
    Stage<kC, kTpc, kB>& sg, const float* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ dy,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long row0, int nv, int c0, int di, int st) {
  for (int i = threadIdx.x; i < kB * kC; i += kThreads) {
    const int r = i / kC, cc = i - r * kC;
    const bool in = r < nv && c0 + cc < di;
    const long long o = (row0 + r) * di + c0 + cc;
    sg.dt[r][cc] = in ? dt[o] : 0.0f;
    sg.x[r][cc] = in ? x[o] : 0.0f;
    if constexpr (kDy) sg.dy[r][cc] = in ? dy[o] : 0.0f;
  }
  for (int i = threadIdx.x; i < kB * kTpc; i += kThreads) {
    const int r = i / kTpc, s = i - r * kTpc;
    const bool in = r < nv && s < st;
    const long long o = (row0 + r) * st + s;
    sg.bm[r][s] = in ? bm[o] : 0.0f;
    if constexpr (kC_) sg.cm[r][s] = in ? cm[o] : 0.0f;
  }
}

// the payload of a staged block: da = bf16(exp(dt a)), dbx = bf16((dt x) B)
// (ex keeps exp(dt a) in float32 for the backward)
template <int kC, int kTpc, int kB>
__device__ __forceinline__ void payload(const Stage<kC, kTpc, kB>& sg,
                                        int cl, int j, float av,
                                        float (&ex)[kB], float (&da)[kB],
                                        float (&dbx)[kB]) {
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    const float dtv = sg.dt[r][cl];
    ex[r] = expf(dtv * av);
    da[r] = rnd(ex[r]);
    const float dtx = dtv * sg.x[r][cl];
    dbx[r] = rnd(dtx * sg.bm[r][j]);
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

template <int kTpc, bool kCkpt>
__global__ void __launch_bounds__(kFwdThreads) scan_bf16_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, float* __restrict__ y,
    float* __restrict__ hck, int l, int di, int st, int c) {
  constexpr int kC = kFwdThreads / kTpc;
  constexpr int kB = 1 << kFwdLow;
  __shared__ Stage<kC, kTpc, kB> sg;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kC;
  const int cl = threadIdx.x / kTpc;
  const int j = threadIdx.x - cl * kTpc;
  const int ch = c0 + cl;
  const bool live = ch < di && j < st;
  const float av = live ? a[static_cast<long long>(ch) * st + j] : 0.0f;
  const int nch = l / c;
  const int nblk = (c + kB - 1) / kB;
  Counter<kFwdLow> ct;
  BlockRec<kFwdLow> rec;                  // unused: kRec is false
  float h = 0.0f;
  for (int k = 0; k < nch; ++k) {
    if constexpr (kCkpt) {
      if (live)
        hck[((static_cast<long long>(b) * nch + k) * di + ch) * st + j] = h;
    }
    float hlast = 0.0f;
    for (int m = 0; m < nblk; ++m) {
      const int nv = min(kB, c - m * kB);
      const long long row0 = static_cast<long long>(b) * l + k * c + m * kB;
      __syncthreads();
      stage_rows<kFwdThreads, kC, kTpc, kB, false, true>(
          sg, x, dt, nullptr, bm, cm, row0, nv, c0, di, st);
      __syncthreads();
      float ex[kB], da[kB], dbx[kB], f[kB], p[kB];
      payload<kC, kTpc, kB>(sg, cl, j, av, ex, da, dbx);
      block_fwd<kFwdLow, false>(ct, m, da, dbx, h, f, rec);
      // y: products never fused into the butterfly's adds, which pair the
      // states from the highest bit down (kref.state_sum's order): the
      // plain version's bits
#pragma unroll
      for (int r = 0; r < kB; ++r) p[r] = __fmul_rn(f[r], sg.cm[r][j]);
      lane_sums<kTpc, kB>(p, j, [&](int r, float v) {
        if (r < nv && ch < di) y[(row0 + r) * di + ch] = v;
      });
      if (m == nblk - 1) {
#pragma unroll
        for (int r = 0; r < kB; ++r)
          if (r == nv - 1) hlast = f[r];
      }
    }
    h = hlast;
  }
}

template <int kTpc, bool kCkpt>
int launch_fwd(const float* x, const float* dt, const float* bm,
               const float* cm, const float* a, float* y, float* hck, int b,
               int l, int di, int st, int c, cudaStream_t s) {
  constexpr int kC = kFwdThreads / kTpc;
  const dim3 grid(static_cast<unsigned>((di + kC - 1) / kC),
                  static_cast<unsigned>(b));
  scan_bf16_fwd_kernel<kTpc, kCkpt><<<grid, kFwdThreads, 0, s>>>(
      x, dt, bm, cm, a, y, hck, l, di, st, c);
  return static_cast<int>(cudaGetLastError());
}

bool bad_chunk(long long l, long long c) {
  return c < 1 || c > kMaxChunk || l % c != 0;
}

template <bool kCkpt>
int forward(const void* x, const void* dt, const void* bm, const void* cm,
            const void* a, void* y, void* hck, long long b, long long l,
            long long di, long long st, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st) || bad_chunk(l, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(hck);
  const int bi = static_cast<int>(b), li = static_cast<int>(l),
            dii = static_cast<int>(di), sti = static_cast<int>(st),
            ci = static_cast<int>(chunk);
#define RT_FWD(T) \
  return launch_fwd<T, kCkpt>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, \
                              ci, s)
  if (st <= 1) RT_FWD(1);
  if (st <= 2) RT_FWD(2);
  if (st <= 4) RT_FWD(4);
  if (st <= 8) RT_FWD(8);
  if (st <= 16) RT_FWD(16);
  RT_FWD(32);
#undef RT_FWD
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

template <int kTpc>
struct BwdShape {
  static constexpr int kC = kBwdThreads / kTpc;
  static constexpr int kB = 1 << kBwdLow;
  static constexpr int kBlocks = kMaxChunk / kB;   // a chunk's blocks, at most
  static constexpr int kWarps = kBwdThreads / 32;
  // pass 1's block ends: (up.a, up.b, h) of every block, bf16, a thread each
  static constexpr int kEndBytes = kBlocks * 3 * kBwdThreads * 2;
};

// One block: kC channels of lane b, every chunk, last first.  dx, ddt (b,
// l, di) written; pb, pc (B, nblk, l, st) get this block's sums of the dB,
// dC terms over its channels; pa (B, di, st) this lane's dA.
template <int kTpc>
__global__ void __launch_bounds__(kBwdThreads, 1) scan_bf16_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ hck,
    const float* __restrict__ dy, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pb, float* __restrict__ pc,
    float* __restrict__ pa, int l, int di, int st, int c) {
  using S = BwdShape<kTpc>;
  constexpr int kC = S::kC, kB = S::kB, kLow = kBwdLow;
  constexpr int kUp = kLevels - kLow;
  extern __shared__ __align__(16) unsigned char dyn[];
  auto* ends = reinterpret_cast<__nv_bfloat16*>(dyn);   // (block, 3, thread)
  __shared__ Stage<kC, kTpc, kB> sg;
  __shared__ float wsum[S::kWarps][kB][2][kTpc];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk_ch = gridDim.x;
  const int c0 = blk * kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kTpc;
  const int j = tid - cl * kTpc;
  const int ch = c0 + cl;
  const bool live = ch < di && j < st;
  const float av = live ? a[static_cast<long long>(ch) * st + j] : 0.0f;
  const int nch = l / c;
  const int nblk = (c + kB - 1) / kB;
  auto end_at = [&](int m, int which) -> __nv_bfloat16& {
    return ends[(m * 3 + which) * kBwdThreads + tid];
  };
  float dacc = 0.0f;
  float gcarry = 0.0f;         // the cotangent of the state leaving chunk k
  for (int k = nch - 1; k >= 0; --k) {
    const long long rowc = static_cast<long long>(b) * l + k * c;
    const float h0 =
        live ? hck[((static_cast<long long>(b) * nch + k) * di + ch) * st + j]
             : 0.0f;
    // pass 1: the chunk's walk, keeping every block's end
    {
      Counter<kLow> ct;
      BlockRec<kLow> rec;
      for (int m = 0; m < nblk; ++m) {
        const int nv = min(kB, c - m * kB);
        __syncthreads();
        stage_rows<kBwdThreads, kC, kTpc, kB, false, false>(
            sg, x, dt, nullptr, bm, cm, rowc + m * kB, nv, c0, di, st);
        __syncthreads();
        float ex[kB], da[kB], dbx[kB], f[kB];
        payload<kC, kTpc, kB>(sg, cl, j, av, ex, da, dbx);
        // the block's last step: its up-value and state (after the upper
        // merges) are what later blocks' entries hold
        const Pair top = block_fwd<kLow, false>(ct, m, da, dbx, h0, f, rec);
        end_at(m, 0) = __float2bfloat16_rn(top.a);
        end_at(m, 1) = __float2bfloat16_rn(top.b);
        end_at(m, 2) = __float2bfloat16_rn(ct.pin);
      }
    }
    // pass 2: the blocks last first
    float sw[kLevels + 1];
    Pair su[kLevels + 1];
#pragma unroll
    for (int i = 0; i <= kLevels; ++i) {
      sw[i] = 0.0f;
      su[i] = Pair{0.0f, 0.0f};
    }
    float gh0 = 0.0f;
    for (int m = nblk - 1; m >= 0; --m) {
      const int nv = min(kB, c - m * kB);
      const long long row0 = rowc + m * kB;
      __syncthreads();
      stage_rows<kBwdThreads, kC, kTpc, kB, true, true>(
          sg, x, dt, dy, bm, cm, row0, nv, c0, di, st);
      __syncthreads();
      // the block's entering counter, from the ends of earlier blocks
      Counter<kLow> ct;
      static_for<kUp>([&](auto K) {
        constexpr int kk = decltype(K)::value;
        if ((m >> kk) & 1) {
          const int e = ((m >> kk) << kk) - 1;
          ct.up[kk] = Pair{__bfloat162float(end_at(e, 0)),
                           __bfloat162float(end_at(e, 1))};
          ct.upf[kk] = __bfloat162float(end_at(e, 2));
        } else {
          ct.up[kk] = Pair{0.0f, 0.0f};
          ct.upf[kk] = 0.0f;
        }
      });
      ct.pin = m > 0 ? __bfloat162float(end_at(m - 1, 2)) : 0.0f;
      const Counter<kLow> entering = ct;
      float ex[kB], da[kB], dbx[kB], f[kB];
      payload<kC, kTpc, kB>(sg, cl, j, av, ex, da, dbx);
      BlockRec<kLow> rec;
      block_fwd<kLow, true>(ct, m, da, dbx, h0, f, rec);
      float g[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        g[r] = rnd(sg.dy[r][cl] * sg.cm[r][j]);
        if (m == nblk - 1 && r == nv - 1) g[r] = rnd(g[r] + gcarry);
      }
      float ga[kB], gb[kB];
      block_bwd<kLow>(entering, m, rec, g, sw, su, ga, gb);
      // float32: da through exp and a, dbx through (dt x) B
      float sxb[kB], q[kB], tb[kB], tc[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        float gda = ga[r];
        if (r == 0 && m == 0) {              // dbx'_0 = dbx_0 + da_0 h0
          gda = rnd(gb[0] * h0);
          gh0 = rnd(gb[0] * da[0]);
        }
        const float dtv = sg.dt[r][cl], xv = sg.x[r][cl];
        const float gu = gda * ex[r];
        sxb[r] = gb[r] * sg.bm[r][j];        // -> sum_s: d(dt x)
        q[r] = fmaf(gu, av, xv * sxb[r]);    // -> sum_s: ddt
        dacc = fmaf(gu, dtv, dacc);
        tb[r] = gb[r] * (dtv * xv);          // dB's term
        tc[r] = sg.dy[r][cl] * f[r];         // dC's term
      }
      // dx = dt sum_s gdbx B, ddt = sum_s (gu a + x gdbx B)
      lane_sums<kTpc, kB>(sxb, j, [&](int r, float v) {
        if (r < nv && ch < di) dx[(row0 + r) * di + ch] = v * sg.dt[r][cl];
      });
      lane_sums<kTpc, kB>(q, j, [&](int r, float v) {
        if (r < nv && ch < di) ddt[(row0 + r) * di + ch] = v;
      });
      // dB, dC: the warp's channels by xor shuffles, then the block's warps
#pragma unroll
      for (int mask = kTpc; mask < 32; mask *= 2) {
#pragma unroll
        for (int r = 0; r < kB; ++r) {
          tb[r] += __shfl_xor_sync(0xffffffffu, tb[r], mask);
          tc[r] += __shfl_xor_sync(0xffffffffu, tc[r], mask);
        }
      }
      if (lane < kTpc) {
#pragma unroll
        for (int r = 0; r < kB; ++r) {
          wsum[warp][r][0][lane] = tb[r];
          wsum[warp][r][1][lane] = tc[r];
        }
      }
      __syncthreads();
      for (int i = tid; i < kB * 2 * kTpc; i += kBwdThreads) {
        const int r = i / (2 * kTpc);
        const int which = (i / kTpc) & 1;
        const int s = i % kTpc;
        float v = wsum[0][r][which][s];
#pragma unroll
        for (int w = 1; w < S::kWarps; ++w) v += wsum[w][r][which][s];
        if (r < nv && s < st) {
          float* out = which ? pc : pb;
          out[((static_cast<long long>(b) * nblk_ch + blk) * l + row0 -
               static_cast<long long>(b) * l + r) * st + s] = v;
        }
      }
    }
    gcarry = gh0;
  }
  if (live) pa[(static_cast<long long>(b) * di + ch) * st + j] = dacc;
}

// The partials summed in a fixed order: dB, dC over the blocks, dA over
// the lanes.  One thread an output.
__global__ void scan_bf16_bwd_reduce(const float* __restrict__ pb,
                                     const float* __restrict__ pc,
                                     const float* __restrict__ pa,
                                     float* __restrict__ db,
                                     float* __restrict__ dc,
                                     float* __restrict__ da, int bsz,
                                     int nblk, long long lst,
                                     long long dist) {
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

template <int kTpc>
int launch_bwd(const float* x, const float* dt, const float* bm,
               const float* cm, const float* a, const float* hck,
               const float* dy, float* dx, float* ddt, float* db, float* dc,
               float* da, float* pb, float* pc, float* pa, int b, int l,
               int di, int st, int c, cudaStream_t s) {
  using S = BwdShape<kTpc>;
  auto kernel = scan_bf16_bwd_kernel<kTpc>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kEndBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (di + S::kC - 1) / S::kC;
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(b));
  kernel<<<grid, kBwdThreads, S::kEndBytes, s>>>(x, dt, bm, cm, a, hck, dy,
                                                 dx, ddt, pb, pc, pa, l, di,
                                                 st, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lst = static_cast<long long>(l) * st;
  const long long dist = static_cast<long long>(di) * st;
  const long long outs = b * lst > dist ? b * lst : dist;
  scan_bf16_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                         s>>>(pb, pc, pa, db, dc, da, b, nblk, lst, dist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x/dt/y (b, l, di), bm/cm (b, l, st), a (di, st), all float32 and
// contiguous; chunk <= 256 divides l.
int rt_selective_scan_bf16(const void* x, const void* dt, const void* bm,
                           const void* cm, const void* a, void* y,
                           long long b, long long l, long long di,
                           long long st, long long chunk, void* stream) {
  return forward<false>(x, dt, bm, cm, a, y, nullptr, b, l, di, st, chunk,
                        stream);
}

// The same, and the float32 state entering every chunk to hck (b, l /
// chunk, di, st).
int rt_selective_scan_bf16_ckpt(const void* x, const void* dt, const void* bm,
                                const void* cm, const void* a, void* y,
                                void* hck, long long b, long long l,
                                long long di, long long st, long long chunk,
                                void* stream) {
  return forward<true>(x, dt, bm, cm, a, y, hck, b, l, di, st, chunk,
                       stream);
}

// The gradients of y for the cotangent dy (b, l, di): dx, ddt (b, l, di),
// db, dc (b, l, st), da (di, st), from hck as rt_selective_scan_bf16_ckpt
// wrote it.  Workspace: pb, pc (b, nblk, l, st) and pa (b, di, st), nblk =
// ceil(di / (256 / tpc)), tpc the power of two >= st.
int rt_selective_scan_bf16_bwd(const void* x, const void* dt, const void* bm,
                               const void* cm, const void* a,
                               const void* hck, const void* dy, void* dx,
                               void* ddt, void* db, void* dc, void* da,
                               void* pb, void* pc, void* pa, long long b,
                               long long l, long long di, long long st,
                               long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st) || bad_chunk(l, chunk))
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
            ci = static_cast<int>(chunk);
#define RT_BWD(T)                                                        \
  return launch_bwd<T>(xf, dtf, bf, cf, af, hf, dyf, dxf, ddtf, dbf, dcf, \
                       daf, pbf, pcf, paf, bi, li, dii, sti, ci, s)
  if (st <= 1) RT_BWD(1);
  if (st <= 2) RT_BWD(2);
  if (st <= 4) RT_BWD(4);
  if (st <= 8) RT_BWD(8);
  if (st <= 16) RT_BWD(16);
  RT_BWD(32);
#undef RT_BWD
}

}  // extern "C"
