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
// positions, so a thread walks its lanes in time keeping the binary
// counter's entries: up[] and h at the end of each pending run of 1, 2, 4,
// ... steps.  The walk does the recursion's combines and no others, in the
// same bracketing, so it gives its bits.  Steps come in blocks of 2^kLow:
// within a block every counter level below kLow is known at compile time
// (the block's steps unrolled, its entries in registers); the kUp = 8 -
// kLow levels above change once a block and are updated under predicates
// from the block's number.  So chunks up to 256 steps, the reference's
// default, are taken (a longer chunk is refused).
//
// Packed bf16 arithmetic, two lanes a thread.  A thread owns the states j
// and j + kTpc of one channel (kTpc = half the power of two >= st, at
// least 1), both held in one 32-bit register as a bf16 pair, and each of
// the tree's products and sums is one fma.rn.bf16x2: a*b + (-0) for a
// product, a*1 + b for a sum, each the exact result rounded once to bf16.
// The reference rounds each operation's float32 result to bf16; for one
// product or one sum of two bf16 values the float32 rounding first and the
// bf16 one after give the exact result's single rounding (24 >= 2*8 + 2
// bits: double rounding is innocuous, subnormals included, since bf16 and
// float32 share their exponent range and a product of two bf16 values
// has 16 significant bits), so the packed operations give the reference's
// bits with no conversion in between.  The products are never contracted
// into the following add (the reference rounds the product first): each
// operation is its own instruction (inline PTX).  NaNs come out canonical
// (compared by position).  On the card no operation differs from the
// plain version's at da near 0 and 1, products below float32's normal
// range, inf and NaN (tests/test_torch_cuda.py), so none keeps the
// float32-and-round form.  exp(dt a) and every float32 sum stay float32.
//
// The forward (rt_selective_scan_bf16, which with ckpt also hands back the
// float32 state entering every chunk, (B, L / c, di, st): the reference's
// boundary states): a thread walks its lane pair's chunks in order, the
// state in its register, a stage of steps ahead in shared memory.  y's
// kTpc parts meet in the transposed butterfly after the thread adds its
// two states, whose order (the states paired from the highest bit of
// their index down) the plain version takes too (kref.state_sum): y is
// its bits.
//
// The backward (rt_selective_scan_bf16_bwd), two kernels and a reduction.
// The ends kernel walks every chunk at once from its saved entering state
// and stores, for every block of 8 steps, the up-value and state at its
// last step (bf16, 6 bytes a lane).  The reverse kernel takes each lane's
// chunks last first and their blocks last first: it loads the block's
// upper counter entries and the state before it from those ends (with the
// block's x, dt, dy, B and C, through cp.async, a stage ahead), walks the
// block's 8 steps forward again keeping every combine's inputs in
// registers, then runs the transposed combines in reverse, packed as the
// forward is, rounded as the reference's VJP rounds them: a product's
// cotangent rounded once, a value used twice summed with one bf16 add, the
// cotangent of a state that several later states read summed from the
// lowest level up (jax's transpose adds them level by level).  The
// cotangents waiting for an earlier position sit in one register a counter
// level.  The states' cotangent is bf16(dy C), the chunk's last step adding
// the carried one.  Then float32: da's cotangent through exp, dbx's through
// the two products, into dx, ddt, dA and the dB/dC terms.  Sums across
// threads and blocks use no atomics (two runs give the same bits): dx and
// ddt over a channel's states (the thread's two, then the transposed
// butterfly); dB and dC over a warp's channels by a transposed butterfly
// of xor shuffles (mask 16 first), then the block's warps in order into
// one partial a block, then the partials in order (a third kernel); dA in
// a register over the steps, then over the lanes in order.
//
// What bounds it.  The forward reads x, dt (di floats a step) and B, C and
// writes y: at falcon-mamba-7b's 32k prefill (di 8192, st 16) 3.2 GB,
// 0.96 ms at 3.35 TB/s, as the float32 scan.  Its tree combines (each two
// products and an add) and the payload's exponentials and products are
// 4.7e10 operations, ~0.7 ms at the 67 TFLOP/s float32 peak.  Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (tools/lm_kernel_bench.py,
// chip_smoke.py; PERF.md §6): the walk takes 4.6-4.8 ms there and is
// issue-bound, about 60 instructions a lane pair and step, 16 of them its
// two expf (whose bits the plain version's torch.exp has; an ex2.approx
// kept outside a guard band around the bf16 rounding midpoints, expf
// inside it, measured slower).  Against the same kernels with each bf16
// operation as float32 then rounded the packed operations save about
// 30 %, the stage a block ahead 3-27 %, two blocks a stage 4 %.  Splitting
// the walk at the chunks (each chunk's last state a chain of at most
// 2 log2 c + 1 h-free links, then every chunk walked at once) gives the
// same bits but costs 1.8 times the walk where the lanes fill the card,
// as every configuration's do (PERF.md keeps its numbers).  The backward
// walks every chunk twice forwards and once in reverse, the first of them
// off the serial path: 4.8 ms at falcon's train microbatch (B 2, L 4096),
// the reverse kernel at two blocks of 128 threads an SM (about 210
// registers; at three the same time, at four it spills and is 25 %
// slower).

#include <cuda_bf16.h>

#include <utility>

#include "selective_scan_common.cuh"

namespace {

constexpr int kLevels = 8;             // a chunk of at most 2^8 steps
constexpr int kMaxChunk = 1 << kLevels;
constexpr int kThreads = 128;          // every kernel's block
constexpr int kFwdLow = 4;             // the forward's blocks of 16 steps
constexpr int kBwdLow = 3;             // the backward's blocks of 8
constexpr int kBwdMinBlocks = 2;       // the reverse kernel: <= 255 regs
constexpr int kStages = 2;             // one stage computed, one in flight

using u32 = unsigned;
constexpr u32 kOne2 = 0x3f803f80u;     // (1, 1)
constexpr u32 kNegZero2 = 0x80008000u; // (-0, -0)

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

// -- packed bf16 pairs: the low half the state j, the high half j + kTpc --

__device__ __forceinline__ float lo_f(u32 v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(u32 v) {
  return __uint_as_float(v & 0xffff0000u);
}
// (lo, hi) rounded to the nearest bf16 (ties to even)
__device__ __forceinline__ u32 pack2(float lo, float hi) {
  u32 r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a*b + c rounded once, on both halves
__device__ __forceinline__ u32 fma2(u32 a, u32 b, u32 c) {
  u32 r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ u32 mul2(u32 a, u32 b) {
  return fma2(a, b, kNegZero2);
}
__device__ __forceinline__ u32 add2(u32 a, u32 b) { return fma2(a, kOne2, b); }

struct Pair {
  u32 a, b;
};

__device__ __forceinline__ Pair comb(Pair x, Pair y) {
  return {mul2(x.a, y.a), add2(mul2(x.b, y.a), y.b)};
}
__device__ __forceinline__ u32 comb_b(u32 f, Pair y) {
  return add2(mul2(f, y.a), y.b);
}

// A lane pair's counter: the low levels' entries (up-value, state at its
// end) and the upper levels', and pin, the state at the step before the
// block.
template <int kLow>
struct Counter {
  Pair lo[kLow];
  u32 lof[kLow];
  Pair up[kLevels - kLow];
  u32 upf[kLevels - kLow];
  u32 pin;
};

// What the backward keeps of a block's forward walk: ca[r][d], the a of
// step r's carry after d merges (d = D(r) is its up-value's), cb[r] the b
// of its up-value, f[r] its state; for the block's last step the a after
// each upper merge (cu), how many there were (nm) and the state its final
// combine reads (fq, where has_fq).
template <int kLow>
struct BlockRec {
  u32 ca[1 << kLow][kLow + 1];
  u32 cb[1 << kLow];
  u32 f[1 << kLow];
  u32 cu[kLevels - kLow];
  int nm;
  bool has_fq;
  u32 fq;
};

// One block (number m of its chunk) of the forward walk over the payload
// (da[r], dbx[r]); the chunk's first block (m = 0) folds h0 into step 0.
// Writes each step's state to f; kRec also fills rec.  Returns the last
// step's up-value after its upper merges.
template <int kLow, bool kRec>
__device__ __forceinline__ Pair block_fwd(Counter<kLow>& ct, int m,
                                          const u32 (&da)[1 << kLow],
                                          const u32 (&dbx)[1 << kLow],
                                          u32 h0, u32 (&f)[1 << kLow],
                                          BlockRec<kLow>& rec) {
  constexpr int kB = 1 << kLow;
  constexpr int kUp = kLevels - kLow;
  Pair top{0u, 0u};
  static_for<kB>([&](auto R) {
    constexpr int r = decltype(R)::value;
    Pair car{da[r], dbx[r]};
    if constexpr (r == 0) {
      if (m == 0) car = Pair{kOne2, add2(dbx[0], mul2(da[0], h0))};
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
      u32 fv;
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
      u32 fq = 0u;
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == tzr) fq = ct.upf[k];
      });
      const u32 fv = restm != 0 ? comb_b(fq, car) : car.b;
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
// dbx'_0)); the block's entering upper entries up_a/up_b[k] and pin; sw[k]
// the cotangent waiting for the state a level-k step's final combine read,
// su[k] the one waiting for the up-value a level-(k+1) merge read.
template <int kLow>
__device__ __forceinline__ void block_bwd(
    const u32 (&up_a)[kLevels - kLow], const u32 (&up_b)[kLevels - kLow],
    u32 pin, int m, const BlockRec<kLow>& rec, const u32 (&g)[1 << kLow],
    u32 (&sw)[kLevels + 1], Pair (&su)[kLevels + 1], u32 (&ga)[1 << kLow],
    u32 (&gb)[1 << kLow]) {
  constexpr int kB = 1 << kLow;
  constexpr int kUp = kLevels - kLow;
  static_for<kB>([&](auto I) {
    constexpr int r = kB - 1 - decltype(I)::value;
    if constexpr (r < kB - 1) {
      constexpr int D = ctz_c(r + 1);
      u32 w = g[r];
      static_for<D>([&](auto K) { w = add2(w, sw[decltype(K)::value]); });
      constexpr int rest = (r + 1) & r;
      u32 gua = 0u;
      if constexpr (rest != 0) {
        gua = mul2(w, rec.f[rest - 1]);
        sw[D] = mul2(w, rec.ca[r][D]);
      } else {
        if (m > 0) {
          gua = mul2(w, pin);
          sw[D] = mul2(w, rec.ca[r][D]);
        }
      }
      u32 gub = w;
      gua = add2(gua, su[D].a);
      gub = add2(gub, su[D].b);
      su[D] = Pair{0u, 0u};
      static_for<D>([&](auto J) {
        constexpr int d = D - decltype(J)::value;     // D .. 1
        constexpr int p = r - (1 << (d - 1));
        const u32 ya = rec.ca[r][d - 1];
        su[d - 1] = Pair{mul2(gua, ya), mul2(gub, ya)};
        gua = add2(mul2(gua, rec.ca[p][d - 1]), mul2(gub, rec.cb[p]));
      });
      ga[r] = gua;
      gb[r] = gub;
    } else {
      const int nm = rec.nm;
      u32 w = g[r];
      static_for<kLow>([&](auto K) { w = add2(w, sw[decltype(K)::value]); });
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k < nm) w = add2(w, sw[kLow + k]);
      });
      u32 top_a = rec.ca[r][kLow];
      static_for<kUp>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == nm - 1) top_a = rec.cu[k];
      });
      u32 gua = 0u;
      const u32 c = mul2(w, top_a);
      if (rec.has_fq) gua = mul2(w, rec.fq);
      u32 gub = w;
      static_for<kUp + 1>([&](auto K) {
        constexpr int k = decltype(K)::value;
        if (k == nm) {
          if (rec.has_fq) sw[kLow + k] = c;
          gua = add2(gua, su[kLow + k].a);
          gub = add2(gub, su[kLow + k].b);
          su[kLow + k] = Pair{0u, 0u};
        }
      });
      static_for<kUp>([&](auto J) {
        constexpr int j = kUp - 1 - decltype(J)::value;  // kUp - 1 .. 0
        if (j < nm) {
          u32 ya;
          if constexpr (j == 0)
            ya = rec.ca[r][kLow];
          else
            ya = rec.cu[j - 1];
          su[kLow + j] = Pair{mul2(gua, ya), mul2(gub, ya)};
          gua = add2(mul2(gua, up_a[j]), mul2(gub, up_b[j]));
        }
      });
      static_for<kLow>([&](auto J) {
        constexpr int d = kLow - decltype(J)::value;  // kLow .. 1
        constexpr int p = r - (1 << (d - 1));
        const u32 ya = rec.ca[r][d - 1];
        su[d - 1] = Pair{mul2(gua, ya), mul2(gub, ya)};
        gua = add2(mul2(gua, rec.ca[p][d - 1]), mul2(gub, rec.cb[p]));
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

// v summed over the lanes lane ^ M for M = kM, kM / 2, ..., kLo, a
// transposed butterfly: each level keeps the half of the kCount values
// that the lane's bit M names, so the lane ends with v[0 .. kCount >>
// levels) holding the sums of the values numbered (lane & ~(kLo - 1) &
// 31) + i.
template <int kCount, int kM, int kLo, int kN>
__device__ __forceinline__ void xsum(float (&v)[kN], int lane) {
  if constexpr (kM >= kLo) {
    constexpr int h = kCount / 2;
    const bool hi = (lane & kM) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float mine = hi ? v[i + h] : v[i];
      const float other = hi ? v[i] : v[i + h];
      v[i] = mine + __shfl_xor_sync(0xffffffffu, other, kM);
    }
    xsum<h, kM / 2, kLo>(v, lane);
  }
}

// kTpc threads a channel, kC channels a block, kW = 2 kTpc states a
// channel (zero past st).
template <int kTpc>
struct Shape {
  static constexpr int kC = kThreads / kTpc;
  static constexpr int kW = 2 * kTpc;
};

// A block of kB steps staged in shared memory: kC channels' (dt, x) pairs
// (and the backward's dy), kW states' B (and C), each B/C row in pairs
// (state j, state j + kTpc) so that a thread reads its two with one load.
template <int kTpc, int kB, bool kDy>
struct alignas(16) Stage {
  static constexpr int kC = Shape<kTpc>::kC, kW = Shape<kTpc>::kW;
  float2 dtx[kB][kC];                  // (dt, x): one load a step
  float dy[kDy ? kB : 1][kC];
  float bm[kB][kW], cm[kB][kW];
};

// The thread's pair of states (j, j + kTpc) in a staged B or C row
template <int kTpc>
__device__ __forceinline__ float2 pair_at(const float (&row)[2 * kTpc],
                                          int j) {
  return *reinterpret_cast<const float2*>(&row[2 * j]);
}

// A thread's share of a stage's cp.async copies: its row and column of x,
// dt (dy) and of B (C), fixed from stage to stage, with its source
// pointers at row 0, so a stage costs one offset a tensor.  issue() stages
// rows row0 .. row0 + nv - 1 (not committed), zeros past them (dt = 0
// there makes da 1 and dbx 0: steps past a chunk change nothing it keeps)
// and past di, st.
template <int kTpc, int kB, bool kDy, bool kCm>
struct Loader {
  static constexpr int kC = Shape<kTpc>::kC, kW = Shape<kTpc>::kW;
  static constexpr int kXRows = kThreads / kC, kBRows = kThreads / kW;
  const float *x, *dt, *dy, *bm, *cm;
  int xr, xc, br, bcol, di, st;
  bool xin, bin;
  __device__ __forceinline__ Loader(const float* x_, const float* dt_,
                                    const float* dy_, const float* bm_,
                                    const float* cm_, int c0, int di_,
                                    int st_)
      : xr(threadIdx.x / kC), xc(threadIdx.x % kC), br(threadIdx.x / kW),
        di(di_), st(st_) {
    const int bs = threadIdx.x % kW;
    bcol = 2 * (bs % kTpc) + bs / kTpc;
    xin = c0 + xc < di;
    bin = bs < st;
    const long long ox = static_cast<long long>(xr) * di + c0 + xc;
    const long long ob = static_cast<long long>(br) * st + bs;
    x = x_ + ox;
    dt = dt_ + ox;
    dy = kDy ? dy_ + ox : nullptr;
    bm = bm_ + ob;
    cm = kCm ? cm_ + ob : nullptr;
  }

  __device__ __forceinline__ void issue(Stage<kTpc, kB, kDy>& sg,
                                        long long row0, int nv) const {
    const long long rx = row0 * di;
#pragma unroll
    for (int e = 0; e * kXRows < kB; ++e) {
      const int r = xr + e * kXRows;
      if (kB % kXRows == 0 || r < kB) {
        const bool in = xin && r < nv;
        const long long o = in ? rx + static_cast<long long>(e * kXRows) * di
                               : 0;
        cp_async<4>(&sg.dtx[r][xc].x, dt + o, in);
        cp_async<4>(&sg.dtx[r][xc].y, x + o, in);
        if constexpr (kDy) cp_async<4>(&sg.dy[r][xc], dy + o, in);
      }
    }
    const long long rb = row0 * st;
#pragma unroll
    for (int e = 0; e * kBRows < kB; ++e) {
      const int r = br + e * kBRows;
      if (kB % kBRows == 0 || r < kB) {
        const bool in = bin && r < nv;
        const long long o = in ? rb + static_cast<long long>(e * kBRows) * st
                               : 0;
        cp_async<4>(&sg.bm[r][bcol], bm + o, in);
        if constexpr (kCm) cp_async<4>(&sg.cm[r][bcol], cm + o, in);
      }
    }
  }
};

// The staged payload of the thread's two lanes at rows r0 .. r0 + kB - 1
// of the stage: da = bf16(exp(dt a)), dbx = bf16((dt x) B), packed; ex
// keeps exp(dt a) in float32 (lo, hi).
template <int kB, bool kEx, class St>
__device__ __forceinline__ void payload(const St& sg, int r0, int cl, int j,
                                        float a_lo, float a_hi,
                                        u32 (&da)[kB], u32 (&dbx)[kB],
                                        float (&ex)[kEx ? kB : 1][2]) {
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    const float2 tx = sg.dtx[r0 + r][cl];
    const float e0 = expf(tx.x * a_lo), e1 = expf(tx.x * a_hi);
    if constexpr (kEx) {
      ex[r][0] = e0;
      ex[r][1] = e1;
    }
    da[r] = pack2(e0, e1);
    const float dtx = tx.x * tx.y;
    const float2 bv = *reinterpret_cast<const float2*>(&sg.bm[r0 + r][2 * j]);
    dbx[r] = pack2(dtx * bv.x, dtx * bv.y);
  }
}

// The stage ring: issue(s, buf) stages step-block s; body(s, buf) runs on
// it once it has landed.  kStages buffers, kStages - 1 blocks in flight
// while one computes; one barrier a block.
template <class Issue, class Body>
__device__ __forceinline__ void ring(int n, Issue&& issue, Body&& body) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s, s);
    cp_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nx = s + kStages - 1;
    if (nx < n) issue(nx, nx % kStages);
    cp_commit();
    body(s, s % kStages);
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

// The walk, writing y: a lane pair walks all its chunks in order,
// carrying the state in its register and writing each chunk's entering
// state to hck where `ckpt`; grid (ncb, B).  A stage holds kPer
// blocks of 16 steps (two where shared memory allows: one barrier and one
// round of copies a 32 steps).
template <int kTpc>
__host__ __device__ constexpr int walk_per() {
  return sizeof(Stage<kTpc, 2 << kFwdLow, false>) * kStages <= 40 * 1024
             ? 2 : 1;
}

template <int kTpc>
__global__ void __launch_bounds__(kThreads) scan_bf16_walk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, float* __restrict__ hck,
    float* __restrict__ y, int l, int di, int st, int c, bool ckpt) {
  constexpr int kC = Shape<kTpc>::kC, kB = 1 << kFwdLow;
  constexpr int kPer = walk_per<kTpc>(), kSB = kPer * kB;
  __shared__ Stage<kTpc, kSB, false> sg[kStages];
  const int b = blockIdx.y, c0 = blockIdx.x * kC;
  const int cl = threadIdx.x / kTpc, j = threadIdx.x - cl * kTpc;
  const int ch = c0 + cl;
  const bool lo_live = ch < di && j < st, hi_live = ch < di && j + kTpc < st;
  const float a_lo = lo_live ? a[(long long)ch * st + j] : 0.0f;
  const float a_hi = hi_live ? a[(long long)ch * st + j + kTpc] : 0.0f;
  const int nch = l / c, nblk = (c + kB - 1) / kB;
  const int nstg = (c + kSB - 1) / kSB;      // stages a chunk
  auto hck_at = [&](int k) {
    return hck + ((static_cast<long long>(b) * nch + k) * di + ch) * st;
  };
  u32 h0 = 0u, hlast = 0u;
  Counter<kFwdLow> ct;
  BlockRec<kFwdLow> rec;                  // unused: kRec is false
  const Loader<kTpc, kSB, false, true> ld(x, dt, nullptr, bm, cm, c0, di,
                                          st);
  // stage s: chunk s / nstg, stage s % nstg of it (issue and body each
  // see s = 0, 1, ... in order, and count chunk and stage themselves)
  int ik = 0, is = 0, bk = 0, bs = 0;
  ring(
      nch * nstg,
      [&](int, int buf) {
        const int k = ik, ms = is;
        if (++is == nstg) {
          is = 0;
          ++ik;
        }
        ld.issue(sg[buf], static_cast<long long>(b) * l + k * c + ms * kSB,
                 min(kSB, c - ms * kSB));
      },
      [&](int, int buf) {
        const auto& sr = sg[buf];
        const int k = bk, ms = bs;
        if (++bs == nstg) {
          bs = 0;
          ++bk;
        }
#pragma unroll
        for (int sub = 0; sub < kPer; ++sub) {
          const int m = ms * kPer + sub;
          if (kPer == 1 || m < nblk) {
            const int nv = min(kB, c - m * kB);
            const long long row0 =
                static_cast<long long>(b) * l + k * c + m * kB;
            if (m == 0) {                     // a chunk enters at hlast
              h0 = hlast;
              if (ckpt) {
                float* hk = hck_at(k);
                if (lo_live) hk[j] = lo_f(h0);
                if (hi_live) hk[j + kTpc] = hi_f(h0);
              }
            }
            u32 da[kB], dbx[kB], f[kB];
            float ex[1][2], p[kB];
            payload<kB, false>(sr, sub * kB, cl, j, a_lo, a_hi, da, dbx, ex);
            block_fwd<kFwdLow, false>(ct, m, da, dbx, h0, f, rec);
            // y: the thread's two states added first (the sum's top
            // level), products never fused into the adds: kref.state_sum's
            // order
#pragma unroll
            for (int r = 0; r < kB; ++r) {
              const float2 cv = pair_at<kTpc>(sr.cm[sub * kB + r], j);
              const float p0 = __fmul_rn(lo_f(f[r]), cv.x);
              p[r] = st > 1 ? __fadd_rn(p0, hi_live ? __fmul_rn(hi_f(f[r]),
                                                                cv.y)
                                                    : 0.0f)
                            : p0;
            }
            if (m == nblk - 1) {
              // a select chain, not f[nv - 1] (local memory)
              static_for<kB>([&](auto R) {
                if (decltype(R)::value == nv - 1)
                  hlast = f[decltype(R)::value];
              });
            }
            lane_sums<kTpc, kB>(p, j, [&](int r, float v) {
              if (r < nv && ch < di) y[(row0 + r) * di + ch] = v;
            });
          }
        }
      });
}

bool bad_chunk(long long l, long long c) {
  return c < 1 || c > kMaxChunk || l % c != 0;
}

template <int kTpc>
int launch_fwd(const float* x, const float* dt, const float* bm,
               const float* cm, const float* a, float* y, float* hck, int b,
               int l, int di, int st, int c, bool ckpt, cudaStream_t s) {
  constexpr int kC = Shape<kTpc>::kC;
  const int ncb = (di + kC - 1) / kC;
  scan_bf16_walk_kernel<kTpc>
      <<<dim3(static_cast<unsigned>(ncb), static_cast<unsigned>(b)),
         kThreads, 0, s>>>(x, dt, bm, cm, a, hck, y, l, di, st, c, ckpt);
  return static_cast<int>(cudaGetLastError());
}

int forward(const void* x, const void* dt, const void* bm, const void* cm,
            const void* a, void* y, void* hck, long long b, long long l,
            long long di, long long st, long long chunk, bool ckpt,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st) || bad_chunk(l, chunk) ||
      (l / chunk) * di >= (1LL << 31))
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
  return launch_fwd<T>(xf, dtf, bf, cf, af, yf, hf, bi, li, dii, sti, ci, \
                       ckpt, s)
  if (st <= 2) RT_FWD(1);
  if (st <= 4) RT_FWD(2);
  if (st <= 8) RT_FWD(4);
  if (st <= 16) RT_FWD(8);
  RT_FWD(16);
#undef RT_FWD
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int kBwdUp = kLevels - kBwdLow;

// The ends of every 8-step block of every (chunk, lane pair): ends (B, L /
// c, nb, 3, di kTpc), nb = ceil(c / 8): the block's last up-value (a, b)
// and its state, packed.  Grid (L / c * ncb, B), ncb blocks of kC
// channels: every chunk at once.
template <int kTpc>
__global__ void __launch_bounds__(kThreads) scan_bf16_ends_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ a,
    const float* __restrict__ hck, u32* __restrict__ ends, int l, int di,
    int st, int c) {
  constexpr int kC = Shape<kTpc>::kC, kB = 1 << kBwdLow;
  __shared__ Stage<kTpc, kB, false> sg[kStages];
  const int ncb = (di + kC - 1) / kC;
  const int b = blockIdx.y, k = blockIdx.x / ncb;
  const int c0 = (blockIdx.x - k * ncb) * kC;
  const int cl = threadIdx.x / kTpc, j = threadIdx.x - cl * kTpc;
  const int ch = c0 + cl;
  const bool lo_live = ch < di && j < st, hi_live = ch < di && j + kTpc < st;
  const float a_lo = lo_live ? a[(long long)ch * st + j] : 0.0f;
  const float a_hi = hi_live ? a[(long long)ch * st + j + kTpc] : 0.0f;
  const int nch = l / c, nblk = (c + kB - 1) / kB;
  const float* hk =
      hck + ((static_cast<long long>(b) * nch + k) * di + ch) * st;
  const u32 h0 = pack2(lo_live ? hk[j] : 0.0f, hi_live ? hk[j + kTpc] : 0.0f);
  const long long pairs = static_cast<long long>(di) * kTpc;
  u32* out = ends + (static_cast<long long>(b) * nch + k) * nblk * 3 * pairs +
             static_cast<long long>(ch) * kTpc + j;
  const long long rowc = static_cast<long long>(b) * l + k * c;
  Counter<kBwdLow> ct;
  BlockRec<kBwdLow> rec;                  // unused: kRec is false
  const Loader<kTpc, kB, false, false> ld(x, dt, nullptr, bm, nullptr, c0,
                                          di, st);
  ring(
      nblk,
      [&](int m, int buf) {
        ld.issue(sg[buf], rowc + m * kB, min(kB, c - m * kB));
      },
      [&](int m, int buf) {
        u32 da[kB], dbx[kB], f[kB];
        float ex[1][2];
        payload<kB, false>(sg[buf], 0, cl, j, a_lo, a_hi, da, dbx, ex);
        const Pair top = block_fwd<kBwdLow, false>(ct, m, da, dbx, h0, f, rec);
        if (ch < di) {
          u32* o = out + static_cast<long long>(m) * 3 * pairs;
          o[0] = top.a;
          o[pairs] = top.b;
          o[2 * pairs] = ct.pin;
        }
      });
}

// The reverse kernel's stage: a block of 8 steps' x, dt, dy, B, C, and the
// block's entering upper entries (a, b, state) and pin from the ends, a
// thread's own.
template <int kTpc>
struct BwdStage {
  Stage<kTpc, 1 << kBwdLow, true> rows;
  u32 up[kBwdUp][3][kThreads];
  u32 pin[kThreads];
};

// The reverse walk: a block serves kC channels of lane b, every chunk,
// last first.  dx, ddt (b, l, di) written; pb, pc (B, ncb, l, st) get this
// block's sums of the dB, dC terms over its channels; pa (B, di, st) this
// lane's dA.
template <int kTpc>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    scan_bf16_rev_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ hck,
        const u32* __restrict__ ends, const float* __restrict__ dy,
        float* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ pb, float* __restrict__ pc,
        float* __restrict__ pa, int l, int di, int st, int c) {
  constexpr int kC = Shape<kTpc>::kC, kW = Shape<kTpc>::kW;
  constexpr int kB = 1 << kBwdLow, kLow = kBwdLow, kWarps = kThreads / 32;
  __shared__ BwdStage<kTpc> sg[kStages];
  __shared__ float wsum[kWarps][2][kB][kW];
  const int b = blockIdx.y, blk = blockIdx.x, ncb = gridDim.x;
  const int c0 = blk * kC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kTpc, j = tid - cl * kTpc;
  const int ch = c0 + cl;
  const bool lo_live = ch < di && j < st, hi_live = ch < di && j + kTpc < st;
  const float a_lo = lo_live ? a[(long long)ch * st + j] : 0.0f;
  const float a_hi = hi_live ? a[(long long)ch * st + j + kTpc] : 0.0f;
  const int nch = l / c, nblk = (c + kB - 1) / kB;
  const long long pairs = static_cast<long long>(di) * kTpc;
  const long long q = static_cast<long long>(c0) * kTpc + tid;
  float dacc0 = 0.0f, dacc1 = 0.0f;
  u32 gcarry = 0u;    // the cotangent of the state leaving the chunk
  u32 gh0 = 0u, h0 = 0u;
  u32 sw[kLevels + 1];
  Pair su[kLevels + 1];
  const Loader<kTpc, kB, true, true> ld(x, dt, dy, bm, cm, c0, di, st);
  // step-block s: chunk nch - 1 - s / nblk, block nblk - 1 - s % nblk
  // (issue and body each count them down themselves)
  int ik = nch - 1, im = nblk - 1, bk = nch - 1, bm_ = nblk - 1;
  ring(
      nch * nblk,
      [&](int, int buf) {
        const int k = ik, m = im;
        if (--im < 0) {
          im = nblk - 1;
          --ik;
        }
        auto& st_ = sg[buf];
        ld.issue(st_.rows, static_cast<long long>(b) * l + k * c + m * kB,
                 min(kB, c - m * kB));
        const bool live = ch < di;
        const u32* e0 = ends +
                        (static_cast<long long>(b) * nch + k) * nblk * 3 *
                            pairs +
                        (live ? q : 0);
        // only the entries the block reads: those of m's set bits (its
        // upper merges and its final combine's state) and the pin
#pragma unroll
        for (int kk = 0; kk < kBwdUp; ++kk) {
          if ((m >> kk) & 1) {
            const u32* src =
                e0 + static_cast<long long>(((m >> kk) << kk) - 1) * 3 * pairs;
#pragma unroll
            for (int w = 0; w < 3; ++w)
              cp_async<4>(&st_.up[kk][w][tid], src + w * pairs, live);
          }
        }
        if (m > 0)
          cp_async<4>(&st_.pin[tid],
                      e0 + (static_cast<long long>(m - 1) * 3 + 2) * pairs,
                      live);
      },
      [&](int, int buf) {
        const int k = bk, m = bm_;
        if (--bm_ < 0) {
          bm_ = nblk - 1;
          --bk;
        }
        const auto& sr = sg[buf].rows;
        const auto& se = sg[buf];
        const int nv = min(kB, c - m * kB);
        const long long row0 = static_cast<long long>(b) * l + k * c + m * kB;
        if (m == nblk - 1) {                 // a new chunk, last block first
          const float* hk =
              hck + ((static_cast<long long>(b) * nch + k) * di + ch) * st;
          h0 = pack2(lo_live ? hk[j] : 0.0f, hi_live ? hk[j + kTpc] : 0.0f);
#pragma unroll
          for (int i = 0; i <= kLevels; ++i) {
            sw[i] = 0u;
            su[i] = Pair{0u, 0u};
          }
        }
        // the block's entering counter, from the ends of earlier blocks
        Counter<kLow> ct;
        u32 up_a[kBwdUp], up_b[kBwdUp];
#pragma unroll
        for (int kk = 0; kk < kBwdUp; ++kk) {
          up_a[kk] = se.up[kk][0][tid];
          up_b[kk] = se.up[kk][1][tid];
          ct.up[kk] = Pair{up_a[kk], up_b[kk]};
          ct.upf[kk] = se.up[kk][2][tid];
        }
        ct.pin = se.pin[tid];
        const u32 pin = ct.pin;
        u32 da[kB], dbx[kB], f[kB];
        float ex[kB][2];
        payload<kB, true>(sr, 0, cl, j, a_lo, a_hi, da, dbx, ex);
        BlockRec<kLow> rec;
        block_fwd<kLow, true>(ct, m, da, dbx, h0, f, rec);
        u32 g[kB];
#pragma unroll
        for (int r = 0; r < kB; ++r) {
          const float dyv = sr.dy[r][cl];
          const float2 cv = pair_at<kTpc>(sr.cm[r], j);
          g[r] = pack2(dyv * cv.x, dyv * cv.y);
          // the chunk's last step takes the carried cotangent (a select,
          // not g[nv - 1]: an indexed register array goes to local memory)
          const u32 gc = add2(g[r], gcarry);
          g[r] = m == nblk - 1 && r == nv - 1 ? gc : g[r];
        }
        u32 ga[kB], gb[kB];
        block_bwd<kLow>(up_a, up_b, pin, m, rec, g, sw, su, ga, gb);
        if (m == 0) {                        // dbx'_0 = dbx_0 + da_0 h0
          ga[0] = mul2(gb[0], h0);
          gh0 = mul2(gb[0], da[0]);
        }
        // float32: da through exp and a, dbx through (dt x) B
        float sxb[kB], qd[kB], v[4 * kB];
#pragma unroll
        for (int r = 0; r < kB; ++r) {
          const float dtv = sr.dtx[r][cl].x, xv = sr.dtx[r][cl].y,
                      dyv = sr.dy[r][cl];
          const float gb0 = lo_f(gb[r]), gb1 = hi_f(gb[r]);
          const float gu0 = lo_f(ga[r]) * ex[r][0],
                      gu1 = hi_f(ga[r]) * ex[r][1];
          const float2 bv = pair_at<kTpc>(sr.bm[r], j);
          const float s0 = gb0 * bv.x, s1 = gb1 * bv.y;
          sxb[r] = s0 + s1;                  // -> sum_s: d(dt x)
          qd[r] = fmaf(gu0, a_lo, xv * s0) + fmaf(gu1, a_hi, xv * s1);
          dacc0 = fmaf(gu0, dtv, dacc0);
          dacc1 = fmaf(gu1, dtv, dacc1);
          const float dtx = dtv * xv;
          v[0 * kB + r] = gb0 * dtx;         // dB's terms, state j
          v[1 * kB + r] = gb1 * dtx;         //   and j + kTpc
          v[2 * kB + r] = dyv * lo_f(f[r]);  // dC's
          v[3 * kB + r] = dyv * hi_f(f[r]);
        }
        // dx = dt sum_s gdbx B, ddt = sum_s (gu a + x gdbx B)
        lane_sums<kTpc, kB>(sxb, j, [&](int r, float val) {
          if (r < nv && ch < di)
            dx[(row0 + r) * di + ch] = val * sr.dtx[r][cl].x;
        });
        lane_sums<kTpc, kB>(qd, j, [&](int r, float val) {
          if (r < nv && ch < di) ddt[(row0 + r) * di + ch] = val;
        });
        // dB, dC: the warp's channels (a transposed butterfly), then the
        // block's warps in order
        xsum<4 * kB, 16, kTpc>(v, lane);
        {
          const int base = lane & ~(kTpc - 1) & 31;
#pragma unroll
          for (int i = 0; i < kTpc; ++i) {
            const int idx = base + i;        // (which, half, r)
            const int which = idx / (2 * kB), half = (idx / kB) & 1;
            wsum[warp][which][idx % kB][j + half * kTpc] = v[i];
          }
        }
        __syncthreads();
        for (int i = tid; i < 2 * kB * kW; i += kThreads) {
          const int which = i / (kB * kW), r = (i / kW) % kB, sidx = i % kW;
          float val = wsum[0][which][r][sidx];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) val += wsum[w][which][r][sidx];
          if (r < nv && sidx < st) {
            float* out = which ? pc : pb;
            out[((static_cast<long long>(b) * ncb + blk) * l + row0 -
                 static_cast<long long>(b) * l + r) * st + sidx] = val;
          }
        }
        if (m == 0) gcarry = gh0;
      });
  if (lo_live) pa[(static_cast<long long>(b) * di + ch) * st + j] = dacc0;
  if (hi_live)
    pa[(static_cast<long long>(b) * di + ch) * st + j + kTpc] = dacc1;
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
               float* da, float* pb, float* pc, float* pa, u32* ends, int b,
               int l, int di, int st, int c, cudaStream_t s) {
  constexpr int kC = Shape<kTpc>::kC;
  const int ncb = (di + kC - 1) / kC, nch = l / c;
  scan_bf16_ends_kernel<kTpc>
      <<<dim3(static_cast<unsigned>(nch * ncb), static_cast<unsigned>(b)),
         kThreads, 0, s>>>(x, dt, bm, a, hck, ends, l, di, st, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_bf16_rev_kernel<kTpc>
      <<<dim3(static_cast<unsigned>(ncb), static_cast<unsigned>(b)), kThreads,
         0, s>>>(x, dt, bm, cm, a, hck, ends, dy, dx, ddt, pb, pc, pa, l, di,
                 st, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lst = static_cast<long long>(l) * st;
  const long long dist = static_cast<long long>(di) * st;
  const long long outs = b * lst > dist ? b * lst : dist;
  scan_bf16_bwd_reduce<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                         s>>>(pb, pc, pa, db, dc, da, b, ncb, lst, dist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x/dt/y (b, l, di), bm/cm (b, l, st), a (di, st), all float32 and
// contiguous; chunk <= 256 divides l.  ckpt: write the float32 state
// entering every chunk to hck (b, l / chunk, di, st), the backward's
// restarts (hck may be null without ckpt).
int rt_selective_scan_bf16(const void* x, const void* dt, const void* bm,
                           const void* cm, const void* a, void* y, void* hck,
                           long long b, long long l, long long di,
                           long long st, long long chunk, long long ckpt,
                           void* stream) {
  return forward(x, dt, bm, cm, a, y, hck, b, l, di, st, chunk, ckpt != 0,
                 stream);
}

// The gradients of y for the cotangent dy (b, l, di): dx, ddt (b, l, di),
// db, dc (b, l, st), da (di, st), from hck as rt_selective_scan_bf16
// wrote it (ckpt).  Workspace: pb, pc (b, ncb, l, st) and pa (b, di, st), ncb =
// ceil(di / (128 / tpc)); ends (b, l / chunk, ceil(chunk / 8), 3, di, tpc)
// 32-bit words, tpc half the power of two >= st (at least 1).
int rt_selective_scan_bf16_bwd(const void* x, const void* dt, const void* bm,
                               const void* cm, const void* a,
                               const void* hck, const void* dy, void* dx,
                               void* ddt, void* db, void* dc, void* da,
                               void* pb, void* pc, void* pa, void* ends,
                               long long b, long long l, long long di,
                               long long st, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, l, di, st) || bad_chunk(l, chunk) ||
      (l / chunk) * di >= (1LL << 31))
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
  auto* ef = static_cast<u32*>(ends);
  const int bi = static_cast<int>(b), li = static_cast<int>(l),
            dii = static_cast<int>(di), sti = static_cast<int>(st),
            ci = static_cast<int>(chunk);
#define RT_BWD(T)                                                        \
  return launch_bwd<T>(xf, dtf, bf, cf, af, hf, dyf, dxf, ddtf, dbf, dcf, \
                       daf, pbf, pcf, paf, ef, bi, li, dii, sti, ci, s)
  if (st <= 2) RT_BWD(1);
  if (st <= 4) RT_BWD(2);
  if (st <= 8) RT_BWD(4);
  if (st <= 16) RT_BWD(8);
  RT_BWD(16);
#undef RT_BWD
}

}  // extern "C"
