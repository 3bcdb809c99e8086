// Single-token (decode) GQA attention over the valid prefix of a KV cache,
// for Hopper (sm_90a):
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] * scale) . v[b, s, h / G]
// over the slots s < lengths[b] of lane b, float32 dot products and softmax,
// the output in q's type; q and the cache float32 or bfloat16 (a float32
// query may read a bfloat16 cache), D <= 128.
//
// Replaces the Pallas TPU kernel decode_attention of
// src/repro/kernels/decode_attention.py (pallas_call at :95), reached
// through repro.kernels.ops.decode_attention; in the port it is the
// attention of every layer of every decode step (models/transformer.py).
//
// What bounds it on this card: bytes.  Each valid slot's K and V rows are
// read once (2 * Hkv * D elements) for about 4 * H * D flops: at bf16 that
// is one flop per byte, far under the card's ratio.  At llama3-8b's decode
// step (8 lanes, 8 KV heads of 128, ~1,600 valid slots a lane) that is
// ~54 MB, 16 us at 3.35 TB/s, so the kernel also has to start fast, fill
// all 132 SMs evenly and end without a second pass.
//
// Design.  The TPU kernel walked the KV axis as a sequential grid axis,
// carrying the running (max, sum, accumulator) from chunk to chunk.
// Blocks here run in no order, and one block per (lane, KV head) would be
// only 64 of them, so the KV axis is split: the grid is (split, lane x KV
// head, head group), the split length `chunk` chosen by the wrapper from
// the static shapes (lengths stay on the device: no host sync) so that
// about four blocks of 128 threads sit on every SM (five fit).  A block
// owns `chunk` slots of one (lane, KV head) and serves kG of its G query
// heads (q held once in shared memory), so K and V are read once for them.
// Its slots go through shared memory in tiles of kTile = 32 slots, double-
// buffered through cp.async (16-byte copies, rows padded by 16 bytes so
// that a warp reading 8 or 32 rows hits distinct banks): the next tile is
// in flight while one computes, and the SM's other blocks keep more in
// flight.  Per tile:
//   1. logits.  A bfloat16 query on a bfloat16 cache (the model's path)
//      uses the tensor cores: mma.sync m16n8k16 with the heads as rows
//      (padded to 16), q's fragments in registers, K through ldmatrix; the
//      products of two bfloat16 are exact, so only the order of the float32
//      sums differs.  Otherwise (float32 query or cache) a thread takes one
//      slot and a quarter of the head dimension for all kG heads on the
//      CUDA cores, q read as broadcasts;
//   2. softmax: a warp per head takes the tile's max once, one ex2 per
//      (head, slot) and one rescale of the running state per tile, not
//      per slot;
//   3. P.V.  On the tensor cores with V through ldmatrix.trans and P split
//      into two bfloat16 halves (p = hi + lo, 16 bits of each probability
//      kept), each warp owning a quarter of the output columns; on the
//      CUDA cores a thread takes four columns and a quarter of the tile's
//      slots for all kG heads, the quarters summed once at the end.
// The block writes its (max, sum, accumulator) partial; the last block of
// a (lane, KV head, head group) to finish, counted by a device counter that
// it resets itself, merges the partials by log-sum-exp and divides by
// max(sum, 1e-30), as the TPU kernel's finish does: one launch.  A lane
// whose prefix fits one split writes its output directly.
//
// Masking: slots at or past lengths[b] are never read (the TPU kernel
// masked them with -1e30, which gives them weight exactly 0 once a valid
// slot is seen, and a valid prefix always starts at slot 0).  A length of
// 0 or less is the one case where that differs: there every slot was
// masked alike, and the TPU kernel returns the mean of V over all S slots.
// This kernel does the same by reading all S slots with every logit set to
// -1e30.  Lengths past S count as S.  Any S, any G and any D <= 128 work;
// 16-byte copies need 16-byte rows (D * sizeof(T) % 16 == 0) and aligned
// k and v, else the rows are copied one element at a time.
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;     // the TPU kernel's mask and start
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 32;             // slots of a tile
constexpr int kStages = 2;            // tiles in the ring
constexpr int kParts = kThreads / kTile;   // threads of a slot in the logits

__device__ __forceinline__ float ex2(float x) {   // one MUFU op, 2 ulp
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2 bfloat16 in a 32-bit word as floats (a bfloat16 is the top half of its
// float32)
__device__ __forceinline__ void unpack2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// 8 elements of a shared-memory row as floats (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&r)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack2(u.x, r[0], r[1]);
  unpack2(u.y, r[2], r[3]);
  unpack2(u.z, r[4], r[5]);
  unpack2(u.w, r[6], r[7]);
}
// 4 elements (aligned to 4 elements)
__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&r)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack2(u.x, r[0], r[1]);
  unpack2(u.y, r[2], r[3]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory without waiting; `in` false fills
// zeros (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// D += A . B on the tensor cores, m16n8k16, bfloat16 in, float32 sums;
// rows 8..15 of A are zero here (at most 8 heads a block)
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0,
                                         unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// two 8 x 8 bfloat16 matrices from shared memory, lanes 0-15 giving the
// rows; .trans delivers them transposed
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned& r0, unsigned& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}
// two floats as a bfloat16 pair (the first in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// slots [0, n) of lane b are attended; n = S when every slot is masked
__device__ __forceinline__ int attended(int len, int s) {
  return len <= 0 ? s : min(len, s);
}

// The shared-memory layout of one block, in bytes from the start.
template <typename T, int kG>
struct Layout {
  int dp, stride;          // head dim padded to 8 * kParts; row in elements
  int ring, qs, lg, ps, state, ticket, bytes;
  __host__ __device__ explicit Layout(int d) {
    const int unit = 8 * kParts;
    dp = (d + unit - 1) / unit * unit;
    stride = dp + 16 / static_cast<int>(sizeof(T));
    ring = 0;                      // [kStages][K, V][kTile][stride]
    qs = kStages * 2 * kTile * stride * static_cast<int>(sizeof(T));
    lg = qs + kG * dp * 4;         // [kParts][kG][kTile] (one part: mma)
    ps = lg + kParts * kG * kTile * 4;       // [kG][kTile]
    state = ps + kG * kTile * 4;             // m, l, corr: [3][kG]
    ticket = state + 3 * kG * 4;
    bytes = ticket + 16;
  }
};

template <typename TQ, typename T, int kG>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int* __restrict__ counters,
    TQ* __restrict__ out, int s_len, int hkv, int g_all, int d, int chunk,
    float scale2, bool vec) {
  using Lay = Layout<T, kG>;
  constexpr int kRowSlots = kTile / kWarps;        // slots of a warp in P.V
  // a bfloat16 query on a bfloat16 cache runs the products on the tensor
  // cores; otherwise CUDA cores in float32
  constexpr bool kMma = std::is_same_v<TQ, __nv_bfloat16> &&
                        std::is_same_v<T, __nv_bfloat16>;
  constexpr int kLgParts = kMma ? 1 : kParts;      // parts of a logit
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay lay(d);
  const int dp = lay.dp, stride = lay.stride;
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* lg = reinterpret_cast<float*>(smem + lay.lg);
  float* ps = reinterpret_cast<float*>(smem + lay.ps);
  float* sm = reinterpret_cast<float*>(smem + lay.state);
  float* sl = sm + kG;
  float* sc = sl + kG;
  int* ticket = reinterpret_cast<int*>(smem + lay.ticket);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = blockIdx.z * kG;
  const int gn = min(kG, g_all - g0);

  // the slots [s0, s1) of split blockIdx.x of (lane b, KV head kvh); the
  // `live` splits below ceil(n / chunk) cover the n attended slots once
  const int split = blockIdx.x;
  const int sg = blockIdx.y;                     // b * hkv + kvh
  const int b = sg / hkv;
  const int kvh = sg - b * hkv;
  const int len = lengths[b];
  const bool masked = len <= 0;
  const int n = attended(len, s_len);
  const int s0 = split * chunk;
  if (s0 >= n) return;                 // past the prefix: no partial
  const int s1 = min(s0 + chunk, n);
  const int live = (n + chunk - 1) / chunk;
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  const long long base = (static_cast<long long>(b) * s_len * hkv + kvh) * d;

  const long long row = static_cast<long long>(hkv) * d;   // slot stride
  const int c4 = lane * 4;             // P.V columns [c4, c4 + 4)
  // the tensor-core path: lane = 4 * group + tig holds row `group` of the
  // m16n8k16 fragments (rows 8..15 are zero) and columns 2 * tig, + 1 and
  // + 8; q's A fragments stay in registers, warp w takes slots [8w, 8w + 8)
  // of a tile for the logits and columns [w * nt * 8, (w + 1) * nt * 8) of
  // the output, nt = dp / 32 column tiles of 8
  const int group = lane >> 2, tig = lane & 3;
  const int nks = dp / 16, ntw = dp / 32;

  // columns [d, dp) of every ring row stay zero (the copies fill [0, d))
  if (d < dp) {
    for (int e = tid; e < kStages * 2 * kTile * (dp - d); e += kThreads) {
      const int r = e / (dp - d);
      ring[r * stride + d + (e - r * (dp - d))] = from_f32<T>(0.0f);
    }
  }

  auto load_tile = [&](int it) {
    const int ts = s0 + it * kTile;
    const int tn = min(kTile, s1 - ts);
    T* kd = ring + (it % kStages) * 2 * kTile * stride;
    T* vd = kd + kTile * stride;
    const T* ks = k + base + ts * row;
    const T* vs = v + base + ts * row;
    if (vec) {
      constexpr int kEach = 16 / static_cast<int>(sizeof(T));
      const int words = d / kEach;              // 16-byte words a row
      // rows past the split are zero-filled: the tensor cores multiply
      // them by a probability of 0, which a stale NaN would spoil
      if (kThreads % words == 0) {
        const int wd = tid % words;
        const int step = kThreads / words;
        for (int r = tid / words; r < kTile; r += step) {
          const long long o = r < tn ? r * row + wd * kEach : 0;
          cp_async16(kd + r * stride + wd * kEach, ks + o, r < tn);
          cp_async16(vd + r * stride + wd * kEach, vs + o, r < tn);
        }
      } else {
        for (int e = tid; e < kTile * words; e += kThreads) {
          const int r = e / words;
          const int wd = e - r * words;
          const long long o = r < tn ? r * row + wd * kEach : 0;
          cp_async16(kd + r * stride + wd * kEach, ks + o, r < tn);
          cp_async16(vd + r * stride + wd * kEach, vs + o, r < tn);
        }
      }
    } else {
      for (int e = tid; e < kTile * d; e += kThreads) {
        const int r = e / d;
        const int c = e - r * d;
        kd[r * stride + c] = r < tn ? ks[r * row + c] : from_f32<T>(0.0f);
        vd[r * stride + c] = r < tn ? vs[r * row + c] : from_f32<T>(0.0f);
      }
    }
    cp_commit();
  };

  // start the copies first, then set up while they fly
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    else cp_commit();
  }
  const TQ* qb = q + (static_cast<long long>(b) * hkv * g_all +
                      static_cast<long long>(kvh) * g_all + g0) * d;
  for (int e = tid; e < kG * dp; e += kThreads) {
    const int g = e / dp;
    const int c = e - g * dp;
    qs[e] = g < gn && c < d ? to_f32(qb[g * d + c]) : 0.0f;
  }
  if (tid < kG) {
    sm[tid] = kMasked;
    sl[tid] = 0.0f;
    sc[tid] = 1.0f;
  }
  float acc[kG][4];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
  unsigned qa[8][2];
  float oacc[4][4];
  if constexpr (kMma) {
    __syncthreads();                 // qs is written
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float* qr = qs + group * dp + ks * 16 + 2 * tig;
      const bool in = group < kG && ks < nks;
      qa[ks][0] = in ? pack_bf16(qr[0], qr[1]) : 0u;
      qa[ks][1] = in ? pack_bf16(qr[8], qr[9]) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();    // tile it landed; tile it - 1's stage is free
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    else cp_commit();
    const int tn = min(kTile, s1 - (s0 + it * kTile));
    const T* kd = ring + (it % kStages) * 2 * kTile * stride;
    const T* vd = kd + kTile * stride;

    // 1. logits, in log2 units (scale2 = scale * log2 e)
    if constexpr (kMma) {
      const int nbs = warp * 8;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks < nks) {
          unsigned b0, b1;
          ldsm_x2(b0, b1, kd + (nbs + (lane & 7)) * stride + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma16816(c, qa[ks][0], qa[ks][1], b0, b1);
        }
      }
      if (group < kG)
        *reinterpret_cast<float2*>(lg + group * kTile + nbs + 2 * tig) =
            make_float2(c[0], c[1]);
    } else {
      const int s = tid % kTile;
      const int part = tid / kTile;
      const int per = dp / kParts;
      float dot[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) dot[g] = 0.0f;
      if (s < tn) {
        const T* kr = kd + s * stride + part * per;
        const float* qp = qs + part * per;
        for (int e = 0; e < per; e += 8) {
          float kf[8];
          load8(kr + e, kf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float qf[8];
            load8(qp + g * dp + e, qf);
#pragma unroll
            for (int u = 0; u < 8; ++u) dot[g] = fmaf(qf[u], kf[u], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) lg[(part * kG + g) * kTile + s] = dot[g];
    }
    __syncthreads();

    // 2. one max and one rescale a head and tile
    for (int g = warp; g < gn; g += kWarps) {
      float lv[kTile / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int s = lane + 32 * u;
        float xl = -INFINITY;
        if (s < tn) {
          float dot = 0.0f;
#pragma unroll
          for (int p = 0; p < kLgParts; ++p)
            dot += lg[(p * kG + g) * kTile + s];
          xl = masked ? kMasked : dot * scale2;
        }
        lv[u] = xl;
        mx = fmaxf(mx, xl);
      }
      mx = warp_max(mx);
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const float p = ex2(lv[u] - m_new);   // 0 past the tile's slots
        ps[g * kTile + lane + 32 * u] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = ex2(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P . V; on the tensor cores P goes in as two
    // bfloat16 halves, p = hi + lo, so the sum keeps 16 bits of each
    // probability
    if constexpr (kMma) {
      const bool rowg = group < gn;
      const float corr = rowg ? sc[group] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        oacc[nt][0] *= corr;
        oacc[nt][1] *= corr;
      }
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        float2 p0 = make_float2(0.0f, 0.0f), p8 = p0;
        if (rowg) {
          p0 = *reinterpret_cast<const float2*>(ps + group * kTile +
                                                ks * 16 + 2 * tig);
          p8 = *reinterpret_cast<const float2*>(ps + group * kTile +
                                                ks * 16 + 8 + 2 * tig);
        }
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(p0.x, p0.y);
        const __nv_bfloat162 h8 = __floats2bfloat162_rn(p8.x, p8.y);
        const unsigned a0 = *reinterpret_cast<const unsigned*>(&h0);
        const unsigned a8 = *reinterpret_cast<const unsigned*>(&h8);
        const unsigned r0 = pack_bf16(p0.x - __low2float(h0),
                                      p0.y - __high2float(h0));
        const unsigned r8 = pack_bf16(p8.x - __low2float(h8),
                                      p8.y - __high2float(h8));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntw) {
            unsigned b0, b1;
            ldsm_x2_trans(b0, b1, vd + (ks * 16 + (lane & 15)) * stride +
                                      (warp * ntw + nt) * 8);
            mma16816(oacc[nt], a0, a8, b0, b1);
            mma16816(oacc[nt], r0, r8, b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < gn) {
          const float corr = sc[g];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
        }
      }
      if (c4 < dp) {
        const int sb = warp * kRowSlots;
        const int sn = min(sb + kRowSlots, tn);
        for (int s = sb; s < sn; ++s) {
          float vf[4];
          load4(vd + s * stride + c4, vf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < gn) {
              const float p = ps[g * kTile + s];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[g][e] = fmaf(p, vf[e], acc[g][e]);
            }
          }
        }
      }
    }
  }

  // the split's (max, sum, accumulator): straight to the output when it
  // is the lane's only split, else a partial at row sg * nsplit + split
  const bool alone = live == 1;
  const long long obase =
      (static_cast<long long>(b) * hkv * g_all +
       static_cast<long long>(kvh) * g_all + g0) * d;
  const long long prow =
      (static_cast<long long>(sg) * gridDim.x + split) * g_all + g0;
  cp_wait<0>();
  __syncthreads();
  if constexpr (kMma) {              // each warp owns its columns
    if (group < gn) {
      const float norm = fmaxf(sl[group], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = (warp * ntw + nt) * 8 + 2 * tig + u;
          if (nt < ntw && e < d) {
            if (alone)
              out[obase + group * d + e] = from_f32<TQ>(oacc[nt][u] / norm);
            else
              part_acc[(prow + group) * d + e] = oacc[nt][u];
          }
        }
      }
    }
  } else {                           // sum the warps' accumulators
    float* red = reinterpret_cast<float*>(smem + lay.ring);
    if (c4 < dp) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        *reinterpret_cast<float4*>(red + (warp * kG + g) * dp + c4) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    __syncthreads();
    for (int e = tid; e < gn * d; e += kThreads) {
      const int g = e / d;
      const int c = e - g * d;
      float a = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) a += red[(wp * kG + g) * dp + c];
      if (alone)
        out[obase + e] = from_f32<TQ>(a / fmaxf(sl[g], 1e-30f));
      else
        part_acc[(prow + g) * d + c] = a;
    }
  }
  if (!alone) {
    if (tid < gn) {
      part_m[prow + tid] = sm[tid];
      part_l[prow + tid] = sl[tid];
    }
    __threadfence();                 // the partial before the ticket
    __syncthreads();
    int* counter = counters + static_cast<long long>(sg) * gridDim.z +
                   blockIdx.z;
    if (tid == 0) *ticket = atomicAdd(counter, 1);
    __syncthreads();
    if (*ticket == live - 1) {
      // the last split of (lane, KV head) to finish merges them: a warp a
      // head takes the max and each split's weight (kept in the ring
      // where they fit), then every thread sums its columns over the
      // splits
      __threadfence();
      const int np = live;
      const long long p0 =
          static_cast<long long>(sg) * gridDim.x * g_all + g0;
      const int cap = lay.qs / 4 / kG;   // weights a head in the ring
      float* wts = reinterpret_cast<float*>(smem + lay.ring);
      for (int g = warp; g < gn; g += kWarps) {
        float mx = kMasked;
        for (int j = lane; j < np; j += 32)
          mx = fmaxf(mx, __ldcg(part_m + p0 + j * g_all + g));
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int j = lane; j < np; j += 32) {
          const long long pj = p0 + j * g_all + g;
          const float wj = ex2(__ldcg(part_m + pj) - mx);
          sum = fmaf(wj, __ldcg(part_l + pj), sum);
          if (j < cap) wts[g * cap + j] = wj;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          sm[g] = mx;
          sl[g] = fmaxf(sum, 1e-30f);
        }
      }
      __syncthreads();
      for (int e = tid; e < gn * d; e += kThreads) {
        const int g = e / d;
        const int c = e - g * d;
        const float* pa = part_acc + (p0 + g) * d + c;
        const long long jstride = static_cast<long long>(g_all) * d;
        const int fast = min(np, cap);
        float a = 0.0f;
#pragma unroll 8
        for (int j = 0; j < fast; ++j)
          a = fmaf(wts[g * cap + j], __ldcg(pa + j * jstride), a);
        for (int j = fast; j < np; ++j)
          a = fmaf(ex2(__ldcg(part_m + p0 + j * g_all + g) - sm[g]),
                   __ldcg(pa + j * jstride), a);
        out[obase + e] = from_f32<TQ>(a / sl[g]);
      }
      if (tid == 0) *counter = 0;    // ready for the next launch
    }
  }
}

struct Args {
  const void *q, *k, *v, *lengths;
  void *out, *part_m, *part_l, *part_acc, *counters;
  int b, s_len, h_all, hkv, d, chunk;
  float scale2;
  bool vec;
  cudaStream_t stream;
};

template <typename TQ, typename T, int kG>
int launch(const Args& a) {
  auto kern = decode_attention_kernel<TQ, T, kG>;
  const int bytes = Layout<T, kG>(a.d).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int g_all = a.h_all / a.hkv;
  const dim3 grid(static_cast<unsigned>((a.s_len + a.chunk - 1) / a.chunk),
                  static_cast<unsigned>(a.b * a.hkv),
                  static_cast<unsigned>((g_all + kG - 1) / kG));
  kern<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), static_cast<int*>(a.counters),
      static_cast<TQ*>(a.out), a.s_len, a.hkv, g_all, a.d, a.chunk,
      a.scale2, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// kG = 1, 2 or 4 query heads a block where G is that small (no idle
// accumulators), else 8 (more heads run as further head groups)
template <typename TQ, typename T>
int by_heads(const Args& a) {
  const int g = a.h_all / a.hkv;
  if (g == 1) return launch<TQ, T, 1>(a);
  if (g == 2) return launch<TQ, T, 2>(a);
  if (g <= 4) return launch<TQ, T, 4>(a);
  return launch<TQ, T, 8>(a);
}

}  // namespace

extern "C" {

// q (b, h, d), k/v (b, s, hkv, d), lengths (b,) int32, out (b, h, d) of q's
// type, all contiguous; part_m/part_l (b * hkv, ceil(s / chunk), h / hkv)
// and part_acc (..., d) float32 scratch; counters (b * h) int32, zero
// before the first launch and left zero by every launch.  chunk: slots a
// split.  q_dtype, kv_dtype: 0 = float32, 1 = bfloat16.  The model's query
// and cache share a type; a float32 query on a bfloat16 cache gives float32
// outputs, which is how the bfloat16 cache is held to its plain version at
// float32 tolerances.  A bfloat16 query on a float32 cache is refused.
int rt_decode_attention(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* part_m,
                        void* part_l, void* part_acc, void* counters,
                        long long b, long long s_len, long long h_all,
                        long long hkv, long long d, long long chunk,
                        int q_dtype, int kv_dtype, float scale,
                        void* stream) {
  if (b == 0 || h_all == 0) return static_cast<int>(cudaGetLastError());
  if (s_len < 1 || hkv < 1 || h_all % hkv != 0 || d < 1 || d > 128 ||
      chunk < 1 || b * hkv > 65535 || (h_all / hkv + 7) / 8 > 65535 ||
      b * h_all >= (1LL << 31) || s_len >= (1LL << 31) ||
      chunk >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = kv_dtype == 1 ? 2 : 4;
  // 16-byte copies need 16-byte rows and aligned k, v
  const bool vec = d * elem % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const Args a{q, k, v, lengths, out, part_m, part_l, part_acc, counters,
               static_cast<int>(b), static_cast<int>(s_len),
               static_cast<int>(h_all), static_cast<int>(hkv),
               static_cast<int>(d), static_cast<int>(chunk),
               scale * kLog2e, vec, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_heads<float, float>(a);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_heads<float, __nv_bfloat16>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_heads<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
