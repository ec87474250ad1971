// Device code of the attention kernel (K3): its constants, tile loaders,
// register-fragment pieces and bf16 bodies, and their launches. The design
// note and the C entry point are in attention.cu; attention_max_probs.cu,
// attention_max_output.cu, attention_clamp_probs.cu and
// attention_clamp_output.cu each instantiate the bodies of one (kMax,
// kProbs) pair, so that nvcc compiles the four in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fragments.cuh"

namespace attn {

using bf16 = __nv_bfloat16;
using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;
using frag::ldsm_x4;
using frag::ldsm_x4_t;
using frag::mma_bf16;
using frag::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kPad = 8;                 // elements added to every shared tile row
constexpr int kWholeKeys = 272;         // keys the whole-head body holds (17 x 16)
constexpr int kWholeTiles = kWholeKeys / 8;
constexpr int kChunkKeys = 64;          // keys per streaming stage
constexpr int kChunkTiles = kChunkKeys / 8;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

enum Body : int { kBodyF32 = 0, kBodyWhole = 1, kBodyStream = 2 };
// flags: q/k/v copied 16 bytes at a time; o stored two values at a time; K
// stored with unit stride on L (its tile is [D][keys]).
enum Flag : int { kVecQ = 1, kVecK = 2, kVecV = 4, kPairO = 8, kKT = 16 };

struct Strides {
  long long b, h, l, d;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, lq, lk, d;
  int dpad;             // d rounded up to 32 (bf16 bodies: 16 KD) or to 16 (f32)
  int ldt;              // pitch of a [rows][D] tile: dpad + kPad
  int tiles_per_block;  // 16-row query tiles of one block
  float scale, clamp;
  int flags;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Rows [row0, row0 + nrows) of a (len, d) matrix with element strides
// (sl, sd) into shared memory as [nrows][dpad] with pitch ld. Rows at or
// beyond len and columns at or beyond d are zero. With `vec` (unit stride on
// d, d % (16 / sizeof(T)) == 0, 16-byte aligned rows), 16 bytes a thread by
// cp.async, zero-filled where out of range, which completes later
// (cp_async_wait); else one value at a time, synchronously, walking the
// unit-stride axis fastest so that neighbouring threads read neighbouring
// addresses.
template <typename T>
__device__ inline void load_rows(T* dst, int ld, const T* src, long long sl, long long sd, int row0, int nrows,
                          int len, int d, int dpad, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int chunks = dpad / kVec;
    for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i % chunks) * kVec, row = row0 + r;
      const bool ok = row < len && c < d;
      cp_async16(dst + r * ld + c, ok ? src + (long long)row * sl + c : src, ok ? 16 : 0);
    }
    return;
  }
  const bool d_fast = sd == 1 || sl != 1;
#pragma unroll 4
  for (int i = threadIdx.x; i < nrows * dpad; i += blockDim.x) {
    int r, c;
    if (d_fast) {
      r = i / dpad;
      c = i % dpad;
    } else {
      c = i / nrows;
      r = i % nrows;
    }
    const int row = row0 + r;
    T val = T(0.f);
    if (row < len && c < d) val = src[(long long)row * sl + (long long)c * sd];
    dst[r * ld + c] = val;
  }
}

// Keys [key0, key0 + nkeys) of a (len, d) matrix stored with unit stride on
// the key axis, transposed into shared memory as [dpad][nkeys] with pitch
// ld: dst[c * ld + r] = src[key0 + r][c], zero out of range. With `vec` (sd
// a multiple of 8, 16-byte aligned base; key0 and nkeys multiples of 8),
// eight keys a thread by cp.async; else one value at a time.
__device__ inline void load_cols(bf16* dst, int ld, const bf16* src, long long sd, int key0, int nkeys, int len, int d,
                          int dpad, bool vec) {
  if (vec) {
    const int groups = nkeys / 8;
    for (int i = threadIdx.x; i < dpad * groups; i += blockDim.x) {
      const int c = i / groups, r = (i % groups) * 8, key = key0 + r;
      const int n = c < d ? max(0, min(8, len - key)) : 0;
      cp_async16(dst + c * ld + r, n > 0 ? src + (long long)c * sd + key : src, 2 * n);
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < dpad * nkeys; i += blockDim.x) {
    const int c = i / nkeys, r = i % nkeys, key = key0 + r;
    dst[c * ld + r] = c < d && key < len ? src[(long long)c * sd + key] : __float2bfloat16(0.f);
  }
}

// 2^x on the SFU: within a few f32 ulps of exp2f, far inside the kernel's
// tolerance against the plain version.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// q[row][col, col + 1] as one A-fragment register; zero out of range.
__device__ __forceinline__ uint32_t q_pair(const bf16* qb, const Params& p, int row, int col, bool vec) {
  if (row >= p.lq || col >= p.d) return 0u;
  const bf16* r = qb + row * p.sq.l;
  if (vec) return *reinterpret_cast<const uint32_t*>(r + col);  // d % 8 == 0, so col + 1 < d
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 lo = r[col * p.sq.d], hi = col + 1 < p.d ? r[(col + 1) * p.sq.d] : zero;
  return (uint32_t)__bfloat16_as_ushort(hi) << 16 | __bfloat16_as_ushort(lo);
}

// The A fragments of query rows [row0, row0 + 16) for the KD k16 steps of D.
template <int KD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[KD][4], const bf16* qb, const Params& p, int row0, int lane) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const bool vec = p.flags & kVecQ;
#pragma unroll
  for (int t = 0; t < KD; ++t) {
    qf[t][0] = q_pair(qb, p, row0 + g, 16 * t + c, vec);
    qf[t][1] = q_pair(qb, p, row0 + g + 8, 16 * t + c, vec);
    qf[t][2] = q_pair(qb, p, row0 + g, 16 * t + c + 8, vec);
    qf[t][3] = q_pair(qb, p, row0 + g + 8, 16 * t + c + 8, vec);
  }
}

// s = q . k^T for this warp's 16 rows and the kTiles x 8 keys of the tile
// at ks: a [keys][D] tile read by ldmatrix, or with kKT a [D][keys] tile
// read by ldmatrix.trans. One ldmatrix.x4 gives the B fragments of two key
// tiles: its matrices are (keys 16u + 8 q8 .., D 16t + 8 hi8 ..).
template <int kTiles, bool kKT, int KD>
__device__ __forceinline__ void warp_logits(float (&s)[kTiles][4], const uint32_t (&qf)[KD][4], const bf16* ks,
                                            int ld, int lane) {
  const int lr = lane & 7, hi8 = (lane >> 3) & 1, q8 = lane >> 4;
  const bf16* base = kKT ? ks + (lr + 8 * hi8) * ld + 8 * q8 : ks + (lr + 8 * q8) * ld + 8 * hi8;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < KD; ++t) {
#pragma unroll
    for (int u = 0; u < kTiles / 2; ++u) {
      uint32_t b[4];
      if (kKT)
        ldsm_x4_t(b, base + t * 16 * ld + u * 16);
      else
        ldsm_x4(b, base + u * 16 * ld + t * 16);
      mma_bf16(s[2 * u], qf[t], b[0], b[1]);
      mma_bf16(s[2 * u + 1], qf[t], b[2], b[3]);
    }
  }
}

// Logits scaled [and rounded to bf16], clamped for the clamped variants;
// keys at or beyond lk become -inf, whose exp is 0.
template <int kTiles, bool kMax, bool kRound>
__device__ __forceinline__ void prep_logits(float (&s)[kTiles][4], const Params& p, int key0, int lane) {
  const int c = key0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[n][i] * p.scale;
      if (kRound) x = __bfloat162float(__float2bfloat16(x));
      if (!kMax) x = fminf(fmaxf(x, -p.clamp), p.clamp);
      s[n][i] = c + 8 * n + (i & 1) < p.lk ? x : -INFINITY;
    }
  }
}

// The row max of rows g (m0) and g + 8 (m1) over these logits.
template <int kTiles>
__device__ __forceinline__ void row_max(const float (&s)[kTiles][4], float& m0, float& m1) {
  m0 = m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// s <- exp(s - m) in place; adds this lane's part of each row's sum to l0, l1.
template <int kTiles>
__device__ __forceinline__ void exps(float (&s)[kTiles][4], float m0, float m1, float& l0, float& l1) {
  const float n0 = -m0 * kLog2e, n1 = -m1 * kLog2e;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    s[n][0] = ex2(fmaf(s[n][0], kLog2e, n0));
    s[n][1] = ex2(fmaf(s[n][1], kLog2e, n0));
    s[n][2] = ex2(fmaf(s[n][2], kLog2e, n1));
    s[n][3] = ex2(fmaf(s[n][3], kLog2e, n1));
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
}

// p = s * f rounded to bf16, as the A fragments of the PV product: key step
// j is accumulator tiles 2j (columns 0-7) and 2j + 1 (columns 8-15).
template <int kSteps>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kSteps][4], const float (&s)[2 * kSteps][4], float f0,
                                       float f1) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0] * f0, s[2 * j][1] * f0);
    pa[j][1] = pack_bf16(s[2 * j][2] * f1, s[2 * j][3] * f1);
    pa[j][2] = pack_bf16(s[2 * j + 1][0] * f0, s[2 * j + 1][1] * f0);
    pa[j][3] = pack_bf16(s[2 * j + 1][2] * f1, s[2 * j + 1][3] * f1);
  }
}

// o += p . v over kSteps x 16 keys of the [keys][D] tile at vs. One
// ldmatrix.x4.trans gives the B fragments of two d tiles: its matrices are
// (keys 16j + 8 hi8 .., D 16w + 8 q8 ..).
template <int KD, int kSteps>
__device__ __forceinline__ void warp_pv(float (&o)[2 * KD][4], const uint32_t (&pa)[kSteps][4], const bf16* vs,
                                        int ld, int lane) {
  const int lr = lane & 7, hi8 = (lane >> 3) & 1, q8 = lane >> 4;
  const bf16* base = vs + (lr + 8 * hi8) * ld + 8 * q8;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int w = 0; w < KD; ++w) {
      uint32_t b[4];
      ldsm_x4_t(b, base + j * 16 * ld + w * 16);
      mma_bf16(o[2 * w], pa[j], b[0], b[1]);
      mma_bf16(o[2 * w + 1], pa[j], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(bf16* ob, const Params& p, int row, int col, float a, float b, bool pairs) {
  if (row >= p.lq || col >= p.d) return;
  bf16* r = ob + row * p.so.l;
  if (pairs) {  // unit stride, d even
    *reinterpret_cast<__nv_bfloat162*>(r + col) = __floats2bfloat162_rn(a, b);
    return;
  }
  r[col * p.so.d] = __float2bfloat16(a);
  if (col + 1 < p.d) r[(col + 1) * p.so.d] = __float2bfloat16(b);
}

// Rows [row0, row0 + 16) of the output: o times f0 (row g) and f1 (row g + 8).
template <int KD>
__device__ __forceinline__ void store_o(bf16* ob, const Params& p, const float (&o)[2 * KD][4], int row0, float f0,
                                        float f1, int lane) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const bool pairs = p.flags & kPairO;
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n) {
    store2(ob, p, row0 + g, 8 * n + c, o[n][0] * f0, o[n][1] * f0, pairs);
    store2(ob, p, row0 + g + 8, 8 * n + c, o[n][2] * f1, o[n][3] * f1, pairs);
  }
}

struct HeadPtrs {
  const bf16 *q, *k, *v;
  bf16* o;
};

__device__ __forceinline__ HeadPtrs head_ptrs(const Params& p) {
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  return {static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h,
          static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h,
          static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h,
          static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h};
}

// --- whole-head body: Lk <= 272, K and V loaded once per block ------------
template <bool kMax, bool kProbs, bool kRound, int KD>
__global__ void __launch_bounds__(kThreads, 2) attention_whole(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool kt = p.flags & kKT;
  const int ldk = kt ? kWholeKeys + kPad : p.ldt;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (kt ? p.dpad * ldk : kWholeKeys * p.ldt);
  const HeadPtrs hp = head_ptrs(p);

  if (kt)
    load_cols(ks, ldk, hp.k, p.sk.d, 0, kWholeKeys, p.lk, p.d, p.dpad, p.flags & kVecK);
  else
    load_rows(ks, ldk, hp.k, p.sk.l, p.sk.d, 0, kWholeKeys, p.lk, p.d, p.dpad, p.flags & kVecK);
  cp_async_commit();
  load_rows(vs, p.ldt, hp.v, p.sv.l, p.sv.d, 0, kWholeKeys, p.lk, p.d, p.dpad, p.flags & kVecV);
  cp_async_commit();

  const int t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(t0 + p.tiles_per_block, (p.lq + 15) / 16);
  const int rounds = (t1 - t0 + kWarps - 1) / kWarps;
  uint32_t qf[KD][4];
  if (t0 + warp < t1) load_q(qf, hp.q, p, (t0 + warp) * 16, lane);
  cp_async_wait<1>();
  __syncthreads();  // K is in shared memory

  for (int r = 0; r < rounds; ++r) {
    const int tile = t0 + r * kWarps + warp;
    const bool live = tile < t1;  // the same for the whole warp
    uint32_t pa[kWholeTiles / 2][4];
    float l0 = 0.f, l1 = 0.f;
    if (live) {
      float s[kWholeTiles][4];
      if (kt)
        warp_logits<kWholeTiles, true>(s, qf, ks, ldk, lane);
      else
        warp_logits<kWholeTiles, false>(s, qf, ks, ldk, lane);
      prep_logits<kWholeTiles, kMax, kRound>(s, p, 0, lane);
      float m0 = 0.f, m1 = 0.f;
      if (kMax) row_max(s, m0, m1);
      exps(s, m0, m1, l0, l1);
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      pack_p(pa, s, kProbs ? 1.f / l0 : 1.f, kProbs ? 1.f / l1 : 1.f);
      if (tile + kWarps < t1) load_q(qf, hp.q, p, (tile + kWarps) * 16, lane);  // overlaps PV
    }
    if (r == 0) {
      cp_async_wait<0>();
      __syncthreads();  // V is in shared memory
    }
    if (live) {
      float o[2 * KD][4];
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      warp_pv<KD>(o, pa, vs, p.ldt, lane);
      store_o<KD>(hp.o, p, o, tile * 16, kProbs ? 1.f : 1.f / l0, kProbs ? 1.f : 1.f / l1, lane);
    }
  }
}

// --- streaming body: any Lk, 64-key chunks through a cp.async ring --------
template <bool kMax, bool kProbs, bool kRound, int KD>
__global__ void __launch_bounds__(kThreads, 2) attention_stream(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool kt = p.flags & kKT;
  const int ldk = kt ? kChunkKeys + kPad : p.ldt;
  const int k_elems = kt ? p.dpad * ldk : kChunkKeys * p.ldt;
  const int stage_elems = k_elems + kChunkKeys * p.ldt;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const HeadPtrs hp = head_ptrs(p);
  const int tile = blockIdx.x * kWarps + warp;  // tiles_per_block == kWarps
  const bool live = tile * 16 < p.lq;

  // Stages: [pass 1: K chunk 0 .. n-1,] then (K, V) chunk 0 .. n-1.
  constexpr bool kTwoPass = kMax || kProbs;
  const int chunks = (p.lk + kChunkKeys - 1) / kChunkKeys;
  const int first = kTwoPass ? chunks : 0;
  const int stages = first + chunks;
  auto prefetch = [&](int st) {
    bf16* buf = ring + (st % kStages) * stage_elems;
    const int c0 = (st < first ? st : st - first) * kChunkKeys;
    if (kt)
      load_cols(buf, ldk, hp.k, p.sk.d, c0, kChunkKeys, p.lk, p.d, p.dpad, p.flags & kVecK);
    else
      load_rows(buf, ldk, hp.k, p.sk.l, p.sk.d, c0, kChunkKeys, p.lk, p.d, p.dpad, p.flags & kVecK);
    if (st >= first)
      load_rows(buf + k_elems, p.ldt, hp.v, p.sv.l, p.sv.d, c0, kChunkKeys, p.lk, p.d, p.dpad, p.flags & kVecV);
  };

  uint32_t qf[KD][4];
  if (live) load_q(qf, hp.q, p, tile * 16, lane);
  prefetch(0);
  cp_async_commit();
  if (stages > 1) prefetch(1);
  cp_async_commit();

  float m0 = kMax ? -INFINITY : 0.f, m1 = m0;  // row max so far (pass 1)
  float l0 = 0.f, l1 = 0.f;                    // this lane's part of the row sums
  float f0 = 1.f, f1 = 1.f;                    // 1 / row sum for kProbs, from pass 1
  float o[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int st = 0; st < stages; ++st) {
    cp_async_wait<1>();
    __syncthreads();  // stage st is in shared memory; stage st - 1's buffer is free
    if (st + 2 < stages) prefetch(st + 2);
    cp_async_commit();
    if (!live) continue;
    const bf16* buf = ring + (st % kStages) * stage_elems;
    const int c0 = (st < first ? st : st - first) * kChunkKeys;
    float s[kChunkTiles][4];
    if (kt)
      warp_logits<kChunkTiles, true>(s, qf, buf, ldk, lane);
    else
      warp_logits<kChunkTiles, false>(s, qf, buf, ldk, lane);
    prep_logits<kChunkTiles, kMax, kRound>(s, p, c0, lane);
    if (st < first) {  // pass 1: the row max and the f32 row sum of exp
      if (kMax) {
        float c_0, c_1;
        row_max(s, c_0, c_1);
        const float n0 = fmaxf(m0, c_0), n1 = fmaxf(m1, c_1);  // finite: a chunk holds a key
        l0 *= ex2((m0 - n0) * kLog2e);
        l1 *= ex2((m1 - n1) * kLog2e);
        m0 = n0;
        m1 = n1;
      }
      exps(s, m0, m1, l0, l1);
      if (st == first - 1) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        if (kProbs) {
          f0 = 1.f / l0;
          f1 = 1.f / l1;
        }
      }
    } else {  // last pass: p [/ l] rounded, o += p . v
      float e0 = 0.f, e1 = 0.f;
      exps(s, m0, m1, e0, e1);
      if (!kTwoPass) {
        l0 += e0;
        l1 += e1;
      }
      uint32_t pa[kChunkTiles / 2][4];
      pack_p(pa, s, f0, f1);
      warp_pv<KD>(o, pa, buf + k_elems, p.ldt, lane);
    }
  }
  if (!live) return;
  if (!kTwoPass) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
  store_o<KD>(hp.o, p, o, tile * 16, kProbs ? 1.f : 1.f / l0, kProbs ? 1.f : 1.f / l1, lane);
}

// --- f32 body's geometry (its kernel is in attention.cu) -------------------
constexpr int kF32Chunk = 64;  // keys per K or V tile
constexpr int kF32Rows = kWarps * 16;
constexpr int kLdc = kF32Chunk + 4;  // pitch of a chunk's logits
constexpr int kLdp = kF32Chunk + 8;  // pitch of a chunk's p

// Bytes of dynamic shared memory each body takes; ops/attention.py's
// attention_plan computes the same and passes it in, and a call whose
// figure differs is refused.
inline size_t smem_bytes(int body, const Params& p) {
  const bool kt = p.flags & kKT;
  const size_t v_chunk = (size_t)kChunkKeys * p.ldt;
  switch (body) {
    case kBodyWhole:
      return 2 * ((kt ? (size_t)p.dpad * (kWholeKeys + kPad) : (size_t)kWholeKeys * p.ldt) +
                  (size_t)kWholeKeys * p.ldt);
    case kBodyStream:
      return 2 * kStages * ((kt ? (size_t)p.dpad * (kChunkKeys + kPad) : v_chunk) + v_chunk);
    default:
      return 4 * ((size_t)(kF32Rows + 2 * kF32Chunk) * p.ldt + (size_t)kF32Rows * kLdc + (size_t)kF32Rows * kLdp);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <bool kMax, bool kProbs, bool kRound, int KD>
cudaError_t launch_body(int body, const Params& p, dim3 grid, size_t smem, cudaStream_t s) {
  if (body == kBodyWhole) return launch(attention_whole<kMax, kProbs, kRound, KD>, p, grid, smem, s);
  return launch(attention_stream<kMax, kProbs, kRound, KD>, p, grid, smem, s);
}

// The bf16 launches of one (kMax, kProbs) pair: KD = dpad / 16 k16 steps of
// D (2, 4, 6 or 8: D padded to a multiple of 32), each body unrolled for it.
template <bool kMax, bool kProbs>
cudaError_t launch_variant(int body, bool round, const Params& p, dim3 grid, size_t smem, cudaStream_t s) {
  switch (p.dpad / 16) {
    case 2:
      return round ? launch_body<kMax, kProbs, true, 2>(body, p, grid, smem, s)
                   : launch_body<kMax, kProbs, false, 2>(body, p, grid, smem, s);
    case 4:
      return round ? launch_body<kMax, kProbs, true, 4>(body, p, grid, smem, s)
                   : launch_body<kMax, kProbs, false, 4>(body, p, grid, smem, s);
    case 6:
      return round ? launch_body<kMax, kProbs, true, 6>(body, p, grid, smem, s)
                   : launch_body<kMax, kProbs, false, 6>(body, p, grid, smem, s);
    case 8:
      return round ? launch_body<kMax, kProbs, true, 8>(body, p, grid, smem, s)
                   : launch_body<kMax, kProbs, false, 8>(body, p, grid, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Each pair is compiled in its own translation unit.
#define VLFM_ATTN_VARIANT(kMax, kProbs) \
  extern template cudaError_t launch_variant<kMax, kProbs>(int, bool, const Params&, dim3, size_t, cudaStream_t);
VLFM_ATTN_VARIANT(true, true)
VLFM_ATTN_VARIANT(true, false)
VLFM_ATTN_VARIANT(false, true)
VLFM_ATTN_VARIANT(false, false)
#undef VLFM_ATTN_VARIANT

}  // namespace attn
