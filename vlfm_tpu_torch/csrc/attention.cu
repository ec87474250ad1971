// Fused attention for NVIDIA Hopper (sm_90a):
//   o = softmax(q . k^T / sqrt(D)) . v      over (B, H, L, D)
// with the logits kept on chip. One template covers every Pallas TPU kernel
// of the JAX package that computes this function (vlfm_tpu_torch/ops/
// attention.py lists them):
//   kMax    row max subtracted before the exp (flash_attention,
//           flash_attention_grouped[_v2]), or else exp(clip(x, -c, c))
//           (the clamped diagnostic kernels, c = 60, and the ViT's bf16
//           softmax, c = 80);
//   kProbs  p / rowsum cast to the input dtype before PV, or else PV on the
//           unnormalised p and the f32 (L, D) result divided by the rowsum;
//   kRound  logits rounded to the input dtype before the exp.
// Any strides: q, k and v may be views of a fused qkv projection, k may be
// stored transposed, and the output may be written in (B, L, H, D) order.
// The plain version is vlfm_tpu_torch/ops/attention.py:attention_ref.
//
// What bounds it on an H100: at the ViT-g shape (32, 16, 257, 88) in bf16
// the function reads q, k and v and writes o, 4 x 23.2 MB, 27.6 us at
// 3.35 TB/s, against 11.9 GFLOP of products, 12.0 us at 989 TFLOP/s. So it
// is bound by memory, and what it must not do is what unfused attention
// does: write the (B, H, L, L) logits to HBM and read them back (135 MB in
// f32 per layer). The design keeps them on chip, 64 keys at a time:
// - one block per (batch * head, tile of 64 queries), 4 warps, each warp
//   owning 16 query rows; 2560 blocks at the ViT-g shape;
// - K and V stream through shared memory in 64-key chunks, double-buffered
//   and filled by cp.async one chunk ahead of the chunk being computed;
// - two passes over the keys where the variant needs the row statistics
//   before any p: the first (K only) takes the row max and the row sum of
//   exp, the sum rescaled as the max grows; the second recomputes each
//   chunk's logits, forms p in the input dtype and accumulates p . v. The
//   clamped, output-normalised variant needs one pass. A chunk's f32
//   logits and its p live in per-warp shared buffers, so shared memory does
//   not grow with L: ~66 KB a block at D = 88, three blocks an SM;
// - both products on the tensor cores (nvcuda::wmma 16x16x16, bf16 in, f32
//   accumulate); D = 88 is zero-padded to 96 in shared memory for the QK^T
//   reduction, keys and queries beyond L are zero rows, and padded keys get
//   p = 0 exactly.
// f32 inputs take the same algorithm with the products on the CUDA cores
// (f32 FMAs): the tensor cores would round the operands.
//
// Plain C interface, bound from Python with ctypes. The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kKeyChunk = 64;  // keys per K or V tile in shared memory
constexpr int kWarps = 4;
constexpr int kQueryTile = kWarps * 16;
constexpr int kMaxD = 128;
constexpr int kMaxDFrags = kMaxD / 16;
constexpr int kLdc = kKeyChunk + 4;  // leading dimension of a chunk's f32 logits
constexpr int kLdp = kKeyChunk + 8;  // leading dimension of a chunk's p

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
  int dpad;   // d rounded up to 16
  int lkpad;  // lk rounded up to 16
  int ldt;    // leading dimension of the Q and K/V tiles (elements)
  float scale, clamp;
  int vec;    // bit 0/1/2: q/k/v may be copied 16 bytes at a time
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }  // nearest even

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + nrows) of a (len, d) matrix with element strides
// (sl, sd) into shared memory (nrows x dpad, leading dimension ld). Rows at
// or beyond len and columns at or beyond d are zero. With `vec`, 16 bytes a
// thread by cp.async (zero-filled where out of range), which completes
// later (cp_async_wait); else one value at a time, synchronously, walking
// the unit-stride axis fastest so that neighbouring threads read
// neighbouring addresses.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long sl, long long sd, int row0, int nrows,
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
    T val = from_f<T>(0.f);
    if (row < len && c < d) val = src[(long long)row * sl + (long long)c * sd];
    dst[r * ld + c] = val;
  }
}

// exp of a logit: after subtracting the row max m, or clamped at +-c. The
// hardware exp2 (__expf) is within a few f32 ulps of expf, far inside the
// kernel's tolerance against the plain version, at a tenth of its
// instructions; the softmax's exps and divides are most of what the kernel
// executes.
template <bool kMax>
__device__ __forceinline__ float stabilized_exp(float x, float m, float c) {
  return kMax ? __expf(x - m) : __expf(fminf(fmaxf(x, -c), c));
}

// This warp's 16 rows of logits for one chunk of keys (nt_count tiles of
// 16), scaled [and rounded], into sc (16 x kLdc f32).
template <typename T, bool kRound>
__device__ __forceinline__ void chunk_logits(const T* qs, const T* kv, float* sc, const Params& p, int r0,
                                             int nt_count, int lane) {
  if constexpr (sizeof(T) == 2) {
    const int kd = p.dpad / 16;
    // four independent accumulators, one per 16 keys of the chunk
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kKeyChunk / 16];
#pragma unroll
    for (int nt = 0; nt < kKeyChunk / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);
#pragma unroll
    for (int t = 0; t < kMaxDFrags; ++t) {
      if (t < kd) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, reinterpret_cast<const bf16*>(qs) + r0 * p.ldt + t * 16, p.ldt);
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 16; ++nt) {
          if (nt < nt_count) {
            // k^T as a column-major (D, keys) matrix: element (c, j) at kv[j * ldt + c]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
            wmma::load_matrix_sync(kf, reinterpret_cast<const bf16*>(kv) + nt * 16 * p.ldt + t * 16, p.ldt);
            wmma::mma_sync(acc[nt], qa, kf, acc[nt]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kKeyChunk / 16; ++nt) {
      if (nt < nt_count) {
        for (int i = 0; i < acc[nt].num_elements; ++i) {
          const float x = acc[nt].x[i] * p.scale;
          acc[nt].x[i] = kRound ? to_f(from_f<T>(x)) : x;
        }
        wmma::store_matrix_sync(sc + nt * 16, acc[nt], kLdc, wmma::mem_row_major);
      }
    }
  } else {
    for (int j = lane; j < nt_count * 16; j += 32) {
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int c = 0; c < p.d; ++c) {
        const float kval = to_f(kv[j * p.ldt + c]);
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[r] = fmaf(to_f(qs[(r0 + r) * p.ldt + c]), kval, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float x = acc[r] * p.scale;
        sc[r * kLdc + j] = kRound ? to_f(from_f<T>(x)) : x;
      }
    }
  }
  __syncwarp();
}

// One block: queries [q0, q0 + 64) of one (batch, head). Lane l of a warp
// keeps the statistics of the warp's row l / 2, over the chunk's keys
// j = 2i + l % 2; the two lanes of a row agree after each chunk.
template <typename T, bool kMax, bool kProbs, bool kRound>
__global__ void __launch_bounds__(kWarps * 32) attention_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row within the tile
  T* qs = reinterpret_cast<T*>(smem);            // kQueryTile x ldt
  T* tiles = qs + kQueryTile * p.ldt;            // 2 x kKeyChunk x ldt
  float* scs = reinterpret_cast<float*>(tiles + 2 * kKeyChunk * p.ldt);  // kQueryTile x kLdc
  float* sc = scs + warp * 16 * kLdc;                                   // this warp's logits
  T* pc = reinterpret_cast<T*>(scs + kQueryTile * kLdc) + warp * 16 * kLdp;  // this warp's p

  const int q0 = blockIdx.x * kQueryTile;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* ob = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr bool kTwoPass = kMax || kProbs;

  // Stages: [pass 1: K chunk 0, ..., K chunk n-1,] then K chunk 0, V chunk
  // 0, K chunk 1, V chunk 1, ... Stage s lives in buffer s & 1; stage s + 1
  // is in flight while stage s is computed.
  const int chunks = (p.lkpad + kKeyChunk - 1) / kKeyChunk;
  const int first = kTwoPass ? chunks : 0;  // the first stage of the last pass
  const int stages = first + 2 * chunks;
  auto prefetch = [&](int st) {
    const bool is_v = st >= first && (st - first) % 2 == 1;
    const int c0 = (st < first ? st : (st - first) / 2) * kKeyChunk;
    const int nk = min(kKeyChunk, p.lkpad - c0);
    T* buf = tiles + (st & 1) * kKeyChunk * p.ldt;
    if (is_v)
      load_tile(buf, p.ldt, vb, p.sv.l, p.sv.d, c0, nk, p.lk, p.d, p.dpad, (p.vec >> 2) & 1);
    else
      load_tile(buf, p.ldt, kb, p.sk.l, p.sk.d, c0, nk, p.lk, p.d, p.dpad, (p.vec >> 1) & 1);
  };

  load_tile(qs, p.ldt, qb, p.sq.l, p.sq.d, q0, kQueryTile, p.lq, p.d, p.dpad, p.vec & 1);
  prefetch(0);
  cp_async_commit();

  const int row = lane >> 1, half = lane & 1;
  const float* srow = sc + row * kLdc;
  T* prow = pc + row * kLdp;
  float m = kMax ? -INFINITY : 0.f;  // row max so far (pass 1)
  float l = 0.f;                     // row sum of exp so far (pass 1)
  float s = 0.f;                     // this lane's part of the row sum of exp in the last pass
  const int kdv = p.dpad / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kMaxDFrags];
  float acc32[16][kMaxD / 32];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int t = 0; t < kMaxDFrags; ++t) wmma::fill_fragment(oacc[t], 0.f);
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < kMaxD / 32; ++t) acc32[r][t] = 0.f;
  }

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      prefetch(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and the Q tile) is in shared memory
    const T* kv = tiles + (st & 1) * kKeyChunk * p.ldt;
    const bool is_v = st >= first && (st - first) % 2 == 1;
    const int c0 = (st < first ? st : (st - first) / 2) * kKeyChunk;
    const int nk = min(kKeyChunk, p.lkpad - c0);
    if (st < first) {
      // pass 1: the row max and the (rescaled) row sum of exp
      chunk_logits<T, kRound>(qs, kv, sc, p, r0, nk / 16, lane);
      float part = 0.f;
      if (kMax) {
        float cm = -INFINITY;
        for (int j = half; j < nk; j += 2)
          if (c0 + j < p.lk) cm = fmaxf(cm, srow[j]);
        const float m_new = fmaxf(m, fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1)));
        for (int j = half; j < nk; j += 2)
          if (c0 + j < p.lk) part += __expf(srow[j] - m_new);
        l *= __expf(m - m_new);
        m = m_new;
      } else {
        for (int j = half; j < nk; j += 2)
          if (c0 + j < p.lk) part += stabilized_exp<false>(srow[j], 0.f, p.clamp);
      }
      l += part + __shfl_xor_sync(0xffffffffu, part, 1);
    } else if (!is_v) {
      // last pass, K chunk: p for this chunk; padded keys get p = 0
      chunk_logits<T, kRound>(qs, kv, sc, p, r0, nk / 16, lane);
      const float inv_l = kProbs ? 1.f / l : 1.f;
      for (int j = half; j < nk; j += 2) {
        const float e = c0 + j < p.lk ? stabilized_exp<kMax>(srow[j], m, p.clamp) : 0.f;
        s += e;
        prow[j] = from_f<T>(kProbs ? e * inv_l : e);
      }
      __syncwarp();
    } else if constexpr (kTensorCores) {
      // last pass, V chunk: o += p . v
      for (int kk = 0; kk < nk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::load_matrix_sync(pa, reinterpret_cast<const bf16*>(pc) + kk * 16, kLdp);
#pragma unroll
        for (int t = 0; t < kMaxDFrags; ++t) {
          if (t < kdv) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
            wmma::load_matrix_sync(vf, reinterpret_cast<const bf16*>(kv) + kk * 16 * p.ldt + t * 16, p.ldt);
            wmma::mma_sync(oacc[t], pa, vf, oacc[t]);
          }
        }
      }
    } else {
      for (int j = 0; j < nk; ++j) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float pv = to_f(pc[r * kLdp + j]);
#pragma unroll
          for (int t = 0; t < kMaxD / 32; ++t) {
            const int c = lane + 32 * t;
            if (c < p.dpad) acc32[r][t] = fmaf(pv, to_f(kv[j * p.ldt + c]), acc32[r][t]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);  // the row sum of lane / 2's row

  // --- epilogue: [divide by the row sum], cast, store -----------------------
  if constexpr (kTensorCores) {
    // the tiles are free now: stage this warp's f32 output rows there
    const int ldo = p.dpad + 4;
    float* os = reinterpret_cast<float*>(tiles) + warp * 16 * ldo;
#pragma unroll
    for (int t = 0; t < kMaxDFrags; ++t)
      if (t < kdv) wmma::store_matrix_sync(os + t * 16, oacc[t], ldo, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const float inv_s = 1.f / __shfl_sync(0xffffffffu, s, 2 * r);
      const int qi = q0 + r0 + r;
      if (qi >= p.lq) continue;
      for (int c = lane; c < p.d; c += 32) {
        const float x = os[r * ldo + c];
        ob[qi * p.so.l + c * p.so.d] = from_f<T>(kProbs ? x : x * inv_s);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float inv_s = 1.f / __shfl_sync(0xffffffffu, s, 2 * r);
      const int qi = q0 + r0 + r;
      if (qi < p.lq) {
#pragma unroll
        for (int t = 0; t < kMaxD / 32; ++t) {
          const int c = lane + 32 * t;
          if (c < p.d) ob[qi * p.so.l + c * p.so.d] = from_f<T>(kProbs ? acc32[r][t] : acc32[r][t] * inv_s);
        }
      }
    }
  }
}

size_t smem_bytes(const Params& p, size_t elem) {
  return (size_t)(kQueryTile + 2 * kKeyChunk) * p.ldt * elem + (size_t)kQueryTile * kLdc * sizeof(float) +
         (size_t)kQueryTile * kLdp * elem;
}

template <typename T, bool kMax, bool kProbs, bool kRound>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, sizeof(T));
  auto kernel = attention_kernel<T, kMax, kProbs, kRound>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.lq + kQueryTile - 1) / kQueryTile, batch_heads);
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename T, bool kMax>
cudaError_t dispatch_norm(const Params& p, int bh, bool probs, bool round, cudaStream_t s) {
  if (probs) return round ? launch<T, kMax, true, true>(p, bh, s) : launch<T, kMax, true, false>(p, bh, s);
  return round ? launch<T, kMax, false, true>(p, bh, s) : launch<T, kMax, false, false>(p, bh, s);
}

}  // namespace

extern "C" {

// q (b, h, lq, d), k and v (b, h, lk, d), o (b, h, lq, d), each with the
// element strides given in `strides` (4 per tensor: b, h, l, d; q, k, v,
// o). stabilize_max: 1 = subtract the row max, 0 = clamp the logits at
// +-clamp. probs: 1 = normalise p before PV, 0 = divide the output.
// round: round the logits to the input dtype. vec: bits 0/1/2 say q/k/v
// may be copied 16 bytes at a time. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value (0 = ok).
int vlfm_attention(const void* q, const void* k, const void* v, void* o, const long long* strides, int b,
                   int h, int lq, int lk, int d, float scale, float clamp, int stabilize_max, int probs,
                   int round, int vec, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 65535) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) *st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  p.heads = h;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.dpad = round_up(d, 16);
  p.lkpad = round_up(lk, 16);
  p.ldt = p.dpad + 8;
  p.scale = scale;
  p.clamp = clamp;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  cudaError_t err;
  if (dtype == 0) {  // rounding f32 logits to f32 is a no-op
    err = stabilize_max ? dispatch_norm<float, true>(p, bh, probs, false, s)
                        : dispatch_norm<float, false>(p, bh, probs, false, s);
  } else if (dtype == 1) {
    err = stabilize_max ? dispatch_norm<bf16, true>(p, bh, probs, round, s)
                        : dispatch_norm<bf16, false>(p, bh, probs, round, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
