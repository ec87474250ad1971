// Fused attention for NVIDIA Hopper (sm_90a):
//   o = softmax(q . k^T / sqrt(D)) . v      over (B, H, L, D)
// with the logits kept on chip. One template covers every Pallas TPU kernel
// of the JAX package that computes this function (vlfm_tpu_torch/ops/
// attention.py lists them: flash_attention_grouped, flash_attention_grouped_v2
// and flash_attention in vlfm_tpu/ops/attention.py, and the diagnostic
// kernels of scripts/diag_attn3.py, diag_attn_core.py and diag_attn_pure.py):
//   kMax    row max subtracted before the exp (flash_attention,
//           flash_attention_grouped[_v2]), or else exp(clip(x, -c, c))
//           (the clamped diagnostic kernels, c = 60, and the ViT's bf16
//           softmax, c = 80);
//   kProbs  p / rowsum cast to the input dtype before PV, or else PV on the
//           unnormalised p and the f32 (L, D) result divided by the rowsum;
//   kRound  logits rounded to the input dtype before the exp.
// Any strides: q, k and v may be views of a fused qkv projection, k may be
// stored transposed, and the output may be written in (B, L, H, D) order.
// The plain version is vlfm_tpu_torch/ops/attention.py:attention_ref; the
// launch plan (body, grid, shared memory) is ops/attention.py:attention_plan.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the ViT-g
// shape (32, 16, 257, 88) in bf16 the function reads q, k and v and writes o
// once, 92.8 MB, 27.6 us; its two products are 11.9 GFLOP, 12.0 us; its
// softmax takes 33.8 M exps, ~8 us on the SFUs at 16 a clock per SM. So it
// is bound by bytes, and what it must not do is what unfused attention does:
// write the (B, H, L, L) logits to HBM and read them back. The bf16 bodies
// keep every intermediate in registers:
// - both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate), one
//   warp per 16 query rows. The QK^T accumulators are the logits: the row
//   max and row sum are taken in the quad of lanes that holds a row
//   (__shfl_xor_sync), p (or p / l for kProbs) is formed in f32, rounded to
//   bf16 where attention_ref rounds it, and repacked straight into the A
//   fragments of the PV product (two adjacent m16n8 accumulator tiles are
//   one k16 A fragment). Logits and p never touch shared memory;
// - K's B fragments come from shared memory by ldmatrix (ldmatrix.trans
//   from a [D][keys] tile when K is stored transposed, the K3d layout), V's
//   by ldmatrix.trans. Tiles are filled by cp.async, 16 bytes a thread, with
//   a row pitch of the padded D + 8 elements (an odd number of 16 bytes), so
//   that the eight rows an ldmatrix reads fall in distinct banks. A tensor that cannot be copied 16 bytes at a
//   time is loaded into the same tiles one element at a time;
// - D is padded to a multiple of 32 (96 at D = 88) and its k16 steps are a
//   template parameter (KD = 2, 4, 6 or 8), so both products unroll with no
//   runtime guard and ptxas schedules each ldmatrix ahead of its mma (a
//   guard on the step count nearly doubled the whole-head body's time on
//   the card: it cut the PV loop into blocks of one ldmatrix and two mma).
//   The four (kMax, kProbs) pairs compile in parallel, one translation unit
//   each (attention_{max,clamp}_{probs,output}.cu);
// - Q is read once from device memory, straight into each warp's A
//   fragments (24 registers at D = 88, zero-padded to 96); the next tile's
//   Q is fetched while the current one's PV runs;
// - whole-head body (Lk <= 272, the main path's 257 tokens): one block per
//   (batch, head) loads K and V whole, once (2 x 272 x 104 x 2 B = 113 KB
//   at D = 88, so two blocks an SM, 8 warps), and its 4 warps walk the 17
//   query tiles of 16 rows: 257 of 272 rows useful (94.5 %; 64-row tiles
//   would make 80 %). A tile's whole logit row, 34 m16n8
//   tiles, is 136 f32 registers; the row max and sum are exact in one pass
//   and QK^T runs once. 512 blocks at B = 32 (1.94 waves of 264), 192 at
//   the spin's 12 views (every SM holds one or two);
// - streaming body (longer Lk, such as 1024 tokens): 64-query blocks, K
//   and V in 64-key chunks through a three-stage cp.async ring, one
//   __syncthreads a stage; two passes where the variant needs the row
//   statistics before any p (the first takes the max and the f32 sum of
//   unrounded exps, rescaled as the max grows; nothing rounded is ever
//   rescaled), one pass for the clamped, output-normalised variant.
// f32 inputs take the CUDA-core body (attention_f32): the same algorithm
// with f32 FMAs, as the tensor cores would round the operands.
//
// Plain C interface, bound from Python with ctypes. The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "attention.cuh"

namespace attn {

// --- f32 body: the same algorithm with f32 FMAs on the CUDA cores ----------

// This warp's 16 rows of logits for one chunk (nk keys), scaled, into sc.
__device__ __forceinline__ void f32_logits(const float* qs, const float* kv, float* sc, const Params& p, int r0,
                                           int nk, int lane) {
  for (int j = lane; j < nk; j += 32) {
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      const float kval = kv[j * p.ldt + c];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = fmaf(qs[(r0 + r) * p.ldt + c], kval, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r * kLdc + j] = acc[r] * p.scale;
  }
  __syncwarp();
}

template <bool kMax>
__device__ __forceinline__ float stabilized_exp(float x, float m, float c) {
  return kMax ? __expf(x - m) : __expf(fminf(fmaxf(x, -c), c));
}

// One block: queries [q0, q0 + 64) of one (batch, head). Lane l of a warp
// keeps the statistics of the warp's row l / 2, over the chunk's keys
// j = 2i + l % 2; the two lanes of a row agree after each chunk.
template <bool kMax, bool kProbs>
__global__ void __launch_bounds__(kThreads) attention_f32(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float* qs = reinterpret_cast<float*>(smem);    // kF32Rows x ldt
  float* tiles = qs + kF32Rows * p.ldt;          // 2 x kF32Chunk x ldt
  float* sc = tiles + 2 * kF32Chunk * p.ldt + warp * 16 * kLdc;  // this warp's logits
  float* pc = tiles + 2 * kF32Chunk * p.ldt + kF32Rows * kLdc + warp * 16 * kLdp;  // this warp's p

  const int q0 = blockIdx.x * kF32Rows;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const float* qb = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kb = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* ob = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;
  constexpr bool kTwoPass = kMax || kProbs;

  // Stages: [pass 1: K chunk 0 .. n-1,] then K chunk 0, V chunk 0, K chunk
  // 1, ... Stage s lives in buffer s & 1; stage s + 1 is in flight while
  // stage s is computed.
  const int lkpad = round_up(p.lk, 16);
  const int chunks = (lkpad + kF32Chunk - 1) / kF32Chunk;
  const int first = kTwoPass ? chunks : 0;
  const int stages = first + 2 * chunks;
  auto prefetch = [&](int st) {
    const bool is_v = st >= first && (st - first) % 2 == 1;
    const int c0 = (st < first ? st : (st - first) / 2) * kF32Chunk;
    const int nk = min(kF32Chunk, lkpad - c0);
    float* buf = tiles + (st & 1) * kF32Chunk * p.ldt;
    if (is_v)
      load_rows(buf, p.ldt, vb, p.sv.l, p.sv.d, c0, nk, p.lk, p.d, p.dpad, p.flags & kVecV);
    else
      load_rows(buf, p.ldt, kb, p.sk.l, p.sk.d, c0, nk, p.lk, p.d, p.dpad, p.flags & kVecK);
  };

  load_rows(qs, p.ldt, qb, p.sq.l, p.sq.d, q0, kF32Rows, p.lq, p.d, p.dpad, p.flags & kVecQ);
  prefetch(0);
  cp_async_commit();

  const int row = lane >> 1, half = lane & 1;
  const float* srow = sc + row * kLdc;
  float* prow = pc + row * kLdp;
  float m = kMax ? -INFINITY : 0.f;  // row max so far (pass 1)
  float l = 0.f;                     // row sum of exp so far (pass 1)
  float s = 0.f;                     // this lane's part of the row sum of exp in the last pass
  float acc[16][kMaxD / 32];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) acc[r][t] = 0.f;

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      prefetch(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and the Q tile) is in shared memory
    const float* kv = tiles + (st & 1) * kF32Chunk * p.ldt;
    const bool is_v = st >= first && (st - first) % 2 == 1;
    const int c0 = (st < first ? st : (st - first) / 2) * kF32Chunk;
    const int nk = min(kF32Chunk, lkpad - c0);
    if (st < first) {
      // pass 1: the row max and the (rescaled) row sum of exp
      f32_logits(qs, kv, sc, p, r0, nk, lane);
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
      f32_logits(qs, kv, sc, p, r0, nk, lane);
      const float inv_l = kProbs ? 1.f / l : 1.f;
      for (int j = half; j < nk; j += 2) {
        const float e = c0 + j < p.lk ? stabilized_exp<kMax>(srow[j], m, p.clamp) : 0.f;
        s += e;
        prow[j] = kProbs ? e * inv_l : e;
      }
      __syncwarp();
    } else {
      // last pass, V chunk: o += p . v
      for (int j = 0; j < nk; ++j) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float pv = pc[r * kLdp + j];
#pragma unroll
          for (int t = 0; t < kMaxD / 32; ++t) {
            const int c = lane + 32 * t;
            if (c < p.dpad) acc[r][t] = fmaf(pv, kv[j * p.ldt + c], acc[r][t]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);  // the row sum of lane / 2's row

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float inv_s = 1.f / __shfl_sync(0xffffffffu, s, 2 * r);
    const int qi = q0 + r0 + r;
    if (qi < p.lq) {
#pragma unroll
      for (int t = 0; t < kMaxD / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < p.d) ob[qi * p.so.l + c * p.so.d] = kProbs ? acc[r][t] : acc[r][t] * inv_s;
      }
    }
  }
}

template <bool kMax>
cudaError_t dispatch(int body, const Params& p, bool probs, bool round, dim3 grid, size_t smem, cudaStream_t s) {
  if (body == kBodyF32)  // rounding f32 logits to f32 is a no-op
    return probs ? launch(attention_f32<kMax, true>, p, grid, smem, s)
                 : launch(attention_f32<kMax, false>, p, grid, smem, s);
  return probs ? launch_variant<kMax, true>(body, round, p, grid, smem, s)
               : launch_variant<kMax, false>(body, round, p, grid, smem, s);
}

}  // namespace attn

extern "C" {

// q (b, h, lq, d), k and v (b, h, lk, d), o (b, h, lq, d), each with the
// element strides given in `strides` (4 per tensor: b, h, l, d; q, k, v,
// o). stabilize_max: 1 = subtract the row max, 0 = clamp the logits at
// +-clamp. probs: 1 = normalise p before PV, 0 = divide the output.
// round: round the logits to the input dtype. flags: the Flag bits above.
// dtype: 0 = float32, 1 = bfloat16. body (0 f32, 1 whole-head, 2
// streaming), tiles_per_block and smem_bytes: the launch plan of
// ops/attention.py:attention_plan. Returns a cudaError_t value (0 = ok).
int vlfm_attention(const void* q, const void* k, const void* v, void* o, const long long* strides, int b,
                   int h, int lq, int lk, int d, float scale, float clamp, int stabilize_max, int probs,
                   int round, int flags, int dtype, int body, int tiles_per_block, int smem, void* stream) {
  using namespace attn;
  if (b <= 0 || h <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 65535) return (int)cudaErrorInvalidValue;
  if ((dtype == 0) != (body == kBodyF32) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (body == kBodyWhole ? (lk > kWholeKeys || tiles_per_block < 1) : tiles_per_block != kWarps)
    return (int)cudaErrorInvalidValue;
  if (body != kBodyWhole && body != kBodyStream && body != kBodyF32) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) *st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  if ((flags & kKT) && (dtype != 1 || p.sk.l != 1)) return (int)cudaErrorInvalidValue;
  p.heads = h;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.dpad = round_up(d, body == kBodyF32 ? 16 : 32);
  p.ldt = p.dpad + kPad;
  p.tiles_per_block = tiles_per_block;
  p.scale = scale;
  p.clamp = clamp;
  p.flags = flags;
  if ((size_t)smem != smem_bytes(body, p)) return (int)cudaErrorInvalidValue;
  const int qtiles = (lq + 15) / 16;
  const dim3 grid((qtiles + tiles_per_block - 1) / tiles_per_block, b * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = stabilize_max ? dispatch<true>(body, p, probs, round, grid, smem, s)
                                        : dispatch<false>(body, p, probs, round, grid, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
