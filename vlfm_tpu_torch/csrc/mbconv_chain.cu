// Fused stride-1 MBConv chain for NVIDIA Hopper (sm_90a):
//   h = round(gelu(x . W1 + b1))              1x1 expand, Cin -> Ch
//   d = round(gelu(depthwise3x3(h) + b2))      stride 1, SAME zero padding in h-space
//   y = round([gelu](d . W3 + b3 [+ x]))       1x1 project, Ch -> Cout
// on NHWC tensors. x, W1, W2, W3 and y share one dtype (bf16 or f32); the
// biases are f32. Every sum is f32; "round" is the cast to the activation
// dtype, at the same three places as the plain version
// (vlfm_tpu_torch/ops/conv_fused.py:mbconv_chain_ref). GELU is the exact erf
// form.
//
// Replaces the Pallas TPU kernel `_chain_kernel` behind
// vlfm_tpu/ops/conv_fused.py:mbconv_chain (vlfm_tpu/ops/conv_fused.py:136),
// which serves TinyViT's stage-0 MBConvs (Cin 64, Ch 256, Cout 64 at
// 256x256, residual and final gelu) and the stride-1 PatchMerging into its
// last stage (Cin 160, Ch 320, Cout 320 at 64x64, neither).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): by bytes,
// stage 0 at B = 8 reads x and writes y once, 134 MB, 0.0401 ms; fused, its
// own arithmetic is the larger floor. Its hidden tensor (B, 256, 256, 256)
// never leaves the chip, but each of its 134 M elements takes two exact-erf
// GELUs (h and d, h on 1.27x as many pixels for the halo): ~300 M GELUs of
// ~20 f32 instructions, ~0.2 ms on 132 SMs x 128 lanes, plus 1.2 G
// depthwise FMAs (~0.04 ms) and 39 GFLOP of 1x1 products (~0.04 ms on
// mma.sync). The design keeps every intermediate on chip:
// - a block owns a 16 x 16 tile of output pixels (4 x 16 where Cout is
//   wide: the merge's 320 accumulators of 256 pixels would not fit the
//   registers), loads its input tile with a one-pixel halo once by cp.async,
//   and walks Ch in chunks of 64 channels: 324 halo pixels for 256 outputs,
//   1.27x the expand and its GELUs (16 x 8 tiles would take 1.41x);
// - the expand runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate), A
//   fragments by ldmatrix from the x tile, B by ldmatrix.trans from the
//   chunk's W1 slice. Its accumulators take the bias, the GELU and the bf16
//   rounding in registers and are written once, as bf16, to the h tile: the
//   3x3 neighbourhood needs them in shared memory;
// - d never touches shared memory: the lane that holds an element of the
//   project's A fragment computes that element's nine taps, bias, GELU and
//   rounding in registers (each warp owns whole output rows of the tile and
//   takes its A fragments from its own taps), then the project runs on
//   mma.sync into accumulators that stay in registers across the Ch loop;
// - weights are staged on chip by cp.async, one chunk ahead: the W1 slice
//   and b1 two chunks ahead, the W3 slice, w2 and b2 one chunk ahead, in
//   two-slot rings. The channel loop reads no weight from global memory;
// - h is double-buffered, so chunk c + 1's expand and chunk c's depthwise
//   and project share one __syncthreads per chunk (4 per tile at Ch = 256);
// - every GELU is libm's erff in registers. A branch-free two-range erf
//   polynomial (within 1.3 f32 ulps of erf) gained a few percent at stage
//   0 on the card but rounded more h and d values the other way from the
//   plain version, so erff stays.
// Shared memory is 185 KB at stage 0 and 203 KB at the merge, so one block
// an SM: 16 warps at stage 0, each one row of the tile (32 accumulators a
// lane; 8 warps of two rows each were about a tenth slower: two warps a
// scheduler hide too little latency), 8 at the merge, each one row and
// half of Cout (so both warps of a row compute its d). 2,048 blocks at
// stage 0, B = 8 (512 at B = 2).
//
// Two kernels, one chosen per call by ops/conv_fused.py:chain_plan (which
// also computes the shared memory, checked here):
// - chain_tc (bf16, Cin a multiple of 16, Ch of 64, Cout a multiple of 16
//   up to 64, or of 32 up to 320, 16-byte aligned pointers), as above;
// - chain_simt (any shape, f32 or bf16): the same algorithm with f32 FMAs on
//   the CUDA cores, 8x8 output tiles, the input tile and the output
//   accumulators in shared memory. It serves the ragged shapes.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/conv_fused.py). The launch goes on the caller's stream
// and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fragments.cuh"

namespace {

using bf16 = __nv_bfloat16;
using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;
using frag::ldsm_x4;
using frag::ldsm_x4_t;
using frag::load_bf16x2;
using frag::mma_bf16;
using frag::pack_bf16;

constexpr int kThreads = 256;  // chain_simt's 8 warps
constexpr int kMaxSmem = 232448;  // a block's shared-memory limit on sm_90

enum Body : int { kBodySimt = 0, kBodyTc16 = 1, kBodyTc4 = 2 };

// The exact (erf) GELU, as F.gelu computes it.
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T and back: the plain version's `.to(dtype)` on an f32 value.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// chain_simt: any shape, f32 or bf16, f32 FMAs.
// ---------------------------------------------------------------------------
constexpr int kSChunk = 32;  // hidden channels per pass over the tile
constexpr int kSTh = 8, kSTw = 8;
constexpr int kSHaloW = kSTw + 2;
constexpr int kSHalo = (kSTh + 2) * kSHaloW;  // 100 halo pixels
constexpr int kSPix = kSTh * kSTw;            // 64 output pixels

size_t simt_smem(int cin, int cout) {
  return sizeof(float) * ((size_t)kSHalo * cin + kSHalo * kSChunk + kSPix * kSChunk + (size_t)kSPix * cout);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_simt(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, const T* __restrict__ w3,
           const float* __restrict__ b3, T* __restrict__ y, int H, int W, int cin, int ch,
           int cout, int residual, int final_gelu) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kSHalo][cin]: x, zero outside the image
  float* hs = xs + (size_t)kSHalo * cin;       // [kSHalo][kSChunk]: h of this chunk
  float* ds = hs + kSHalo * kSChunk;           // [kSPix][kSChunk]: d of this chunk
  float* acc = ds + kSPix * kSChunk;           // [kSPix][cout]: projection sums
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kSTh, c0 = blockIdx.x * kSTw, b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * cin;

  for (int i = tid; i < kSHalo * cin; i += kThreads) {
    const int p = i / cin, k = i - p * cin;
    const int hr = r0 - 1 + p / kSHaloW, hc = c0 - 1 + p % kSHaloW;
    float v = 0.f;
    if (hr >= 0 && hr < H && hc >= 0 && hc < W) v = to_f32(xb[((size_t)hr * W + hc) * cin + k]);
    xs[i] = v;
  }
  for (int i = tid; i < kSPix * cout; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int c0h = 0; c0h < ch; c0h += kSChunk) {
    const int cc = min(kSChunk, ch - c0h);
    // Expand: one warp per halo pixel, one lane per hidden channel.
    for (int i = tid; i < kSHalo * kSChunk; i += kThreads) {
      const int p = i / kSChunk, j = i - p * kSChunk;
      const int hr = r0 - 1 + p / kSHaloW, hc = c0 - 1 + p % kSHaloW;
      float v = 0.f;
      if (j < cc && hr >= 0 && hr < H && hc >= 0 && hc < W) {
        const float* xp = xs + (size_t)p * cin;
        const T* wp = w1 + c0h + j;
        float s = 0.f;
        for (int k = 0; k < cin; ++k) s = fmaf(xp[k], to_f32(wp[(size_t)k * ch]), s);
        v = round_to<T>(gelu(s + b1[c0h + j]));
      }
      hs[i] = v;
    }
    __syncthreads();
    // Depthwise 3x3 over the chunk.
    for (int i = tid; i < kSPix * kSChunk; i += kThreads) {
      const int q = i / kSChunk, j = i - q * kSChunk;
      float v = 0.f;
      if (j < cc) {
        const int r = q / kSTw, c = q % kSTw;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float hv = hs[((r + t / 3) * kSHaloW + c + t % 3) * kSChunk + j];
          s = fmaf(hv, to_f32(w2[(size_t)t * ch + c0h + j]), s);
        }
        v = round_to<T>(gelu(s + b2[c0h + j]));
      }
      ds[i] = v;
    }
    __syncthreads();
    // Project the chunk; each thread owns the same accumulators every chunk.
    for (int i = tid; i < kSPix * cout; i += kThreads) {
      const int q = i / cout, o = i - q * cout;
      const float* dp = ds + q * kSChunk;
      float s = acc[i];
      for (int j = 0; j < cc; ++j) s = fmaf(dp[j], to_f32(w3[(size_t)(c0h + j) * cout + o]), s);
      acc[i] = s;
    }
    __syncthreads();
  }

  for (int i = tid; i < kSPix * cout; i += kThreads) {
    const int q = i / cout, o = i - q * cout;
    const int r = r0 + q / kSTw, c = c0 + q % kSTw;
    if (r < H && c < W) {
      float v = acc[i] + b3[o];
      if (residual) v += xs[((q / kSTw + 1) * kSHaloW + q % kSTw + 1) * cin + o];
      if (final_gelu) v = gelu(v);
      y[(((size_t)b * H + r) * W + c) * cout + o] = from_f32<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// chain_tc: bf16 on mma.sync with register fragments.
// ---------------------------------------------------------------------------
constexpr int kTw = 16;  // tile width: an m16 tile of the project is one row of 16 output pixels
constexpr int kHaloW = kTw + 2;
constexpr int kChunk = 64;      // hidden channels per pass over the tile
constexpr int kLdc = kChunk + 8;  // pitch of the h tile and of a W1 slice (an odd number of 16 B)

template <int TH>
struct TcTile {
  static constexpr int kHalo = (TH + 2) * kHaloW;     // 324 (TH 16) or 108 (TH 4) halo pixels
  static constexpr int kMh = (kHalo + 15) / 16 * 16;  // expand GEMM rows: 336 or 112
};

// Byte offsets of the shared regions (every pitch an odd number of 16-byte
// units, so the eight rows an ldmatrix or a tap load reads fall in distinct
// banks), and the total.
struct TcSmem {
  size_t xs, hs, w1s, w3s, w2s, b1s, b2s, total;
  __host__ __device__ TcSmem(int mh, int cin, int cout) {
    xs = 0;                                                         // [mh][cin + 8]
    hs = align128(xs + 2ull * mh * (cin + 8));                      // [2][mh][kLdc]
    w1s = align128(hs + 2ull * 2 * mh * kLdc);                      // [2][cin][kLdc]
    w3s = align128(w1s + 2ull * 2 * cin * kLdc);                    // [2][kChunk][cout + 8]
    w2s = align128(w3s + 2ull * 2 * kChunk * (cout + 8));           // [2][9][kChunk]
    b1s = align128(w2s + 2ull * 2 * 9 * kChunk);                    // [2][kChunk] f32
    b2s = align128(b1s + 4ull * 2 * kChunk);                        // [2][kChunk] f32
    total = align128(b2s + 4ull * 2 * kChunk);
  }
};

// TH output rows of 16 pixels a block of WARPS warps. The warps split the
// rows into TH / MW groups of MW rows and Cout into the remaining groups; a
// warp holds NW n8 tiles of Cout (the first Cout / 8 / groups of them are
// used).
template <int TH, int MW, int NW, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
chain_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
         const bf16* __restrict__ w2, const float* __restrict__ b2, const bf16* __restrict__ w3,
         const float* __restrict__ b3, bf16* __restrict__ y, int H, int W, int cin, int ch,
         int cout, int residual, int final_gelu) {
  using Tl = TcTile<TH>;
  constexpr int kMGroups = TH / MW;
  static_assert(WARPS % kMGroups == 0, "the warps split rows and Cout evenly");
  constexpr int kNGroups = WARPS / kMGroups;
  constexpr int kThreadsTc = WARPS * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem lay(Tl::kMh, cin, cout);
  const int ldx = cin + 8, ldw3 = cout + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + lay.w1s);
  bf16* w3s = reinterpret_cast<bf16*>(smem + lay.w3s);
  bf16* w2s = reinterpret_cast<bf16*>(smem + lay.w2s);
  float* b1s = reinterpret_cast<float*>(smem + lay.b1s);
  float* b2s = reinterpret_cast<float*>(smem + lay.b2s);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * kTw, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * cin;
  const int chunks = ch / kChunk;

  // The input tile with its halo, zero outside the image and in the
  // padding rows.
  const int xv = cin / 8;
  for (int i = tid; i < Tl::kMh * xv; i += kThreadsTc) {
    const int p = i / xv, k = (i - p * xv) * 8;
    const int hr = r0 - 1 + p / kHaloW, hc = c0 - 1 + p % kHaloW;
    const bool ok = p < Tl::kHalo && hr >= 0 && hr < H && hc >= 0 && hc < W;
    cp_async16(xs + p * ldx + k, ok ? xb + ((size_t)hr * W + hc) * cin + k : xb, ok ? 16 : 0);
  }
  // W1's columns and b1 of chunk c, into slot c % 2.
  auto stage_w1 = [&](int c) {
    bf16* dst = w1s + (c & 1) * cin * kLdc;
    for (int i = tid; i < cin * (kChunk / 8); i += kThreadsTc) {
      const int k = i / (kChunk / 8), j = (i % (kChunk / 8)) * 8;
      cp_async16(dst + k * kLdc + j, w1 + (size_t)k * ch + c * kChunk + j, 16);
    }
    if (tid < kChunk / 4) cp_async16(b1s + (c & 1) * kChunk + 4 * tid, b1 + c * kChunk + 4 * tid, 16);
  };
  // W3's rows, w2 and b2 of chunk c, into slot c % 2.
  auto stage_w3 = [&](int c) {
    bf16* dst = w3s + (c & 1) * kChunk * ldw3;
    const int cv = cout / 8;
    for (int i = tid; i < kChunk * cv; i += kThreadsTc) {
      const int k = i / cv, j = (i % cv) * 8;
      cp_async16(dst + k * ldw3 + j, w3 + (size_t)(c * kChunk + k) * cout + j, 16);
    }
    for (int i = tid; i < 9 * (kChunk / 8); i += kThreadsTc) {
      const int tap = i / (kChunk / 8), j = (i % (kChunk / 8)) * 8;
      cp_async16(w2s + ((c & 1) * 9 + tap) * kChunk + j, w2 + (size_t)tap * ch + c * kChunk + j, 16);
    }
    if (tid < kChunk / 4) cp_async16(b2s + (c & 1) * kChunk + 4 * tid, b2 + c * kChunk + 4 * tid, 16);
  };

  // h of chunk c = round(gelu(x . W1 + b1)) on the halo tile, 0 outside the
  // image (SAME padding in h-space), into h slot c % 2. A unit of work is 16
  // halo pixels x 32 channels.
  auto expand = [&](int c) {
    const bf16* wsl = w1s + (c & 1) * cin * kLdc;
    const float* bias = b1s + (c & 1) * kChunk;
    bf16* h = hs + (c & 1) * Tl::kMh * kLdc;
    for (int u = warp; u < Tl::kMh / 16 * 2; u += WARPS) {
      const int m = u >> 1, n0 = (u & 1) * 32;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      const bf16* ap = xs + (16 * m + (lane & 15)) * ldx + (lane >> 4) * 8;
      const bf16* bp = wsl + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdc + n0 + (lane >> 4) * 8;
#pragma unroll 2
      for (int k = 0; k < cin; k += 16) {
        uint32_t a[4], bb[4], bc[4];
        ldsm_x4(a, ap + k);
        ldsm_x4_t(bb, bp + k * kLdc);
        ldsm_x4_t(bc, bp + k * kLdc + 16);
        mma_bf16(acc[0], a, bb[0], bb[1]);
        mma_bf16(acc[1], a, bb[2], bb[3]);
        mma_bf16(acc[2], a, bc[0], bc[1]);
        mma_bf16(acc[3], a, bc[2], bc[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * m + g + 8 * half;
        if (p >= Tl::kHalo) continue;
        const int hr = r0 - 1 + p / kHaloW, hc = c0 - 1 + p % kHaloW;
        const bool in = hr >= 0 && hr < H && hc >= 0 && hc < W;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = n0 + 8 * n + t2;
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            v0 = gelu(acc[n][2 * half] + bias[j]);
            v1 = gelu(acc[n][2 * half + 1] + bias[j + 1]);
          }
          *reinterpret_cast<uint32_t*>(h + p * kLdc + j) = pack_bf16(v0, v1);
        }
      }
    }
  };

  const int mg = warp % kMGroups, ng = warp / kMGroups;
  const int row0 = mg * MW;                        // this warp's first output row in the tile
  const int nper = cout / 8 / kNGroups;            // its n8 tiles of Cout (even, <= NW)
  const int nbase = ng * nper;
  float acc[MW][NW][4];                            // o = d . W3, across the chunks
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NW; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  stage_w1(0);
  if (chunks > 1) stage_w1(1);
  stage_w3(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  expand(0);
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    if (c + 2 < chunks) stage_w1(c + 2);  // slot c % 2: expand(c) is done
    if (c + 1 < chunks) stage_w3(c + 1);  // slot (c + 1) % 2: chunk c - 1's project is done
    cp_async_commit();
    if (c + 1 < chunks) expand(c + 1);    // h slot (c + 1) % 2: chunk c - 1's taps are done

    // d = round(gelu(taps + b2)) straight into the project's A fragments,
    // then o += d . W3 for this chunk, 16 channels at a time.
    const bf16* h = hs + (c & 1) * Tl::kMh * kLdc;
    const bf16* wd = w2s + (c & 1) * 9 * kChunk;
    const float* bias = b2s + (c & 1) * kChunk;
    const bf16* bp = w3s + (c & 1) * kChunk * ldw3 + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldw3 + nbase * 8 +
                     (lane >> 4) * 8;
#pragma unroll 1
    for (int s = 0; s < kChunk / 16; ++s) {
      uint32_t a[MW][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // channels j, j + 1 (a0, a1) and j + 8, j + 9 (a2, a3)
        const int j = 16 * s + t2 + 8 * hf;
        float2 wt[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) wt[tap] = load_bf16x2(wd + tap * kChunk + j);
        const float bj0 = bias[j], bj1 = bias[j + 1];
#pragma unroll
        for (int xi = 0; xi < 2; ++xi) {  // output columns g (a0, a2) and g + 8 (a1, a3)
          float2 hv[MW + 2][3];
#pragma unroll
          for (int i = 0; i < MW + 2; ++i)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) hv[i][dx] = load_bf16x2(h + ((row0 + i) * kHaloW + g + 8 * xi + dx) * kLdc + j);
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              s0 = fmaf(hv[m + tap / 3][tap % 3].x, wt[tap].x, s0);
              s1 = fmaf(hv[m + tap / 3][tap % 3].y, wt[tap].y, s1);
            }
            a[m][xi + 2 * hf] = pack_bf16(gelu(s0 + bj0), gelu(s1 + bj1));
          }
        }
      }
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        if (2 * np < nper) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bp + 16 * s * ldw3 + 16 * np);
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            mma_bf16(acc[m][2 * np], a[m], bb[0], bb[1]);
            mma_bf16(acc[m][2 * np + 1], a[m], bb[2], bb[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the staged weights are in; h slot c % 2 and this chunk's weights are free
  }

  // y = round([gelu](o + b3 [+ x])), two channels a lane at a time.
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int r = r0 + row0 + m;
#pragma unroll
    for (int xi = 0; xi < 2; ++xi) {
      const int cc = c0 + g + 8 * xi;
      if (r >= H || cc >= W) continue;
      const bf16* xc = xs + ((row0 + m + 1) * kHaloW + g + 8 * xi + 1) * ldx;
      bf16* yp = y + (((size_t)b * H + r) * W + cc) * cout;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        if (n < nper) {
          const int o = (nbase + n) * 8 + t2;
          float v0 = acc[m][n][2 * xi] + b3[o], v1 = acc[m][n][2 * xi + 1] + b3[o + 1];
          if (residual) {
            const float2 xr = load_bf16x2(xc + o);
            v0 += xr.x;
            v1 += xr.y;
          }
          if (final_gelu) {
            v0 = gelu(v0);
            v1 = gelu(v1);
          }
          *reinterpret_cast<uint32_t*>(yp + o) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// The two tile shapes: 16 x 16 pixels, 16 warps, each one row and all of
// Cout (up to 8 n8 tiles); 4 x 16 pixels, 8 warps, each one row and half of
// Cout (up to 20 n8 tiles).
using Tc16 = TcTile<16>;
using Tc4 = TcTile<4>;

struct Args {
  const void *x, *w1, *w2, *w3;
  const float *b1, *b2, *b3;
  void* y;
  int batch, h, w, cin, ch, cout, residual, final_gelu;
};

size_t body_smem(int body, const Args& a) {
  if (body == kBodyTc16) return TcSmem(Tc16::kMh, a.cin, a.cout).total;
  if (body == kBodyTc4) return TcSmem(Tc4::kMh, a.cin, a.cout).total;
  return simt_smem(a.cin, a.cout);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the tensor-core bodies may take these arguments.
bool tc_ok(int body, const Args& a) {
  const bool ptrs = aligned16(a.x) && aligned16(a.w1) && aligned16(a.w2) && aligned16(a.w3) &&
                    aligned16(a.b1) && aligned16(a.b2) && aligned16(a.y);
  const bool shapes = a.cin % 16 == 0 && a.ch % kChunk == 0;
  const bool cout = body == kBodyTc16 ? a.cout % 16 == 0 && a.cout <= 64 : a.cout % 32 == 0 && a.cout <= 320;
  return ptrs && shapes && cout;
}

template <typename T>
cudaError_t launch_simt(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(chain_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w + kSTw - 1) / kSTw, (a.h + kSTh - 1) / kSTh, a.batch);
  chain_simt<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), a.b1, static_cast<const T*>(a.w2), a.b2,
      static_cast<const T*>(a.w3), a.b3, static_cast<T*>(a.y), a.h, a.w, a.cin, a.ch, a.cout, a.residual,
      a.final_gelu);
  return cudaSuccess;
}

template <int TH, int MW, int NW, int WARPS>
cudaError_t launch_tc(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = chain_tc<TH, MW, NW, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w + kTw - 1) / kTw, (a.h + TH - 1) / TH, a.batch);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w1), a.b1, static_cast<const bf16*>(a.w2),
      a.b2, static_cast<const bf16*>(a.w3), a.b3, static_cast<bf16*>(a.y), a.h, a.w, a.cin, a.ch, a.cout,
      a.residual, a.final_gelu);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x (batch, h, w, cin); w1 (cin, ch); w2 (3, 3, ch); w3 (ch, cout); y (batch,
// h, w, cout); all contiguous. dtype: 0 = float32, 1 = bfloat16 (x, w1, w2,
// w3, y); the biases are float32. body (0 simt, 1 tensor cores on 16 x 16
// tiles, 2 on 4 x 16 tiles) and smem: the plan of
// ops/conv_fused.py:chain_plan; a plan this file disagrees with is refused.
// Returns a cudaError_t value (0 = ok).
int vlfm_mbconv_chain(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                      const void* w3, const float* b3, void* y, int batch, int h, int w, int cin, int ch,
                      int cout, int residual, int final_gelu, int dtype, int body, int smem, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || ch <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535 || (residual && cout != cin)) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, w2, w3, b1, b2, b3, y, batch, h, w, cin, ch, cout, residual, final_gelu};
  if (body != kBodySimt && (dtype != 1 || !tc_ok(body, a))) return (int)cudaErrorInvalidValue;
  if (body < kBodySimt || body > kBodyTc4 || (size_t)smem != body_smem(body, a) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (body == kBodyTc16) {
    err = launch_tc<16, 1, 8, 16>(a, smem, s);
  } else if (body == kBodyTc4) {
    err = launch_tc<4, 1, 20, 8>(a, smem, s);
  } else if (dtype == 0) {
    err = launch_simt<float>(a, smem, s);
  } else if (dtype == 1) {
    err = launch_simt<bf16>(a, smem, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
