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
// What bounds it: the hidden tensor. Unfused, stage 0 writes and reads a
// (256, 256, 256) hidden tensor per image (33.5 MB in bf16) several times,
// against 8.4 MB in and 8.4 MB out; per image the block is ~4.6 GFLOP,
// ~0.27 FLOP per byte of the unfused traffic and ~270 per byte of the fused
// one. So the design keeps h and d on chip: a block owns a tile of output
// pixels, loads the input tile with a one-pixel halo on both spatial axes
// once, and walks Ch in chunks of 32 channels. Per chunk it expands the halo
// tile, runs the depthwise taps, and projects the chunk into the output
// accumulators. The depthwise conv is per channel, so chunking Ch is exact.
// Halo cells outside the image are set to 0 in h-space (not gelu(b1)), on
// both axes, which is the conv's SAME padding. Fused, what bounds it on an
// H100 is its own on-chip work: the exact-erf GELUs, the shared-memory
// passes and the block syncs of each chunk, not HBM or the tensor cores
// (PERF.md has the measurement).
//
// Two kernels, one chosen per call by `route` below:
// - chain_tc (bf16, Cin and Cout multiples of 16, Ch a multiple of 32,
//   32-byte aligned pointers): both 1x1 products on the tensor cores with
//   nvcuda::wmma, bf16 in, f32 accumulate. The tile is 16 pixels wide and
//   TH rows high. The output accumulators of the whole tile stay in
//   registers across the Ch loop, spread over the 8 warps' fragments. At
//   Cout 320 (the merge into the last stage) a 128-pixel tile's
//   accumulators would be 160 KB, so a wide Cout takes TH = 4 (64 pixels,
//   80 fragments, 10 a warp) and a narrow one TH = 8 (128 pixels).
//   W1 and W3 fragments are read from global memory; they are a few hundred
//   KB at most and stay in L1/L2.
// - chain_simt (any shape, f32 or bf16): the same algorithm with f32 FMAs on
//   the CUDA cores, 8x8 output tiles, the input tile and the output
//   accumulators in shared memory. It serves the ragged shapes.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/conv_fused.py). The launch goes on the caller's stream
// and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // hidden channels per pass over the tile
constexpr int kMaxSmem = 232448;  // a block's shared-memory limit on sm_90

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
constexpr int kSTh = 8, kSTw = 8;
constexpr int kSHaloW = kSTw + 2;
constexpr int kSHalo = (kSTh + 2) * kSHaloW;  // 100 halo pixels
constexpr int kSPix = kSTh * kSTw;            // 64 output pixels

size_t simt_smem(int cin, int cout) {
  return sizeof(float) * ((size_t)kSHalo * cin + kSHalo * kChunk + kSPix * kChunk + (size_t)kSPix * cout);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_simt(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, const T* __restrict__ w3,
           const float* __restrict__ b3, T* __restrict__ y, int H, int W, int cin, int ch,
           int cout, int residual, int final_gelu) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kSHalo][cin]: x, zero outside the image
  float* hs = xs + (size_t)kSHalo * cin;       // [kSHalo][kChunk]: h of this chunk
  float* ds = hs + kSHalo * kChunk;            // [kSPix][kChunk]: d of this chunk
  float* acc = ds + kSPix * kChunk;            // [kSPix][cout]: projection sums
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

  for (int c0h = 0; c0h < ch; c0h += kChunk) {
    const int cc = min(kChunk, ch - c0h);
    // Expand: one warp per halo pixel, one lane per hidden channel.
    for (int i = tid; i < kSHalo * kChunk; i += kThreads) {
      const int p = i / kChunk, j = i - p * kChunk;
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
    for (int i = tid; i < kSPix * kChunk; i += kThreads) {
      const int q = i / kChunk, j = i - q * kChunk;
      float v = 0.f;
      if (j < cc) {
        const int r = q / kSTw, c = q % kSTw;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float hv = hs[((r + t / 3) * kSHaloW + c + t % 3) * kChunk + j];
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
      const float* dp = ds + q * kChunk;
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
// chain_tc: bf16 on the tensor cores (wmma 16x16x16, f32 accumulate).
// ---------------------------------------------------------------------------
constexpr int kTw = 16;  // tile width: one output row of the tile is one 16-row fragment

template <int TH>
struct TcTile {
  static constexpr int kHaloW = kTw + 2;
  static constexpr int kHalo = (TH + 2) * kHaloW;       // 180 (TH 8) or 108 (TH 4)
  static constexpr int kMh = (kHalo + 15) / 16 * 16;    // GEMM rows of the expand: 192 or 112
  static constexpr int kMo = TH * kTw;                  // output pixels: 128 or 64
  static constexpr int kLdd = kChunk + 8;               // bf16 row pitch of d, padded
};

template <int TH>
struct TcSmem {
  size_t xs, st, ds, os, total;  // byte offsets of each region, and the total
  __host__ __device__ TcSmem(int cin, int cout) {
    using Tl = TcTile<TH>;
    xs = 0;
    st = align128(xs + sizeof(bf16) * Tl::kMh * (size_t)(cin + 8));
    ds = align128(st + sizeof(float) * Tl::kMh * kChunk);
    os = align128(ds + sizeof(bf16) * Tl::kMo * Tl::kLdd);
    total = align128(os + sizeof(float) * Tl::kMo * (size_t)cout);
  }
};

template <int TH, int NF>
__global__ void __launch_bounds__(kThreads)
chain_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
         const bf16* __restrict__ w2, const float* __restrict__ b2, const bf16* __restrict__ w3,
         const float* __restrict__ b3, bf16* __restrict__ y, int H, int W, int cin, int ch,
         int cout, int residual, int final_gelu) {
  using namespace nvcuda;
  using Tl = TcTile<TH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem<TH> lay(cin, cout);
  const int ldx = cin + 8;  // padded row pitch of the input tile (bank spread)
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);    // [kMh][ldx]: x halo tile, 0 outside
  float* st = reinterpret_cast<float*>(smem + lay.st);  // [kMh][kChunk]: expand sums, then h
  bf16* ds = reinterpret_cast<bf16*>(smem + lay.ds);    // [kMo][kLdd]: d of this chunk
  float* os = reinterpret_cast<float*>(smem + lay.os);  // [kMo][cout]: projection sums

  const int tid = threadIdx.x, warp = tid / 32;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * kTw, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * cin;

  // Input tile with its halo, 16 bytes a thread per access (cin % 16 == 0).
  const int vecs = cin / 8;
  for (int i = tid; i < Tl::kMh * vecs; i += kThreads) {
    const int p = i / vecs, k = (i - p * vecs) * 8;
    const int hr = r0 - 1 + p / Tl::kHaloW, hc = c0 - 1 + p % Tl::kHaloW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < Tl::kHalo && hr >= 0 && hr < H && hc >= 0 && hc < W)
      v = *reinterpret_cast<const uint4*>(xb + ((size_t)hr * W + hc) * cin + k);
    *reinterpret_cast<uint4*>(xs + (size_t)p * ldx + k) = v;
  }

  const int n_out = (Tl::kMo / 16) * (cout / 16);  // output fragments of the tile
  const int nct = cout / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int s = 0; s < NF; ++s) wmma::fill_fragment(acc[s], 0.f);
  __syncthreads();

  for (int c0h = 0; c0h < ch; c0h += kChunk) {
    // Expand: (kMh x cin) . (cin x 32) on the tensor cores into st.
    constexpr int n_exp = (Tl::kMh / 16) * (kChunk / 16);
    for (int f = warp; f < n_exp; f += kWarps) {
      const int mt = f / (kChunk / 16), nt = f % (kChunk / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int k = 0; k < cin; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, xs + (size_t)mt * 16 * ldx + k, ldx);
        wmma::load_matrix_sync(bm, w1 + (size_t)k * ch + c0h + nt * 16, ch);
        wmma::mma_sync(c, a, bm, c);
      }
      wmma::store_matrix_sync(st + mt * 16 * kChunk + nt * 16, c, kChunk, wmma::mem_row_major);
    }
    __syncthreads();
    // h = round(gelu(sum + b1)) inside the image, 0 outside (SAME padding).
    for (int i = tid; i < Tl::kMh * kChunk; i += kThreads) {
      const int p = i / kChunk, j = i % kChunk;
      const int hr = r0 - 1 + p / Tl::kHaloW, hc = c0 - 1 + p % Tl::kHaloW;
      float v = 0.f;
      if (p < Tl::kHalo && hr >= 0 && hr < H && hc >= 0 && hc < W)
        v = round_to<bf16>(gelu(st[i] + b1[c0h + j]));
      st[i] = v;
    }
    __syncthreads();
    // Depthwise 3x3: one warp per output pixel, one lane per channel.
    for (int i = tid; i < Tl::kMo * kChunk; i += kThreads) {
      const int q = i / kChunk, j = i % kChunk;
      const int r = q / kTw, c = q % kTw;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float hv = st[((r + t / 3) * Tl::kHaloW + c + t % 3) * kChunk + j];
        s = fmaf(hv, __bfloat162float(w2[(size_t)t * ch + c0h + j]), s);
      }
      ds[q * Tl::kLdd + j] = __float2bfloat16(gelu(s + b2[c0h + j]));
    }
    __syncthreads();
    // Project: (kMo x 32) . (32 x cout) into the register accumulators.
#pragma unroll
    for (int s = 0; s < NF; ++s) {
      const int f = warp + s * kWarps;
      if (f < n_out) {
        const int mt = f / nct, nt = f % nct;
#pragma unroll
        for (int k = 0; k < kChunk; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, ds + mt * 16 * Tl::kLdd + k, Tl::kLdd);
          wmma::load_matrix_sync(bm, w3 + (size_t)(c0h + k) * cout + nt * 16, cout);
          wmma::mma_sync(acc[s], a, bm, acc[s]);
        }
      }
    }
    __syncthreads();  // st and ds are rewritten by the next chunk
  }

#pragma unroll
  for (int s = 0; s < NF; ++s) {
    const int f = warp + s * kWarps;
    if (f < n_out) {
      const int mt = f / nct, nt = f % nct;
      wmma::store_matrix_sync(os + (size_t)mt * 16 * cout + nt * 16, acc[s], cout, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < Tl::kMo * cout; i += kThreads) {
    const int q = i / cout, o = i - q * cout;
    const int r = r0 + q / kTw, c = c0 + q % kTw;
    if (r < H && c < W) {
      float v = os[i] + b3[o];
      if (residual) v += __bfloat162float(xs[(size_t)((q / kTw + 1) * Tl::kHaloW + q % kTw + 1) * ldx + o]);
      if (final_gelu) v = gelu(v);
      y[(((size_t)b * H + r) * W + c) * cout + o] = __float2bfloat16(v);
    }
  }
}

struct Args {
  const void *x, *w1, *w2, *w3;
  const float *b1, *b2, *b3;
  void* y;
  int batch, h, w, cin, ch, cout, residual, final_gelu;
};

bool aligned32(const void* p) { return reinterpret_cast<uintptr_t>(p) % 32 == 0; }

// 1: chain_tc takes the call; 0: chain_simt.
int route(const Args& a, int dtype) {
  const bool shapes = a.cin % 16 == 0 && a.cout % 16 == 0 && a.ch % kChunk == 0 && a.cout <= 512;
  const bool ptrs = aligned32(a.x) && aligned32(a.w1) && aligned32(a.w3) && aligned32(a.y);
  return dtype == 1 && shapes && ptrs ? 1 : 0;
}

template <typename T>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  const size_t smem = simt_smem(a.cin, a.cout);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w + kSTw - 1) / kSTw, (a.h + kSTh - 1) / kSTh, a.batch);
  chain_simt<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), a.b1, static_cast<const T*>(a.w2), a.b2,
      static_cast<const T*>(a.w3), a.b3, static_cast<T*>(a.y), a.h, a.w, a.cin, a.ch, a.cout, a.residual,
      a.final_gelu);
  return cudaSuccess;
}

template <int TH, int NF>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = TcSmem<TH>(a.cin, a.cout).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_tc<TH, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.w + kTw - 1) / kTw, (a.h + TH - 1) / TH, a.batch);
  chain_tc<TH, NF><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w1), a.b1, static_cast<const bf16*>(a.w2),
      a.b2, static_cast<const bf16*>(a.w3), a.b3, static_cast<bf16*>(a.y), a.h, a.w, a.cin, a.ch, a.cout,
      a.residual, a.final_gelu);
  return cudaSuccess;
}

// Smallest instantiated NF that holds ceil(fragments / warps).
template <int TH>
cudaError_t dispatch_tc(const Args& a, cudaStream_t stream) {
  const int frags = (TcTile<TH>::kMo / 16) * (a.cout / 16);
  const int need = (frags + kWarps - 1) / kWarps;
  if (need <= 2) return launch_tc<TH, 2>(a, stream);
  if (need <= 4) return launch_tc<TH, 4>(a, stream);
  if (need <= 8) return launch_tc<TH, 8>(a, stream);
  if (need <= 10) return launch_tc<TH, 10>(a, stream);
  if (need <= 16) return launch_tc<TH, 16>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Which kernel a call with these arguments takes: 1 = tensor cores
// (chain_tc), 0 = CUDA cores (chain_simt).
int vlfm_mbconv_chain_route(const void* x, const void* w1, const void* w3, const void* y, int cin,
                            int ch, int cout, int dtype) {
  const Args a{x, w1, nullptr, w3, nullptr, nullptr, nullptr, const_cast<void*>(y), 1, 1, 1, cin, ch, cout, 0, 0};
  return route(a, dtype);
}

// x (batch, h, w, cin); w1 (cin, ch); w2 (3, 3, ch); w3 (ch, cout); y (batch,
// h, w, cout); all contiguous. dtype: 0 = float32, 1 = bfloat16 (x, w1, w2,
// w3, y); the biases are float32. Returns a cudaError_t value (0 = ok).
int vlfm_mbconv_chain(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                      const void* w3, const float* b3, void* y, int batch, int h, int w, int cin, int ch,
                      int cout, int residual, int final_gelu, int dtype, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || ch <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535 || (residual && cout != cin)) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, w2, w3, b1, b2, b3, y, batch, h, w, cin, ch, cout, residual, final_gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_simt<float>(a, s);
  } else if (dtype == 1) {
    if (route(a, dtype) == 1) {
      err = cout <= 128 ? dispatch_tc<8>(a, s) : dispatch_tc<4>(a, s);
    } else {
      err = launch_simt<bf16>(a, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
