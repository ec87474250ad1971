// LayerNorm over the last axis, f32 statistics, for NVIDIA Hopper (sm_90a),
// alone or fused with the residual add before it.
//
// Replaces the Pallas TPU kernel `_ln_kernel` behind
// vlfm_tpu/ops/norms.py:layer_norm (vlfm_tpu/ops/norms.py:28), which serves
// every LayerNorm of the BLIP-2 ViT-g and Q-Former (and, in the port,
// OWL-ViT's). It computes, per row of a (rows, D) tensor:
//   mu  = sum(x) * (1/D)                  (f32)
//   var = sum((x - mu)^2) * (1/D)         (f32, two passes over the
//                                          register-held row, not E[x^2]-mu^2)
//   y   = (x - mu) * rsqrt(var + eps) * scale + bias, stored in x's dtype.
// x and y are bf16 or f32; scale and bias are f32.
//
// Two entries share that one device body:
//   vlfm_layer_norm      y = LN(x)
//   vlfm_add_layer_norm  s = x + h, rounded to the stream dtype as PyTorch's
//                        add rounds it (f32 sum, one round to nearest even),
//                        then y = LN(s); s is stored only when the caller
//                        keeps it (a pre-norm site, where s is the next
//                        residual). h has x's dtype; its rows repeat every
//                        h_rows rows of x (a position table broadcast over
//                        the batch), h_rows == rows otherwise.
// The normalisation of s is the plain entry's arithmetic, rounding for
// rounding, so the fused entry equals `x + h` followed by the plain entry
// bit for bit.
//
// What bounds it: memory traffic. The plain entry reads x once and writes y
// once: 2 passes over the tensor (a ViT-g row of 1408 bf16 is 2.8 KB). The
// fused entry reads x and h and writes y, and s when it is kept: 3 passes
// (post-norm) or 4 (pre-norm), where an add kernel and the plain entry make
// 3 + 2. The arithmetic is a few FLOPs a byte, far below the card's
// compute-to-bandwidth ratio. One warp owns one row and holds it in
// registers between the loads, the two reductions (warp shuffles, no shared
// memory) and the stores, so each byte moves once. When D * sizeof(T) is a
// multiple of 16 bytes and every pointer is 16-byte aligned, each lane moves
// 16 bytes per access; otherwise each access is one element (ragged D such
// as 33). Each lane holds NV packs, the fewest that cover the row (6 of 16
// bytes at D = 1408 bf16, 3 at 768). scale and bias go to shared memory by
// cp.async (through L1) at the block's start, one copy for its rows, and
// are read from there after the reductions: their latency hides behind the
// row's, and they hold no registers, which would cost the large shapes
// occupancy.
//
// The launch floor. At the robot's B = 1 rows (32-577) the body is a few
// hundred nanoseconds and an empty kernel's launch costs more, so the
// design cuts what it can around it: a residual add no longer takes a
// launch of its own (the fused entry), scale and bias arrive during the
// row's loads instead of after its reductions, and a block holds 1, 2 or 4
// rows (one warp each), the most that still gives every SM a block, so
// that 32-577 rows spread over all SMs.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/norms.py). The launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fragments.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowsPerBlock = 4;  // one warp per row, at most 128 threads a block
constexpr int kMaxD = 2048;          // largest D any instantiation below holds

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a bf16 cast in JAX
}

// VEC consecutive f32 values from shared memory at p + col: float4 reads
// when VEC allows it (16-byte aligned then), scalar reads otherwise.
template <int VEC>
__device__ __forceinline__ void read_f32(const float* p, int col, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + col + e);
      out[e] = q.x;
      out[e + 1] = q.y;
      out[e + 2] = q.z;
      out[e + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = p[col + e];
  }
}

// 16 (or 4) bytes global -> shared, asynchronously, through L1 (.ca): the
// blocks on one SM read scale and bias from L2 once between them.
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(frag::smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(frag::smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Each lane holds NV packs of VEC consecutive elements: pack p of lane l is
// pack index l + 32 * p of the row. Packs past the row end are masked. With
// ADD, the row is s = x + h (h's row is row % h_rows), stored to s_out
// unless it is null; without, h, h_rows and s_out are unused. The block's
// rows share one copy of scale and bias in shared memory (2 d floats),
// brought in by cp.async while the rows load and reduce, so they cost no
// registers and their latency hides behind the row's.
template <typename T, int VEC, int NV, bool ADD>
__global__ void __launch_bounds__(kWarp * kMaxRowsPerBlock)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ h, int h_rows,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ y, T* __restrict__ s_out, int rows, int d, float eps) {
  extern __shared__ __align__(16) float staged[];  // scale[d], then bias[d]
  float* s_scale = staged;
  float* s_bias = staged + d;  // 16-byte aligned on the 16-byte path: d % 4 == 0 there
  if constexpr (VEC > 1) {
    for (int i = threadIdx.x * 4; i < d; i += blockDim.x * 4) {
      cp_async16_l1(s_scale + i, scale + i);
      cp_async16_l1(s_bias + i, bias + i);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      cp_async4(s_scale + i, scale + i);
      cp_async4(s_bias + i, bias + i);
    }
  }
  frag::cp_async_commit();

  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const bool live = row < rows;  // a warp past the last row still meets the barrier
  const int npacks = d / VEC;
  using P = Pack<T, VEC>;
  float v[NV][VEC];
  float mu = 0.f, rstd = 0.f;
  if (live) {
    const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
    const P* hr = ADD ? reinterpret_cast<const P*>(h + (size_t)(row % h_rows) * d) : nullptr;
    // Every load of the row is issued before any arithmetic.
    P xp[NV], hp[NV];
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      const int idx = lane + kWarp * p;
      if (idx < npacks) {
        xp[p] = xr[idx];
        if constexpr (ADD) hp[p] = hr[idx];
      }
    }

    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      const int idx = lane + kWarp * p;
      if (idx < npacks) {
        if constexpr (ADD) {
          P sp;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            // PyTorch's add: an f32 sum, one rounding to T.
            sp.v[e] = from_f32<T>(__fadd_rn(to_f32(xp[p].v[e]), to_f32(hp[p].v[e])));
            v[p][e] = to_f32(sp.v[e]);
            sum += v[p][e];
          }
          if (s_out != nullptr) reinterpret_cast<P*>(s_out + (size_t)row * d)[idx] = sp;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            v[p][e] = to_f32(xp[p].v[e]);
            sum += v[p][e];
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[p][e] = 0.f;
      }
    }
    // The statistics' roundings are spelled out, so no code layout changes
    // them: a rounded mean, rounded centring, fused square-accumulate and
    // fused variance + eps (those two as nvcc contracted them before).
    const float inv_d = 1.f / (float)d;
    mu = __fmul_rn(warp_sum(sum), inv_d);

    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      if (lane + kWarp * p < npacks) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = __fsub_rn(v[p][e], mu);
          sq = __fmaf_rn(c, c, sq);
        }
      }
    }
    rstd = rsqrtf(__fmaf_rn(warp_sum(sq), inv_d, eps));
  }
  frag::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;

  P* yr = reinterpret_cast<P*>(y + (size_t)row * d);
#pragma unroll
  for (int p = 0; p < NV; ++p) {
    const int idx = lane + kWarp * p;
    if (idx < npacks) {
      float sc[VEC], bi[VEC];
      read_f32<VEC>(s_scale, idx * VEC, sc);
      read_f32<VEC>(s_bias, idx * VEC, bi);
      P out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // Rounded multiply, then rounded add (no FMA contraction): the same
        // roundings as the plain version's (y * scale + bias).
        const float t = __fmul_rn(__fsub_rn(v[p][e], mu), rstd);
        out.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(t, sc[e]), bi[e]));
      }
      yr[idx] = out;
    }
  }
}

struct Args {
  const void* x;
  const void* h;
  int h_rows;
  const float* scale;
  const float* bias;
  void* y;
  void* s;
  int rows;
  int d;
  float eps;
};

// Rows (warps) per block: the most of 4, 2, 1 that still gives every SM a block.
int rows_per_block(int rows) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  int rpb = kMaxRowsPerBlock;
  while (rpb > 1 && (rows + rpb - 1) / rpb < n) rpb /= 2;
  return rpb;
}

template <typename T, int VEC, int NV, bool ADD>
void launch(const Args& a, cudaStream_t stream) {
  const int rpb = rows_per_block(a.rows);
  const dim3 grid((a.rows + rpb - 1) / rpb);
  const size_t smem = 2 * sizeof(float) * a.d;  // scale and bias, staged
  layer_norm_kernel<T, VEC, NV, ADD><<<grid, kWarp * rpb, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.h), a.h_rows, a.scale, a.bias,
      static_cast<T*>(a.y), static_cast<T*>(a.s), a.rows, a.d, a.eps);
}

// NV runs 1, 2, 3, 4, 6, 8, 12, 16 (powers of two and their 3/2) on the
// 16-byte path, so a lane holds close to the packs it needs; 1, 4, 16, 64
// on the scalar path, which only ragged widths take (fewer instances: as
// many as powers of two on both paths). At ViT-g's D = 1408 bf16, 6 packs
// a lane rather than 8 took 3 % off 257 rows and 6-12 % off 2056-8224 on
// an H100 (scripts/ab_layer_norm.py, the two in turns); 768 and 512 tie.
template <int NV, bool FINE>
constexpr int next_nv() {
  if constexpr (!FINE) {
    return NV * 4;
  } else if constexpr (NV == 1) {
    return 2;
  } else if constexpr ((NV & (NV - 1)) == 0) {
    return NV + NV / 2;
  } else {
    return NV / 3 * 4;
  }
}

// The smallest NV of the sequence, up to MAXNV, with 32 * NV * VEC >= d.
template <typename T, int VEC, int NV, int MAXNV, bool ADD>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (kWarp * NV * VEC >= a.d) {
    launch<T, VEC, NV, ADD>(a, stream);
    return cudaSuccess;
  }
  if constexpr (NV < MAXNV) {
    return dispatch<T, VEC, next_nv<NV, (VEC > 1)>(), MAXNV, ADD>(a, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool ADD>
cudaError_t run(const Args& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  const bool aligned = aligned16(a.x) && aligned16(a.h) && aligned16(a.y) && aligned16(a.s) &&
                       aligned16(a.scale) && aligned16(a.bias);
  if (a.d % kVec == 0 && aligned) {
    return dispatch<T, kVec, 1, kMaxD / (kWarp * kVec), ADD>(a, stream);
  }
  return dispatch<T, 1, 1, kMaxD / kWarp, ADD>(a, stream);
}

template <bool ADD>
int run_dtype(const Args& a, int dtype, void* stream) {
  if (a.rows <= 0 || a.d <= 0 || a.d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run<float, ADD>(a, s);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16, ADD>(a, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest feature width the kernel takes; the Python wrapper checks it.
int vlfm_layer_norm_max_d() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int vlfm_layer_norm(const void* x, const float* scale, const float* bias, void* y, int rows,
                    int d, float eps, int dtype, void* stream) {
  return run_dtype<false>(Args{x, nullptr, rows, scale, bias, y, nullptr, rows, d, eps}, dtype,
                          stream);
}

// y = LayerNorm(x + h); s = x + h is stored when s is not null. h has x's
// dtype and h_rows rows (h_rows divides rows; row r of x takes h's row
// r % h_rows). Returns a cudaError_t value (0 = ok).
int vlfm_add_layer_norm(const void* x, const void* h, int h_rows, const float* scale,
                        const float* bias, void* y, void* s, int rows, int d, float eps, int dtype,
                        void* stream) {
  if (h_rows <= 0 || rows % h_rows != 0) return (int)cudaErrorInvalidValue;
  return run_dtype<true>(Args{x, h, h_rows, scale, bias, y, s, rows, d, eps}, dtype, stream);
}

}  // extern "C"
