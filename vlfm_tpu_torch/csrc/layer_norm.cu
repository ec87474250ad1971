// LayerNorm over the last axis, f32 statistics, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ln_kernel` behind
// vlfm_tpu/ops/norms.py:layer_norm (vlfm_tpu/ops/norms.py:28), which serves
// every LayerNorm of the BLIP-2 ViT-g and Q-Former. It computes, per row of
// a (rows, D) tensor:
//   mu  = sum(x) * (1/D)                  (f32)
//   var = sum((x - mu)^2) * (1/D)         (f32, two passes over the
//                                          register-held row, not E[x^2]-mu^2)
//   y   = (x - mu) * rsqrt(var + eps) * scale + bias, stored in x's dtype.
// x and y are bf16 or f32; scale and bias are f32.
//
// What bounds it: memory traffic. Each row is read once and written once
// (a ViT-g row of 1408 bf16 is 2.8 KB) and the arithmetic is a few FLOPs a
// byte, far below the card's compute-to-bandwidth ratio. The design keeps
// the traffic at that minimum: one warp owns one row and holds it in
// registers between the load, the two reductions (warp shuffles, no shared
// memory) and the store. When D * sizeof(T) is a multiple of 16 bytes and
// every pointer is 16-byte aligned, each lane moves 16 bytes per access of
// x and y and loads scale and bias as float4; otherwise each access is one
// element (ragged D such as 33). scale and bias (a few KB) stay in L1/L2.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/norms.py). The launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;  // one warp per row, 128 threads a block
constexpr int kMaxD = 2048;       // largest D any instantiation below holds

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

// VEC consecutive f32 values from p + col: float4 loads when VEC allows it
// (the caller guarantees 16-byte alignment then), scalar loads otherwise.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, int col, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + col + e));
      out[e] = q.x;
      out[e + 1] = q.y;
      out[e + 2] = q.z;
      out[e + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = __ldg(p + col + e);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Each lane holds NV packs of VEC consecutive elements: pack p of lane l is
// pack index l + 32 * p of the row. Packs past the row end are masked.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows, int d,
                  float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int npacks = d / VEC;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)row * d);
  Pack<T, VEC>* yr = reinterpret_cast<Pack<T, VEC>*>(y + (size_t)row * d);

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < NV; ++p) {
    const int idx = lane + kWarp * p;
    if (idx < npacks) {
      const Pack<T, VEC> pk = xr[idx];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[p][e] = to_f32(pk.v[e]);
        sum += v[p][e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[p][e] = 0.f;
    }
  }
  const float inv_d = 1.f / (float)d;
  const float mu = warp_sum(sum) * inv_d;

  float sq = 0.f;
#pragma unroll
  for (int p = 0; p < NV; ++p) {
    if (lane + kWarp * p < npacks) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float c = v[p][e] - mu;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);

#pragma unroll
  for (int p = 0; p < NV; ++p) {
    const int idx = lane + kWarp * p;
    if (idx < npacks) {
      float s[VEC], b[VEC];
      load_f32<VEC>(scale, idx * VEC, s);
      load_f32<VEC>(bias, idx * VEC, b);
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // Rounded multiply, then rounded add (no FMA contraction): the same
        // roundings as the plain version's (y * scale + bias).
        const float y = __fmul_rn(v[p][e] - mu, rstd);
        out.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(y, s[e]), b[e]));
      }
      yr[idx] = out;
    }
  }
}

template <typename T, int VEC, int NV>
void launch(const void* x, const float* scale, const float* bias, void* y, int rows, int d,
            float eps, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_kernel<T, VEC, NV><<<grid, kWarp * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, d, eps);
}

// Smallest NV in {1, 2, 4, ..., MAXNV} with 32 * NV * VEC >= d.
template <typename T, int VEC, int NV, int MAXNV>
cudaError_t dispatch(const void* x, const float* scale, const float* bias, void* y, int rows,
                     int d, float eps, cudaStream_t stream) {
  if (kWarp * NV * VEC >= d) {
    launch<T, VEC, NV>(x, scale, bias, y, rows, d, eps, stream);
    return cudaSuccess;
  }
  if constexpr (NV < MAXNV) {
    return dispatch<T, VEC, NV * 2, MAXNV>(x, scale, bias, y, rows, d, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(const void* x, const float* scale, const float* bias, void* y, int rows, int d,
                float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(scale) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(bias) % 16 == 0);
  if (d % kVec == 0 && aligned) {
    return dispatch<T, kVec, 1, kMaxD / (kWarp * kVec)>(x, scale, bias, y, rows, d, eps, stream);
  }
  return dispatch<T, 1, 1, kMaxD / kWarp>(x, scale, bias, y, rows, d, eps, stream);
}

}  // namespace

extern "C" {

// Largest feature width the kernel takes; the Python wrapper checks it.
int vlfm_layer_norm_max_d() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int vlfm_layer_norm(const void* x, const float* scale, const float* bias, void* y, int rows,
                    int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run<float>(x, scale, bias, y, rows, d, eps, s);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
