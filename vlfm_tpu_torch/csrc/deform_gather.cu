// Multi-scale deformable gather + combine for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` behind
// vlfm_tpu/ops/deform_gather.py:gather_combine (vlfm_tpu/ops/deform_gather.py:85),
// which GroundingDINO's deformable attention calls once per level
// (vlfm_tpu/models/grounding_dino.py:_deform_combine_levels). It computes,
// for every (batch b, query q, head h), over all levels l and points p:
//
//   x = (g_x + 1) * W_l / 2 - 0.5,  y = (g_y + 1) * H_l / 2 - 0.5   (f32)
//   x0 = floor(x), y0 = floor(y), dx = x - x0, dy = y - y0
//   s  = (1-dx)(1-dy) v[y0][x0] + dx(1-dy) v[y0][x0+1]
//        + (1-dx)dy v[y0+1][x0] + dx dy v[y0+1][x0+1]   (taps outside the
//        map contribute 0: grid_sample, zeros padding, align_corners=False)
//   out[b, q, h, :] = sum_{l, p} w[b, q, h, l, p] * s           (f32)
//
// value (B, S, nh*dh) is f32 or bf16, the levels flattened one after the
// other (S = sum H_l W_l); grids (B, Q, nh, nl, P, 2) f32; weights
// (B, Q, nh, nl, P) f32 or bf16; out (B, Q, nh, dh) f32.
//
// The TPU kernel kept a zero-padded table of 2x2 stencils per (batch, head)
// in VMEM, because the TPU has no vector gather. A GPU gathers natively, so
// this kernel reads `value` where the samples fall and builds no table (the
// table stores each value row four times).
//
// What bounds it: memory, and the gathers' locality. Each sample reads four
// dh-wide rows at data-dependent places. At the encoder's shape (B=8,
// Q = S = 13,294, nh 8, dh 32, 4 levels, 4 points) that is 13.6 M samples x 4
// taps x 32 channels, several GB of L2 traffic, against ~0.4 GB of
// compulsory bytes (each input read once, the output written once).
//
// Design (simple and exact first): one warp per (b, q, h); lane i of the
// warp computes sample i's anchor, bilinear weights and masks (up to 32
// samples per round), and the warp then walks the samples in order, taking
// each one's taps and weights from that lane by shuffles; the lanes run
// over the dh channels, so each tap is one coalesced dh-wide load (64 bytes
// in bf16, 128 in f32 at dh = 32). Sums are f32 in a fixed order (the four
// taps, then the samples level by level, point by point), each output is
// written by exactly one warp: no atomics, and the result is
// bit-reproducible. Positions are computed with rounded, uncontracted
// operations in the order of the plain version, and clamped as floats
// before any conversion to int, so far-off samples cannot overflow.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/deform_gather.py). The launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLevels = 8;
constexpr int kMaxHeadDim = 128;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first row of the level in value's S axis
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// NC = ceil(dh / 32) channels per lane.
template <typename TV, typename TW, int NC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
deform_gather_kernel(const TV* __restrict__ value, const float* __restrict__ grids,
                     const TW* __restrict__ weights, float* __restrict__ out, Levels lv, int nl,
                     int s, int q, int nh, int dh, int npts, long long warps) {
  const int lane = threadIdx.x % kWarp;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= warps) return;
  const int h = (int)(warp % nh);
  const long long bq = warp / nh;
  const int b = (int)(bq / q);
  const int nlp = nl * npts;
  const int cin = nh * dh;
  const TV* vb = value + (size_t)b * s * cin + (size_t)h * dh;
  const float* g = grids + (size_t)warp * nlp * 2;
  const TW* wq = weights + (size_t)warp * nlp;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int base = 0; base < nlp; base += kWarp) {
    // Lane i: sample base + i. rows < 0 mark taps outside the map.
    int r00 = -1, r01 = -1, r10 = -1, r11 = -1;
    float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f, aw = 0.f;
    const int j = base + lane;
    if (j < nlp) {
      const int l = j / npts;
      const int H = lv.h[l], W = lv.w[l];
      const float gx = g[2 * j], gy = g[2 * j + 1];
      aw = to_f32(wq[j]);
      // (g + 1) * W / 2 - 0.5, each operation rounded, as the plain version.
      const float x = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 0.5f), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 0.5f), 0.5f);
      const float fx0 = floorf(x), fy0 = floorf(y);
      const float dx = __fsub_rn(x, fx0), dy = __fsub_rn(y, fy0);
      // Clamp as floats first: every tap of a clamped corner stays outside
      // exactly when it was outside before, and the conversion cannot overflow.
      const int x0 = (int)fminf(fmaxf(fx0, -2.f), (float)W + 1.f);
      const int y0 = (int)fminf(fmaxf(fy0, -2.f), (float)H + 1.f);
      const bool xin0 = x0 >= 0 && x0 < W, xin1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool yin0 = y0 >= 0 && y0 < H, yin1 = y0 + 1 >= 0 && y0 + 1 < H;
      const float ax = __fsub_rn(1.f, dx), ay = __fsub_rn(1.f, dy);
      // The mask multiplies as a float, so a NaN weight stays NaN.
      w00 = __fmul_rn(__fmul_rn(ax, ay), (xin0 && yin0) ? 1.f : 0.f);
      w01 = __fmul_rn(__fmul_rn(dx, ay), (xin1 && yin0) ? 1.f : 0.f);
      w10 = __fmul_rn(__fmul_rn(ax, dy), (xin0 && yin1) ? 1.f : 0.f);
      w11 = __fmul_rn(__fmul_rn(dx, dy), (xin1 && yin1) ? 1.f : 0.f);
      const int row0 = lv.start[l] + y0 * W + x0;
      if (yin0 && xin0) r00 = row0;
      if (yin0 && xin1) r01 = row0 + 1;
      if (yin1 && xin0) r10 = row0 + W;
      if (yin1 && xin1) r11 = row0 + W + 1;
    }
    const int n = min(kWarp, nlp - base);
    for (int k = 0; k < n; ++k) {
      const int t00 = __shfl_sync(0xffffffffu, r00, k), t01 = __shfl_sync(0xffffffffu, r01, k);
      const int t10 = __shfl_sync(0xffffffffu, r10, k), t11 = __shfl_sync(0xffffffffu, r11, k);
      const float v00w = __shfl_sync(0xffffffffu, w00, k), v01w = __shfl_sync(0xffffffffu, w01, k);
      const float v10w = __shfl_sync(0xffffffffu, w10, k), v11w = __shfl_sync(0xffffffffu, w11, k);
      const float a = __shfl_sync(0xffffffffu, aw, k);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + kWarp * c;
        if (d < dh) {
          const float v00 = t00 >= 0 ? to_f32(vb[(size_t)t00 * cin + d]) : 0.f;
          const float v01 = t01 >= 0 ? to_f32(vb[(size_t)t01 * cin + d]) : 0.f;
          const float v10 = t10 >= 0 ? to_f32(vb[(size_t)t10 * cin + d]) : 0.f;
          const float v11 = t11 >= 0 ? to_f32(vb[(size_t)t11 * cin + d]) : 0.f;
          float sm = __fmul_rn(v00w, v00);
          sm = __fadd_rn(sm, __fmul_rn(v01w, v01));
          sm = __fadd_rn(sm, __fmul_rn(v10w, v10));
          sm = __fadd_rn(sm, __fmul_rn(v11w, v11));
          acc[c] = __fadd_rn(acc[c], __fmul_rn(a, sm));
        }
      }
    }
  }
  float* o = out + (size_t)warp * dh;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + kWarp * c;
    if (d < dh) o[d] = acc[c];
  }
}

template <typename TV, typename TW>
cudaError_t run(const void* value, const float* grids, const void* weights, float* out,
                const Levels& lv, int nl, int b, int s, int q, int nh, int dh, int npts,
                cudaStream_t stream) {
  const long long warps = (long long)b * q * nh;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarp * kWarpsPerBlock);
  const TV* v = static_cast<const TV*>(value);
  const TW* w = static_cast<const TW*>(weights);
  switch ((dh + kWarp - 1) / kWarp) {
    case 1:
      deform_gather_kernel<TV, TW, 1><<<grid, block, 0, stream>>>(v, grids, w, out, lv, nl, s, q, nh,
                                                                    dh, npts, warps);
      break;
    case 2:
      deform_gather_kernel<TV, TW, 2><<<grid, block, 0, stream>>>(v, grids, w, out, lv, nl, s, q, nh,
                                                                    dh, npts, warps);
      break;
    case 3:
      deform_gather_kernel<TV, TW, 3><<<grid, block, 0, stream>>>(v, grids, w, out, lv, nl, s, q, nh,
                                                                    dh, npts, warps);
      break;
    case 4:
      deform_gather_kernel<TV, TW, 4><<<grid, block, 0, stream>>>(v, grids, w, out, lv, nl, s, q, nh,
                                                                    dh, npts, warps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// levels: nl (H, W) pairs on the host. value_dtype, weight_dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
int vlfm_deform_gather(const void* value, const float* grids, const void* weights, float* out,
                       const int* levels, int nl, int b, int s, int q, int nh, int dh, int npts,
                       int value_dtype, int weight_dtype, void* stream) {
  if (nl < 1 || nl > kMaxLevels || b < 1 || q < 1 || nh < 1 || npts < 1 || dh < 1 ||
      dh > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  long long start = 0;
  for (int l = 0; l < nl; ++l) {
    lv.h[l] = levels[2 * l];
    lv.w[l] = levels[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return (int)cudaErrorInvalidValue;
    lv.start[l] = (int)start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (value_dtype == 0 && weight_dtype == 0) {
    err = run<float, float>(value, grids, weights, out, lv, nl, b, s, q, nh, dh, npts, st);
  } else if (value_dtype == 1 && weight_dtype == 0) {
    err = run<__nv_bfloat16, float>(value, grids, weights, out, lv, nl, b, s, q, nh, dh, npts, st);
  } else if (value_dtype == 0 && weight_dtype == 1) {
    err = run<float, __nv_bfloat16>(value, grids, weights, out, lv, nl, b, s, q, nh, dh, npts, st);
  } else if (value_dtype == 1 && weight_dtype == 1) {
    err = run<__nv_bfloat16, __nv_bfloat16>(value, grids, weights, out, lv, nl, b, s, q, nh, dh,
                                            npts, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
