// Multi-scale deformable gather + combine for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` behind
// vlfm_tpu/ops/deform_gather.py:gather_combine (vlfm_tpu/ops/deform_gather.py:85),
// which GroundingDINO's deformable attention calls once per level
// (vlfm_tpu/models/grounding_dino.py:_deform_combine_levels). It computes,
// for every item (batch b, query q, head h), over all levels l and points p:
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
// (B, Q, nh, nl, P) f32 or bf16; out (B, Q, nh, dh) f32. Items are taken in
// memory order, (b, q, h) with the heads of one query together, so a run of
// items has its grids and weights in one contiguous span.
//
// The TPU kernel kept a zero-padded table of 2x2 stencils per (batch, head)
// in VMEM and combined the taps on the MXU through 0/1 expand and tap-sum
// matrices, because the TPU has no vector gather. A GPU gathers natively, so
// this kernel reads `value` where the samples fall. It uses no tensor cores:
// the combine is four weighted rows per sample, with no operand shared
// between items. It keeps no window of `value` in shared memory either: the
// records show that the samples' locality did not set the time of the
// first design (uniform random grids and the model's own, which cluster
// around each token's reference point, took the same time).
//
// What bounds it: the taps' traffic through L1. At the encoder's shape
// (B=8, Q = S = 13,294, nh 8, dh 32, 4 levels x 4 points) there are 13.6 M
// samples, 54 M tap rows of 128 bytes (f32), 7 GB through L1, against
// 0.38 GB that the call must move (each input read once, the output written
// once). At L1's 128 bytes a clock per SM the taps alone take ~0.24 ms on
// an H100; each lane group also reads its 32-byte sample record from shared
// memory through the same data path. The first design spent ~40
// warp-instructions per sample around the 4 tap loads (9 shuffles to pass
// a sample's taps and weights from one lane to the warp, 4 scalar loads
// behind branches with 64-bit addresses, a sample loop of run-time
// length), so instruction issue and latency set its time; this design
// spends ~9 by count. What each step does:
//
// 1. Lane groups with wide taps. An item gets G = dh * esize / 16 lanes
//    (8 in f32, 4 in bf16 at dh = 32), each lane loads its VW channels of a
//    tap as one 16-byte load, and a warp serves 32 / G items at once. Each
//    lane accumulates VW channels in registers and writes them with 16-byte
//    stores. Offsets are 32-bit (the wrapper refuses tensors of 2^31
//    elements or more); the (b, h) base pointer is computed once per item.
//    Where dh * esize or the value pointer is not 16-byte aligned, the plan
//    takes an 8-, 4- or 2-byte vector, down to one element a lane; a dh of
//    more than 32 vectors takes 2 or 4 vectors a lane (the CHUNKS template).
// 2. Sample tables in shared memory. Every thread of the block takes part
//    in the position math of the tile's samples (items x nl*P); each sample
//    leaves its four row offsets (-1 for a tap outside the map) and its four
//    tap weights, the attention weight folded in as the TPU kernel folds it
//    (vlfm_tpu/models/grounding_dino.py:383), in shared memory. A group then
//    reads a sample's record with two broadcast 16-byte shared loads instead
//    of 9 shuffles.
// 3. An unrolled sample loop. nl*P = 16 (GroundingDINO's 4 x 4) is a
//    template parameter; other counts take a run-time loop. Samples are
//    taken four at a time: a lane issues its 16 independent tap loads before
//    the arithmetic that needs them.
// 4. Grids and weights streamed by bulk copies. A persistent grid of two
//    blocks per SM walks tiles of consecutive items, block k taking tiles
//    k, k + grid, k + 2 grid, ...: the blocks in flight then hold one band
//    of consecutive items, whose value rows stay in L2 (the encoder's value
//    is 109 MB in f32 at B=8, twice the L2; blocks that each walked their
//    own contiguous run spread over all 8 images at once and took a third
//    longer). One thread copies each tile's grids and weights (contiguous
//    in memory) into shared memory with cp.async.bulk on an mbarrier,
//    double-buffered: the next tile's bytes arrive while this one gathers.
//    A tile whose spans are not 16-byte aligned or whole (the last one, or
//    odd counts) is read by the threads from device memory instead.
//
// Rounding order: positions are computed with rounded, uncontracted
// operations in the order of the plain version and clamped as floats before
// any conversion to int, so far-off samples cannot overflow. A tap weight is
// a * ((1-dx)(1-dy) * mask), each product rounded; the output accumulates in
// f32 with one fused multiply-add per tap and channel, the four taps in
// order, the samples level by level, point by point. Each output is written
// by one lane group in that fixed order, with no atomics: the result is
// bit-reproducible. An outside tap's load is predicated off and reads 0, so
// an inf or NaN elsewhere in `value` cannot leak in (0 x inf), while a NaN
// attention weight still makes the output NaN.
//
// Plain C interface, bound from Python with ctypes
// (vlfm_tpu_torch/ops/deform_gather.py, whose deform_plan chooses the
// vector width, lane groups, tile, grid and shared memory). The kernel
// refuses a plan that is not legal for the tensors or whose shared-memory
// figure differs from its own. The launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kBlocksPerSm = 2;  // with kMaxWarps: at most 128 registers a thread
constexpr int kMaxLevels = 8;
constexpr int kMaxHeadDim = 128;
constexpr int kBatch = 4;  // samples whose taps a lane loads before using them
constexpr int kSampleTemplate = 16;
constexpr int kMaxSmem = 232448;

struct Params {
  const void* value;
  const float* grids;
  const void* weights;
  float* out;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
  int nl, npts, nlp, s, q, nh, dh, cin;
  int items, tiles, tile_items;
  int lane_shift;  // log2 of the lanes per item
  int nvec;        // dh / VW: the vectors of a row
  int wbf16;       // weights are bf16
  int bulk;        // grids and weights of whole tiles arrive by bulk copies
  int gbytes, wbytes;  // a stage buffer's grid and weight bytes
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory: two mbarriers, the double-buffered sample tables
// (int4 offsets, then float4 weights; nl*P + 1 records an item, the last
// one padding, so that the groups of a quarter-warp read other banks), then
// with bulk copies the two stage buffers of grids and then of weights.
// deform_plan computes the same.
__host__ __device__ constexpr int table_offset() { return 16; }
__host__ __device__ constexpr int smem_bytes(int records, int gbytes, int wbytes, int bulk) {
  return table_offset() + 2 * 2 * records * 16 + (bulk ? 2 * (gbytes + wbytes) : 0);
}

// --- Hopper's bulk copy on an mbarrier ----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's earlier generic accesses to shared memory before the
// bulk copies it issues next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- A lane's VW channels of one tap ------------------------------------------
template <typename TV, int VW>
struct Vec;
template <>
struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<float, 2> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
  }
};
template <>
struct Vec<float, 1> {
  using Raw = unsigned int;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) { f[0] = __uint_as_float(r); }
};
// bf16 pairs: the element at the lower address is the word's low half.
__device__ __forceinline__ void bf16x2(unsigned int u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    bf16x2(r.x, f), bf16x2(r.y, f + 2), bf16x2(r.z, f + 4), bf16x2(r.w, f + 6);
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) { bf16x2(r.x, f), bf16x2(r.y, f + 2); }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using Raw = unsigned int;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) { bf16x2(r, f); }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
};

template <int VW>
__device__ __forceinline__ void store(float* o, const float* a) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VW; e += 4) *reinterpret_cast<float4*>(o + e) = make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
  } else {
    o[0] = a[0];
  }
}

__device__ __forceinline__ int tap_of(const int4& o, int t) { return t == 0 ? o.x : t == 1 ? o.y : t == 2 ? o.z : o.w; }
__device__ __forceinline__ float tap_of(const float4& w, int t) { return t == 0 ? w.x : t == 1 ? w.y : t == 2 ? w.z : w.w; }

// KB samples of one item: the taps' loads first, then their FMAs.
template <typename TV, int VW, int CHUNKS, int KB>
__device__ __forceinline__ void gather(const int4* ro, const float4* rw, const TV* vb, int stride, const bool* ok,
                                       float (&acc)[CHUNKS][VW]) {
  using V = Vec<TV, VW>;
  typename V::Raw raw[KB][4][CHUNKS];
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const int4 o = ro[u];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int off = tap_of(o, t);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        raw[u][t][c] = typename V::Raw{};
        if (off >= 0 && ok[c]) raw[u][t][c] = __ldg(reinterpret_cast<const typename V::Raw*>(vb + off + c * stride));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const float4 w = rw[u];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float wt = tap_of(w, t);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float f[VW];
        V::unpack(raw[u][t][c], f);
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[c][e] = __fmaf_rn(wt, f[e], acc[c][e]);
      }
    }
  }
}

// NLP: the samples per item as a template (kSampleTemplate), or 0 for a
// run-time count.
template <typename TV, int VW, int CHUNKS, int NLP>
__global__ void __launch_bounds__(kWarp * kMaxWarps, kBlocksPerSm) deform_gather_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int nlp = NLP ? NLP : p.nlp;
  const int ts = p.tile_items * nlp;  // the samples of a whole tile
  const int wsize = p.wbf16 ? 2 : 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* offs = reinterpret_cast<int4*>(smem + table_offset());
  float4* wts = reinterpret_cast<float4*>(smem + table_offset() + 2 * ts * 16);
  unsigned char* stage_g = smem + table_offset() + 4 * ts * 16;
  unsigned char* stage_w = stage_g + 2 * p.gbytes;

  if (tid < p.nl) s_h[tid] = p.h[tid], s_w[tid] = p.w[tid], s_start[tid] = p.start[tid];
  if (p.bulk && tid == 0) {
    mbar_init(smem_u32(&bars[0]));
    mbar_init(smem_u32(&bars[1]));
    fence_mbar_init();
  }
  __syncthreads();

  // This block's tiles: every gridDim.x-th, so that the blocks in flight
  // hold one band of consecutive tiles.
  const int t_begin = blockIdx.x, t_step = gridDim.x;
  auto whole = [&](int t) { return p.items - t * p.tile_items >= p.tile_items; };
  auto issue = [&](int t, int buf) {
    const uint32_t bar = smem_u32(&bars[buf]);
    mbar_expect_tx(bar, ts * 8 + ts * wsize);
    bulk_g2s(smem_u32(stage_g + buf * p.gbytes), p.grids + (size_t)t * ts * 2, ts * 8, bar);
    bulk_g2s(smem_u32(stage_w + buf * p.wbytes),
             static_cast<const unsigned char*>(p.weights) + (size_t)t * ts * wsize, ts * wsize, bar);
  };
  if (p.bulk && tid == 0 && t_begin < p.tiles && whole(t_begin)) issue(t_begin, 0);

  // The lane's group and its place in it.
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int li = lane & ((1 << p.lane_shift) - 1);
  const int item_local = (warp << (5 - p.lane_shift)) + (lane >> p.lane_shift);
  const int stride = VW << p.lane_shift;  // elements between a lane's chunks
  bool ok[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) ok[c] = li + (c << p.lane_shift) < p.nvec;

  for (int t = t_begin, k = 0; t < p.tiles; t += t_step, ++k) {
    const int buf = k & 1;
    if (p.bulk && tid == 0 && t + t_step < p.tiles && whole(t + t_step)) {
      fence_proxy_async();
      issue(t + t_step, buf ^ 1);
    }
    const int first = t * p.tile_items;
    const int ti = min(p.tile_items, p.items - first);
    const bool staged = p.bulk && ti == p.tile_items;
    if (staged) mbar_wait(smem_u32(&bars[buf]), (k >> 1) & 1);
    const float* gsrc = staged ? reinterpret_cast<const float*>(stage_g + buf * p.gbytes)
                               : p.grids + (size_t)first * nlp * 2;
    const unsigned char* wsrc = staged ? stage_w + buf * p.wbytes
                                       : static_cast<const unsigned char*>(p.weights) + (size_t)first * nlp * wsize;
    int4* to = offs + buf * ts;
    float4* tw = wts + buf * ts;

    // Position math, every thread on its share of the tile's samples.
    for (int j = tid; j < ti * nlp; j += nthreads) {
      const int l = (j % nlp) / p.npts;
      const int H = s_h[l], W = s_w[l];
      const float gx = gsrc[2 * j], gy = gsrc[2 * j + 1];
      const float a = p.wbf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(wsrc)[j])
                              : reinterpret_cast<const float*>(wsrc)[j];
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
      tw[j] = make_float4(__fmul_rn(a, __fmul_rn(__fmul_rn(ax, ay), (xin0 && yin0) ? 1.f : 0.f)),
                          __fmul_rn(a, __fmul_rn(__fmul_rn(dx, ay), (xin1 && yin0) ? 1.f : 0.f)),
                          __fmul_rn(a, __fmul_rn(__fmul_rn(ax, dy), (xin0 && yin1) ? 1.f : 0.f)),
                          __fmul_rn(a, __fmul_rn(__fmul_rn(dx, dy), (xin1 && yin1) ? 1.f : 0.f)));
      // Element offsets from the item's (b, h) base; unsigned, as an outside
      // corner's row may be negative and is never used.
      const unsigned row0 = (unsigned)(s_start[l] + y0 * W + x0), cin = (unsigned)p.cin;
      to[j] = make_int4(yin0 && xin0 ? (int)(row0 * cin) : -1, yin0 && xin1 ? (int)((row0 + 1u) * cin) : -1,
                        yin1 && xin0 ? (int)((row0 + W) * cin) : -1,
                        yin1 && xin1 ? (int)((row0 + W + 1u) * cin) : -1);
    }
    __syncthreads();  // the tables are whole; the stage buffer is free again

    if (item_local < ti) {
      const int i = first + item_local;
      const int h = i % p.nh, b = i / (p.q * p.nh);
      const TV* vb = static_cast<const TV*>(p.value) + (b * p.s * p.cin + h * p.dh + li * VW);
      const int4* ro = to + item_local * nlp;
      const float4* rw = tw + item_local * nlp;
      float acc[CHUNKS][VW];
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[c][e] = 0.f;
      if constexpr (NLP != 0) {
#pragma unroll
        for (int j = 0; j < NLP; j += kBatch) gather<TV, VW, CHUNKS, kBatch>(ro + j, rw + j, vb, stride, ok, acc);
      } else {
        int j = 0;
        for (; j + kBatch <= nlp; j += kBatch) gather<TV, VW, CHUNKS, kBatch>(ro + j, rw + j, vb, stride, ok, acc);
        for (; j < nlp; ++j) gather<TV, VW, CHUNKS, 1>(ro + j, rw + j, vb, stride, ok, acc);
      }
      float* o = p.out + (size_t)i * p.dh + li * VW;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        if (ok[c]) store<VW>(o + c * stride, acc[c]);
    }
  }
}

template <typename TV, int VW>
constexpr int kMaxChunks = (kMaxHeadDim / VW + kWarp - 1) / kWarp;

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int blocks, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename TV, int VW, int CHUNKS>
cudaError_t run_samples(const Params& p, int nlp_template, int blocks, int threads, int smem, cudaStream_t st) {
  if (nlp_template == kSampleTemplate)
    return launch(deform_gather_kernel<TV, VW, CHUNKS, kSampleTemplate>, p, blocks, threads, smem, st);
  return launch(deform_gather_kernel<TV, VW, CHUNKS, 0>, p, blocks, threads, smem, st);
}

template <typename TV, int VW>
cudaError_t run_chunks(const Params& p, int chunks, int nlp_template, int blocks, int threads, int smem,
                       cudaStream_t st) {
  if (chunks == 1) return run_samples<TV, VW, 1>(p, nlp_template, blocks, threads, smem, st);
  if constexpr (kMaxChunks<TV, VW> >= 2) {
    if (chunks == 2) return run_samples<TV, VW, 2>(p, nlp_template, blocks, threads, smem, st);
  }
  if constexpr (kMaxChunks<TV, VW> >= 4) {
    if (chunks == 4) return run_samples<TV, VW, 4>(p, nlp_template, blocks, threads, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TV>
cudaError_t run_vec(const Params& p, int vec, int chunks, int nlp_template, int blocks, int threads, int smem,
                    cudaStream_t st) {
  switch (vec) {
    case 1: return run_chunks<TV, 1>(p, chunks, nlp_template, blocks, threads, smem, st);
    case 2: return run_chunks<TV, 2>(p, chunks, nlp_template, blocks, threads, smem, st);
    case 4: return run_chunks<TV, 4>(p, chunks, nlp_template, blocks, threads, smem, st);
    case 8:
      if constexpr (sizeof(TV) == 2) return run_chunks<TV, 8>(p, chunks, nlp_template, blocks, threads, smem, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return (1 << s) == n ? s : -1;
}

}  // namespace

extern "C" {

// levels: nl (H, W) pairs on the host. value_dtype, weight_dtype: 0 =
// float32, 1 = bfloat16. The plan of ops/deform_gather.py:deform_plan:
// vec (elements of a lane's tap load), lanes (per item), chunks (tap loads
// per lane per tap), warps (per block), nlp_template (16 or 0), bulk (1:
// grids and weights by bulk copies), blocks (the persistent grid) and
// smem_bytes. Returns a cudaError_t value (0 = ok).
int vlfm_deform_gather(const void* value, const float* grids, const void* weights, float* out,
                       const int* levels, int nl, int b, int s, int q, int nh, int dh, int npts,
                       int value_dtype, int weight_dtype, int vec, int lanes, int chunks, int warps,
                       int nlp_template, int bulk, int blocks, int smem, void* stream) {
  if (nl < 1 || nl > kMaxLevels || b < 1 || q < 1 || nh < 1 || npts < 1 || dh < 1 || dh > kMaxHeadDim ||
      (value_dtype != 0 && value_dtype != 1) || (weight_dtype != 0 && weight_dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  long long start = 0;
  for (int l = 0; l < nl; ++l) {
    p.h[l] = levels[2 * l];
    p.w[l] = levels[2 * l + 1];
    if (p.h[l] < 1 || p.w[l] < 1) return (int)cudaErrorInvalidValue;
    p.start[l] = (int)start;
    start += (long long)p.h[l] * p.w[l];
  }
  const long long items = (long long)b * q * nh, nlp = (long long)nl * npts;
  if (start != s || (long long)b * s * nh * dh >= (1LL << 31) || items * nlp * 2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;

  // The plan must be legal for these tensors: the vector divides the head
  // and the value pointer's alignment, the lane groups tile a warp and cover
  // the head, the sample template matches, bulk copies see 16-byte spans.
  const int esize = value_dtype ? 2 : 4, wsize = weight_dtype ? 2 : 4;
  if (vec < 1 || vec * esize > 16 || log2_exact(vec) < 0 || dh % vec ||
      reinterpret_cast<uintptr_t>(value) % (vec * esize))
    return (int)cudaErrorInvalidValue;
  // nvec vectors a row: the smallest power-of-two group of lanes that holds
  // them, up to a warp; beyond that 2 or 4 vectors a lane.
  const int nvec = dh / vec;
  int want_lanes = 1, want_chunks = 1;
  while (want_lanes < nvec && want_lanes < kWarp) want_lanes *= 2;
  while (want_lanes * want_chunks < nvec) want_chunks *= 2;
  const int shift = log2_exact(lanes);
  if (lanes != want_lanes || chunks != want_chunks || (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      nlp_template != (nlp == kSampleTemplate ? kSampleTemplate : 0) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int tile_items = warps * (kWarp / lanes);
  const long long ts = (long long)tile_items * nlp, records = (long long)tile_items * (nlp + 1);
  if (records * 64 > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.gbytes = align16((int)ts * 8);
  p.wbytes = align16((int)ts * wsize);
  if (bulk && (reinterpret_cast<uintptr_t>(grids) % 16 || reinterpret_cast<uintptr_t>(weights) % 16 ||
               (ts * 8) % 16 || (ts * wsize) % 16))
    return (int)cudaErrorInvalidValue;
  if (smem != smem_bytes((int)ts, p.gbytes, p.wbytes, bulk) || smem > kMaxSmem) return (int)cudaErrorInvalidValue;

  p.value = value, p.grids = grids, p.weights = weights, p.out = out;
  p.nl = nl, p.npts = npts, p.nlp = (int)nlp, p.s = s, p.q = q, p.nh = nh, p.dh = dh, p.cin = nh * dh;
  p.items = (int)items;
  p.tile_items = tile_items;
  p.tiles = (int)((items + tile_items - 1) / tile_items);
  p.lane_shift = shift;
  p.nvec = nvec;
  p.wbf16 = weight_dtype;
  p.bulk = bulk ? 1 : 0;
  blocks = blocks < p.tiles ? blocks : p.tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * kWarp;
  cudaError_t err = value_dtype == 0 ? run_vec<float>(p, vec, chunks, nlp_template, blocks, threads, smem, st)
                                     : run_vec<__nv_bfloat16>(p, vec, chunks, nlp_template, blocks, threads, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
