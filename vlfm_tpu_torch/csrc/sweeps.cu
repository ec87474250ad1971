// The obstacle map's two convergence loops, each run to its fixed point in
// one launch, for NVIDIA Hopper (sm_90a).
//
// These kernels replace no TPU kernel. The JAX package runs both loops as
// `lax.while_loop` over `jnp` ops (vlfm_tpu/ops/bitpack.py:flood_packed,
// vlfm_tpu/ops/flood.py:flood_from_seed and label_components), which XLA
// keeps on the device. The port's plain versions are Python loops of eager
// sweeps that read a "changed" flag back to the host every few sweeps: a
// flood sweep is ~17 launches, a labelling sweep ~10, and the host read
// stands in the way of capturing the policy step as a CUDA graph. Here a
// whole loop is one launch and reads nothing back.
//
//   vlfm_flood  cur = seed & mask; repeat cur' = dilate3x3(cur) & mask on
//               32 columns a word. `wrap` set: rows and words roll around
//               the lane's grid as torch.roll does (the bit-packed loop,
//               ops/bitpack.py:dilate8_packed); unset: cells outside the
//               grid are empty (the unpacked loop's zero-padded dilation).
//               Input and output are bool bytes, packed into words in the
//               kernel (any width).
//   vlfm_label  lab = mask ? linear index : INT32_MAX; repeat lab' = mask ?
//               min over the in-grid 3x3 neighbourhood of lab : INT32_MAX
//               (ops/flood.py:label_components, Jacobi sweeps, so a capped
//               run stops where the plain loop stops). A set cell never holds
//               INT32_MAX, so the labels carry the mask: it is not stored.
//
// Stopping rule. A lane stops at the first sweep that changes nothing, or
// after `cap` sweeps: the plain loop's max_iters rounded up to a whole
// check. The plain loop stops at the first check that saw no lane change,
// and a converged lane is a fixed point, so both return the same bits, the
// capped case included.
//
// Design. One cluster of 8 CTAs per lane (grid (8, lanes)); each
// CTA of the cluster holds a band of rows in shared memory, double
// buffered: the flood its rows' words of cur and mask (a 1344x1344 lane is
// 1344 rows of 42 words, 168 rows a CTA at 8 CTAs), the labelling its rows'
// int32 labels (336x336: 42 rows a CTA). A sweep reads the source buffer
// (its own rows, and the rows above and below its band from the
// neighbouring CTAs' shared memory through distributed shared memory) and
// writes the other buffer. A CTA that changed a word (a block-wide OR)
// stores 1 in this sweep's flag in CTA 0's shared memory; one cluster
// barrier ends the sweep, after which every thread reads the flag. Three
// flags rotate, so CTA 0 clears the next sweep's flag during this one and
// no second barrier is needed. Nothing goes through device memory between
// the load and the store of the result. The bool flood packs its rows into
// words as it loads them: a warp ballots 32 columns into a word.
//
// What bounds it: the barrier's latency per sweep, not bytes. The lane's
// bytes move once (a 1344x1344 flood reads 3.6 MB of bool mask and seed
// and writes 1.8 MB; the labelling reads 113 KB and writes 452 KB), and a
// sweep's arithmetic on 7,056 words (or 14,112 labels) a CTA is a few
// hundred cycles at 1024 threads; each sweep then waits on the cluster
// barrier and one read of CTA 0's flag.
//
// The counts. Each launch adds the batch's sweeps (the most any lane ran,
// as the plain loops count a sweep of all lanes) and 1, its launch, into two
// int64 accumulators on the device (utils/profiling.py's `map.sweeps` and
// `flood.launches` or `label.launches`), so a CUDA graph's replays keep
// counting: each lane's CTA 0 takes the maximum into a two-int scratch
// through atomics, and the last lane to finish adds both and clears the
// scratch for the next launch. Launches that share a scratch must not run at
// once (the wrappers keep one per device; a stream runs them in order).
//
// `vlfm_cluster_sync` is no part of the map: a kernel of the same clusters
// (8 CTAs of 1024 threads) that only waits on the cluster barrier, `iters`
// times, whose time per barrier is the floor of one sweep on the card.
//
// Plain C interface, bound from Python with ctypes (vlfm_tpu_torch/ops/
// flood.py). The launch goes on the caller's stream; the functions return
// cudaGetLastError() or a refusal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 8;  // CTAs a lane: the most a portable cluster holds
constexpr int kSmemLimit = 232448;  // 227 KB, a block's most on sm_90
constexpr int kFlagBytes = 16;      // three rotating int flags, padded to 16 bytes
constexpr int32_t kBig = 0x7fffffff;
constexpr int kMaxDevices = 64;

struct Band {
  int rank, rows_per, r0, r1;
};

__device__ __forceinline__ Band band_of(const cg::cluster_group& cluster, int rows, int rows_per) {
  Band b;
  b.rank = (int)cluster.block_rank();
  b.rows_per = rows_per;
  b.r0 = min(rows, b.rank * rows_per);
  b.r1 = min(rows, b.r0 + rows_per);
  return b;
}

// Pointer to row `r`'s first element in the buffer `buf` (this CTA's copy)
// as the CTA that owns the row holds it.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const cg::cluster_group& cluster, const Band& b, T* buf, int r,
                                            int row_len) {
  if (r >= b.r0 && r < b.r1) return buf + (size_t)(r - b.r0) * row_len;
  const int owner = r / b.rows_per;
  return cluster.map_shared_rank(buf, owner) + (size_t)(r - owner * b.rows_per) * row_len;
}

// The end of a sweep: a CTA that changed (a block-wide OR) flags it to CTA
// 0 with one store, CTA 0 clears the flag two sweeps ahead, the cluster
// waits, and every thread reads whether any CTA changed.
__device__ __forceinline__ bool end_sweep(const cg::cluster_group& cluster, int* flags, int sweep, bool changed) {
  const int slot = sweep % 3;
  volatile int* flags0 = cluster.map_shared_rank(flags, 0);
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags0[slot] = 1;
  if (cluster.block_rank() == 0 && threadIdx.x == 0) flags[(sweep + 1) % 3] = 0;
  cluster.sync();
  return flags0[slot] != 0;
}

// Lane's CTA 0, thread 0: add the batch's sweeps (the lanes' maximum) and
// the launch once the last lane has finished.
__device__ __forceinline__ void count_sweeps(int sweeps, int lanes, unsigned long long* total,
                                             unsigned long long* launches, int* scratch) {
  atomicMax(&scratch[0], sweeps);
  __threadfence();
  if (atomicAdd(&scratch[1], 1) == lanes - 1) {
    const int most = atomicExch(&scratch[0], 0);
    atomicExch(&scratch[1], 0);
    atomicAdd(total, (unsigned long long)most);
    atomicAdd(launches, 1ULL);
  }
}

struct FloodArgs {
  const uint8_t* mask;  // (lanes, rows, cols) bool
  const uint8_t* seed;
  uint8_t* out;
  int lanes, rows, cols, words, rows_per, cap, wrap;
  unsigned long long *sweeps, *launches;
  int* scratch;
};

// Word w of row r of a lane's bool grid: one warp packs 32 columns with a
// ballot (lane j reads column w*32 + j). Called by a whole warp.
__device__ __forceinline__ uint32_t pack_word(const uint8_t* grid, int cols, int r, int w) {
  const int col = w * 32 + (threadIdx.x & 31);
  const bool bit = col < cols && grid[(size_t)r * cols + col] != 0;
  return __ballot_sync(0xffffffffu, bit);
}

__global__ void __launch_bounds__(kThreads) flood_kernel(FloodArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  int* flags = reinterpret_cast<int*>(smem);
  const Band b = band_of(cluster, a.rows, a.rows_per);
  const int band_words = (b.r1 - b.r0) * a.words;
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(smem + kFlagBytes);
  uint32_t* buf1 = buf0 + (size_t)a.rows_per * a.words;
  uint32_t* mask = buf1 + (size_t)a.rows_per * a.words;
  const int lane = blockIdx.y;
  const int warp = threadIdx.x >> 5, nwarps = kThreads >> 5;

  const uint8_t* m = a.mask + (size_t)lane * a.rows * a.cols;
  const uint8_t* s = a.seed + (size_t)lane * a.rows * a.cols;
  for (int i = warp; i < band_words; i += nwarps) {
    const int r = b.r0 + i / a.words, w = i % a.words;
    const uint32_t mw = pack_word(m, a.cols, r, w), sw = pack_word(s, a.cols, r, w);
    if ((threadIdx.x & 31) == 0) {
      mask[i] = mw;
      buf0[i] = sw & mw;
    }
  }
  if (b.rank == 0 && threadIdx.x == 0) flags[0] = flags[1] = flags[2] = 0;
  cluster.sync();

  uint32_t* src = buf0;
  uint32_t* dst = buf1;
  int run = 0;
  while (run < a.cap) {
    bool changed = false;
    for (int i = threadIdx.x; i < band_words; i += kThreads) {
      const int lr = i / a.words, w = i - lr * a.words, r = b.r0 + lr;
      int up = r - 1, down = r + 1;
      if (a.wrap) {
        up = up < 0 ? a.rows - 1 : up;
        down = down == a.rows ? 0 : down;
      }
      const uint32_t* row_u = up >= 0 ? row_ptr(cluster, b, src, up, a.words) : nullptr;
      const uint32_t* row_d = down < a.rows ? row_ptr(cluster, b, src, down, a.words) : nullptr;
      const uint32_t* row_c = src + (size_t)lr * a.words;
      // the vertical OR of the three rows at word ww (0 outside the grid)
      auto column = [&](int ww) -> uint32_t {
        if (a.wrap) ww = ww < 0 ? a.words - 1 : (ww == a.words ? 0 : ww);
        else if (ww < 0 || ww >= a.words) return 0u;
        uint32_t v = row_c[ww];
        if (row_u) v |= row_u[ww];
        if (row_d) v |= row_d[ww];
        return v;
      };
      const uint32_t n = column(w), lo = column(w - 1), hi = column(w + 1);
      const uint32_t res = (n | (n << 1) | (lo >> 31) | (n >> 1) | (hi << 31)) & mask[i];
      changed |= res != row_c[w];
      dst[i] = res;
    }
    const bool any = end_sweep(cluster, flags, run, changed);
    ++run;
    uint32_t* t = src;
    src = dst;
    dst = t;
    if (!any) break;
  }
  cluster.sync();  // CTA 0's flags stay readable until every CTA has read them

  uint8_t* o = a.out + (size_t)lane * a.rows * a.cols;
  for (int i = warp; i < band_words; i += nwarps) {
    const int r = b.r0 + i / a.words, w = i % a.words;
    const int col = w * 32 + (threadIdx.x & 31);
    if (col < a.cols) o[(size_t)r * a.cols + col] = (uint8_t)((src[i] >> (threadIdx.x & 31)) & 1u);
  }
  if (b.rank == 0 && threadIdx.x == 0) count_sweeps(run, a.lanes, a.sweeps, a.launches, a.scratch);
}

struct LabelArgs {
  const uint8_t* mask;  // (lanes, rows, cols) bool
  int32_t* out;         // (lanes, rows, cols) int32
  int lanes, rows, cols, rows_per, cap;
  unsigned long long *sweeps, *launches;
  int* scratch;
};

__global__ void __launch_bounds__(kThreads) label_kernel(LabelArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  int* flags = reinterpret_cast<int*>(smem);
  const Band b = band_of(cluster, a.rows, a.rows_per);
  const int band_cells = (b.r1 - b.r0) * a.cols;
  int32_t* buf0 = reinterpret_cast<int32_t*>(smem + kFlagBytes);
  int32_t* buf1 = buf0 + (size_t)a.rows_per * a.cols;
  const int lane = blockIdx.y;
  const size_t base = ((size_t)lane * a.rows + b.r0) * a.cols;

  for (int i = threadIdx.x; i < band_cells; i += kThreads)
    buf0[i] = a.mask[base + i] ? (int32_t)(b.r0 * a.cols + i) : kBig;
  if (b.rank == 0 && threadIdx.x == 0) flags[0] = flags[1] = flags[2] = 0;
  cluster.sync();

  int32_t* src = buf0;
  int32_t* dst = buf1;
  int run = 0;
  while (run < a.cap) {
    bool changed = false;
    for (int i = threadIdx.x; i < band_cells; i += kThreads) {
      const int lr = i / a.cols, c = i - lr * a.cols, r = b.r0 + lr;
      const int32_t v = src[i];
      int32_t res = kBig;
      if (v != kBig) {
        res = v;
        for (int dr = -1; dr <= 1; ++dr) {
          const int rr = r + dr;
          if (rr < 0 || rr >= a.rows) continue;
          const int32_t* row = row_ptr(cluster, b, src, rr, a.cols);
          if (c > 0) res = min(res, row[c - 1]);
          res = min(res, row[c]);
          if (c + 1 < a.cols) res = min(res, row[c + 1]);
        }
      }
      changed |= res != v;
      dst[i] = res;
    }
    const bool any = end_sweep(cluster, flags, run, changed);
    ++run;
    int32_t* t = src;
    src = dst;
    dst = t;
    if (!any) break;
  }
  cluster.sync();

  for (int i = threadIdx.x; i < band_cells; i += kThreads) a.out[base + i] = src[i];
  if (b.rank == 0 && threadIdx.x == 0) count_sweeps(run, a.lanes, a.sweeps, a.launches, a.scratch);
}

__global__ void __launch_bounds__(kThreads) cluster_sync_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
}

// Shared memory of one CTA: the flags and `buffers` bands of rows_per rows.
long long smem_bytes(int rows_per, long long row_bytes, int buffers) {
  return kFlagBytes + (long long)rows_per * row_bytes * buffers;
}

// The dynamic shared memory each kernel was granted on each device: raised
// where a launch needs more, so that later launches (those inside a graph
// capture too) make no attribute call.
template <typename Kernel>
cudaError_t allow(Kernel kernel, int smem, int* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted[dev] = smem;
  return err;
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& args, int lanes, int smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)kCluster, (unsigned)lanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool plan_ok(int lanes, int rows, int rows_per, long long smem, long long want) {
  return lanes > 0 && rows > 0 && rows_per == (rows + kCluster - 1) / kCluster && smem == want &&
         smem <= kSmemLimit;
}

int flood_granted[kMaxDevices], label_granted[kMaxDevices];

}  // namespace

extern "C" {

// The flood of `lanes` (rows, cols) bool grids: mask, seed and out, at most
// `cap` sweeps (cap >= 0), rolling round the grid's edges with `wrap`.
// rows_per = ceil(rows / 8) rows a CTA and `smem` bytes of shared memory a
// CTA are the Python plan's figures, refused unless they equal this file's.
// sweeps, launches: the int64 accumulators; scratch: two int32 zeros.
// Returns a cudaError_t value.
int vlfm_flood(const void* mask, const void* seed, void* out, int wrap, int lanes, int rows, int cols, int cap,
               int rows_per, int smem, void* sweeps, void* launches, void* scratch, void* stream) {
  const int words = (cols + 31) / 32;
  if (cols <= 0 || cap < 0 || !plan_ok(lanes, rows, rows_per, smem, smem_bytes(rows_per, 4LL * words, 3)))
    return (int)cudaErrorInvalidValue;
  FloodArgs a{static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(seed), static_cast<uint8_t*>(out),
              lanes, rows, cols, words, rows_per, cap, wrap, static_cast<unsigned long long*>(sweeps),
              static_cast<unsigned long long*>(launches), static_cast<int*>(scratch)};
  cudaError_t err = allow(flood_kernel, smem, flood_granted);
  return (int)(err != cudaSuccess ? err : launch(flood_kernel, a, lanes, smem, stream));
}

// The labelling of `lanes` (rows, cols) bool masks into int32 labels, at
// most `cap` sweeps; the plan, accumulators and scratch as for vlfm_flood.
int vlfm_label(const void* mask, void* out, int lanes, int rows, int cols, int cap, int rows_per, int smem,
               void* sweeps, void* launches, void* scratch, void* stream) {
  if (cols <= 0 || cap < 0 || (long long)rows * cols >= (long long)kBig ||
      !plan_ok(lanes, rows, rows_per, smem, smem_bytes(rows_per, 4LL * cols, 2)))
    return (int)cudaErrorInvalidValue;
  LabelArgs a{static_cast<const uint8_t*>(mask), static_cast<int32_t*>(out), lanes, rows, cols, rows_per, cap,
              static_cast<unsigned long long*>(sweeps), static_cast<unsigned long long*>(launches),
              static_cast<int*>(scratch)};
  cudaError_t err = allow(label_kernel, smem, label_granted);
  return (int)(err != cudaSuccess ? err : launch(label_kernel, a, lanes, smem, stream));
}

// `clusters` clusters of the sweep kernels' shape that each wait on the
// cluster barrier `iters` times and do nothing else.
int vlfm_cluster_sync(int clusters, int iters, void* stream) {
  if (clusters <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  return (int)launch(cluster_sync_kernel, iters, clusters, 0, stream);
}

}  // extern "C"
