// Peak finding on confidence maps, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sleap_tpu/ops/pallas_peaks.py:
//   - global_slab_kernel, global_band_kernel <- _peak_kernel
//                            (find_global_peaks_integral_pallas)
//   - local_peaks_kernel  <- _local_peaks_kernel{,_banded,_packed}
//                            (find_local_peaks_fused_pallas)
//   - hwcs_band_kernel    <- _hwcs_kernel
//                            (find_local_peaks_fused_pallas_hwcs)
// Bound to PyTorch with ctypes from sleap_tpu_torch/ops/cuda_peaks.py, which
// also holds each kernel's plain PyTorch version and the design notes.
//
// Maps are read in place through the caller's (S, H, W, C) element strides,
// so an NHWC view of an NCHW conv output needs no transpose copy. Map m is
// (sample m / C, channel m % C). Each kernel spreads its maps over blocks as
// its section says.
//
// Order of peaks: by value descending, ties to the smallest row-major index
// (jnp.argmax's first occurrence; lax.top_k's lower index first).
//
// Arithmetic: the argmax and the top-K selection are exact comparisons, so
// values and integer locations match the plain version bit for bit. The
// integral-refinement window sums run in another order than the plain
// version's (and nvcc may contract a*b+c into an FMA), so refined xy agree
// within 1e-4 px, not bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Helpers shared by the kernels.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t bf16_bits) { return bf16_bits_to_float(bf16_bits); }

// Order-preserving bits of a float (larger float, larger unsigned), and back.
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

// Integral regression over the (2*half+1)^2 window centred on (iy, ix),
// zero outside the map (the zero-padded patch of the XLA path, the masked
// window of the TPU kernel); get(y, x) reads a map value as float32, from
// shared or device memory. Called by a whole warp; lane t takes taps t,
// t + 32, ..., whose (row, column) it steps without a division; every lane
// gets (dx, dy).
template <typename Get>
__device__ void window_offsets(Get get, int H, int W, int iy, int ix, int half, float& dx,
                               float& dy) {
  const int lane = threadIdx.x & 31;
  const int p = 2 * half + 1;
  const int q = 32 / p;
  const int r = 32 - q * p;
  int u = lane / p;
  int w = lane - u * p;
  float z = 0.f, sx = 0.f, sy = 0.f;
  for (int t = lane; t < p * p; t += 32) {
    const int y = iy + u - half;
    const int x = ix + w - half;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float v = get(y, x);
      z += v;
      sx += v * (float)(w - half);
      sy += v * (float)(u - half);
    }
    u += q;
    w += r;
    if (w >= p) {
      w -= p;
      ++u;
    }
  }
  z = warp_sum(z);
  dx = warp_sum(sx) / z;
  dy = warp_sum(sy) / z;
}

// ---------------------------------------------------------------------------
// Global peaks (kernel 1).
//
// Per (sample, channel) map: the max, its first-occurrence row-major index,
// and the integral-regression centroid of the (2*half+1)^2 window around it;
// xy is NaN where max < threshold; half < 0 gives the grid peak. Maps are
// float32 or bf16, read as they lie and compared in float32. A map holding a
// NaN has value NaN, and xy is not NaN (NaN < threshold is false). Its index
// is the first NaN's on the grid route (half < 0), as jnp.argmax takes it in
// find_global_peaks_rough; on the integral route it follows the TPU kernel
// (jnp.max propagates the NaN, and no element equals it): index H*W, so
// (ix, iy) = (0, H) with the window masked to the map.
//
// Bound by reading the maps once: on the top-down path 64 crops x 13 nodes
// of 40^2 are 5.3 MB in float32 (1.6 us at 3.35 TB/s) and 2.7 MB in bf16
// (0.8 us), against two compares per value. Two routes:
//
// - Slab route, for maps laid out as a conv head writes them: one map
//   channel-major (the NHWC view of an NCHW float32 conv output), or a
//   sample's H x W x C block channels-last (the bf16 head conv's output), so
//   that any band of rows is one contiguous span. A unit (one map, or one
//   sample's maps) goes to one block or, when the units are too few to keep
//   the SMs busy or a unit overflows shared memory, to a thread block
//   cluster of P blocks that split its rows (P = 1 for the path's 832
//   float32 maps and its 64 bf16 samples, 8 for single-instance's 4
//   samples). A block copies its rows, plus the window's half-height above
//   and below, into shared memory with one TMA bulk copy (cp.async.bulk) on
//   an mbarrier; the span's unaligned head and tail (under 16 bytes each)
//   come by plain loads. One warp per map scans the block's own rows from
//   shared memory, one lane waiting on the mbarrier for it: each lane keeps
//   its first-occurrence max by a strict compare and a NaN flag, and the
//   lanes merge by one key (order-preserving value bits, then the smallest
//   index) in two warp reductions (redux.sync). In a cluster every block
//   pushes its keys into every block's shared memory and, after one cluster
//   barrier, the block whose rows hold a map's peak merges them and reads
//   the window from its own slab: no block barrier after the copy is
//   issued, no second trip to device memory. Measured on the card: every
//   thread spinning on the mbarrier cost microseconds, four chunked copies
//   per slab lost to one, a launch with a cluster attribute of 1 cost twice
//   a plain one, and 16-byte shared-memory reads gained nothing.
// - Band route, for any other strides or a band too large for shared memory
//   (e.g. 512^2 x 13): the 8 blocks of a cluster scan bands of rows of one
//   map through its strides and push their keys into the first block's
//   shared memory (kernel 2's split cluster barrier), which merges them and
//   refines from the map in device memory.
// ---------------------------------------------------------------------------

constexpr int kGpSmemLimit = 200 * 1024;       // slab route's dynamic shared memory
constexpr int kGpMaxWarps = 32;
constexpr int kGpMaxParts = 8;                 // blocks a cluster (the portable maximum)
constexpr int kGpBandThreads = 256;
constexpr int kGpBandWarps = kGpBandThreads / 32;
constexpr uint32_t kNanKey = 0xffffffffu;      // a map holding a NaN: above every value
constexpr uint32_t kNoIdx = 0x7fffffffu;       // no value above -inf seen

// A lane's first-occurrence max over the indices it visits in increasing
// order, and its first NaN.
struct ArgMax {
  float v = -INFINITY;
  uint32_t i = kNoIdx;
  uint32_t nan_i = kNoIdx;
  __device__ __forceinline__ void add(float x, uint32_t idx) {
    if (x != x) nan_i = min(nan_i, idx);
    if (x > v) {
      v = x;
      i = idx;
    }
  }
  // The key: value bits (NaN above all, -0 as +0, which compare equal) and
  // the index to take at that value (for NaN: the first NaN's on the grid
  // route, H*W on the integral route).
  __device__ __forceinline__ void key(uint32_t n_pixels, bool grid, uint32_t& hi,
                                      uint32_t& idx) const {
    const bool nan = nan_i != kNoIdx;
    hi = nan ? kNanKey : order_bits(v + 0.f);
    idx = nan ? (grid ? nan_i : n_pixels) : i;
  }
};

// The warp's best key on every lane: the largest hi, then the smallest idx.
__device__ __forceinline__ void warp_best(uint32_t& hi, uint32_t& idx) {
  const uint32_t best = __reduce_max_sync(0xffffffffu, hi);
  idx = __reduce_min_sync(0xffffffffu, hi == best ? idx : 0xffffffffu);
  hi = best;
}

// One warp turns map m's merged key (idx already a pixel of the map, or
// H*W) into its value, xy and window offsets; get(y, x) reads the map.
template <typename Get>
__device__ void finish_peak(Get get, int H, int W, uint32_t hi, uint32_t idx, float threshold,
                            int half, int64_t m, float* __restrict__ xy,
                            float* __restrict__ vals) {
  const float val = hi == kNanKey ? NAN : from_order_bits(hi);
  const int iy = (int)(idx / (uint32_t)W);
  const int ix = (int)idx - iy * W;
  float x = (float)ix, y = (float)iy;
  if (half >= 0) {
    float dx, dy;
    window_offsets(get, H, W, iy, ix, half, dx, dy);
    x += dx;
    y += dy;
  }
  if ((threadIdx.x & 31) == 0) {
    const bool below = val < threshold;
    xy[2 * m] = below ? NAN : x;
    xy[2 * m + 1] = below ? NAN : y;
    vals[m] = val;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_done(uint32_t bar) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar) : "memory");
  return ok != 0;
}

// A copy that never lands (a fault of this code) traps, so the launch fails
// instead of hanging the card; try_wait suspends the thread between tries.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  for (uint32_t tries = 0; !mbar_done(bar); ++tries)
    if (tries == (1u << 26)) __trap();
}

// Slab route. Unit u = blockIdx.x / P is channels c0 .. c0 + G - 1 of
// sample s (channels-last: G = C, pixel p of map g at element p * C + g;
// channel-major: G = 1, at p); the cluster's block `rank` owns rows
// [rank * rows_per, + rows_per) and holds rows ya .. yb (its own and the
// window's half-height around them) in dynamic shared memory, from byte
// (address & 15) on, so the bulk copy lands 16-byte aligned. The keys follow
// at slab_bytes: hi then idx, [P][G] each.
template <typename T>
__global__ void __launch_bounds__(kGpMaxWarps * 32)
global_slab_kernel(const T* __restrict__ cms, int64_t sS, int H, int W, int C, int G, int pix,
                   int ch, int rows_per, int slab_bytes, float threshold, int half,
                   float* __restrict__ xy, float* __restrict__ vals) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // Arrive now, wait before writing to a peer's shared memory.
  if (P > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int HW = H * W;
  const int groups = (C + G - 1) / G;
  const int unit = blockIdx.x / P;
  const int s = unit / groups;
  const int c0 = (unit - s * groups) * G;
  const int gn = min(G, C - c0);
  const int h = max(half, 0);
  const int y0 = min(H, rank * rows_per);
  const int y1 = min(H, y0 + rows_per);
  const int ya = y0 < y1 ? max(0, y0 - h) : y0;
  const int yb = y0 < y1 ? min(H, y1 + h) : y0;
  const int n = yb > ya ? ((yb - ya) * W - 1) * pix + (gn - 1) * ch + 1 : 0;  // slab elements
  const T* src = cms + (int64_t)s * sS + (int64_t)c0 * ch + (int64_t)ya * W * pix;

  // One bulk copy of the slab's 16-byte aligned interior; plain loads of
  // the elements before and after it.
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + (uintptr_t)n * sizeof(T);
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15;
  const uintptr_t e16 = e & ~(uintptr_t)15;
  T* data = reinterpret_cast<T*>(smem + (a & 15));
  const uint32_t bulk = e16 > a16 ? (uint32_t)(e16 - a16) : 0u;
  const int head = bulk ? (int)((a16 - a) / sizeof(T)) : n;  // plain: [0, head)
  const int tail = bulk ? (int)((e16 - a) / sizeof(T)) : n;  // plain: [tail, n)
  if (threadIdx.x == 0 && bulk) {
    const uint32_t b = smem_addr(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bulk)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(data + head)), "l"(src + head), "r"(bulk), "r"(b)
        : "memory");
  }
  for (int j = threadIdx.x; j < head; j += blockDim.x) data[j] = src[j];
  for (int j = tail + threadIdx.x; j < n; j += blockDim.x) data[j] = src[j];
  __syncthreads();  // barrier initialised, head and tail stored
  if (P > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  uint32_t* key_hi = reinterpret_cast<uint32_t*>(smem + slab_bytes);
  uint32_t* key_idx = key_hi + P * G;
  // The own rows, as pixels from row ya.
  const int qa = (y0 - ya) * W;
  const int qb = (y1 - ya) * W;
  const uint32_t base = (uint32_t)(ya * W);  // pixel index of slab pixel 0
  for (int g = warp; g < gn; g += n_warps) {
    const T* map = data + g * ch;
    ArgMax am;
    if (bulk) {
      // One lane waits (every thread of the block spinning on the mbarrier
      // costs microseconds); the warp's lanes see the copy after it.
      if (lane == 0) mbar_wait(smem_addr(&bar));
      __syncwarp();
    }
#pragma unroll 4
    for (int q = qa + lane; q < qb; q += 32) am.add(to_f32(map[q * pix]), base + (uint32_t)q);
    uint32_t hi, idx;
    am.key((uint32_t)HW, half < 0, hi, idx);
    warp_best(hi, idx);
    auto get = [&](int y, int x) { return to_f32(map[((y - ya) * W + x) * pix]); };
    if (P == 1) {
      if (idx == kNoIdx) idx = 0;  // every value is -inf: the first one
      finish_peak(get, H, W, hi, idx, threshold, half, (int64_t)s * C + c0 + g, xy, vals);
    } else if (lane < P) {  // this block's key into block `lane`'s shared memory
      *cluster.map_shared_rank(key_hi + rank * G + g, lane) = hi;
      *cluster.map_shared_rank(key_idx + rank * G + g, lane) = idx;
    }
  }
  if (P == 1) return;
  cluster.sync();  // every block's keys are in every block's shared memory

  // The block whose rows hold map g's peak (row H - 1 for an index of H*W)
  // refines it from its slab.
  for (int g = warp; g < gn; g += n_warps) {
    uint32_t hi = lane < P ? key_hi[lane * G + g] : 0u;
    uint32_t idx = lane < P ? key_idx[lane * G + g] : 0xffffffffu;
    warp_best(hi, idx);
    if (idx == kNoIdx) idx = 0;
    if (min((int)(idx / (uint32_t)W), H - 1) / rows_per != rank) continue;
    const T* map = data + g * ch;
    auto get = [&](int y, int x) { return to_f32(map[((y - ya) * W + x) * pix]); };
    finish_peak(get, H, W, hi, idx, threshold, half, (int64_t)s * C + c0 + g, xy, vals);
  }
}

// Band route: block `part` of map m's cluster scans rows part * rows_per ..,
// one warp a row, lanes across columns.
template <typename T>
__global__ void __cluster_dims__(1, kGpMaxParts, 1) __launch_bounds__(kGpBandThreads)
global_band_kernel(const T* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC,
                   int H, int W, int C, float threshold, int half, float* __restrict__ xy,
                   float* __restrict__ vals) {
  __shared__ uint32_t warp_hi[kGpBandWarps], warp_idx[kGpBandWarps];
  __shared__ uint32_t part_hi[kGpMaxParts], part_idx[kGpMaxParts];  // the first block's
  cg::cluster_group cluster = cg::this_cluster();
  // Arrive now, wait before writing to the first block's shared memory.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x;
  const int part = blockIdx.y;  // the block's rank in its cluster
  const T* map = cms + (int64_t)(m / C) * sS + (int64_t)(m % C) * sC;
  const int rows_per = (H + kGpMaxParts - 1) / kGpMaxParts;
  const int ya = part * rows_per;
  const int yb = min(H, ya + rows_per);

  ArgMax am;
  for (int y = ya + warp; y < yb; y += kGpBandWarps) {
    const T* row = map + (int64_t)y * sH;
    for (int x = lane; x < W; x += 32) am.add(to_f32(row[(int64_t)x * sW]), (uint32_t)(y * W + x));
  }
  uint32_t hi, idx;
  am.key((uint32_t)(H * W), half < 0, hi, idx);
  warp_best(hi, idx);
  if (lane == 0) {
    warp_hi[warp] = hi;
    warp_idx[warp] = idx;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    hi = lane < kGpBandWarps ? warp_hi[lane] : 0u;
    idx = lane < kGpBandWarps ? warp_idx[lane] : 0xffffffffu;
    warp_best(hi, idx);
    if (lane == 0) {
      *cluster.map_shared_rank(part_hi + part, 0) = hi;
      *cluster.map_shared_rank(part_idx + part, 0) = idx;
    }
  }
  cluster.sync();  // every part's key is in the first block's shared memory
  if (part != 0 || warp != 0) return;
  hi = lane < kGpMaxParts ? part_hi[lane] : 0u;
  idx = lane < kGpMaxParts ? part_idx[lane] : 0xffffffffu;
  warp_best(hi, idx);
  if (idx == kNoIdx) idx = 0;  // every value is -inf: the first one
  auto get = [&](int y, int x) { return to_f32(map[(int64_t)y * sH + (int64_t)x * sW]); };
  finish_peak(get, H, W, hi, idx, threshold, half, (int64_t)m, xy, vals);
}

// The SMs of the current device, read once per process and device.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

// The slab route's plan for these maps, or G = 0 for the band route.
struct SlabPlan {
  int G = 0, pix = 0, ch = 0, P = 1, rows_per = 0, slab_bytes = 0, smem = 0;
};

template <typename T>
SlabPlan slab_plan(int64_t sH, int64_t sW, int64_t sC, int S, int H, int W, int C, int half) {
  SlabPlan plan;
  const int64_t HW = (int64_t)H * W;
  if (sW == 1 && sH == W && (C == 1 || sC == HW)) {  // channel-major: one map a unit
    plan.G = 1;
    plan.pix = 1;
    plan.ch = (int)HW;
  } else if ((C == 1 || sC == 1) && sW == C && sH == (int64_t)W * C) {  // channels-last
    plan.G = C;
    plan.pix = C;
    plan.ch = 1;
  } else {
    return plan;
  }
  // Blocks a unit: more than one only while the grid would fill under a
  // quarter of the SMs (on the card, 64 bf16 samples of 40^2 x 13 lost
  // 0.4 us split in two; 4 of 48^2 x 13 gained 0.8 us split in eight), each
  // block keeping at least two rows; more if the band with its halo
  // overflows shared memory.
  const int64_t units = (int64_t)S * ((C + plan.G - 1) / plan.G);
  const int64_t h = half > 0 ? half : 0;
  const int sms = sm_count();
  while (plan.P < kGpMaxParts && 4 * plan.P <= H && 8 * units * plan.P <= sms) plan.P *= 2;
  for (;;) {
    plan.rows_per = (H + plan.P - 1) / plan.P;
    const int64_t rows = plan.rows_per + 2 * h < H ? plan.rows_per + 2 * h : H;
    const int64_t slab = ((int64_t)plan.G * rows * W * (int64_t)sizeof(T) + 31) & ~(int64_t)15;
    const int64_t total = slab + 8 * (int64_t)plan.P * plan.G;
    if (total <= kGpSmemLimit) {
      plan.slab_bytes = (int)slab;
      plan.smem = (int)total;
      return plan;
    }
    if (plan.P == kGpMaxParts || 2 * plan.P > H) break;
    plan.P *= 2;
  }
  plan.G = 0;
  return plan;
}

template <typename T>
cudaError_t launch_global(const T* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC, int S,
                          int H, int W, int C, float threshold, int half, float* xy, float* vals,
                          cudaStream_t stream) {
  const SlabPlan plan = slab_plan<T>(sH, sW, sC, S, H, W, C, half);
  if (!plan.G) {
    global_band_kernel<T><<<dim3(S * C, kGpMaxParts), kGpBandThreads, 0, stream>>>(
        cms, sS, sH, sW, sC, H, W, C, threshold, half, xy, vals);
    return cudaGetLastError();
  }
  if (plan.smem > 48 * 1024) {
    // Once per process, device and dtype: dynamic shared memory above 48 KB.
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(global_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kGpSmemLimit);
      if (err != cudaSuccess) return err;
      raised[dev] = true;
    }
  }
  const int64_t blocks = (int64_t)S * ((C + plan.G - 1) / plan.G) * plan.P;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int threads = 32 * (plan.G < kGpMaxWarps ? plan.G : kGpMaxWarps);  // a warp a map
  if (plan.P == 1) {  // no cluster attribute: on the card it doubled the launch's cost
    global_slab_kernel<T><<<(unsigned)blocks, threads, plan.smem, stream>>>(
        cms, sS, H, W, C, plan.G, plan.pix, plan.ch, plan.rows_per, plan.slab_bytes, threshold,
        half, xy, vals);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)plan.P;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, global_slab_kernel<T>, cms, sS, H, W, C,
                                             plan.G, plan.pix, plan.ch, plan.rows_per,
                                             plan.slab_bytes, threshold, half, xy, vals);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Helpers shared by kernels 2 and 4.
// ---------------------------------------------------------------------------

// max that propagates NaN, as the plain version's comparisons do (a NaN
// neighbour makes v > neighbour false).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Insert into a list sorted descending (registers: static indices only).
template <int KMAX, typename Key>
__device__ __forceinline__ void insert_key(Key (&lk)[KMAX], Key key) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const Key cur = lk[i];
    const bool gt = key > cur;
    lk[i] = gt ? key : cur;
    key = gt ? cur : key;
  }
}

template <int KMAX, typename Key>
__device__ __forceinline__ void pop_head(Key (&lk)[KMAX], Key empty) {
#pragma unroll
  for (int i = 0; i + 1 < KMAX; ++i) lk[i] = lk[i + 1];
  lk[KMAX - 1] = empty;
}

// ---------------------------------------------------------------------------
// Local peaks on float32 maps (kernel 2).
//
// Strict 8-neighbour NMS above threshold (out-of-map neighbours count as
// -inf), the top K in the order above, optional integral offsets on the raw
// map; empty slots get vals = -inf and NaN peaks.
//
// The bytes are few (16 centroid maps of 64^2 on the top-down path are
// 0.26 MB, 0.08 us at 3.35 TB/s, below a launch's own cost), so the kernel
// is bound by latency: one block per map would give 16 blocks for 132 SMs,
// and K rounds of block argmax two barriers each. This design:
//
// - Each map is cut into kLpParts = 8 parts (bands of rows x column
//   segments; 8 bands of 8 rows for a 64^2 map, so the path's 16 maps give
//   128 blocks), and the 8 blocks of a map form one thread block cluster.
//   A part walks tiles of kLpTileRows x kLpTileCols, staging each with its
//   one-pixel halo into shared memory (-inf outside the map), every
//   thread's loads issued before any is stored; the NMS then reads shared
//   memory, not 8 strided global loads per pixel.
// - Peaks order by one 64-bit key: the value's order-preserving bits above
//   ~index, so every comparison is an integer max with the tie rule built
//   in (kernel 4's packed key, widened to float32 and any map size).
// - Each thread keeps a sorted top-KMAX of its survivors in registers
//   behind the block's cut-off (the largest last key of a full list, raised
//   by one shared atomicMax), warps merge their 32 lists by K rounds of
//   warp max, and one warp merges the 8 warp lists: no block-wide rounds.
// - The merge across parts goes through the cluster's distributed shared
//   memory: each part writes its list into the first block's shared memory,
//   and after one cluster barrier the first block merges the 8 lists (one
//   per lane) and refines the winners from the raw map, one warp per
//   winner: no workspace, ticket or memory fence.
// ---------------------------------------------------------------------------

typedef unsigned long long Key64;
constexpr Key64 kNoKey64 = 0ull;   // no real key is 0: its value bits would be a NaN
constexpr int kLpThreads = 256;
constexpr int kLpWarps = kLpThreads / 32;
constexpr int kLpTileRows = 8;
constexpr int kLpTileCols = 256;
constexpr int kLpParts = 8;        // blocks per map: one cluster (the portable maximum)
constexpr int kLpBatch = 4;        // staged pixels each thread loads before storing

// Largest key of the warp, on every lane: the largest high word, then the
// largest low word among the lanes that hold it.
__device__ __forceinline__ Key64 warp_max_key(Key64 k) {
  const uint32_t hi = (uint32_t)(k >> 32);
  const uint32_t best_hi = __reduce_max_sync(0xffffffffu, hi);
  const uint32_t lo = __reduce_max_sync(0xffffffffu, hi == best_hi ? (uint32_t)k : 0u);
  return ((Key64)best_hi << 32) | lo;
}

template <int KMAX>
__global__ void __cluster_dims__(1, kLpParts, 1) __launch_bounds__(kLpThreads)
local_peaks_kernel(const float* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW,
                   int64_t sC, int H, int W, int C, int K, float threshold, int half,
                   float* __restrict__ peaks, float* __restrict__ vals) {
  __shared__ float tile[(kLpTileRows + 2) * (kLpTileCols + 2)];
  __shared__ Key64 lists[kLpWarps][KMAX];
  __shared__ Key64 all_lists[kLpParts * KMAX];  // the first block's: every part's list
  __shared__ Key64 cut;
  cg::cluster_group cluster = cg::this_cluster();

  // This block's part: segments as wide as a tile, up to 8, then bands.
  int n_segs = 1;
  while (n_segs < kLpParts && n_segs * kLpTileCols < W) n_segs *= 2;
  const int seg_cols = (W + n_segs - 1) / n_segs;
  const int band_rows = (H + kLpParts / n_segs - 1) / (kLpParts / n_segs);
  const int part = blockIdx.y;  // the block's rank in its cluster
  const int band = part / n_segs;
  const int ya = band * band_rows;
  const int yb = min(ya + band_rows, H);
  const int xa = (part - band * n_segs) * seg_cols;
  const int xb = min(xa + seg_cols, W);
  const int m = blockIdx.x;
  const float* map = cms + (int64_t)(m / C) * sS + (int64_t)(m % C) * sC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Arrive now, wait before writing to a peer's shared memory: by then
  // every block of the cluster has started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) cut = kNoKey64;
  Key64 lk[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) lk[i] = kNoKey64;

  for (int ty = ya; ty < yb; ty += kLpTileRows) {
    const int rows = min(kLpTileRows, yb - ty);
    for (int tx = xa; tx < xb; tx += kLpTileCols) {
      const int cols = min(kLpTileCols, xb - tx);
      const int pitch = cols + 2;
      const int n_stage = (rows + 2) * pitch;
      __syncthreads();  // the previous tile is read; cut is set
      for (int base = threadIdx.x; base < n_stage; base += kLpThreads * kLpBatch) {
        float v[kLpBatch];
#pragma unroll
        for (int k = 0; k < kLpBatch; ++k) {
          const int t = base + k * kLpThreads;
          v[k] = -INFINITY;
          if (t < n_stage) {
            const int r = t / pitch;
            const int y = ty - 1 + r;
            const int x = tx - 1 + t - r * pitch;
            if (y >= 0 && y < H && x >= 0 && x < W) v[k] = __ldg(map + y * sH + x * sW);
          }
        }
#pragma unroll
        for (int k = 0; k < kLpBatch; ++k) {
          const int t = base + k * kLpThreads;
          if (t < n_stage) tile[t] = v[k];
        }
      }
      __syncthreads();

      for (int p = threadIdx.x; p < rows * cols; p += kLpThreads) {
        const int r = p / cols;
        const int x = p - r * cols;
        const float* c = tile + (r + 1) * pitch + x + 1;
        const float v = c[0];
        if (!(v > threshold)) continue;
        const float nb = max_nan(max_nan(max_nan(c[-pitch - 1], c[-pitch]),
                                         max_nan(c[-pitch + 1], c[-1])),
                                 max_nan(max_nan(c[1], c[pitch - 1]),
                                         max_nan(c[pitch], c[pitch + 1])));
        if (!(v > nb)) continue;
        // v + 0 turns -0 into +0: the plain version ties the two.
        const Key64 key = ((Key64)order_bits(v + 0.f) << 32) |
                          (uint32_t)~((ty + r) * W + tx + x);
        const Key64 c_now = cut;
        if (key > lk[KMAX - 1] && key > c_now) {
          insert_key(lk, key);
          if (lk[KMAX - 1] > c_now) atomicMax(&cut, lk[KMAX - 1]);
        }
      }
    }
  }

  // The part's top K: each warp merges its 32 thread lists, then warp 0
  // merges the warp lists straight into the first block's all_lists.
  {
    int j = 0;
    for (; j < K; ++j) {
      const Key64 best = warp_max_key(lk[0]);
      if (best == kNoKey64) break;
      if (lk[0] == best) pop_head(lk, kNoKey64);
      if (lane == 0) lists[warp][j] = best;
    }
    for (j += lane; j < K; j += 32) lists[warp][j] = kNoKey64;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    Key64* out = cluster.map_shared_rank(all_lists, 0) + part * K;
    int ptr = 0;
    int j = 0;
    for (; j < K; ++j) {
      const Key64 head = lane < kLpWarps && ptr < K ? lists[lane][ptr] : kNoKey64;
      const Key64 best = warp_max_key(head);
      if (best == kNoKey64) break;
      if (head == best) ++ptr;
      if (lane == 0) out[j] = best;
    }
    for (j += lane; j < K; j += 32) out[j] = kNoKey64;
  }
  cluster.sync();  // every part's list is in the first block's all_lists
  if (part != 0) return;

  // Merge the part lists (lane = part); the winners go to lists[0].
  if (warp == 0) {
    const Key64* mine = all_lists + lane * K;
    int ptr = 0;
    for (int j = 0; j < K; ++j) {
      const Key64 head = lane < kLpParts && ptr < K ? mine[ptr] : kNoKey64;
      const Key64 best = warp_max_key(head);
      if (lane == 0) lists[0][j] = best;
      if (best != kNoKey64 && head == best) ++ptr;
    }
  }
  __syncthreads();

  for (int j = warp; j < K; j += kLpWarps) {
    const Key64 key = lists[0][j];
    float x = NAN, y = NAN, val = -INFINITY;
    if (key != kNoKey64) {
      const int i = (int)~(uint32_t)key;
      const int iy = i / W;
      const int ix = i - iy * W;
      val = from_order_bits((uint32_t)(key >> 32));
      x = (float)ix;
      y = (float)iy;
      if (half >= 0) {
        float dx, dy;
        window_offsets([&](int yy, int xx) { return map[yy * sH + xx * sW]; }, H, W, iy, ix,
                       half, dx, dy);
        x += dx;
        y += dy;
      }
    }
    if (lane == 0) {
      const int64_t o = (int64_t)m * K + j;
      peaks[2 * o] = x;
      peaks[2 * o + 1] = y;
      vals[o] = val;
    }
  }
}

template <int KMAX>
cudaError_t launch_local(const float* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC,
                         int S, int H, int W, int C, int K, float threshold, int half,
                         float* peaks, float* vals, cudaStream_t stream) {
  local_peaks_kernel<KMAX><<<dim3(S * C, kLpParts), kLpThreads, 0, stream>>>(
      cms, sS, sH, sW, sC, H, W, C, K, threshold, half, peaks, vals);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Local peaks on bf16 maps with packed keys (kernel 4).
//
// The contract of local_peaks_kernel on the float32 values of bf16 maps
// with H*W <= 2^16, threshold > 0 and a 5x5 window, and the TPU kernel's
// int32 sort key: key = bf16_bits << 16 | (H*W - 1 - row-major index). For
// a positive value the key orders by value, then by smaller index, and
// every merge is a plain integer max; keys of one map are unique. Peaks are
// positive (threshold > 0), so out-of-map neighbours read as 0 instead of
// -inf without changing any NMS result, and the zero-padded integral window
// reads the same zeros.
//
// Bound by reading the maps once: 16 x 256^2 x 13 bf16 = 27 MB on the
// bottom-up main path, 8.1 us at 3.35 TB/s. The design streams rows, as the
// TPU kernel does with its 4-row VMEM ring, but in parallel bands:
//
// - One block owns a band of 16 rows x up to 256 columns x up to 16 channels
//   of one sample (grid: bands x column segments, samples, channel groups),
//   and streams the band's rows, plus one halo row above and below, through
//   a ring of kHwcsSlots row slots in shared memory. The halo costs
//   18 / 16 of the bytes.
// - Channels-last rows that are 16-byte aligned and contiguous (the bf16
//   head conv's output) are copied with 16-byte cp.async, kHwcsSlots - 1 rows
//   ahead of the row being read, so loads overlap the NMS. Any other layout
//   (an NCHW view, W*C*2 % 16 != 0, wide or many-channel maps) stages
//   element by element through the caller's strides, prefetched into
//   registers a step ahead; it is the same kernel, not the plain version.
// - blockDim = 32 * channels, so thread i always has channel i % nch and
//   columns i / nch + 32k: its (x, c) offsets are computed once, a warp reads
//   consecutive bf16 values, and no division is left in the row loop.
// - NMS is separable: each thread keeps, per column, the 3-max of the row
//   above and the centre and side max of the current row in registers, so a
//   pixel costs three shared-memory reads, survivors or not.
// - Survivors go into a sorted top-K of the thread's own channel in
//   registers, behind a cut-off: the larger of the list's last key and the
//   channel's shared one, which a thread raises (one shared-memory atomicMax)
//   when its list's last key rises, so noisy maps soon stop inserting. At
//   the band's end the 32 lists of a channel merge by K rounds of warp max.
// - The merge folds into the same launch: the last block of each sample to
//   finish (a ticket, reset after use) takes each channel's top K of the
//   bands' candidates, decodes value and xy from the keys and refines them
//   from the raw map, one winner per lane.
// ---------------------------------------------------------------------------

constexpr int kEmptyKey = (int)0x80000000;
constexpr int kHwcsSlots = 4;      // the row being read and 3 in flight
constexpr int kHwcsMaxCh = 16;     // channels of one block (blockDim <= 512)
constexpr int kHwcsCols = 8;       // columns per thread
constexpr int kHwcsBlockCols = kHwcsCols * 32;  // columns per block
constexpr int kHwcsRows = 16;      // rows per block (a band)
constexpr int kHwcsSmemLimit = 200 * 1024;  // below the 227 KB opt-in, less static smem

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slot layout, in bf16 elements: column lx in [-1, 256] of channel cl at
// pad + lx * nch + cl, pad = nch rounded up to 8, so column 0 of a slot is
// 16-byte aligned for cp.async and the halo columns are slot memory too.
// Columns past the block's stay zero, so every thread reads all its columns.
template <int KMAX, bool FAST>
__global__ void __launch_bounds__(kHwcsMaxCh * 32)
hwcs_band_kernel(const uint16_t* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW,
                 int64_t sC, int H, int W, int C, int K, float threshold, int refine,
                 int n_segs, int nch, int slot_elems, int smem_ints,
                 int* __restrict__ cand, unsigned* __restrict__ tickets,
                 float* __restrict__ peaks, float* __restrict__ vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  __shared__ int cut[kHwcsMaxCh];  // per channel: a key no top K needs
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cl = threadIdx.x % nch;   // this thread's channel in the group
  const int lx0 = threadIdx.x / nch;  // its first column; then every 32nd
  const int part = blockIdx.x;
  const int n_parts = gridDim.x;
  const int band = part / n_segs;
  const int seg = part - band * n_segs;
  const int s = blockIdx.y;
  const int c0 = blockIdx.z * nch;
  const bool has_c = c0 + cl < C;
  const int y0 = band * kHwcsRows;
  const int y1 = min(y0 + kHwcsRows, H);
  const int x0 = seg * kHwcsBlockCols;
  const int bw = min(kHwcsBlockCols, W - x0);
  const int pad = (nch + 7) & ~7;
  const int HW = H * W;
  const uint16_t* map = cms + (int64_t)s * sS;

  // Zero the ring once: the fast path never writes the halo columns.
  for (int i = threadIdx.x; i < kHwcsSlots * slot_elems / 2; i += blockDim.x)
    reinterpret_cast<uint32_t*>(ring)[i] = 0u;
  if (threadIdx.x < nch) cut[threadIdx.x] = kEmptyKey;
  __syncthreads();

  auto slot = [&](int r) { return ring + ((r - y0 + 1) % kHwcsSlots) * slot_elems + pad; };
  // Fast path: row r's W*C contiguous values, 16 bytes per copy.
  auto copy_row = [&](int r) {
    if (r > y1) return;
    uint16_t* dst = slot(r);
    if (r < 0 || r >= H) {  // outside the map: zeros
      for (int e = threadIdx.x; e < W * C; e += blockDim.x) dst[e] = 0;
      return;
    }
    const uint16_t* src = map + (int64_t)r * sH;
    for (int i = threadIdx.x; i < (W * C) >> 3; i += blockDim.x)
      cp_async16(dst + 8 * i, src + 8 * i);
  };
  // Strided path: this thread's columns lx0 - 1 + 32k (halo included) of
  // its channel, fetched into registers, stored after the step's NMS.
  uint16_t pre[kHwcsCols + 1];
  auto fetch_row = [&](int r) {
    const bool in_map = r >= 0 && r < H && r <= y1 && has_c;
    const uint16_t* src = map + (int64_t)(in_map ? r : 0) * sH + (int64_t)(c0 + cl) * sC;
#pragma unroll
    for (int k = 0; k <= kHwcsCols; ++k) {
      const int lx = lx0 - 1 + 32 * k;
      const int x = x0 + lx;
      pre[k] = (in_map && lx <= bw && x >= 0 && x < W) ? src[(int64_t)x * sW] : (uint16_t)0;
    }
  };
  auto store_row = [&](int r) {
    if (r > y1) return;
    uint16_t* dst = slot(r) + cl;
#pragma unroll
    for (int k = 0; k <= kHwcsCols; ++k) {
      const int lx = lx0 - 1 + 32 * k;
      if (lx <= bw) dst[lx * nch] = pre[k];
    }
  };

  // Prologue: rows y0 - 1 .. y0 + kHwcsSlots - 3 in flight.
  for (int r = y0 - 1; r <= y0 + kHwcsSlots - 3; ++r) {
    if constexpr (FAST) {
      copy_row(r);
    } else {
      fetch_row(r);
      store_row(r);
    }
    cp_async_commit();
  }

  int lk[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) lk[i] = kEmptyKey;
  // The thread's columns inside the block (none if its channel is past C):
  // lx0 + 32k < bw for k < n_cols.
  const int n_cols = has_c ? min(max((bw - lx0 + 31) / 32, 0), kHwcsCols) : 0;
  const unsigned col_mask = (1u << n_cols) - 1u;
  float hm_prev[kHwcsCols], ca[kHwcsCols], sa[kHwcsCols], cb[kHwcsCols], sb[kHwcsCols];
#pragma unroll
  for (int k = 0; k < kHwcsCols; ++k) hm_prev[k] = ca[k] = sa[k] = cb[k] = sb[k] = 0.f;

  // Step r reads row r into (c_new, s_new) and tests row r - 1, whose
  // centres and side maxima are (c_old, s_old) and whose row above has the
  // 3-max hm_prev. Rows go in pairs with the two register sets swapped, so
  // nothing is copied from one step to the next.
  auto step = [&](int r, float (&c_old)[kHwcsCols], float (&s_old)[kHwcsCols],
                  float (&c_new)[kHwcsCols], float (&s_new)[kHwcsCols]) {
    cp_async_wait<kHwcsSlots - 2>();
    __syncthreads();  // row r has landed; row r - 1's slot is free
    const int ahead = r + kHwcsSlots - 1;
    if constexpr (FAST)
      copy_row(ahead);
    else
      fetch_row(ahead);
    cp_async_commit();

    // Loads for all columns first (slots span 256 columns, so they are in
    // bounds; columns past the block's read zeros), then a branch-free
    // survivor mask, then inserts only where a bit is set.
    const uint16_t* row = slot(r) + cl + lx0 * nch;
    const int stride = 32 * nch;
#pragma unroll
    for (int k = 0; k < kHwcsCols; ++k) {
      const uint16_t* q = row + k * stride;
      c_new[k] = bf16_bits_to_float(q[0]);
      s_new[k] = max_nan(bf16_bits_to_float(q[-nch]), bf16_bits_to_float(q[nch]));
    }
    // The cut-off: the larger of this list's last key and the channel's
    // shared one (the largest last key of its threads: the block holds K
    // keys above it, so a survivor below it is never in the top K). Its
    // value part joins the mask, so full lists stop taking the branch.
    const int cut_c = cut[cl];
    const int floor_key = max(lk[KMAX - 1], cut_c);
    const float floor_v =
        floor_key == kEmptyKey ? -INFINITY : __int_as_float(floor_key & (int)0xffff0000);
    unsigned mask = 0u;
#pragma unroll
    for (int k = 0; k < kHwcsCols; ++k) {
      const float v = c_old[k];
      const bool peak = v > threshold && v >= floor_v && v > s_old[k] && v > hm_prev[k] &&
                        v > max_nan(c_new[k], s_new[k]);
      mask |= (unsigned)peak << k;
    }
    mask &= r > y0 ? col_mask : 0u;
    if (mask) {
      const int lin0 = (r - 1) * W + x0 + lx0;
#pragma unroll
      for (int k = 0; k < kHwcsCols; ++k) {
        if (mask >> k & 1u) {
          const int key = (int)((__float_as_uint(c_old[k]) & 0xffff0000u) |
                                (uint32_t)(HW - 1 - (lin0 + 32 * k)));
          if (key > lk[KMAX - 1] && key > cut_c) {
            insert_key(lk, key);
            if (lk[KMAX - 1] > cut_c) atomicMax(cut + cl, lk[KMAX - 1]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kHwcsCols; ++k) hm_prev[k] = max_nan(c_old[k], s_old[k]);
    if constexpr (!FAST) store_row(ahead);
  };
  for (int r = y0 - 1; r <= y1; r += 2) {
    step(r, ca, sa, cb, sb);
    if (r + 1 <= y1) step(r + 1, cb, sb, ca, sa);
  }

  // The band's top K of each channel: 32 thread lists, K rounds of warp max.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int* lists = reinterpret_cast<int*>(smem);
  {
    int* mine = lists + (cl * 32 + lx0) * K;
#pragma unroll
    for (int t = 0; t < KMAX; ++t)
      if (t < K) mine[t] = lk[t];
  }
  __syncthreads();
  if (c0 + warp < C && warp < nch) {
    const int* theirs = lists + (warp * 32 + lane) * K;
    int hk[KMAX];
#pragma unroll
    for (int t = 0; t < KMAX; ++t) hk[t] = t < K ? theirs[t] : kEmptyKey;
    int* out = cand + (((int64_t)s * C + c0 + warp) * n_parts + part) * K;
    for (int j = 0; j < K; ++j) {
      const int best = __reduce_max_sync(0xffffffffu, hk[0]);
      if (best != kEmptyKey && hk[0] == best) pop_head(hk, kEmptyKey);
      if (lane == 0) out[j] = best;
    }
  }

  // The last block of sample s merges every channel's candidates.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + s, 1u) == (unsigned)(gridDim.x * gridDim.z) - 1u;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const int n = n_parts * K;
  const int slice = smem_ints / (blockDim.x >> 5);
  int* stage = reinterpret_cast<int*>(smem) + warp * slice;
  const bool staged = n <= slice;
  for (int cc = warp; cc < C; cc += blockDim.x >> 5) {
    const int* list = cand + ((int64_t)s * C + cc) * n;
    if (staged) {
      for (int t = lane; t < n; t += 32) stage[t] = __ldcg(list + t);
      __syncwarp();
    }
    int win0 = kEmptyKey, win1 = kEmptyKey;
    int last = 0x7fffffff;
    for (int j = 0; j < K; ++j) {
      int best = kEmptyKey;
      if (last != kEmptyKey) {
        for (int t = lane; t < n; t += 32) {
          const int k = staged ? stage[t] : __ldcg(list + t);
          if (k < last && k > best) best = k;
        }
      }
      best = __reduce_max_sync(0xffffffffu, best);
      if (lane == (j & 31)) {
        if (j < 32)
          win0 = best;
        else
          win1 = best;
      }
      last = best;
    }
    __syncwarp();  // the slice is restaged for the next channel

    // Lane j decodes winner j (and j + 32), refined from the raw map.
    const uint16_t* m = map + (int64_t)cc * sC;
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j >= K) break;
      const int key = h ? win1 : win0;
      float x = NAN, y = NAN, val = -INFINITY;
      if (key != kEmptyKey) {
        const int lin = HW - 1 - (key & 0xffff);
        const int iy = lin / W;
        const int ix = lin - iy * W;
        val = __int_as_float(key & (int)0xffff0000);
        x = (float)ix;
        y = (float)iy;
        if (refine) {
          float z = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
          for (int u = -2; u <= 2; ++u) {
#pragma unroll
            for (int w = -2; w <= 2; ++w) {
              const int yy = iy + u;
              const int xx = ix + w;
              if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
                const float v = bf16_bits_to_float(m[(int64_t)yy * sH + (int64_t)xx * sW]);
                z += v;
                sx += v * (float)w;
                sy += v * (float)u;
              }
            }
          }
          x += sx / z;
          y += sy / z;
        }
      }
      const int64_t o = ((int64_t)s * C + cc) * K + j;
      vals[o] = val;
      peaks[2 * o] = x;
      peaks[2 * o + 1] = y;
    }
  }
  if (threadIdx.x == 0) tickets[s] = 0u;  // ready for the next launch
}

template <int KMAX, bool FAST>
cudaError_t launch_hwcs_path(const uint16_t* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC,
                             int S, int H, int W, int C, int K, float threshold, int refine,
                             int* cand, unsigned* tickets, float* peaks, float* vals,
                             cudaStream_t stream) {
  const int nch = C < kHwcsMaxCh ? C : kHwcsMaxCh;
  const int n_groups = (C + nch - 1) / nch;
  const int n_segs = (W + kHwcsBlockCols - 1) / kHwcsBlockCols;
  const int n_bands = (H + kHwcsRows - 1) / kHwcsRows;
  const int pad = (nch + 7) & ~7;
  const int slot_elems = (pad + (kHwcsCols * 32 + 1) * nch + 7) & ~7;
  const int ring_bytes = kHwcsSlots * slot_elems * 2;
  const int list_bytes = nch * 32 * K * 4;
  const int smem = ring_bytes > list_bytes ? ring_bytes : list_bytes;
  if (smem > kHwcsSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // Once per process and device: dynamic shared memory above 48 KB.
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(hwcs_band_kernel<KMAX, FAST>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kHwcsSmemLimit);
      if (err != cudaSuccess) return err;
      raised[dev] = true;
    }
  }
  hwcs_band_kernel<KMAX, FAST><<<dim3(n_bands * n_segs, S, n_groups), nch * 32, smem, stream>>>(
      cms, sS, sH, sW, sC, H, W, C, K, threshold, refine, n_segs, nch, slot_elems, smem / 4,
      cand, tickets, peaks, vals);
  return cudaGetLastError();
}

// Rows take the 16-byte copy path when one block spans the width and all
// channels, and each row is W * C contiguous bf16 values on a 16-byte
// boundary (mirrored by ``hwcs_fast_rows`` in ops/cuda_peaks.py for tests).
bool hwcs_fast_rows(const uint16_t* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC, int W,
                    int C) {
  return sC == 1 && sW == C && C <= kHwcsMaxCh && W <= kHwcsBlockCols && (W * C) % 8 == 0 &&
         sH % 8 == 0 && sS % 8 == 0 && ((uintptr_t)cms & 15) == 0;
}

template <int KMAX>
cudaError_t launch_hwcs(const uint16_t* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC,
                        int S, int H, int W, int C, int K, float threshold, int refine,
                        int* cand, unsigned* tickets, float* peaks, float* vals,
                        cudaStream_t stream) {
  if (hwcs_fast_rows(cms, sS, sH, sW, sC, W, C))
    return launch_hwcs_path<KMAX, true>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, refine,
                                        cand, tickets, peaks, vals, stream);
  return launch_hwcs_path<KMAX, false>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, refine,
                                       cand, tickets, peaks, vals, stream);
}

}  // namespace

// C entry points: launch on the caller's stream, allocate nothing, return the
// launch's cudaGetLastError() (0 on success). Strides are in elements.

// Kernel 1's plan for these maps, without a launch: the blocks a map or
// sample takes on the slab route, or 0 for the band route.
extern "C" int sleap_global_plan(int64_t sH, int64_t sW, int64_t sC, int S, int H, int W, int C,
                                 int bf16, int half) {
  const SlabPlan plan = bf16 ? slab_plan<uint16_t>(sH, sW, sC, S, H, W, C, half)
                             : slab_plan<float>(sH, sW, sC, S, H, W, C, half);
  return plan.G ? plan.P : 0;
}

// Kernel 1. cms holds bf16 bit patterns if bf16 != 0, else float32 values.
extern "C" int sleap_global_peaks(const void* cms, int64_t sS, int64_t sH, int64_t sW,
                                  int64_t sC, int S, int H, int W, int C, int bf16,
                                  float threshold, int half, float* xy, float* vals,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || H < 1 || W < 1 || C < 1 || (int64_t)H * W >= (int64_t)kNoIdx ||
      (int64_t)S * C > 0x7fffffff || half > 4096)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch_global(static_cast<const uint16_t*>(cms), sS, sH, sW, sC, S, H, W, C,
                              threshold, half, xy, vals, st);
  return (int)launch_global(static_cast<const float*>(cms), sS, sH, sW, sC, S, H, W, C, threshold,
                            half, xy, vals, st);
}

extern "C" int sleap_local_peaks(const float* cms, int64_t sS, int64_t sH, int64_t sW,
                                 int64_t sC, int S, int H, int W, int C, int K,
                                 float threshold, int half, float* peaks, float* vals,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H < 1 || W < 1 || K < 1 || K > 64 || (int64_t)S * C > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (K <= 4) return (int)launch_local<4>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 8) return (int)launch_local<8>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 16) return (int)launch_local<16>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 32) return (int)launch_local<32>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  return (int)launch_local<64>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
}

// Kernel 4. cms holds bf16 bit patterns. The caller passes a workspace:
// cand holds S * C * ceil(H/16) * ceil(W/256) * K keys, tickets S zeros (the
// kernel leaves them zero). K is rounded up to a list length of 8, 16 or 64.
extern "C" int sleap_local_peaks_hwcs(const uint16_t* cms, int64_t sS, int64_t sH, int64_t sW,
                                      int64_t sC, int S, int H, int W, int C, int K,
                                      float threshold, int refine, int* cand, unsigned* tickets,
                                      float* peaks, float* vals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)H * W > 65536 || K < 1 || K > 64 || S > 65535 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)launch_hwcs<8>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, refine, cand, tickets, peaks, vals, st);
  if (K <= 16) return (int)launch_hwcs<16>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, refine, cand, tickets, peaks, vals, st);
  return (int)launch_hwcs<64>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, refine, cand, tickets, peaks, vals, st);
}
