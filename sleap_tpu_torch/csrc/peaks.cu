// Peak finding on confidence maps, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sleap_tpu/ops/pallas_peaks.py:
//   - global_peaks_kernel <- _peak_kernel (find_global_peaks_integral_pallas)
//   - local_peaks_kernel  <- _local_peaks_kernel{,_banded,_packed}
//                            (find_local_peaks_fused_pallas)
//   - hwcs_band_kernel    <- _hwcs_kernel
//                            (find_local_peaks_fused_pallas_hwcs)
// Bound to PyTorch with ctypes from sleap_tpu_torch/ops/cuda_peaks.py, which
// also holds each kernel's plain PyTorch version and the design notes.
//
// Maps are read in place through the caller's (S, H, W, C) element strides,
// so an NHWC view of an NCHW conv output needs no transpose copy. Map m is
// (sample m / C, channel m % C). In kernel 1 one thread block owns one map;
// kernels 2 and 4 spread each map over blocks (see their sections).
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

constexpr int kThreads = 256;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide (max value, min index at max); every thread gets the result.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? sv[lane] : -INFINITY;
    i = lane < nwarps ? si[lane] : kNoIndex;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();  // sv/si are reused by the next call
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Integral regression over the (2*half+1)^2 window centred on (iy, ix),
// zero outside the map (the zero-padded patch of the XLA path). Called by a
// whole warp; every lane gets (dx, dy).
__device__ void window_offsets(const float* map, int64_t sH, int64_t sW, int H, int W,
                               int iy, int ix, int half, float& dx, float& dy) {
  const int lane = threadIdx.x & 31;
  const int p = 2 * half + 1;
  float z = 0.f, sx = 0.f, sy = 0.f;
  for (int t = lane; t < p * p; t += 32) {
    const int u = t / p - half;
    const int w = t % p - half;
    const int y = iy + u;
    const int x = ix + w;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float v = map[y * sH + x * sW];
      z += v;
      sx += v * (float)w;
      sy += v * (float)u;
    }
  }
  z = warp_sum(z);
  dx = warp_sum(sx) / z;
  dy = warp_sum(sy) / z;
}

// One block per map: argmax (first occurrence), optional integral offsets.
// half < 0 gives the unrefined grid peak. xy is NaN where max < threshold.
__global__ void __launch_bounds__(kThreads)
global_peaks_kernel(const float* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW,
                    int64_t sC, int H, int W, int C, float threshold, int half,
                    float* __restrict__ xy, float* __restrict__ vals) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int m = blockIdx.x;
  const float* map = cms + (int64_t)(m / C) * sS + (int64_t)(m % C) * sC;
  const int n = H * W;

  float bv = -INFINITY;
  int bi = kNoIndex;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    const int y = l / W;
    const int x = l - y * W;
    const float v = map[y * sH + x * sW];
    if (better(v, l, bv, bi)) {
      bv = v;
      bi = l;
    }
  }
  block_argmax(bv, bi, sv, si);

  if (threadIdx.x < 32) {
    const int iy = bi / W;
    const int ix = bi - iy * W;
    float x = (float)ix, y = (float)iy;
    if (half >= 0) {
      float dx, dy;
      window_offsets(map, sH, sW, H, W, iy, ix, half, dx, dy);
      x += dx;
      y += dy;
    }
    if (threadIdx.x == 0) {
      const bool below = bv < threshold;
      xy[2 * m] = below ? NAN : x;
      xy[2 * m + 1] = below ? NAN : y;
      vals[m] = bv;
    }
  }
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

// Order-preserving bits of a float (larger float, larger unsigned), and back.
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

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
        window_offsets(map, sH, sW, H, W, iy, ix, half, dx, dy);
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

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

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
extern "C" int sleap_global_peaks(const float* cms, int64_t sS, int64_t sH, int64_t sW,
                                  int64_t sC, int S, int H, int W, int C, float threshold,
                                  int half, float* xy, float* vals, void* stream) {
  global_peaks_kernel<<<S * C, kThreads, 0, (cudaStream_t)stream>>>(
      cms, sS, sH, sW, sC, H, W, C, threshold, half, xy, vals);
  return (int)cudaGetLastError();
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
