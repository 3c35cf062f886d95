// Peak finding on confidence maps, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sleap_tpu/ops/pallas_peaks.py:
//   - global_peaks_kernel <- _peak_kernel (find_global_peaks_integral_pallas)
//   - local_peaks_kernel  <- _local_peaks_kernel{,_banded,_packed}
//                            (find_local_peaks_fused_pallas)
//   - hwcs_tile_kernel + hwcs_merge_kernel <- _hwcs_kernel
//                            (find_local_peaks_fused_pallas_hwcs)
// Bound to PyTorch with ctypes from sleap_tpu_torch/ops/cuda_peaks.py, which
// also holds each kernel's plain PyTorch version and the design notes.
//
// Maps are read in place through the caller's (S, H, W, C) element strides,
// so an NHWC view of an NCHW conv output needs no transpose copy. Map m is
// (sample m / C, channel m % C). One thread block owns one map.
//
// Order of peaks: by value descending, ties to the smallest row-major index
// (jnp.argmax's first occurrence; lax.top_k's lower index first).
//
// Arithmetic: the argmax and the top-K selection are exact comparisons, so
// values and integer locations match the plain version bit for bit. The
// integral-refinement window sums run in another order than the plain
// version's (and nvcc may contract a*b+c into an FMA), so refined xy agree
// within 1e-4 px, not bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// One block per map: strict 8-neighbour NMS above threshold (out-of-map
// neighbours count as -inf), top-K in the order above, optional integral
// offsets on the raw map. Each thread keeps its own sorted top-K of the
// pixels it visits (ascending index, so an equal value never displaces an
// earlier one); K rounds of block argmax over the list heads merge them.
// Empty slots get vals = -inf and NaN peaks.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
local_peaks_kernel(const float* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW,
                   int64_t sC, int H, int W, int C, int K, float threshold, int half,
                   float* __restrict__ peaks, float* __restrict__ vals) {
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ float win_v[KMAX];
  __shared__ int win_i[KMAX];
  const int m = blockIdx.x;
  const float* map = cms + (int64_t)(m / C) * sS + (int64_t)(m % C) * sC;
  const int n = H * W;

  float lv[KMAX];
  int li[KMAX];
  int cnt = 0;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    const int y = l / W;
    const int x = l - y * W;
    const float v = map[y * sH + x * sW];
    if (!(v > threshold)) continue;
    if (cnt == K && !(v > lv[K - 1])) continue;
    bool peak = true;
    for (int dy = -1; dy <= 1 && peak; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if ((dy == 0 && dx == 0) || xx < 0 || xx >= W) continue;
        if (!(v > map[yy * sH + xx * sW])) {
          peak = false;
          break;
        }
      }
    }
    if (!peak) continue;
    int p = cnt < K ? cnt : K - 1;
    while (p > 0 && lv[p - 1] < v) {
      lv[p] = lv[p - 1];
      li[p] = li[p - 1];
      --p;
    }
    lv[p] = v;
    li[p] = l;
    if (cnt < K) ++cnt;
  }

  int head = 0;
  for (int j = 0; j < K; ++j) {
    float hv = head < cnt ? lv[head] : -INFINITY;
    int hi = head < cnt ? li[head] : kNoIndex;
    block_argmax(hv, hi, sv, si);
    if (head < cnt && li[head] == hi) ++head;
    if (threadIdx.x == 0) {
      win_v[j] = hi == kNoIndex ? -INFINITY : hv;
      win_i[j] = hi;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < K; j += blockDim.x >> 5) {
    const int i = win_i[j];
    float x = NAN, y = NAN;
    if (i != kNoIndex) {
      const int iy = i / W;
      const int ix = i - iy * W;
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
      peaks[2 * ((int64_t)m * K + j)] = x;
      peaks[2 * ((int64_t)m * K + j) + 1] = y;
      vals[(int64_t)m * K + j] = win_v[j];
    }
  }
}

template <int KMAX>
cudaError_t launch_local(const float* cms, int64_t sS, int64_t sH, int64_t sW, int64_t sC,
                         int S, int H, int W, int C, int K, float threshold, int half,
                         float* peaks, float* vals, cudaStream_t stream) {
  local_peaks_kernel<KMAX><<<S * C, kThreads, 0, stream>>>(
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
// Pass 1, hwcs_tile_kernel: one block per (tile of BH x BW pixels, sample)
// stages the tile, all C channels, plus a 2-pixel halo into shared memory
// (bf16, zero outside the map; reads go through the caller's strides, so
// threads walk the (x, c) axis that is contiguous in channels-last memory),
// appends each NMS survivor's key to its channel's list, then one warp per
// channel takes the list's top K by K rounds of warp max and refines each
// winner from the staged window. Survivors are never 8-adjacent, so a list
// holds at most ceil(BH/2) * ceil(BW/2) keys. Output: K (key, dx, dy) per
// (sample, channel, tile), empty slots kEmptyKey.
// Pass 2, hwcs_merge_kernel: one warp per (sample, channel) takes the top K
// of its tiles' candidates and decodes value, x and y from the keys.
//
// Bound by reading the maps once (16 x 256^2 x 13 bf16 = 27 MB on the
// bottom-up main path, ~8 us at 3.35 TB/s); the halo rows add (BH+4)/BH of
// that. Nothing carries over between blocks, unlike the TPU kernel's
// sequential row stream with its top-K kept across grid steps.
// ---------------------------------------------------------------------------

constexpr int kHwcsHalo = 2;
constexpr int kEmptyKey = (int)0x80000000;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

// Largest key in the warp (and its index); every lane gets the result.
// Keys of one map are unique, so the index of a non-empty key is too.
__device__ __forceinline__ void warp_max_key(int& key, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ok > key || (ok == key && oi < idx)) {
      key = ok;
      idx = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hwcs_tile_kernel(const uint16_t* __restrict__ cms, int64_t sS, int64_t sH, int64_t sW,
                 int64_t sC, int H, int W, int C, int K, float threshold, int refine,
                 int BH, int BW, int n_wseg, int cap, int* __restrict__ cand_keys,
                 float* __restrict__ cand_dx, float* __restrict__ cand_dy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TH = BH + 2 * kHwcsHalo;
  const int TW = BW + 2 * kHwcsHalo;
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  const size_t tile_bytes = ((size_t)TH * TW * C * sizeof(uint16_t) + 15) & ~(size_t)15;
  int* count = reinterpret_cast<int*>(smem + tile_bytes);
  int* lists = count + C;

  const int t_id = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int s = blockIdx.y;
  const int r0 = (t_id / n_wseg) * BH;
  const int c0 = (t_id % n_wseg) * BW;
  const uint16_t* map = cms + (int64_t)s * sS;

  for (int c = threadIdx.x; c < C; c += blockDim.x) count[c] = 0;
  const int row_elems = TW * C;
  for (int i = threadIdx.x; i < TH * row_elems; i += blockDim.x) {
    const int ty = i / row_elems;
    const int rem = i - ty * row_elems;
    const int tx = rem / C;
    const int c = rem - tx * C;
    const int y = r0 - kHwcsHalo + ty;
    const int x = c0 - kHwcsHalo + tx;
    uint16_t v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) v = map[y * sH + x * sW + c * sC];
    tile[i] = v;
  }
  __syncthreads();

  const int HW = H * W;
  const int inner = BW * C;
  for (int i = threadIdx.x; i < BH * inner; i += blockDim.x) {
    const int ly = i / inner;
    const int rem = i - ly * inner;
    const int lx = rem / C;
    const int c = rem - lx * C;
    const int y = r0 + ly;
    const int x = c0 + lx;
    if (y >= H || x >= W) continue;
    const int t = ((ly + kHwcsHalo) * TW + lx + kHwcsHalo) * C + c;
    const uint16_t bits = tile[t];
    const float v = bf16_bits_to_float(bits);
    if (!(v > threshold)) continue;
    bool peak = true;
    for (int dy = -1; dy <= 1 && peak; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        if (!(v > bf16_bits_to_float(tile[t + (dy * TW + dx) * C]))) {
          peak = false;
          break;
        }
      }
    }
    if (!peak) continue;
    const int key = (int)(((uint32_t)bits << 16) | (uint32_t)(HW - 1 - (y * W + x)));
    lists[c * cap + atomicAdd(&count[c], 1)] = key;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = warp; c < C; c += blockDim.x >> 5) {
    const int n = count[c];
    const int* list = lists + c * cap;
    const int64_t base = (((int64_t)s * C + c) * n_tiles + t_id) * K;
    int last = 0x7fffffff;
    for (int j = 0; j < K; ++j) {
      int best = kEmptyKey, unused = 0;
      if (last != kEmptyKey) {
        for (int t = lane; t < n; t += 32) {
          const int k = list[t];
          if (k < last && k > best) best = k;
        }
      }
      warp_max_key(best, unused);
      float dx = 0.f, dy = 0.f;
      if (refine && best != kEmptyKey) {
        const int lin = HW - 1 - (best & 0xffff);
        const int ly = lin / W - r0 + kHwcsHalo;
        const int lx = lin % W - c0 + kHwcsHalo;
        float z = 0.f, sx = 0.f, sy = 0.f;
        if (lane < 25) {
          const int u = lane / 5 - 2;
          const int w = lane % 5 - 2;
          const float v = bf16_bits_to_float(tile[((ly + u) * TW + lx + w) * C + c]);
          z = v;
          sx = v * (float)w;
          sy = v * (float)u;
        }
        z = warp_sum(z);
        dx = warp_sum(sx) / z;
        dy = warp_sum(sy) / z;
      }
      if (lane == 0) {
        cand_keys[base + j] = best;
        cand_dx[base + j] = dx;
        cand_dy[base + j] = dy;
      }
      last = best;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hwcs_merge_kernel(const int* __restrict__ cand_keys, const float* __restrict__ cand_dx,
                  const float* __restrict__ cand_dy, int n_maps, int n_cand, int H, int W,
                  int K, float* __restrict__ peaks, float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= n_maps) return;  // whole warps only
  const int* keys = cand_keys + (int64_t)m * n_cand;
  const int HW = H * W;
  int last = 0x7fffffff;
  for (int j = 0; j < K; ++j) {
    int best = kEmptyKey, bi = 0;
    if (last != kEmptyKey) {
      for (int t = lane; t < n_cand; t += 32) {
        const int k = keys[t];
        if (k < last && k > best) {
          best = k;
          bi = t;
        }
      }
    }
    warp_max_key(best, bi);
    if (lane == 0) {
      const int64_t o = (int64_t)m * K + j;
      if (best == kEmptyKey) {
        vals[o] = -INFINITY;
        peaks[2 * o] = NAN;
        peaks[2 * o + 1] = NAN;
      } else {
        const int lin = HW - 1 - (best & 0xffff);
        const int64_t c = (int64_t)m * n_cand + bi;
        vals[o] = __int_as_float(best & (int)0xffff0000);
        peaks[2 * o] = (float)(lin % W) + cand_dx[c];
        peaks[2 * o + 1] = (float)(lin / W) + cand_dy[c];
      }
    }
    last = best;
  }
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
  if (K <= 4) return (int)launch_local<4>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 8) return (int)launch_local<8>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 16) return (int)launch_local<16>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 32) return (int)launch_local<32>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  if (K <= 64) return (int)launch_local<64>(cms, sS, sH, sW, sC, S, H, W, C, K, threshold, half, peaks, vals, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4. cms holds bf16 bit patterns; (BH, BW) is the tile the caller
// sized the candidate buffers for: ceil(H/BH) * ceil(W/BW) tiles, each
// giving K (key, dx, dy) per (sample, channel).
extern "C" int sleap_local_peaks_hwcs(const uint16_t* cms, int64_t sS, int64_t sH, int64_t sW,
                                      int64_t sC, int S, int H, int W, int C, int K,
                                      float threshold, int refine, int BH, int BW,
                                      int* cand_keys, float* cand_dx, float* cand_dy,
                                      float* peaks, float* vals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)H * W > 65536 || K < 1 || K > 64 || BH < 1 || BW < 1 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_wseg = (W + BW - 1) / BW;
  const int n_tiles = ((H + BH - 1) / BH) * n_wseg;
  const int cap = ((BH + 1) / 2) * ((BW + 1) / 2);
  const size_t tile_bytes =
      ((size_t)(BH + 2 * kHwcsHalo) * (BW + 2 * kHwcsHalo) * C * sizeof(uint16_t) + 15) &
      ~(size_t)15;
  const size_t smem = tile_bytes + (size_t)C * (1 + cap) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hwcs_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hwcs_tile_kernel<<<dim3(n_tiles, S), kThreads, smem, st>>>(
      cms, sS, sH, sW, sC, H, W, C, K, threshold, refine, BH, BW, n_wseg, cap, cand_keys,
      cand_dx, cand_dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = kThreads / 32;
  hwcs_merge_kernel<<<(S * C + warps - 1) / warps, kThreads, 0, st>>>(
      cand_keys, cand_dx, cand_dy, S * C, n_tiles * K, H, W, K, peaks, vals);
  return (int)cudaGetLastError();
}
