// Peak finding on confidence maps, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sleap_tpu/ops/pallas_peaks.py:
//   - global_peaks_kernel <- _peak_kernel (find_global_peaks_integral_pallas)
//   - local_peaks_kernel  <- _local_peaks_kernel{,_banded,_packed}
//                            (find_local_peaks_fused_pallas)
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
