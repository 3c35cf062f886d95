// Unit-spaced bilinear crops, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _crop_kernel of
// sleap_tpu/ops/pallas_crops.py (crop_bboxes_unit_pallas). Bound to PyTorch
// with ctypes from sleap_tpu_torch/ops/cuda_crops.py, which also holds the
// plain PyTorch version.
//
// For box i, output (r, c, ch) blends the four pixels around
// (y0 + r + fy, x0 + c + fx), where (x0, y0) = floor(top_left[i]) and
// (fx, fy) its fractional part, in frame box_indices[i]. Taps outside the
// image (or a box index outside the batch) read 0, as TF's
// crop_and_resize extrapolation_value=0.
//
// The blend is written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot
// contract it into FMAs: each product and sum rounds once, in the order of
// the plain version (top = v00*(1-fx) + v01*fx, bot likewise,
// out = top*(1-fy) + bot*fy). Kernel and plain version then agree bitwise,
// and truncating the crops back to uint8 cannot move a pixel by 1.
//
// Bound by the float32 it writes: 64 crops of 160^2 on the top-down path are
// 6.55 MB, 2 us at 3.35 TB/s, against 7 FLOPs per output. Index math per
// output must stay 32-bit and division-free: a 64-bit division is a call to
// a subroutine of dozens of instructions, and three of them per output made
// one thread per output with int64 indices slower than F.grid_sample. This
// design:
//
// - One block owns one box, a band of up to kBandRows output rows and a
//   segment of up to kSegElems flat (column, channel) elements of each row.
//   It reads its box's (x0, y0, fx, fy, b) once and forms the frame's base
//   pointer in 64 bits once; all per-element index math is 32-bit (the
//   wrapper raises where a crop batch or a frame would overflow it).
// - The block stages the band's (rows + 1) x (segment + C) source window in
//   shared memory as float32, zero outside the image, so the blend has no
//   branches. Rows that are contiguous channels-last load 4 elements per
//   thread (4 bytes of uint8, 16 of float32); other rows load element by
//   element through the strides. Every thread issues its loads for up to
//   kStageBatch window units before it stores any, so a block waits for
//   memory about once.
// - The blend works on flat channels-last rows: output element j of row r
//   blends window elements j and j + C of rows r and r + 1, so any C takes
//   the same code. Each thread makes 4 consecutive outputs from 16-byte
//   shared-memory reads (32-bit reads at a 4-float thread stride would
//   conflict 4 ways in the banks): the word at j and the two aligned words
//   from j + (C & ~3), out of which the taps j + C .. j + C + 3 are picked by
//   C & 3, the same for every thread. It writes them with one 16-byte store
//   where the row allows it. The loop over a thread's quads is unrolled 4
//   times, so their shared-memory reads overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBandRows = 16;     // output rows per block, at most
constexpr int kSegElems = 512;    // flat output elements of a row per block, at most
constexpr int kStageBatch = 8;    // window units each thread loads before storing
constexpr int kSmemLimit = 48 * 1024;  // static launch limit, no opt-in

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Window row stride in floats: the segment, then room for the two 16-byte
// words from j + (C & ~3) of a thread's last quad.
__host__ __device__ constexpr int window_stride(int seg, int C) {
  return round4(seg) + (C & ~3) + 4;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The four taps j + C .. j + C + 3 of a window row, from its 16-byte words at
// j + (C & ~3) and 4 further; shift = C & 3.
__device__ __forceinline__ void taps_c(const float* p, int shift, float (&a)[4]) {
  const float4 w0 = lds4(p);
  const float4 w1 = lds4(p + 4);
  const float v[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = shift == 0 ? v[k] : shift == 1 ? v[k + 1] : shift == 2 ? v[k + 2] : v[k + 3];
}

// Four consecutive elements of T as one load: 4 bytes of uint8, 16 of float.
template <typename T>
struct Quad;

template <>
struct Quad<uint8_t> {
  typedef uint32_t V;
  static __device__ __forceinline__ V zero() { return 0u; }
  static __device__ __forceinline__ float get(V v, int b) {
    return (float)((v >> (8 * b)) & 0xffu);
  }
};

template <>
struct Quad<float> {
  typedef float4 V;
  static __device__ __forceinline__ V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float get(V v, int b) {
    return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
  }
};

// Stage the band's source window: window row wr is source row y0 + wr and
// holds flat elements g0 + q, q < ew (flat = column * C + channel).
template <typename T>
__device__ __forceinline__ void stage(float* win, int stride, const T* frame, bool box_ok,
                                      int y0, int g0, int x0, int n_rows, int ew, int H, int W,
                                      int C, int sH, int sW, int sC, bool quads) {
  const int flat_w = W * C;
  if (quads) {
    // Rows of W * C contiguous elements on a 4-element boundary, W * C % 4
    // == 0: quad w holds flat elements 4w .. 4w + 3 of the row, all inside
    // the row or all outside it.
    typedef typename Quad<T>::V V;
    const int w_lo = g0 >> 2;  // floor, also for negative g0
    const int n_quads = ((g0 + ew - 1) >> 2) - w_lo + 1;
    const int total = n_rows * n_quads;
    for (int base = threadIdx.x; base < total; base += kThreads * kStageBatch) {
      V v[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int t = base + k * kThreads;
        v[k] = Quad<T>::zero();
        if (t < total) {
          const int wr = t / n_quads;
          const int w = w_lo + t - wr * n_quads;
          const int y = y0 + wr;
          if (box_ok && y >= 0 && y < H && w >= 0 && 4 * w < flat_w)
            v[k] = __ldg(reinterpret_cast<const V*>(frame + y * sH) + w);
        }
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int t = base + k * kThreads;
        if (t < total) {
          const int wr = t / n_quads;
          const int w = w_lo + t - wr * n_quads;
          float* row = win + wr * stride;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int q = 4 * w + b - g0;
            if (q >= 0 && q < ew) row[q] = Quad<T>::get(v[k], b);
          }
        }
      }
    }
    return;
  }
  const bool contiguous = sC == 1 && sW == C;
  const int total = n_rows * ew;
  for (int base = threadIdx.x; base < total; base += kThreads * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int t = base + k * kThreads;
      v[k] = 0.f;
      if (t < total) {
        const int wr = t / ew;
        const int g = g0 + t - wr * ew;
        const int y = y0 + wr;
        if (box_ok && y >= 0 && y < H) {
          if (contiguous) {
            if (g >= 0 && g < flat_w) v[k] = (float)frame[y * sH + g];
          } else {
            // Flat element -> (column, channel); g is negative left of the
            // image, so divide its distance from x0's first element instead.
            const int rel = g - x0 * C;
            const int col = C == 1 ? rel : rel / C;
            const int ch = rel - col * C;
            const int x = x0 + col;
            if (x >= 0 && x < W) v[k] = (float)frame[y * sH + x * sW + ch * sC];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int t = base + k * kThreads;
      if (t < total) {
        const int wr = t / ew;
        win[wr * stride + t - wr * ew] = v[k];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_unit_kernel(const T* __restrict__ img, int64_t sB, int sH, int sW, int sC, int B, int H,
                 int W, int C, const float* __restrict__ top_left,
                 const int64_t* __restrict__ box_indices, int ch, int cw, int band_rows,
                 int n_bands, int n_segs, bool quads, bool vec_store, float* __restrict__ out) {
  extern __shared__ __align__(16) float win[];

  // Block -> (box, band, segment).
  int blk = blockIdx.x;
  const int seg = blk % n_segs;
  blk /= n_segs;
  const int band = blk % n_bands;
  const int i = blk / n_bands;

  const int row_elems = cw * C;
  const int j0 = seg * kSegElems;
  const int seg_elems = min(kSegElems, row_elems - j0);
  const int r0 = band * band_rows;
  const int n_out_rows = min(band_rows, ch - r0);
  const int stride = window_stride(min(kSegElems, row_elems), C);

  // The box, once per block. Clamping the origin to one window beyond the
  // image keeps the int math in range and changes no tap: a window that
  // starts further out lies wholly outside either way.
  const float x1 = __ldg(top_left + 2 * i);
  const float y1 = __ldg(top_left + 2 * i + 1);
  const float xf = floorf(x1);
  const float yf = floorf(y1);
  const float fx = __fsub_rn(x1, xf);
  const float fy = __fsub_rn(y1, yf);
  const int x0 = (int)fminf(fmaxf(xf, -(float)(cw + 1)), (float)W);
  const int y0 = (int)fminf(fmaxf(yf, -(float)(ch + 1)), (float)H);
  const int64_t b = (int64_t)__ldg(reinterpret_cast<const long long*>(box_indices) + i);
  const bool box_ok = b >= 0 && b < B;
  const T* frame = img + (box_ok ? b : 0) * sB;

  stage<T>(win, stride, frame, box_ok, y0 + r0, x0 * C + j0, x0, n_out_rows + 1,
           seg_elems + C, H, W, C, sH, sW, sC, quads);
  __syncthreads();

  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const int n_quads = (seg_elems + 3) >> 2;
  const int total = n_out_rows * n_quads;
  const int c_lo = C & ~3;
  const int shift = C & 3;
  float* out_box = out + (i * ch + r0) * row_elems + j0;
#pragma unroll 4
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const int r = t / n_quads;
    const int jj = 4 * (t - r * n_quads);
    const float* top_row = win + r * stride + jj;
    const float* bot_row = top_row + stride;
    const float4 t0 = lds4(top_row);
    const float4 b0 = lds4(bot_row);
    const float a00[4] = {t0.x, t0.y, t0.z, t0.w};
    const float a10[4] = {b0.x, b0.y, b0.z, b0.w};
    float a01[4], a11[4];
    taps_c(top_row + c_lo, shift, a01);
    taps_c(bot_row + c_lo, shift, a11);
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float top = __fadd_rn(__fmul_rn(a00[k], gx), __fmul_rn(a01[k], fx));
      const float bot = __fadd_rn(__fmul_rn(a10[k], gx), __fmul_rn(a11[k], fx));
      o[k] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    }
    float* dst = out_box + r * row_elems + jj;
    const int left = seg_elems - jj;
    if (vec_store && left >= 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < left) dst[k] = o[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* img, int64_t sB, int sH, int sW, int sC, int B, int H, int W,
                   int C, const float* top_left, const int64_t* box_indices, int n, int ch, int cw,
                   float* out, cudaStream_t stream) {
  const int row_elems = cw * C;
  const int stride = window_stride(row_elems < kSegElems ? row_elems : kSegElems, C);
  // Rows per band: kBandRows, fewer where a wide channel count would not
  // fit the window in static shared memory.
  int band_rows = kSmemLimit / (stride * 4) - 1;
  if (band_rows > kBandRows) band_rows = kBandRows;
  if (band_rows > ch) band_rows = ch;
  if (band_rows < 1) return cudaErrorInvalidValue;
  const int n_bands = (ch + band_rows - 1) / band_rows;
  const int n_segs = (row_elems + kSegElems - 1) / kSegElems;
  const int64_t blocks = (int64_t)n * n_bands * n_segs;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = (band_rows + 1) * stride * 4;
  const bool quads = sC == 1 && sW == C && (W * C) % 4 == 0 && sH % 4 == 0 && sB % 4 == 0 &&
                     ((uintptr_t)img % (4 * sizeof(T))) == 0;
  const bool vec_store = row_elems % 4 == 0 && ((uintptr_t)out & 15) == 0;
  crop_unit_kernel<T><<<(int)blocks, kThreads, smem, stream>>>(
      (const T*)img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, ch, cw, band_rows,
      n_bands, n_segs, quads, vec_store, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point: dtype 0 = uint8, 1 = float32. Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError() (0 on success).
// Strides are in elements; sH, sW, sC and every offset inside one frame,
// and n * ch * cw * C, must fit in int32 (the wrapper checks). out is
// contiguous (n, ch, cw, C) float32.
extern "C" int sleap_crop_unit(const void* img, int dtype, int64_t sB, int sH, int sW, int sC,
                               int B, int H, int W, int C, const float* top_left,
                               const int64_t* box_indices, int n, int ch, int cw, float* out,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || ch < 1 || cw < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<uint8_t>(img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, n, ch,
                                cw, out, st);
  if (dtype == 1)
    return (int)launch<float>(img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, n, ch, cw,
                              out, st);
  return (int)cudaErrorInvalidValue;
}
