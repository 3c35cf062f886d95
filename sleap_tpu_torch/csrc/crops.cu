// Unit-spaced bilinear crops, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _crop_kernel of
// sleap_tpu/ops/pallas_crops.py (crop_bboxes_unit_pallas). Bound to PyTorch
// with ctypes from sleap_tpu_torch/ops/cuda_crops.py, which also holds the
// plain PyTorch version and the design notes.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_unit_kernel(const T* __restrict__ img, int64_t sB, int64_t sH, int64_t sW, int64_t sC,
                 int B, int H, int W, int C, const float* __restrict__ top_left,
                 const int64_t* __restrict__ box_indices, int n, int ch, int cw,
                 float* __restrict__ out) {
  const int64_t total = (int64_t)n * ch * cw * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    int64_t t = e;
    const int c = (int)(t % C);
    t /= C;
    const int col = (int)(t % cw);
    t /= cw;
    const int row = (int)(t % ch);
    const int i = (int)(t / ch);

    const float x1 = top_left[2 * i];
    const float y1 = top_left[2 * i + 1];
    const float x0 = floorf(x1);
    const float y0 = floorf(y1);
    const float fx = __fsub_rn(x1, x0);
    const float fy = __fsub_rn(y1, y0);
    const int64_t b = box_indices[i];
    const int yd = (int)y0 + row;
    const int xd = (int)x0 + col;

    const bool bok = b >= 0 && b < B;
    const T* frame = img + (bok ? b : 0) * sB + (int64_t)c * sC;
    auto tap = [&](int y, int x) -> float {
      return (bok && y >= 0 && y < H && x >= 0 && x < W) ? (float)frame[y * sH + x * sW] : 0.f;
    };
    const float v00 = tap(yd, xd);
    const float v01 = tap(yd, xd + 1);
    const float v10 = tap(yd + 1, xd);
    const float v11 = tap(yd + 1, xd + 1);

    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
    const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
    out[e] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  }
}

template <typename T>
cudaError_t launch(const void* img, int64_t sB, int64_t sH, int64_t sW, int64_t sC, int B,
                   int H, int W, int C, const float* top_left, const int64_t* box_indices,
                   int n, int ch, int cw, float* out, cudaStream_t stream) {
  const int64_t total = (int64_t)n * ch * cw * C;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  crop_unit_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, n, ch, cw, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point: dtype 0 = uint8, 1 = float32. Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError() (0 on success).
// Strides are in elements; out is contiguous (n, ch, cw, C) float32.
extern "C" int sleap_crop_unit(const void* img, int dtype, int64_t sB, int64_t sH, int64_t sW,
                               int64_t sC, int B, int H, int W, int C, const float* top_left,
                               const int64_t* box_indices, int n, int ch, int cw, float* out,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<uint8_t>(img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, n, ch,
                                cw, out, st);
  if (dtype == 1)
    return (int)launch<float>(img, sB, sH, sW, sC, B, H, W, C, top_left, box_indices, n, ch, cw,
                              out, st);
  return (int)cudaErrorInvalidValue;
}
