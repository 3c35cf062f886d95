// FFmpeg's "simple" IDCT as OpenCV's FFmpeg backend runs it on x86-64 (the
// rounding of its SIMD form), fitted to recorded decodes: the row and
// column passes of the J5 (csrc/jpeg.cu) and M1/M2 (csrc/mpeg4.cu) kernels,
// which feed them dequantised coefficients. Constants W1..W7 are cos(k pi /
// 16) sqrt(2) 2^14, W4 = 16383. Sums wrap at 32 bits, so the arithmetic is
// unsigned.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ int16_t wrap16(uint32_t v) { return (int16_t)(uint16_t)v; }

__device__ __forceinline__ int16_t sat16(int32_t v) {
  return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The even and odd halves of one 1-D pass: a[0..3] + b[0..3] -> outputs 0-3,
// a - b -> outputs 7-4. `a0` already holds W4 * x0 plus the rounding.
__device__ __forceinline__ void simple_1d(uint32_t a0, const int32_t (&x)[8], uint32_t (&o)[8]) {
  constexpr int32_t W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                    W7 = 4520;
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) + (uint32_t)(W6 * x[6]);
  a1 += (uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) - (uint32_t)(W2 * x[6]);
  a2 += -(uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) + (uint32_t)(W2 * x[6]);
  a3 += -(uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) - (uint32_t)(W6 * x[6]);
  const uint32_t b0 = (uint32_t)(W1 * x[1]) + (uint32_t)(W3 * x[3]) + (uint32_t)(W5 * x[5]) +
                      (uint32_t)(W7 * x[7]);
  const uint32_t b1 = (uint32_t)(W3 * x[1]) - (uint32_t)(W7 * x[3]) - (uint32_t)(W1 * x[5]) -
                      (uint32_t)(W5 * x[7]);
  const uint32_t b2 = (uint32_t)(W5 * x[1]) - (uint32_t)(W1 * x[3]) + (uint32_t)(W7 * x[5]) +
                      (uint32_t)(W3 * x[7]);
  const uint32_t b3 = (uint32_t)(W7 * x[1]) - (uint32_t)(W5 * x[3]) + (uint32_t)(W3 * x[5]) -
                      (uint32_t)(W1 * x[7]);
  o[0] = a0 + b0; o[7] = a0 - b0;
  o[1] = a1 + b1; o[6] = a1 - b1;
  o[2] = a2 + b2; o[5] = a2 - b2;
  o[3] = a3 + b3; o[4] = a3 - b3;
}

// Pass 1: one row of dequantised coefficients `x` into `out`, 8 int16 of
// the 8x8 workspace. A row whose AC terms are all zero is its DC times 8,
// wrapped to 16 bits; else shift 11 (rounding 1 << 10), saturated to int16.
__device__ __forceinline__ void simple_row(const int32_t (&x)[8], int16_t* out) {
  bool ac = false;
#pragma unroll
  for (int k = 1; k < 8; ++k) ac |= x[k] != 0;
  if (!ac) {
    const int16_t dc = wrap16((uint32_t)x[0] << 3);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = dc;
  } else {
    uint32_t o[8];
    simple_1d((uint32_t)(16383 * x[0]) + (1u << 10), x, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = sat16((int32_t)o[k] >> 11);
  }
}

// Pass 2: column `lane` of the workspace `ws` (64 int16, rows of 8): the
// rounding 32 added to the DC term in 16 bits, shift 20; the values before
// saturation.
__device__ __forceinline__ void simple_column(const int16_t* ws, int lane, int32_t (&v)[8]) {
  int32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[8 * k + lane];
  const int32_t dc = wrap16((uint32_t)(x[0] + 32));
  uint32_t o[8];
  simple_1d((uint32_t)(16383 * dc), x, o);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (int32_t)o[k] >> 20;
}

}  // namespace
