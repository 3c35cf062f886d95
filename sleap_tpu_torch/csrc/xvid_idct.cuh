// Xvid's IDCT as OpenCV's FFmpeg backend runs it on x86-64 (ff_xvid_idct_sse2,
// which FFmpeg picks for a stream whose user data or fourcc names Xvid),
// fitted to recorded decodes of crafted intra blocks: the row and column
// passes of the Xvid forms of M1, M2 and M3 (csrc/mpeg4.cu), which feed them
// dequantised coefficients. Rows: AP-922's matrix product in 32 bits, each
// row's constants 2^14 sqrt(2) cos(k pi / 16) of the column index times the
// same factor of the row's index folded into 0..4, Walken's rounders,
// shifted right by 11 and saturated to 16 bits. Columns: Loeffler's
// butterflies in saturating 16-bit arithmetic with pmulhw products (tan(pi /
// 16), tan(pi / 8), tan(3 pi / 16) - 1 and cos(pi / 4) / 2 in Q16), shifted
// right by 6. io/mpeg4.py's xvid_idct_values is the plain version.
#pragma once

#include <stdint.h>

namespace {

__device__ __constant__ int32_t kXvidRow[8][8] = {
    {16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520},
    {22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270},
    {21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906},
    {19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315},
    {16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520},
    {19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315},
    {21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906},
    {22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270}};
__device__ __constant__ int32_t kXvidRounder[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

__device__ __forceinline__ int32_t xvid_sat(int32_t v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

__device__ __forceinline__ int32_t xvid_mulhi(int32_t a, int32_t c) { return (a * c) >> 16; }

// Pass 1: row `r` of dequantised coefficients `x` into `out`, 8 int16 of the
// workspace. Sums wrap at 32 bits, as paddd does.
__device__ __forceinline__ void xvid_row(const int32_t (&x)[8], int r, int16_t* out) {
  const int32_t* c = kXvidRow[r];
  const uint32_t rnd = (uint32_t)kXvidRounder[r];
  uint32_t p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = (uint32_t)(c[k] * x[k]);
  uint32_t a[4], b[4];
  a[0] = p[0] + p[2] + p[4] + p[6] + rnd;
  a[1] = p[0] + (uint32_t)(c[6] * x[2]) - p[4] - (uint32_t)(c[2] * x[6]) + rnd;
  a[2] = p[0] - (uint32_t)(c[6] * x[2]) - p[4] + (uint32_t)(c[2] * x[6]) + rnd;
  a[3] = p[0] - p[2] + p[4] - p[6] + rnd;
  b[0] = p[1] + p[3] + p[5] + p[7];
  b[1] = (uint32_t)(c[3] * x[1]) - (uint32_t)(c[7] * x[3]) - (uint32_t)(c[1] * x[5]) -
         (uint32_t)(c[5] * x[7]);
  b[2] = (uint32_t)(c[5] * x[1]) - (uint32_t)(c[1] * x[3]) + (uint32_t)(c[7] * x[5]) +
         (uint32_t)(c[3] * x[7]);
  b[3] = (uint32_t)(c[7] * x[1]) - (uint32_t)(c[5] * x[3]) + (uint32_t)(c[3] * x[5]) -
         (uint32_t)(c[1] * x[7]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k] = (int16_t)xvid_sat((int32_t)(a[k] + b[k]) >> 11);
    out[7 - k] = (int16_t)xvid_sat((int32_t)(a[k] - b[k]) >> 11);
  }
}

// Pass 2: column `lane` of the workspace `ws` (64 int16, rows of 8): the
// values before saturation to 8 bits.
__device__ __forceinline__ void xvid_column(const int16_t* ws, int lane, int32_t (&v)[8]) {
  constexpr int32_t kT1 = 13036, kT2 = 27146, kT3 = -21746, kC4 = 23170;
  int32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[8 * k + lane];
  const int32_t tm35 = xvid_sat(xvid_sat(xvid_mulhi(x[3], kT3) + x[3]) - x[5]);
  const int32_t tp35 = xvid_sat(xvid_sat(xvid_mulhi(x[5], kT3) + x[5]) + x[3]);
  const int32_t tp17 = xvid_sat(xvid_mulhi(x[7], kT1) + x[1]);
  const int32_t tm17 = xvid_sat(xvid_mulhi(x[1], kT1) - x[7]);
  const int32_t b0 = xvid_sat(tp17 + tp35), b3 = xvid_sat(tm17 - tm35);
  const int32_t t1 = xvid_sat(tp17 - tp35), t2 = xvid_sat(tm17 + tm35);
  const int32_t b1 = xvid_sat(2 * xvid_mulhi(xvid_sat(t1 + t2), kC4));
  const int32_t b2 = xvid_sat(2 * xvid_mulhi(xvid_sat(t1 - t2), kC4));
  const int32_t tm26 = xvid_sat(xvid_mulhi(x[2], kT2) - x[6]);
  const int32_t tp26 = xvid_sat(xvid_mulhi(x[6], kT2) + x[2]);
  const int32_t tp04 = xvid_sat(x[0] + x[4]), tm04 = xvid_sat(x[0] - x[4]);
  const int32_t a0 = xvid_sat(tp04 + tp26), a1 = xvid_sat(tm04 + tm26);
  const int32_t a2 = xvid_sat(tm04 - tm26), a3 = xvid_sat(tp04 - tp26);
  v[0] = xvid_sat(a0 + b0) >> 6, v[7] = xvid_sat(a0 - b0) >> 6;
  v[1] = xvid_sat(a1 + b1) >> 6, v[6] = xvid_sat(a1 - b1) >> 6;
  v[2] = xvid_sat(a2 + b2) >> 6, v[5] = xvid_sat(a2 - b2) >> 6;
  v[3] = xvid_sat(a3 + b3) >> 6, v[4] = xvid_sat(a3 - b3) >> 6;
}

}  // namespace
