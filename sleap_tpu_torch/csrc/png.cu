// PNG row unfiltering in host C (nvcc compiles it as host code into the
// kernel library): the port's fast route for the PNG frames of .pkg.slp
// files, bound with ctypes from sleap_tpu_torch/io/png.py, whose numpy
// wavefront is the plain version this must equal.
//
// Not a kernel, and no TPU kernel has a counterpart: the JAX package decodes
// PNG with cv2 on the host. Host C and not a CUDA kernel because the Video
// interface returns numpy frames, and the Average and Paeth filters depend
// on the byte to the left: one sequential pass over the rows at memory
// speed does less than a wavefront launch plus a copy back.

#include <stdint.h>
#include <string.h>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int pa = b > c ? b - c : c - b;            // |p - a|, p = a + b - c
  const int pb = a > c ? a - c : c - a;            // |p - b|
  const int pc = (a + b - 2 * c) < 0 ? 2 * c - a - b : a + b - 2 * c;  // |p - c|
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

}  // namespace

// rows: height rows of 1 + stride bytes, each a filter type (0-4) and the
// filtered bytes; out: height x stride unfiltered bytes; bpp: bytes a pixel.
// Returns 0, or 1 + the first row whose filter type is unknown.
extern "C" int sleap_png_unfilter(const uint8_t* rows, int64_t height, int64_t stride, int bpp,
                                  uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = rows + y * (stride + 1);
    const uint8_t kind = *src++;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y ? dst - stride : nullptr;
    switch (kind) {
      case 0:
        memcpy(dst, src, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = up && i >= bpp ? up[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}
