// LZF decompression in host C (nvcc compiles it as host code into the
// kernel library): the card's route for HDF5 chunks that h5py's lzf filter
// (filter 32000) stored, bound with ctypes from
// sleap_tpu_torch/io/lzf.py, whose Python decoder is the plain version this
// must equal.
//
// Not a kernel, and no TPU kernel has a counterpart: the JAX package reads
// HDF5 through h5py, which decodes LZF on the host. An LZF stream is a
// sequence of tokens, each of whose back references reads bytes that the
// tokens before it wrote, so a chunk is one pass on the host.
//
// sleap_hdf5_lzf_decode(src, n, dst, capacity, written): liblzf's
// lzf_decompress. A control byte below 32 copies that many plus one literal
// bytes; any other is a back reference of (ctrl >> 5) + 2 bytes (a length
// byte follows where ctrl >> 5 is 7) at distance ((ctrl & 31) << 8) + next
// byte + 1, copied byte by byte so that an overlapping copy repeats. Returns
// 0, 1 when `capacity` bytes are not enough (liblzf's E2BIG; `written` is
// then undefined), or 2 when the stream is corrupt (EINVAL: a token past
// the end of the input, or a reference before the start of the output).

#include <stdint.h>
#include <string.h>

extern "C" int sleap_hdf5_lzf_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t capacity,
                                     int64_t* written) {
  enum { kOk = 0, kFull = 1, kCorrupt = 2 };
  int64_t i = 0, o = 0;
  while (i < n) {
    const unsigned ctrl = src[i++];
    if (ctrl < 32) {
      const int64_t run = (int64_t)ctrl + 1;
      if (o + run > capacity) return kFull;
      if (i + run > n) return kCorrupt;
      memcpy(dst + o, src + i, (size_t)run);
      i += run;
      o += run;
      continue;
    }
    int64_t len = ctrl >> 5;
    if (i >= n) return kCorrupt;
    if (len == 7) {
      len += src[i++];
      if (i >= n) return kCorrupt;
    }
    const int64_t ref = o - (int64_t)((ctrl & 0x1f) << 8) - 1 - src[i++];
    len += 2;
    if (o + len > capacity) return kFull;
    if (ref < 0) return kCorrupt;
    for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[ref + k];
    o += len;
  }
  *written = o;
  return kOk;
}
