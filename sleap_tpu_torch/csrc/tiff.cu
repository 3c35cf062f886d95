// TIFF's LZW and PackBits codecs in host C (nvcc compiles it as host code
// into the kernel library): the card's route for the TIFF stills of image
// folders, .pkg.slp and HDF5 frame rows and ImgStores, bound with ctypes
// from sleap_tpu_torch/io/tiff.py, whose Python codecs are the plain
// versions these must equal.
//
// Not a kernel, and no TPU kernel has a counterpart: the JAX package reads
// and writes TIFF with cv2 on the host. Both codecs are sequential byte
// streams (each code depends on the table the codes before it built), so a
// strip is one pass on the host.
//
// - sleap_tiff_lzw_decode: libtiff's LZWDecode: MSB-first codes of 9 to 12
//   bits, the width growing one code before the table needs it, clear and
//   end-of-information codes; the string of a code is written back to front
//   along its prefix chain.
// - sleap_tiff_lzw_encode: libtiff's LZWEncode and LZWPostEncode, with its
//   open-addressed hash table (9001 entries, xor hash, secondary probe), a
//   clear code when the table reaches 4094 entries and when the compression
//   ratio stops improving at a checkpoint every 10000 input bytes.
// - sleap_tiff_packbits_decode: libtiff's PackBitsDecode.
// - sleap_tiff_packbits_encode: runs of 3 to 128 equal bytes as a repeat,
//   the bytes between them as literals of up to 128 (the plain encoder's
//   rule).
//
// Each takes (src, n, dst, capacity, written) and returns 0, or: 1 the data
// ends before `capacity` bytes are decoded, 2 an LZW code past the table, 3
// a clear code followed by a string code, 4 the output buffer is too small.

#include <stdint.h>
#include <string.h>

namespace {

enum { kOk = 0, kShort = 1, kBadCode = 2, kBadClear = 3, kFull = 4 };
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxCode = 4095, kCheckGap = 10000;
constexpr int kHashSize = 9001, kHashShift = 13 - 8;

}  // namespace

extern "C" int sleap_tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
                                     int64_t* written) {
  static thread_local uint16_t prefix[kMaxCode + 1];
  static thread_local uint8_t suffix[kMaxCode + 1], first[kMaxCode + 1];
  static thread_local int32_t length[kMaxCode + 1];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  const int64_t n_bits = 8 * n;
  int64_t p = 0, pos = 0;
  int nbits = 9, free_ent = kFirst, prev = -1, err = kOk;
  while (pos < size && p + nbits <= n_bits) {
    uint32_t w = 0;
    for (int k = 0; k < 3; ++k) {
      const int64_t q = (p >> 3) + k;
      w = (w << 8) | (q < n ? src[q] : 0);
    }
    const int code = (int)((w >> (24 - nbits - (p & 7))) & ((1u << nbits) - 1));
    p += nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      prev = -1;
      continue;
    }
    const int entry = code;
    if (prev < 0) {
      if (code > kClear) {
        err = kBadClear;
        break;
      }
    } else if (code < free_ent || (code == free_ent && free_ent <= kMaxCode)) {
      // The new entry: the previous string and the first byte of this one
      // (of the previous string itself where this code is the new entry);
      // a full table takes no more.
      if (free_ent <= kMaxCode) {
        prefix[free_ent] = (uint16_t)prev;
        first[free_ent] = first[prev];
        suffix[free_ent] = code == free_ent ? first[prev] : first[code];
        length[free_ent] = length[prev] + 1;
        ++free_ent;
      }
    } else {
      err = kBadCode;
      break;
    }
    // Write the string back to front, cut at `size`.
    const int len = length[entry];
    int skip = (int)(pos + len > size ? pos + len - size : 0);
    int e = entry;
    for (int k = len - 1; k >= 0; --k) {
      if (skip > 0) {
        --skip;
      } else {
        dst[pos + k] = suffix[e];
      }
      e = prefix[e];
    }
    pos += len < size - pos ? len : size - pos;
    prev = entry;
    if (free_ent >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  *written = pos;
  if (err) return err;
  return pos < size ? kShort : kOk;
}

extern "C" int sleap_tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t capacity,
                                     int64_t* written) {
  static thread_local int64_t hash[kHashSize];
  static thread_local uint16_t codes[kHashSize];
  int64_t pos = 0, outcount = 0, incount = 0, checkpoint = kCheckGap, ratio = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, maxcode = 511, free_ent = kFirst;
  bool full = false;
  auto put = [&](int code) {
    acc = (acc << nbits) | (uint64_t)code;
    nacc += nbits;
    while (nacc >= 8) {
      nacc -= 8;
      if (pos >= capacity) {
        full = true;
      } else {
        dst[pos++] = (uint8_t)(acc >> nacc);
      }
    }
    acc &= (1ull << nacc) - 1;
    outcount += nbits;
  };
  auto clear_hash = [&]() {
    for (int i = 0; i < kHashSize; ++i) hash[i] = -1;
  };
  auto reset = [&]() {
    clear_hash();
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = 9;
    maxcode = 511;
  };
  clear_hash();
  int ent = -1;
  if (n > 0) {
    put(kClear);
    ent = src[0];
    incount = 1;
  }
  for (int64_t i = 1; i < n; ++i) {
    const int c = src[i];
    ++incount;
    const int64_t fcode = ((int64_t)c << 12) + ent;
    int h = (c << kHashShift) ^ ent;
    if (hash[h] == fcode) {
      ent = codes[h];
      continue;
    }
    bool hit = false;
    if (hash[h] >= 0) {  // the secondary probe
      const int disp = h == 0 ? 1 : kHashSize - h;
      do {
        if ((h -= disp) < 0) h += kHashSize;
        if (hash[h] == fcode) {
          ent = codes[h];
          hit = true;
          break;
        }
      } while (hash[h] >= 0);
    }
    if (hit) continue;
    put(ent);
    ent = c;
    codes[h] = (uint16_t)free_ent++;
    hash[h] = fcode;
    if (free_ent == kMaxCode - 1) {
      reset();
    } else if (free_ent > maxcode) {
      ++nbits;
      maxcode = (1 << nbits) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      int64_t rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio) {
        reset();
      } else {
        ratio = rat;
      }
    }
  }
  if (ent >= 0) {
    put(ent);
    ++free_ent;
    if (free_ent == kMaxCode - 1) {
      put(kClear);
      nbits = 9;
    } else if (free_ent > maxcode) {
      ++nbits;
    }
  }
  put(kEoi);
  if (nacc > 0) {
    if (pos >= capacity) {
      full = true;
    } else {
      dst[pos++] = (uint8_t)((acc << (8 - nacc)) & 0xff);
    }
  }
  *written = pos;
  return full ? kFull : kOk;
}

extern "C" int sleap_tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t size,
                                          int64_t* written) {
  int64_t i = 0, pos = 0;
  while (i < n && pos < size) {
    const int h = src[i++];
    if (h == 128) continue;
    if (h > 128) {
      if (i >= n) break;
      int64_t run = 257 - h;
      if (run > size - pos) run = size - pos;
      memset(dst + pos, src[i++], (size_t)run);
      pos += run;
    } else {
      int64_t run = h + 1;
      if (run > size - pos) run = size - pos;
      if (i + run > n) break;
      memcpy(dst + pos, src + i, (size_t)run);
      pos += run;
      i += run;
    }
  }
  *written = pos;
  return pos < size ? kShort : kOk;
}

extern "C" int sleap_tiff_packbits_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                                          int64_t capacity, int64_t* written) {
  int64_t i = 0, pos = 0;
  while (i < n) {
    int64_t j = i + 1;
    while (j < n && j - i < 128 && src[j] == src[i]) ++j;
    if (j - i >= 3) {
      if (pos + 2 > capacity) return kFull;
      dst[pos++] = (uint8_t)(257 - (j - i));
      dst[pos++] = src[i];
      i = j;
      continue;
    }
    j = i + 1;
    while (j < n && j - i < 128 && !(j + 2 < n && src[j] == src[j + 1] && src[j] == src[j + 2])) ++j;
    if (pos + 1 + (j - i) > capacity) return kFull;
    dst[pos++] = (uint8_t)(j - i - 1);
    memcpy(dst + pos, src + i, (size_t)(j - i));
    pos += j - i;
    i = j;
  }
  *written = pos;
  return kOk;
}
