// TIFF's LZW, PackBits and CCITT codecs in host C (nvcc compiles it as host code
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
// - sleap_tiff_ccitt_decode: tif_fax3.c's decoders of fax strips and tiles:
//   Modified Huffman (compression 2: 1-D rows from byte boundaries), T.4
//   (3: an EOL before each row, then with 2-D coding a tag bit for a 1-D or
//   a 2-D row) and T.6 (4: 2-D rows, each against the row above, white
//   above the first). Runs are found by one lookup of the next 13 bits in a
//   table of 8192 entries a colour (length << 12 | run); a row is kept as
//   its changing elements, written out as packed bits with black as 1. Each
//   code depends on where the one before it ended, so a strip is one pass
//   on the host, as for LZW.
//
// The LZW and PackBits entries take (src, n, dst, capacity, written) and
// return 0, or: 1 the data ends before `capacity` bytes are decoded, 2 an
// LZW code past the table, 3 a clear code followed by a string code, 4 the
// output buffer is too small.

#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

enum { kOk = 0, kShort = 1, kBadCode = 2, kBadClear = 3, kFull = 4 };
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxCode = 4095, kCheckGap = 10000;
constexpr int kHashSize = 9001, kHashShift = 13 - 8;

// T.4's run-length codes as {code, length, run}: white, then black (the
// extended make-up codes 1792-2560 in both); io/tiff.py's WHITE_CODES,
// BLACK_CODES and EXTENDED_CODES.
struct RunCode {
  uint16_t code;
  uint8_t length;
  uint16_t run;
};
const RunCode kWhiteCodes[] = {
    {53, 8, 0}, {7, 6, 1}, {7, 4, 2}, {8, 4, 3}, {11, 4, 4}, {12, 4, 5}, {14, 4, 6}, {15, 4, 7},
    {19, 5, 8}, {20, 5, 9}, {7, 5, 10}, {8, 5, 11}, {8, 6, 12}, {3, 6, 13}, {52, 6, 14},
    {53, 6, 15}, {42, 6, 16}, {43, 6, 17}, {39, 7, 18}, {12, 7, 19}, {8, 7, 20}, {23, 7, 21},
    {3, 7, 22}, {4, 7, 23}, {40, 7, 24}, {43, 7, 25}, {19, 7, 26}, {36, 7, 27}, {24, 7, 28},
    {2, 8, 29}, {3, 8, 30}, {26, 8, 31}, {27, 8, 32}, {18, 8, 33}, {19, 8, 34}, {20, 8, 35},
    {21, 8, 36}, {22, 8, 37}, {23, 8, 38}, {40, 8, 39}, {41, 8, 40}, {42, 8, 41}, {43, 8, 42},
    {44, 8, 43}, {45, 8, 44}, {4, 8, 45}, {5, 8, 46}, {10, 8, 47}, {11, 8, 48}, {82, 8, 49},
    {83, 8, 50}, {84, 8, 51}, {85, 8, 52}, {36, 8, 53}, {37, 8, 54}, {88, 8, 55}, {89, 8, 56},
    {90, 8, 57}, {91, 8, 58}, {74, 8, 59}, {75, 8, 60}, {50, 8, 61}, {51, 8, 62}, {52, 8, 63},
    {27, 5, 64}, {18, 5, 128}, {23, 6, 192}, {55, 7, 256}, {54, 8, 320}, {55, 8, 384},
    {100, 8, 448}, {101, 8, 512}, {104, 8, 576}, {103, 8, 640}, {204, 9, 704}, {205, 9, 768},
    {210, 9, 832}, {211, 9, 896}, {212, 9, 960}, {213, 9, 1024}, {214, 9, 1088}, {215, 9, 1152},
    {216, 9, 1216}, {217, 9, 1280}, {218, 9, 1344}, {219, 9, 1408}, {152, 9, 1472}, {153, 9, 1536},
    {154, 9, 1600}, {24, 6, 1664}, {155, 9, 1728}, {8, 11, 1792}, {12, 11, 1856}, {13, 11, 1920},
    {18, 12, 1984}, {19, 12, 2048}, {20, 12, 2112}, {21, 12, 2176}, {22, 12, 2240}, {23, 12, 2304},
    {28, 12, 2368}, {29, 12, 2432}, {30, 12, 2496}, {31, 12, 2560},
};
const RunCode kBlackCodes[] = {
    {55, 10, 0}, {2, 3, 1}, {3, 2, 2}, {2, 2, 3}, {3, 3, 4}, {3, 4, 5}, {2, 4, 6}, {3, 5, 7},
    {5, 6, 8}, {4, 6, 9}, {4, 7, 10}, {5, 7, 11}, {7, 7, 12}, {4, 8, 13}, {7, 8, 14}, {24, 9, 15},
    {23, 10, 16}, {24, 10, 17}, {8, 10, 18}, {103, 11, 19}, {104, 11, 20}, {108, 11, 21},
    {55, 11, 22}, {40, 11, 23}, {23, 11, 24}, {24, 11, 25}, {202, 12, 26}, {203, 12, 27},
    {204, 12, 28}, {205, 12, 29}, {104, 12, 30}, {105, 12, 31}, {106, 12, 32}, {107, 12, 33},
    {210, 12, 34}, {211, 12, 35}, {212, 12, 36}, {213, 12, 37}, {214, 12, 38}, {215, 12, 39},
    {108, 12, 40}, {109, 12, 41}, {218, 12, 42}, {219, 12, 43}, {84, 12, 44}, {85, 12, 45},
    {86, 12, 46}, {87, 12, 47}, {100, 12, 48}, {101, 12, 49}, {82, 12, 50}, {83, 12, 51},
    {36, 12, 52}, {55, 12, 53}, {56, 12, 54}, {39, 12, 55}, {40, 12, 56}, {88, 12, 57},
    {89, 12, 58}, {43, 12, 59}, {44, 12, 60}, {90, 12, 61}, {102, 12, 62}, {103, 12, 63},
    {15, 10, 64}, {200, 12, 128}, {201, 12, 192}, {91, 12, 256}, {51, 12, 320}, {52, 12, 384},
    {53, 12, 448}, {108, 13, 512}, {109, 13, 576}, {74, 13, 640}, {75, 13, 704}, {76, 13, 768},
    {77, 13, 832}, {114, 13, 896}, {115, 13, 960}, {116, 13, 1024}, {117, 13, 1088},
    {118, 13, 1152}, {119, 13, 1216}, {82, 13, 1280}, {83, 13, 1344}, {84, 13, 1408},
    {85, 13, 1472}, {90, 13, 1536}, {91, 13, 1600}, {100, 13, 1664}, {101, 13, 1728},
    {8, 11, 1792}, {12, 11, 1856}, {13, 11, 1920}, {18, 12, 1984}, {19, 12, 2048}, {20, 12, 2112},
    {21, 12, 2176}, {22, 12, 2240}, {23, 12, 2304}, {28, 12, 2368}, {29, 12, 2432}, {30, 12, 2496},
    {31, 12, 2560},
};

constexpr int kLookupBits = 13;

// Lookup tables of the next 13 bits -> length << 12 | run, 0 for no code.
struct RunTables {
  uint16_t white[1 << kLookupBits], black[1 << kLookupBits];
  RunTables() {
    memset(white, 0, sizeof(white));
    memset(black, 0, sizeof(black));
    fill(white, kWhiteCodes, sizeof(kWhiteCodes) / sizeof(RunCode));
    fill(black, kBlackCodes, sizeof(kBlackCodes) / sizeof(RunCode));
  }
  static void fill(uint16_t* table, const RunCode* codes, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      const int span = 1 << (kLookupBits - codes[i].length);
      const int lo = codes[i].code << (kLookupBits - codes[i].length);
      for (int k = 0; k < span; ++k) table[lo + k] = (uint16_t)(codes[i].length << 12 | codes[i].run);
    }
  }
};

enum { kFaxShort = 1, kFaxBadRun = 2, kFaxBadMode = 3, kFaxBadVertical = 4, kFaxNoEol = 5 };

// The k bits from bit p on, MSB-first; bits past the end read as zeros.
inline uint32_t fax_peek(const uint8_t* d, int64_t n_bytes, int64_t p, int k) {
  uint64_t w = 0;
  const int64_t q = p >> 3;
  for (int i = 0; i < 5; ++i) w = (w << 8) | (q + i < n_bytes ? d[q + i] : 0u);
  return (uint32_t)((w >> (40 - (p & 7) - k)) & ((1u << k) - 1));
}

struct FaxReader {
  const uint8_t* d;
  int64_t n_bytes, p;
  uint32_t peek(int k) const { return fax_peek(d, n_bytes, p, k); }
  bool past_end() const { return p > 8 * n_bytes; }
};

// One run of `black` (0 white): make-up codes, then a terminating one.
int fax_run(FaxReader& r, const RunTables& t, int black, int* run) {
  const uint16_t* table = black ? t.black : t.white;
  int total = 0;
  for (;;) {
    const uint16_t look = table[r.peek(kLookupBits)];
    if (!look) return kFaxBadRun;
    r.p += look >> 12;
    total += look & 0xFFF;
    if ((look & 0xFFF) < 64) {
      *run = total;
      return r.past_end() ? kFaxShort : 0;
    }
  }
}

int fax_line_1d(FaxReader& r, const RunTables& t, int width, std::vector<int>& changes) {
  changes.clear();
  int a0 = 0, colour = 0;
  while (a0 < width) {
    int run;
    if (int err = fax_run(r, t, colour, &run)) return err;
    a0 = a0 + run < width ? a0 + run : width;
    changes.push_back(a0);
    colour ^= 1;
  }
  return 0;
}

// The 2-D modes as {code, length, mode (0 pass, 1 horizontal, 2 vertical),
// offset}, tried in this order.
struct ModeCode {
  int code, length, mode, offset;
};
const ModeCode kModes[] = {{1, 4, 0, 0}, {1, 3, 1, 0},  {1, 1, 2, 0},  {3, 3, 2, 1},  {3, 6, 2, 2},
                           {3, 7, 2, 3}, {2, 3, 2, -1}, {2, 6, 2, -2}, {2, 7, 2, -3}};

int fax_line_2d(FaxReader& r, const RunTables& t, int width, std::vector<int>& ref,
                std::vector<int>& changes) {
  changes.clear();
  ref.insert(ref.end(), 3, width);
  int a0 = -1, colour = 0;
  size_t i = 0;
  while (a0 < width) {
    // b1: the first change on the reference row right of a0 turning to the
    // colour opposite a0's (even indices turn white to black); b2 the next.
    i = i > 0 ? i - 1 : 0;
    while (ref[i] <= a0 || (int)(i & 1) != colour) ++i;
    const int b1 = ref[i], b2 = ref[i + 1];
    const ModeCode* m = nullptr;
    for (const ModeCode& c : kModes) {
      if ((int)r.peek(c.length) == c.code) {
        m = &c;
        break;
      }
    }
    if (!m) return kFaxBadMode;
    r.p += m->length;
    if (r.past_end()) return kFaxShort;
    if (m->mode == 0) {
      a0 = b2;
    } else if (m->mode == 1) {
      int run1, run2;
      if (int err = fax_run(r, t, colour, &run1)) return err;
      if (int err = fax_run(r, t, colour ^ 1, &run2)) return err;
      const int start = a0 > 0 ? a0 : 0;
      const int a1 = start + run1 < width ? start + run1 : width;
      const int a2 = a1 + run2 < width ? a1 + run2 : width;
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
    } else {
      const int a1 = b1 + m->offset;
      if (a1 < (a0 > 0 ? a0 : 0) || a1 > width) return kFaxBadVertical;
      changes.push_back(a1);
      a0 = a1;
      colour ^= 1;
    }
  }
  return 0;
}

// Past the next EOL (11 or more zeros, then a one), as libtiff's SYNC_EOL.
int fax_eol(FaxReader& r) {
  int zeros = 0;
  while (zeros < 11 || !r.peek(1)) {
    if (r.p >= 8 * r.n_bytes) return kFaxNoEol;
    zeros = r.peek(1) ? 0 : zeros + 1;
    ++r.p;
  }
  ++r.p;
  return 0;
}

void fax_write_row(const std::vector<int>& changes, int width, uint8_t* row) {
  int x = 0, black = 0;
  for (size_t k = 0; k <= changes.size(); ++k) {
    const int end = k < changes.size() ? (changes[k] < width ? changes[k] : width) : width;
    for (; x < end; ++x) {
      if (black) row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
    }
    black ^= 1;
  }
}

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


// (src, n) one strip or tile -> `rows` rows of `width` bits, packed MSB-first
// (whole bytes a row) into dst, which the caller zeroed; black is 1.
// compression 2, 3 or 4; options T4Options for 3 (bit 0: 2-D coding).
// Returns 0, or 1 the data ends before the last row, 2 an invalid run code, 3
// an invalid 2-D mode code, 4 a vertical code past the row, 5 no EOL.
extern "C" int sleap_tiff_ccitt_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t width,
                                       int64_t rows, int64_t compression, int64_t options) {
  static const RunTables tables;
  FaxReader r{src, n, 0};
  std::vector<int> ref, changes;
  const int64_t stride = (width + 7) / 8;
  for (int64_t y = 0; y < rows; ++y) {
    int err;
    if (compression == 2) {
      err = fax_line_1d(r, tables, (int)width, changes);
      r.p = (r.p + 7) / 8 * 8;
    } else if (compression == 3) {
      if ((err = fax_eol(r))) return err;
      int one_d = 1;
      if (options & 1) {
        one_d = (int)r.peek(1);
        ++r.p;
      }
      err = one_d ? fax_line_1d(r, tables, (int)width, changes)
                  : fax_line_2d(r, tables, (int)width, ref, changes);
    } else {
      err = fax_line_2d(r, tables, (int)width, ref, changes);
    }
    if (err) return err;
    fax_write_row(changes, (int)width, dst + y * stride);
    ref.swap(changes);
  }
  return 0;
}
