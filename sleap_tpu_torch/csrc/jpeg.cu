// JPEG decoding as libjpeg-turbo decodes it (cv2.imdecode's defaults), and
// encoding as it encodes (cv2.imencode(".jpg") at quality 95), bit for bit:
// the Huffman entropy decoder and encoder in host C, and the inverse DCT
// (J1), the chroma upsampling and colour conversion (J2), the colour
// conversion and downsampling (J3), the forward DCT and quantisation (J4)
// and progressive JPEG's block smoothing (J6) hand-written for Hopper
// (sm_90a). Bound with ctypes from
// sleap_tpu_torch/io/jpeg.py, which holds the plain versions (Python entropy
// coding, PyTorch integer code for the rest) that these must equal.
//
// No TPU kernel has a counterpart: the JAX package decodes and encodes JPEG
// with cv2 on the host (sleap_tpu/io/video.py, HDF5Video.get_frame and
// Video.to_hdf5; sleap_tpu/io/slp.py; sleap_tpu/io/dirimgstore.py).
//
// - sleap_jpeg_decode_scan (host): one scan's entropy-coded data, unstuffed
//   a restart interval at a time into the caller's scratch buffer and read through a
//   32-bit window; a symbol is one lookup of the next 16 bits in a 65536-entry
//   table (length << 8 | symbol). Coefficients land de-zigzagged in the
//   caller's (pinned) int16 buffer, (blocks, 64), each component's blocks
//   row-major at its own offset.
// - sleap_jpeg_decode_progressive (host): one progressive scan as jdphuff.c
//   decodes it (DC first with its point transform, DC refinement, AC first
//   with end-of-band runs, AC refinement with correction bits), adding to the
//   coefficients the scans before it left in the same buffer; read as
//   sleap_jpeg_decode_scan reads. A restart resets the DC predictions and the
//   end-of-band run.
// - jpeg_idct_kernel (J1): dequantisation and jidctint.c's jpeg_idct_islow
//   with 64-bit sums (JLONG), the int workspace between the passes and the
//   10-bit post-IDCT range table. Eight threads a block of 8x8: pass 1 one
//   column each, through shared memory, pass 2 one row each, written as 8
//   bytes. Output (blocks, 8, 8) uint8: the component planes tiled in blocks,
//   each block's table picked by three component boundaries (up to four
//   components, CMYK's in one launch). Bound by bytes (192 a block in and
//   out); the 64-bit multiplies are a few hundred integer operations a block.
// - jpeg_color_kernel (J2): one thread an output pixel. Each component is
//   brought to full size as libjpeg-turbo's jinit_upsampler picks:
//   h2v1_fancy_upsample (3:1 on columns, rounding 1 / 2),
//   h2v2_fancy_upsample (3:1 on rows, then on columns, rounding 8 / 7) for
//   planes more than 2 samples wide, h1v2_fancy_upsample (4:4:0: 3:1 on
//   rows, rounding 1 / 2), else replication (4:1:1 and the rest:
//   int_upsample), edges replicated at the component's downsampled size.
//   Then the colour mode: gray copies Y; YCbCr converts with jdcolor.c's
//   integer tables computed inline (SCALEBITS 16) to BGR; RGB (Adobe
//   transform 0, ids 'R' 'G' 'B', JPEG-in-TIFF's RGB) is written B, G, R as
//   stored; CMYK (and YCCK, converted to R, G, B and inverted to C, M, Y)
//   goes through OpenCV's icvCvt_CMYK2BGR_8u_C4C3R to BGR. Bound by bytes:
//   the planes read, H*W*3 written.
// - jpeg_smooth_kernel (J6): jdcoefct.c's decompress_smooth_data, where
//   libjpeg-turbo's smoothing_ok holds (a progressive file whose scans leave
//   AC coefficients 1-9 short of full precision): one thread a block, which
//   copies its 64 coefficients and, for each of AC01, AC10, AC20, AC11, AC02
//   (and AC03, AC12, AC21, AC30 and the DC itself where the component has
//   no AC data yet) that is zero and not known exact, writes the estimate
//   from the 5 x 5 DC values around the block (64-bit sums, rounded to the
//   coefficient's quantisation step, capped below 1 << Al). Rows and columns
//   are clamped at the image's edge as libjpeg-turbo's sliding registers
//   and image_block_row test clamp them. Input and output are separate
//   buffers: a block's DC estimate must not reach its neighbours'. Bound by
//   bytes (256 a block in and out); the DC reads of the neighbours hit L1/L2.
// - jpeg_ycc_kernel (J3): gray or BGR uint8 -> the components' 8x8 blocks
//   (blocks, 64) uint8. Gray is one thread a sample of the padded plane.
//   Colour is one thread a chroma sample: jccolor.c's rgb_ycc_convert
//   (SCALEBITS 16; Y adds ONE_HALF, Cb and Cr CBCR_OFFSET + ONE_HALF - 1)
//   of the 2x2 pixels under it, h2v2_downsample's sum with its bias of 1 on
//   even and 2 on odd columns, and the up to four Y samples it covers. Edges
//   repeat as jcprepct.c and jcsample.c repeat them: the last column and row
//   of the frame, and the last chroma row down to whole MCUs. Bound by bytes.
// - jpeg_fdct_kernel (J4): the level shift, jfdctint.c's jpeg_fdct_islow
//   (CONST_BITS 13, PASS1_BITS 2, 16-bit DCTELEM between the passes) and
//   jcdctmgr.c's quantize with compute_reciprocal's tables, in unsigned 32
//   bits. Eight threads a block: pass 1 one row each, through shared memory,
//   pass 2 and the quantisation one column each. Output (blocks, 64) int16 in
//   natural order. Bound by bytes (192 a block in and out).
// - sleap_jpeg_encode_scan (host): jchuff.c's encode_one_block over the MCUs
//   in jccoefct.c's order, with its dummy blocks past Y's right and bottom
//   edges (no AC, the DC of the block before); 0xFF stuffed, the last byte
//   padded with 1-bits.
//
// All are the simple first design: no tiling of the chroma reads in shared
// memory, the frame copied back to the host.

#include <stdint.h>
#include <string.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "simple_idct.cuh"
#endif

namespace {

// Zigzag position -> natural index; 16 more entries of 63 catch a corrupt
// run length as libjpeg's jpeg_natural_order does.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kOk = 0, kBadCode = 1, kShortData = 2, kBadRestart = 3 };

// The entropy-coded bytes from data[pos] to the next marker, with 0xFF 0x00
// read as 0xFF; returns the marker's position, *n the bytes written.
int64_t unstuff(const uint8_t* data, int64_t size, int64_t pos, uint8_t* out, int64_t* n) {
  int64_t k = 0;
  while (pos < size) {
    const uint8_t b = data[pos];
    if (b == 0xFF && pos + 1 < size) {
      if (data[pos + 1] != 0) break;
      out[k++] = 0xFF;
      pos += 2;
      continue;
    }
    out[k++] = b;
    ++pos;
  }
  *n = k;
  return pos;
}

// The 32 stream bits from bit p on, first bit highest (the buffer holds 8
// zero bytes past its data).
inline uint32_t peek32(const uint8_t* buf, int64_t p) {
  const uint8_t* b = buf + (p >> 3);
  const uint32_t w = (uint32_t)b[0] << 24 | (uint32_t)b[1] << 16 | (uint32_t)b[2] << 8 | b[3];
  const uint32_t lo = b[4];
  const int s = (int)(p & 7);
  return s ? (w << s) | (lo >> (8 - s)) : w;
}

// The (length << 8 | symbol) of the code at bit p: from the 9-bit table
// `fast` when the code is that short (most are), else from the full one.
inline uint16_t lookup(const uint16_t* fast, const uint16_t* full, uint32_t bits) {
  const uint16_t look = fast[bits >> 23];
  return look ? look : full[bits >> 16];
}

// t bits from bit p as the JPEG "extend" rule reads a signed value.
inline int receive_extend(const uint8_t* buf, int64_t p, int t) {
  int v = (int)(peek32(buf, p) >> (32 - t));
  if (v < (1 << (t - 1))) v -= (1 << t) - 1;
  return v;
}

}  // namespace

// Entropy-decode one scan. luts: 2 * ncomp tables of 65536 uint16 (the DC
// tables of the scan's components, then their AC tables); info: per scan
// component (block offset, blocks a row, blocks across an MCU, down an MCU).
// A one-component scan walks the component's own blocks, mcux x mcuy of
// them. restart: MCUs per restart interval, 0 for none. Returns 0, or the
// error: 1 an invalid code, 2 data ending before the last block, 3 a
// restart marker missing or out of order. buf: scratch of at least
// size - start + 16 bytes, for the unstuffed data of an interval.
extern "C" int sleap_jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t start,
                                      const uint16_t* luts, int ncomp, const int32_t* info,
                                      int mcux, int mcuy, int restart, int16_t* coefs,
                                      uint8_t* buf) {
  const int64_t total = (int64_t)mcux * mcuy;
  const int64_t interval = restart > 0 ? restart : total;
  int64_t pos = start, mcu = 0, n_restarts = 0;
  int err = kOk;
  // 9-bit tables: the full table's entry where the code is at most 9 bits.
  uint16_t fast[8][512];
  for (int t = 0; t < 2 * ncomp && t < 8; ++t)
    for (int j = 0; j < 512; ++j) {
      const uint16_t look = luts[(int64_t)t * 65536 + (j << 7)];
      fast[t][j] = (look >> 8) <= 9 ? look : 0;
    }
  while (err == kOk) {
    int64_t n = 0;
    const int64_t end = unstuff(data, size, pos, buf, &n);
    memset(buf + n, 0, 16);
    const int64_t n_bits = 8 * n;
    int64_t p = 0;
    int preds[4] = {0, 0, 0, 0};
    const int64_t stop = mcu + interval < total ? mcu + interval : total;
    for (; mcu < stop && err == kOk; ++mcu) {
      const int64_t my = mcu / mcux, mx = mcu % mcux;
      for (int s = 0; s < ncomp && err == kOk; ++s) {
        const int32_t* ci = info + 4 * s;
        const uint16_t* dc = luts + (int64_t)s * 65536;
        const uint16_t* ac = luts + (int64_t)(ncomp + s) * 65536;
        for (int by = 0; by < ci[3] && err == kOk; ++by) {
          for (int bx = 0; bx < ci[2]; ++bx) {
            int16_t* block = coefs + 64 * ((int64_t)ci[0] + (my * ci[3] + by) * ci[1]
                                           + mx * ci[2] + bx);
            uint16_t look = lookup(fast[s], dc, peek32(buf, p));
            if (!look || (look & 0xFF) > 15) {
              err = kBadCode;
              break;
            }
            p += look >> 8;
            const int t = look & 0xFF;
            if (t) {
              preds[s] += receive_extend(buf, p, t);
              p += t;
            }
            block[0] = (int16_t)preds[s];
            for (int k = 1; k < 64;) {
              look = lookup(fast[ncomp + s], ac, peek32(buf, p));
              if (!look) {
                err = kBadCode;
                break;
              }
              p += look >> 8;
              const int r = (look >> 4) & 15, u = look & 15;
              if (u) {
                k += r;
                block[kNatural[k]] = (int16_t)receive_extend(buf, p, u);
                p += u;
                ++k;
              } else if (r == 15) {
                k += 16;
              } else {
                break;
              }
            }
            if (err) break;
          }
        }
      }
    }
    if (err) break;
    if (p > n_bits) {
      err = kShortData;
      break;
    }
    pos = end;
    if (mcu == total) break;
    // Restart: the next interval starts after RSTn, n counting 0..7.
    while (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] != 0xD0 + (n_restarts % 8)) {
      err = kBadRestart;
      break;
    }
    pos += 2;
    ++n_restarts;
  }
  return err;
}

// Entropy-decode one progressive scan (jdphuff.c's decode_mcu_DC_first,
// _DC_refine, _AC_first and _AC_refine) into coefs, which holds what the
// scans before it decoded. luts: ncomp tables of 65536 uint16, the DC tables
// of a DC-first scan or the one AC table of an AC scan (none for a DC
// refinement); info, mcux, mcuy and restart as sleap_jpeg_decode_scan's;
// ss, se, ah, al the scan's band and successive-approximation bits. Returns
// sleap_jpeg_decode_scan's errors.
extern "C" int sleap_jpeg_decode_progressive(const uint8_t* data, int64_t size, int64_t start,
                                             const uint16_t* luts, int ncomp, const int32_t* info,
                                             int mcux, int mcuy, int restart, int ss, int se,
                                             int ah, int al, int16_t* coefs, uint8_t* buf) {
  const int64_t total = (int64_t)mcux * mcuy;
  const int64_t interval = restart > 0 ? restart : total;
  const int p1 = 1 << al, m1 = -(1 << al);
  const bool dc = ss == 0, refine = ah != 0;
  int64_t pos = start, mcu = 0, n_restarts = 0;
  int err = kOk;
  while (err == kOk) {
    int64_t n = 0;
    const int64_t end = unstuff(data, size, pos, buf, &n);
    memset(buf + n, 0, 16);
    const int64_t n_bits = 8 * n;
    int64_t p = 0;
    int preds[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    auto bits = [&](int t) {
      const int v = t ? (int)(peek32(buf, p) >> (32 - t)) : 0;
      p += t;
      return v;
    };
    auto symbol = [&](const uint16_t* table, int* out) {
      if (p > n_bits) return kShortData;
      const uint16_t look = table[peek32(buf, p) >> 16];
      if (!look) return kBadCode;
      p += look >> 8;
      *out = look & 0xFF;
      return kOk;
    };
    auto correct = [&](int16_t* block, int k) {  // a correction bit for a nonzero coefficient
      int16_t* c = block + kNatural[k];
      if (bits(1) && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
    };
    const int64_t stop = mcu + interval < total ? mcu + interval : total;
    for (; mcu < stop && err == kOk; ++mcu) {
      const int64_t my = mcu / mcux, mx = mcu % mcux;
      for (int s = 0; s < ncomp && err == kOk; ++s) {
        const int32_t* ci = info + 4 * s;
        const uint16_t* table = luts + (int64_t)s * 65536;
        for (int by = 0; by < ci[3] && err == kOk; ++by) {
          for (int bx = 0; bx < ci[2] && err == kOk; ++bx) {
            int16_t* block = coefs + 64 * ((int64_t)ci[0] + (my * ci[3] + by) * ci[1]
                                           + mx * ci[2] + bx);
            if (dc && !refine) {
              int t = 0;
              if ((err = symbol(table, &t)) != kOk) break;
              if (t > 15) {
                err = kBadCode;
                break;
              }
              if (t) {
                int v = bits(t);
                if (v < (1 << (t - 1))) v -= (1 << t) - 1;
                preds[s] += v;
              }
              block[0] = (int16_t)(int)((unsigned)preds[s] << al);
            } else if (dc) {
              if (bits(1)) block[0] = (int16_t)(block[0] | p1);
            } else if (!refine) {
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              for (int k = ss; k <= se; ++k) {
                int rs = 0;
                if ((err = symbol(table, &rs)) != kOk) break;
                const int r = rs >> 4, t = rs & 15;
                if (t) {
                  k += r;
                  int v = bits(t);
                  if (v < (1 << (t - 1))) v -= (1 << t) - 1;
                  block[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = (1u << r) + (unsigned)bits(r) - 1;
                  break;
                }
              }
            } else {
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = 0;
                  if ((err = symbol(table, &rs)) != kOk) break;
                  int r = rs >> 4, t = rs & 15;
                  if (t) {
                    t = bits(1) ? p1 : m1;  // a newly nonzero coefficient
                  } else if (r != 15) {
                    eobrun = (1u << r) + (unsigned)bits(r);
                    break;
                  }
                  // Past r zero coefficients, correcting the nonzero ones.
                  do {
                    if (block[kNatural[k]] != 0) {
                      correct(block, k);
                    } else if (--r < 0) {
                      break;
                    }
                    ++k;
                  } while (k <= se);
                  if (t) block[kNatural[k]] = (int16_t)t;
                }
                if (err) break;
              }
              if (eobrun > 0) {
                for (; k <= se; ++k)
                  if (block[kNatural[k]] != 0) correct(block, k);
                --eobrun;
              }
            }
          }
        }
      }
    }
    if (err) break;
    if (p > n_bits) {
      err = kShortData;
      break;
    }
    pos = end;
    if (mcu == total) break;
    while (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] != 0xD0 + (n_restarts % 8)) {
      err = kBadRestart;
      break;
    }
    pos += 2;
    ++n_restarts;
  }
  return err;
}

// Huffman-encode one frame's quantised coefficients ((blocks, 64) int16,
// natural order) as one interleaved scan (one component: its own blocks).
// info: per component (block offset, blocks a row, block rows, blocks across
// an MCU, down an MCU, table 0 or 1). codes: int32 (4, 2, 256), the code and
// code length of each symbol of DC0, AC0, DC1, AC1. Writes at most capacity
// bytes to out and their count to *written; returns 0, or 1 when out is too
// small.
extern "C" int sleap_jpeg_encode_scan(const int16_t* coefs, int ncomp, const int32_t* info,
                                      int mcux, int mcuy, const int32_t* codes, uint8_t* out,
                                      int64_t capacity, int64_t* written) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t pos = 0;
  bool full = false;
  auto put = [&](uint32_t code, int size) {
    acc = (acc << size) | code;
    nacc += size;
    while (nacc >= 8) {
      nacc -= 8;
      const uint8_t b = (uint8_t)(acc >> nacc);
      if (pos + 2 > capacity) {
        full = true;
        return;
      }
      out[pos++] = b;
      if (b == 0xFF) out[pos++] = 0;
    }
  };
  auto bits = [](int v) {
    int t = v < 0 ? -v : v, n = 0;
    while (t) {
      ++n;
      t >>= 1;
    }
    return n;
  };
  int last[4] = {0, 0, 0, 0};
  for (int my = 0; my < mcuy && !full; ++my) {
    for (int mx = 0; mx < mcux && !full; ++mx) {
      int dc = 0;
      for (int s = 0; s < ncomp; ++s) {
        const int32_t* ci = info + 6 * s;
        const int32_t* dco = codes + 2 * 256 * (2 * ci[5]);
        const int32_t* aco = codes + 2 * 256 * (2 * ci[5] + 1);
        for (int uy = 0; uy < ci[4]; ++uy) {
          for (int ux = 0; ux < ci[3]; ++ux) {
            const int by = my * ci[4] + uy, bx = mx * ci[3] + ux;
            const int16_t* block = nullptr;
            if (by < ci[2] && bx < ci[1]) {
              block = coefs + 64 * ((int64_t)ci[0] + (int64_t)by * ci[1] + bx);
              dc = block[0];
            }  // else a dummy block: the DC before it, no AC
            const int diff = dc - last[s];
            last[s] = dc;
            int n = bits(diff);
            put((uint32_t)dco[n], dco[256 + n]);
            if (n) put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << n) - 1), n);
            int run = 0;
            if (block) {
              for (int k = 1; k < 64; ++k) {
                const int v = block[kNatural[k]];
                if (v == 0) {
                  ++run;
                  continue;
                }
                while (run > 15) {
                  put((uint32_t)aco[0xF0], aco[256 + 0xF0]);
                  run -= 16;
                }
                n = bits(v);
                const int sym = (run << 4) | n;
                put((uint32_t)aco[sym], aco[256 + sym]);
                put((uint32_t)(v < 0 ? v - 1 : v) & ((1u << n) - 1), n);
                run = 0;
              }
            }
            if (run || !block) put((uint32_t)aco[0], aco[256]);
          }
        }
      }
    }
  }
  if (nacc && !full) put((1u << (8 - nacc)) - 1, 8 - nacc);
  *written = pos;
  return full ? 1 : 0;
}

#ifdef __CUDACC__

namespace {

constexpr int kBlocksPerCta = 32;  // 8x8 blocks per thread block, 8 threads each

// One 1-D pass of jpeg_idct_islow on x[0..7] (JLONG arithmetic), descaled
// by `shift` with rounding.
__device__ __forceinline__ void idct_1d(const int64_t (&x)[8], int64_t (&o)[8], int shift) {
  int64_t z1 = (x[2] + x[6]) * 4433;
  const int64_t tmp2 = z1 - x[6] * 15137;
  const int64_t tmp3 = z1 + x[2] * 6270;
  const int64_t tmp0 = (x[0] + x[4]) * 8192;
  const int64_t tmp1 = (x[0] - x[4]) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = (int64_t)1 << (shift - 1);
  o[0] = (tmp10 + t3 + half) >> shift;
  o[7] = (tmp10 - t3 + half) >> shift;
  o[1] = (tmp11 + t2 + half) >> shift;
  o[6] = (tmp11 - t2 + half) >> shift;
  o[2] = (tmp12 + t1 + half) >> shift;
  o[5] = (tmp12 - t1 + half) >> shift;
  o[3] = (tmp13 + t0 + half) >> shift;
  o[4] = (tmp13 - t0 + half) >> shift;
}

__global__ void __launch_bounds__(kBlocksPerCta * 8)
jpeg_idct_kernel(const int16_t* __restrict__ coefs, int64_t blocks,
                 const int32_t* __restrict__ quant, int64_t end0, int64_t end1,
                 int64_t end2, uint8_t* __restrict__ out) {
  __shared__ int32_t ws[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < blocks;
  if (live) {
    const int comp = b < end0 ? 0 : (b < end1 ? 1 : (b < end2 ? 2 : 3));
    const int16_t* c = coefs + 64 * b;
    const int32_t* q = quant + 64 * comp;
    int64_t x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (int64_t)c[8 * k + lane] * q[8 * k + lane];
    idct_1d(x, o, 11);  // pass 1: column `lane`
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[local][8 * k + lane] = (int32_t)o[k];
  }
  __syncthreads();
  if (live) {
    int64_t x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = ws[local][8 * lane + k];
    idct_1d(x, o, 18);  // pass 2: row `lane`
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int64_t v = ((o[k] + 512) & 1023) - 512 + 128;  // the 10-bit range table
      v = v < 0 ? 0 : (v > 255 ? 255 : v);
      if (k < 4) lo |= (uint32_t)v << (8 * k);
      else hi |= (uint32_t)v << (8 * (k - 4));
    }
    *reinterpret_cast<uint2*>(out + 64 * b + 8 * lane) = make_uint2(lo, hi);
  }
}

// J5: dequantisation and the inverse DCT of FFmpeg's Motion-JPEG decoder as
// OpenCV's FFmpeg backend runs it (libavcodec's simple IDCT on x86-64),
// fitted to its recorded decodes: constants W1..W7 (cos(k pi / 16) sqrt(2)
// 2^14, W4 = 16383), rows first (shift 11, saturated to int16; a row whose
// AC terms are all zero is its DC times 8, wrapped to 16 bits), then
// columns (the rounding 32 added to the DC term in 16 bits, shift 20,
// clipped to 0-255). AC coefficients are dequantised with a 16-bit wrap;
// the DC carries the level shift (+1024) and saturates. Sums wrap at 32
// bits, so the arithmetic is unsigned.
__global__ void __launch_bounds__(kBlocksPerCta * 8)
jpeg_idct_ffmpeg_kernel(const int16_t* __restrict__ coefs, int64_t blocks,
                        const int32_t* __restrict__ quant, int64_t end0, int64_t end1,
                        uint8_t* __restrict__ out) {
  __shared__ int16_t ws[kBlocksPerCta][64];
  __shared__ __align__(8) uint8_t px[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < blocks;
  if (live) {  // pass 1: row `lane`
    const int comp = b < end0 ? 0 : (b < end1 ? 1 : 2);
    const int16_t* c = coefs + 64 * b + 8 * lane;
    const int32_t* q = quant + 64 * comp + 8 * lane;
    int32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int32_t v = (int32_t)c[k] * q[k];
      x[k] = (lane == 0 && k == 0) ? sat16(v + 1024) : wrap16((uint32_t)v);
    }
    simple_row(x, &ws[local][8 * lane]);
  }
  __syncthreads();
  if (live) {  // pass 2: column `lane`
    int32_t v[8];
    simple_column(ws[local], lane, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) px[local][8 * k + lane] = clamp255(v[k]);
  }
  __syncthreads();
  if (live)
    *reinterpret_cast<uint2*>(out + 64 * b + 8 * lane) =
        *reinterpret_cast<const uint2*>(&px[local][8 * lane]);
}

// jccolor.c's rgb_ycc_convert of one BGR pixel.
__device__ __forceinline__ void ycc(const uint8_t* __restrict__ p, int& y, int& cb, int& cr) {
  const int b = p[0], g = p[1], r = p[2];
  y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
  cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
  cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
}

// The byte of sample (y, x) of a plane of blocks_w blocks a row, tiled in
// 8x8 blocks from block `offset`.
__device__ __forceinline__ int64_t tile(int64_t offset, int blocks_w, int y, int x) {
  return 64 * (offset + (int64_t)(y >> 3) * blocks_w + (x >> 3)) + 8 * (y & 7) + (x & 7);
}

__global__ void jpeg_ycc_kernel(const uint8_t* __restrict__ img, int H, int W, int ncomp, int bw,
                                int bh, int mcux, int mcuy, uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ncomp == 1) {
    const int64_t cols = 8 * (int64_t)bw;
    if (i >= cols * 8 * bh) return;
    const int y = (int)(i / cols), x = (int)(i % cols);
    out[tile(0, bw, y, x)] = img[(int64_t)min(y, H - 1) * W + min(x, W - 1)];
    return;
  }
  const int64_t cols = 8 * (int64_t)mcux;
  if (i >= cols * 8 * mcuy) return;
  const int cy = (int)(i / cols), cx = (int)(i % cols);
  // Y: the 2x2 samples under this chroma sample that lie in Y's blocks.
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int y = 2 * cy + dy, x = 2 * cx + dx;
      if (y < 8 * bh && x < 8 * bw) {
        const uint8_t* p = img + 3 * ((int64_t)min(y, H - 1) * W + min(x, W - 1));
        out[tile(0, bw, y, x)] = (uint8_t)((19595 * p[2] + 38470 * p[1] + 7471 * p[0] + 32768) >> 16);
      }
    }
  }
  // Chroma: rows past the downsampled height repeat its last row.
  const int sy = min(cy, (H + 1) / 2 - 1);
  const int r0 = min(2 * sy, H - 1), r1 = min(2 * sy + 1, H - 1);
  const int c0 = min(2 * cx, W - 1), c1 = min(2 * cx + 1, W - 1);
  int yy, cb, cr, sb = 0, sr = 0;
  const int rows[2] = {r0, r1}, cs[2] = {c0, c1};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      ycc(img + 3 * ((int64_t)rows[a] * W + cs[b]), yy, cb, cr);
      sb += cb;
      sr += cr;
    }
  }
  const int bias = 1 + (cx & 1);
  const int64_t cb_off = (int64_t)bw * bh, cr_off = cb_off + (int64_t)mcux * mcuy;
  out[tile(cb_off, mcux, cy, cx)] = (uint8_t)((sb + bias) >> 2);
  out[tile(cr_off, mcux, cy, cx)] = (uint8_t)((sr + bias) >> 2);
}

// One 1-D pass of jpeg_fdct_islow on d[0..7] (JLONG arithmetic): pass 1
// scales by 2^PASS1_BITS, pass 2 removes it.
__device__ __forceinline__ void fdct_1d(const int64_t (&d)[8], int64_t (&o)[8], bool pass1) {
  const int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  const int64_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  const int64_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int n = pass1 ? 11 : 15;
  const int64_t half = (int64_t)1 << (n - 1);
  if (pass1) {
    o[0] = (tmp10 + tmp11) * 4;
    o[4] = (tmp10 - tmp11) * 4;
  } else {
    o[0] = (tmp10 + tmp11 + 2) >> 2;
    o[4] = (tmp10 - tmp11 + 2) >> 2;
  }
  int64_t z1 = (tmp12 + tmp13) * 4433;
  o[2] = (z1 + tmp13 * 6270 + half) >> n;
  o[6] = (z1 - tmp12 * 15137 + half) >> n;
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int64_t z5 = (z3 + z4) * 9633;
  const int64_t t4 = tmp4 * 2446, t5 = tmp5 * 16819, t6 = tmp6 * 25172, t7 = tmp7 * 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  o[7] = (t4 + z1 + z3 + half) >> n;
  o[5] = (t5 + z2 + z4 + half) >> n;
  o[3] = (t6 + z2 + z3 + half) >> n;
  o[1] = (t7 + z1 + z4 + half) >> n;
}

__global__ void __launch_bounds__(kBlocksPerCta * 8)
jpeg_fdct_kernel(const uint8_t* __restrict__ samples, int64_t blocks,
                 const int32_t* __restrict__ divs, int64_t end0, int16_t* __restrict__ out) {
  __shared__ int16_t ws[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < blocks;
  if (live) {
    const uint8_t* s = samples + 64 * b + 8 * lane;
    int64_t x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (int64_t)s[k] - 128;
    fdct_1d(x, o, true);  // pass 1: row `lane`
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[local][8 * lane + k] = (int16_t)o[k];
  }
  __syncthreads();
  if (live) {
    int64_t x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = ws[local][8 * k + lane];
    fdct_1d(x, o, false);  // pass 2: column `lane`
    const int32_t* d = divs + (b < end0 ? 0 : 3 * 64);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 8 * k + lane;
      const int v = (int16_t)o[k];
      const uint32_t recip = (uint32_t)d[i], corr = (uint32_t)d[64 + i];
      const int shift = d[128 + i];
      const uint32_t q = ((uint32_t)(v < 0 ? -v : v) + corr) * recip >> (shift + 16);
      out[64 * b + i] = (int16_t)(v < 0 ? -(int)q : (int)q);
    }
  }
}

struct Comp {
  int offset, blocks_w, width, height, hs, vs, method;
};

enum { kReplicate = 0, kH2V1 = 1, kH2V2 = 2, kH1V2 = 3 };
enum { kGray = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };

__device__ __forceinline__ int sample(const uint8_t* __restrict__ s, const Comp& c, int y, int x) {
  return s[64 * ((int64_t)c.offset + (int64_t)(y >> 3) * c.blocks_w + (x >> 3)) + 8 * (y & 7)
           + (x & 7)];
}

// A component's sample at output pixel (y, x), upsampled by the method
// libjpeg-turbo's jinit_upsampler picks for it (io/jpeg.py's upsampling).
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ s, const Comp& c, int y, int x) {
  if (c.method == kH1V2) {
    const int cy = y >> 1, odd = y & 1;
    const int ny = odd ? min(cy + 1, c.height - 1) : max(cy - 1, 0);
    return (3 * sample(s, c, cy, x) + sample(s, c, ny, x) + 1 + odd) >> 2;
  }
  if (c.method == kReplicate) return sample(s, c, y / c.vs, x / c.hs);
  const int cx = x >> 1, odd = x & 1;
  const int nx = odd ? min(cx + 1, c.width - 1) : max(cx - 1, 0);
  if (c.method == kH2V1) return (3 * sample(s, c, y, cx) + sample(s, c, y, nx) + 1 + odd) >> 2;
  const int cy = y >> 1;
  const int ny = (y & 1) ? min(cy + 1, c.height - 1) : max(cy - 1, 0);
  const int here = 3 * sample(s, c, cy, cx) + sample(s, c, ny, cx);
  const int next = 3 * sample(s, c, cy, nx) + sample(s, c, ny, nx);
  return (3 * here + next + 8 - odd) >> 4;
}

__global__ void jpeg_color_kernel(const uint8_t* __restrict__ s, int mode, int H, int W, Comp c0,
                                  Comp c1, Comp c2, Comp c3, uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)H * W) return;
  const int y = (int)(i / W), x = (int)(i % W);
  const int v0 = upsampled(s, c0, y, x);
  if (mode == kGray) {
    out[i] = (uint8_t)v0;
    return;
  }
  const int v1 = upsampled(s, c1, y, x), v2 = upsampled(s, c2, y, x);
  int r = v0, g = v1, b = v2;
  if (mode != kRgb && mode != kCmyk) {  // YCbCr (of YCCK too) to R, G, B
    const int cb = v1 - 128, cr = v2 - 128;
    r = clamp255(v0 + ((91881 * cr + 32768) >> 16));
    g = clamp255(v0 + ((-22554 * cb - 46802 * cr + 32768) >> 16));
    b = clamp255(v0 + ((116130 * cb + 32768) >> 16));
  }
  if (mode == kCmyk || mode == kYcck) {  // OpenCV's CMYK -> BGR
    const int k = upsampled(s, c3, y, x);
    const int c = mode == kCmyk ? v0 : 255 - r, m = mode == kCmyk ? v1 : 255 - g,
              ye = mode == kCmyk ? v2 : 255 - b;
    r = k - (((255 - c) * k) >> 8);
    g = k - (((255 - m) * k) >> 8);
    b = k - (((255 - ye) * k) >> 8);
  }
  out[3 * i + 0] = clamp255(b);
  out[3 * i + 1] = clamp255(g);
  out[3 * i + 2] = clamp255(r);
}

// J6's arguments per component (io/jpeg.py's smooth_params): block offset,
// blocks a row of the buffer, blocks across and down the image, block rows
// an iMCU row, iMCU rows, coef_bits of zigzag coefficients 1-9, quantisation
// values of coefficients 0-9, block rows of the buffer (a row past them,
// which a lone component's iMCU rows can name, reads as zeros).
struct SmoothComp {
  int offset, blocks_w, wib, hib, v, total, bits[9], q[10], blocks_h;
};
struct SmoothArgs {
  SmoothComp c[4];
  int ncomp;
};

// Natural positions of zigzag coefficients 1-9, and each estimate's weights
// on the 5 x 5 DC values (rows above to below, columns left to right):
// with DC interpolation (AC01..AC30, then the DC), and without (AC01..AC02).
__constant__ int kSmoothPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
__constant__ int16_t kWChangeDc[10][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0},
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2}};
__constant__ int8_t kWAc[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

// decompress_smooth_data's pred: |num| rounded to a multiple of q << 8,
// capped below 1 << al where al > 0, with num's sign.
__device__ __forceinline__ int64_t smooth_estimate(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (al > 0 && pred >= ((int64_t)1 << al)) pred = ((int64_t)1 << al) - 1;
  return num < 0 ? -pred : pred;
}

__global__ void __launch_bounds__(128)
jpeg_smooth_kernel(const int16_t* __restrict__ in, int64_t blocks, SmoothArgs a,
                   int16_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  int ci = 0;
  while (ci + 1 < a.ncomp && b >= a.c[ci + 1].offset) ++ci;
  const SmoothComp& c = a.c[ci];
  const int64_t base = 64 * b;
  const int4* src = reinterpret_cast<const int4*>(in + base);
  int4* dst = reinterpret_cast<int4*>(out + base);
  for (int k = 0; k < 8; ++k) dst[k] = src[k];
  const int64_t local = b - c.offset;
  const int row = (int)(local / c.blocks_w), col = (int)(local % c.blocks_w);
  if (row >= c.hib || col >= c.wib) return;
  // The rows decompress_smooth_data reads: its image_block_row counts the
  // last iMCU row's rows as if every iMCU row had as many.
  const int imcu = row / c.v, br = row % c.v;
  const int rows_here = imcu < c.total - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
  const int ibr = imcu * rows_here + br, ibrs = rows_here * c.total;
  int r5[5];
  r5[2] = row;
  r5[1] = ibr > 0 ? row - 1 : row;
  r5[0] = ibr > 1 ? row - 2 : r5[1];
  r5[3] = ibr < ibrs - 1 ? row + 1 : row;
  r5[4] = ibr < ibrs - 2 ? row + 2 : r5[3];
  int dc[25];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 5; ++j) {
      const int x = min(max(col + j - 2, 0), c.wib - 1);
      dc[5 * i + j] =
          r5[i] < c.blocks_h ? in[64 * ((int64_t)c.offset + (int64_t)r5[i] * c.blocks_w + x)] : 0;
    }
  }
  bool change_dc = true;
  for (int k = 0; k < 9; ++k) change_dc &= c.bits[k] == -1;
  const int n_ac = change_dc ? 9 : 5;
  for (int k = 0; k < n_ac; ++k) {
    const int al = c.bits[k], pos = kSmoothPos[k];
    if (al == 0 || in[base + pos] != 0) continue;
    int64_t sum = 0;
    for (int j = 0; j < 25; ++j) sum += (int64_t)(change_dc ? kWChangeDc[k][j] : kWAc[k][j]) * dc[j];
    out[base + pos] = (int16_t)smooth_estimate((int64_t)c.q[0] * sum, c.q[k + 1], al);
  }
  if (change_dc) {
    int64_t sum = 0;
    for (int j = 0; j < 25; ++j) sum += (int64_t)kWChangeDc[9][j] * dc[j];
    out[base] = (int16_t)smooth_estimate((int64_t)c.q[0] * sum, c.q[0], 0);
  }
}

}  // namespace

// J1: (blocks, 64) int16 coefficients, (components, 64) int32 quant tables;
// blocks below end0 are component 0, below end1 component 1, below end2
// component 2, the rest 3.
extern "C" int sleap_jpeg_idct(const void* coefs, int64_t blocks, const void* quant, int64_t end0,
                               int64_t end1, int64_t end2, void* out, void* stream) {
  if (blocks <= 0) return 0;
  const int64_t grid = (blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_idct_kernel<<<(unsigned)grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, blocks, (const int32_t*)quant, end0, end1, end2, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// J5: FFmpeg's dequantisation and IDCT, J1's layout; Motion-JPEG frames are
// gray or YCbCr, so blocks map to three tables by two boundaries.
extern "C" int sleap_jpeg_idct_ffmpeg(const void* coefs, int64_t blocks, const void* quant,
                                      int64_t end0, int64_t end1, void* out, void* stream) {
  if (blocks <= 0) return 0;
  const int64_t grid = (blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_idct_ffmpeg_kernel<<<(unsigned)grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, blocks, (const int32_t*)quant, end0, end1, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// J2: the (blocks, 8, 8) samples of J1 -> (H, W) or (H, W, 3) BGR uint8, in
// colour mode `mode` (0 gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK). Per component
// (four; unused ones repeat the first): block offset, blocks a row,
// downsampled width and height, the horizontal and vertical upsampling
// factors and the upsampling method (0 replication, 1 h2v1, 2 h2v2 and 3
// h1v2 fancy).
extern "C" int sleap_jpeg_color(const void* samples, int mode, int H, int W,
                                int o0, int b0, int w0, int h0, int hs0, int vs0, int m0,
                                int o1, int b1, int w1, int h1, int hs1, int vs1, int m1,
                                int o2, int b2, int w2, int h2, int hs2, int vs2, int m2,
                                int o3, int b3, int w3, int h3, int hs3, int vs3, int m3,
                                void* out, void* stream) {
  const int64_t n = (int64_t)H * W;
  if (n <= 0) return 0;
  const int threads = 256;
  const Comp c0{o0, b0, w0, h0, hs0, vs0, m0}, c1{o1, b1, w1, h1, hs1, vs1, m1},
      c2{o2, b2, w2, h2, hs2, vs2, m2}, c3{o3, b3, w3, h3, hs3, vs3, m3};
  jpeg_color_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)samples, mode, H, W, c0, c1, c2, c3, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// J6: (blocks, 64) int16 coefficients -> smoothed ones in `out`; params: the
// host's (ncomp, 32) int32 rows of io/jpeg.py's smooth_params.
extern "C" int sleap_jpeg_smooth(const void* coefs, int64_t blocks, const void* params, int ncomp,
                                 void* out, void* stream) {
  if (blocks <= 0) return 0;
  if (ncomp < 1 || ncomp > 4) return (int)cudaErrorInvalidValue;
  SmoothArgs a{};
  const int32_t* p = (const int32_t*)params;
  for (int ci = 0; ci < ncomp; ++ci, p += 32) {
    SmoothComp& c = a.c[ci];
    c.offset = p[0];
    c.blocks_w = p[1];
    c.wib = p[2];
    c.hib = p[3];
    c.v = p[4];
    c.total = p[5];
    for (int k = 0; k < 9; ++k) c.bits[k] = p[6 + k];
    for (int k = 0; k < 10; ++k) c.q[k] = p[15 + k];
    c.blocks_h = p[25];
  }
  a.ncomp = ncomp;
  const int threads = 128;
  jpeg_smooth_kernel<<<(unsigned)((blocks + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>((const int16_t*)coefs, blocks, a, (int16_t*)out);
  return (int)cudaGetLastError();
}

// J3: (H, W) gray or (H, W, 3) BGR uint8 -> (blocks, 64) uint8: Y's bw x bh
// blocks, then (colour) Cb's and Cr's mcux x mcuy.
extern "C" int sleap_jpeg_ycc(const void* img, int H, int W, int ncomp, int bw, int bh, int mcux,
                              int mcuy, void* out, void* stream) {
  const int64_t n = ncomp == 1 ? 64 * (int64_t)bw * bh : 64 * (int64_t)mcux * mcuy;
  if (n <= 0) return 0;
  const int threads = 256;
  jpeg_ycc_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, H, W, ncomp, bw, bh, mcux, mcuy, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// J4: (blocks, 64) uint8 samples -> (blocks, 64) int16 coefficients; divs:
// int32 (2, 3, 64) reciprocals, corrections and shifts of the two tables;
// blocks below end0 use table 0, the rest table 1.
extern "C" int sleap_jpeg_fdct(const void* samples, int64_t blocks, const void* divs, int64_t end0,
                               void* out, void* stream) {
  if (blocks <= 0) return 0;
  const int64_t grid = (blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_fdct_kernel<<<(unsigned)grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)samples, blocks, (const int32_t*)divs, end0, (int16_t*)out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
