// MPEG-4 Part 2 (the I-, P- and B-VOPs of the Simple and Advanced Simple
// Profiles' tools) decoding as OpenCV's FFmpeg backend decodes it, bit for
// bit: the macroblock layer's entropy decoder in host C and the
// reconstruction kernels M1, M2 and M3 hand-written for Hopper (sm_90a), each
// in two instantiations: FFmpeg's simple IDCT (simple_idct.cuh) or Xvid's
// (xvid_idct.cuh), which FFmpeg runs for streams an Xvid build wrote. Bound
// with ctypes from sleap_tpu_torch/io/mpeg4.py, which holds the plain
// versions (the Python entropy decoder, PyTorch integer code for M1, M2 and
// M3) that these must equal.
//
// No TPU kernel has a counterpart: the JAX package decodes videos with cv2 on
// the host (sleap_tpu/io/video.py, MediaVideo).
//
// - sleap_mpeg4_decode_vop (host): every macroblock of one VOP from the bit
//   after its header, as FFmpeg's mpeg4_decode_mb and mpeg4_decode_block
//   decode them: MCBPC (with stuffing), CBPY, DQUANT, the motion vectors
//   (one, or four in a 4MV macroblock: ff_h263_pred_motion's median,
//   ff_h263_decode_motion's f_code wrap; apply_8x8's clips and
//   ff_h263_round_chroma for a 4MV macroblock's jobs), the
//   intra DC (its VLC, or a TCOEF where intra_dc_vlc_thr says so) and its
//   prediction with FFmpeg's clip of the stored value, TCOEF run-levels with
//   the three escapes, AC prediction (rescaled across quantisers with
//   ROUNDED_DIV) and H.263 or MPEG dequantisation (the latter in 16-bit
//   lanes, as FFmpeg's x86 code). A B-VOP (decode_b): macroblocks whose
//   co-located one the future reference skipped are skipped unread; MODB,
//   MB_TYPE, CBPB, DBQUANT, forward and backward vectors predicted from the
//   last of their direction, direct mode's delta over the co-located
//   vectors scaled by pb_time / pp_time (ff_mpeg4_set_direct_mv). An I- or
//   P-VOP returns its co-located macroblocks (skipped, four vectors, intra,
//   and motion_val's four vectors once decoded) for the B-VOPs after it. A
//   symbol is one lookup of the next bits (up to 13) in a table of (symbol
//   << 8 | length). Output: the dequantised blocks (rows of 64 int16, raster
//   order) and one job an 8x8 block for each kernel (below). Errors return
//   1-6 (an invalid code, the data ends inside a macroblock, more than 64
//   coefficients, a marker bit missing, an escape after an escape, a video
//   packet header of another prefix or macroblock). Video packets: after each
//   macroblock, where the VOL enables resync markers, a marker and its
//   header (ff_mpeg4_decode_video_packet_header) start a packet, whose first
//   row sees no neighbour outside it (decode_slice's first_slice_line in DC
//   and vector prediction) and whose start clears the AC predictors around
//   it (ff_mpeg4_clean_buffers), and a B-VOP's vector predictors.
// - mpeg4_intra_kernel (M1): the IDCT "put" of intra blocks. Eight threads a
//   block: pass 1 one row each, through shared memory, pass 2 one column
//   each, the block written as eight 8-byte rows into its plane. Job: (mb *
//   6 + block, coefficient row, 0, 0). Bound by bytes (128 in, 64 out a
//   block).
// - mpeg4_inter_kernel (M2): an inter or skipped block: the half-pel
//   prediction from the reference plane, (a + b + 1 - r) >> 1 and (a + b + c +
//   d + 2 - r) >> 2 with vop_rounding_type r, every sample position clamped
//   to the padded plane (FFmpeg's emulated_edge_mc at the macroblock-padded
//   h_edge_pos and v_edge_pos); in the blocks FFmpeg moves with its 8-wide
//   functions (chroma, a 4MV macroblock's luma: the job's kNarrow flag) at
//   r = 1 the x and y halves take the rounding of the MMXEXT
//   put_no_rnd_pixels8_x2/_y2 that FFmpeg installs without
//   AV_CODEC_FLAG_BITEXACT (the left sample, and each odd row of the pair,
//   lowered by one with saturation before a rounding average); then the
//   IDCT residual (where the job has one) added with saturation. Job: (mb *
//   6 + block | kNarrow, coefficient row or -1, vector x, vector y), the
//   vector in half samples of the block's own plane, relative to the block.
//   Bound by bytes.
// - mpeg4_bidir_kernel (M3): a B-VOP's block: the forward prediction from
//   the past reference, the backward one from the future reference, or both
//   averaged as (f + b + 1) >> 1 (FFmpeg's put then avg_pixels, exact at
//   rounding 0 in its 16- and 8-wide forms), each as M2's at r = 0; then the
//   residual. Job: 8 int32 (mb * 6 + block, coefficient row or -1, forward
//   x, y, backward x, y, directions 1 forward / 2 backward / 3 both, 0).
//   Bound by bytes.
//
// The kernels are the simple first design: one launch each a VOP, no tiling
// of the reference reads.

#include <stdint.h>
#include <string.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "simple_idct.cuh"
#include "xvid_idct.cuh"
#endif

namespace {

struct Code {
  uint16_t code;
  uint8_t length;
};

// Annex B's and H.263's tables, as io/mpeg4.py's (the escape is each TCOEF
// table's last code; intra codes from 67 and inter codes from 58 are "last").
const Code kIntraVlc[103] = {{2, 2}, {6, 3}, {15, 4}, {13, 5}, {12, 5}, {21, 6}, {19, 6}, {18, 6},
    {23, 7}, {31, 8}, {30, 8}, {29, 8}, {37, 9}, {36, 9}, {35, 9}, {33, 9}, {33, 10}, {32, 10},
    {15, 10}, {14, 10}, {7, 11}, {6, 11}, {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12},
    {14, 4}, {20, 6}, {22, 7}, {28, 8}, {32, 9}, {31, 9}, {13, 10}, {34, 11}, {83, 12}, {85, 12},
    {11, 5}, {21, 7}, {30, 9}, {12, 10}, {86, 12}, {17, 6}, {27, 8}, {29, 9}, {11, 10}, {16, 6},
    {34, 9}, {10, 10}, {13, 6}, {28, 9}, {8, 10}, {18, 7}, {27, 9}, {84, 12}, {20, 7}, {26, 9},
    {87, 12}, {25, 8}, {9, 10}, {24, 8}, {35, 11}, {23, 8}, {25, 9}, {24, 9}, {7, 10}, {88, 12},
    {7, 4}, {12, 6}, {22, 8}, {23, 9}, {6, 10}, {5, 11}, {4, 11}, {89, 12}, {15, 6}, {22, 9},
    {5, 10}, {14, 6}, {4, 10}, {17, 7}, {36, 11}, {16, 7}, {37, 11}, {19, 7}, {90, 12}, {21, 8},
    {91, 12}, {20, 8}, {19, 8}, {26, 8}, {21, 9}, {20, 9}, {19, 9}, {18, 9}, {17, 9}, {38, 11},
    {39, 11}, {92, 12}, {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const Code kInterVlc[103] = {{2, 2}, {15, 4}, {21, 6}, {23, 7}, {31, 8}, {37, 9}, {36, 9},
    {33, 10}, {32, 10}, {7, 11}, {6, 11}, {32, 11}, {6, 3}, {20, 6}, {30, 8}, {15, 10}, {33, 11},
    {80, 12}, {14, 4}, {29, 8}, {14, 10}, {81, 12}, {13, 5}, {35, 9}, {13, 10}, {12, 5}, {34, 9},
    {82, 12}, {11, 5}, {12, 10}, {83, 12}, {19, 6}, {11, 10}, {84, 12}, {18, 6}, {10, 10}, {17, 6},
    {9, 10}, {16, 6}, {8, 10}, {22, 7}, {85, 12}, {21, 7}, {20, 7}, {28, 8}, {27, 8}, {33, 9},
    {32, 9}, {31, 9}, {30, 9}, {29, 9}, {28, 9}, {27, 9}, {26, 9}, {34, 11}, {35, 11}, {86, 12},
    {87, 12}, {7, 4}, {25, 9}, {5, 11}, {15, 6}, {4, 11}, {14, 6}, {13, 6}, {12, 6}, {19, 7},
    {18, 7}, {17, 7}, {16, 7}, {26, 8}, {25, 8}, {24, 8}, {23, 8}, {22, 8}, {21, 8}, {20, 8},
    {19, 8}, {24, 9}, {23, 9}, {22, 9}, {21, 9}, {20, 9}, {19, 9}, {18, 9}, {17, 9}, {7, 10},
    {6, 10}, {5, 10}, {4, 10}, {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12},
    {90, 12}, {91, 12}, {92, 12}, {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6},
    {1, 9}};
const Code kInterMcbpc[28] = {{1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4}, {2, 5},
    {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const Code kMvd[33] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7}, {11, 9},
    {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11},
    {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5}, {1, 6}, {1, 7},
    {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
    {1, 9}, {1, 10}, {1, 11}, {1, 12}};
const uint8_t kIntraRun[102] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6,
    6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const uint8_t kIntraLevel[102] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4,
    1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kInterRun[102] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40};
const uint8_t kInterLevel[102] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
    4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kYDcScale[32] = {0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
    16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const uint8_t kZigzag[64] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
    33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
    23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12,
    19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43,
    36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41,
    33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21, 29,
    36, 44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

constexpr int kIntraLast = 67, kInterLast = 58, kEscape = 102;
const int8_t kDquant[4] = {-1, -2, 1, 2};
const uint16_t kResyncPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000};
const uint8_t kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
// A job's flag above mb * 6 + block: FFmpeg's 8-wide half-pel functions
// (chroma, a 4MV macroblock's luma), whose MMXEXT no_rnd forms round otherwise.
constexpr int32_t kNarrow = 1 << 24;

enum { kOk = 0, kBadCode = 1, kShort = 2, kTooMany = 3, kMarker = 4, kDoubleEscape = 5,
       kResync = 6 };

// A lookup of the next `bits` bits: symbol << 8 | length, 0 where no code.
struct Lut {
  int bits = 0;
  uint32_t* entry = nullptr;
  void build(const Code* codes, int n) {
    for (int s = 0; s < n; ++s) bits = codes[s].length > bits ? codes[s].length : bits;
    entry = new uint32_t[1u << bits]();
    for (int s = 0; s < n; ++s) {
      if (!codes[s].length) continue;
      const int shift = bits - codes[s].length;
      const uint32_t lo = (uint32_t)codes[s].code << shift;
      for (uint32_t k = lo; k < lo + (1u << shift); ++k) entry[k] = (uint32_t)s << 8 | codes[s].length;
    }
  }
};

struct Tables {
  Lut intra_tcoef, inter_tcoef, intra_mcbpc, inter_mcbpc, cbpy, mvd, dc_lum, dc_chrom;
  uint8_t max_level[2][2][64] = {}, max_run[2][2][64] = {};  // [intra][last][run or level]
  Tables() {
    intra_tcoef.build(kIntraVlc, 103);
    inter_tcoef.build(kInterVlc, 103);
    intra_mcbpc.build(kIntraMcbpc, 9);
    inter_mcbpc.build(kInterMcbpc, 28);
    cbpy.build(kCbpy, 16);
    mvd.build(kMvd, 33);
    dc_lum.build(kDcLum, 13);
    dc_chrom.build(kDcChrom, 13);
    for (int intra = 0; intra < 2; ++intra)
      for (int k = 0; k < 102; ++k) {
        const int last = k >= (intra ? kIntraLast : kInterLast);
        const int run = intra ? kIntraRun[k] : kInterRun[k];
        const int level = intra ? kIntraLevel[k] : kInterLevel[k];
        uint8_t& ml = max_level[intra][last][run];
        uint8_t& mr = max_run[intra][last][level];
        ml = level > ml ? level : ml;
        mr = run > mr ? run : mr;
      }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// MSB-first bits of data[0, cap); reads past `cap` give zeros.
struct Bits {
  const uint8_t* data;
  int64_t cap, pos;
  uint32_t peek(int n) const {
    const int64_t at = pos >> 3;
    uint64_t w = 0;
    if (at + 8 <= cap) {
      for (int k = 0; k < 8; ++k) w = w << 8 | data[at + k];
    } else {
      for (int k = 0; k < 8; ++k) w = w << 8 | (at + k < cap ? data[at + k] : 0);
    }
    return (uint32_t)((w << (pos & 7)) >> (64 - n));
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int vlc(const Lut& t) {
    const uint32_t e = t.entry[peek(t.bits)];
    if (!e) return -1;
    pos += e & 0xFF;
    return (int)(e >> 8);
  }
};

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline int16_t wrap16h(int v) { return (int16_t)(uint16_t)(uint32_t)v; }
inline int median3(int a, int b, int c) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return c < lo ? lo : (c > hi ? hi : c);
}
inline int rounded_div(int a, int b) { return a > 0 ? (a + (b >> 1)) / b : (a - (b >> 1)) / b; }

// A macroblock's vector into its four b8 entries, `base` the b8 row above.
inline void set_vector(int* mv, int base, int vw, int mx, int my) {
  const int at[4] = {base + vw, base + vw + 1, base + 2 * vw, base + 2 * vw + 1};
  for (int k : at) mv[2 * k] = mx, mv[2 * k + 1] = my;
}

int motion(Bits& r, int pred, int f_code, int& err) {
  const int code = r.vlc(tables().mvd);
  if (code < 0) { err = kBadCode; return 0; }
  if (!code) return pred;
  const int sign = r.read(1);
  int val = code;
  if (f_code > 1) val = (((val - 1) << (f_code - 1)) | (int)r.read(f_code - 1)) + 1;
  val = pred + (sign ? -val : val);
  const int bits = 5 + f_code;
  return ((val + (1 << (bits - 1))) & ((1 << bits) - 1)) - (1 << (bits - 1));
}

// TCOEF run-levels into `block` (raster order, ints) from scan position i + 1;
// inter levels dequantised (qmul, qadd). Returns an error code.
int tcoef(Bits& r, int* block, int i, bool intra, const uint8_t* scan, int qmul, int qadd) {
  const Tables& t = tables();
  const Lut& lut = intra ? t.intra_tcoef : t.inter_tcoef;
  const uint8_t* run_of = intra ? kIntraRun : kInterRun;
  const uint8_t* level_of = intra ? kIntraLevel : kInterLevel;
  const int last_from = intra ? kIntraLast : kInterLast;
  for (;;) {
    int s = r.vlc(lut);
    if (s < 0) return kBadCode;
    int last, run, level;
    bool fixed = false;
    if (s == kEscape) {
      if (!r.read(1)) {  // type 1: level + LMAX
        s = r.vlc(lut);
        if (s < 0) return kBadCode;
        if (s == kEscape) return kDoubleEscape;
        last = s >= last_from, run = run_of[s], level = level_of[s];
        level += t.max_level[intra][last][run];
      } else if (!r.read(1)) {  // type 2: run + RMAX + 1
        s = r.vlc(lut);
        if (s < 0) return kBadCode;
        if (s == kEscape) return kDoubleEscape;
        last = s >= last_from, run = run_of[s], level = level_of[s];
        run += t.max_run[intra][last][level] + 1;
      } else {  // type 3: fixed length
        last = r.read(1);
        run = r.read(6);
        if (!r.read(1)) return kMarker;
        level = (int)r.read(12);
        level -= (level & 0x800) << 1;
        if (!r.read(1)) return kMarker;
        fixed = true;
      }
    } else {
      last = s >= last_from, run = run_of[s], level = level_of[s];
    }
    if (fixed) {
      level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      level = clampi(level, -2048, 2047);
    } else {
      level = level * qmul + qadd;
      if (r.read(1)) level = -level;
    }
    i += run + 1;
    if (i > 63 || (i == 63 && !last)) return kTooMany;
    block[scan[i]] = level;
    if (last) return kOk;
  }
}

// MPEG dequantisation as FFmpeg's x86 dct_unquantize_mpeg2_intra/_inter (the
// MMX forms it installs without AV_CODEC_FLAG_BITEXACT) compute it, in
// 16-bit lanes: q = the linear quantiser scale (twice the quantiser) times
// the matrix entry, its low 16 bits; intra |level| q, low 16 bits, shifted
// right by 4 as a signed word; inter (2 |level| + 1) q, low 16 bits,
// shifted right by 5 as an unsigned word, then the mismatch control (the
// last coefficient's lowest bit flipped where the block's sum is even).
void dequantise_mpeg_intra(int* block, int qscale, const int64_t* matrix) {
  for (int j = 1; j < 64; ++j) {
    const int v = block[j];
    if (!v) continue;
    const uint32_t q = (uint32_t)(2 * qscale * matrix[j]) & 0xFFFF;
    const uint32_t a = (uint16_t)(v < 0 ? -v : v);
    const int level = (int16_t)(uint16_t)(a * q) >> 4;
    block[j] = wrap16h(v > 0 ? level : -level);
  }
}

void dequantise_mpeg_inter(int* block, int qscale, const int64_t* matrix) {
  int parity = 1;
  for (int j = 0; j < 64; ++j) {
    const int v = block[j];
    if (!v) continue;
    const uint32_t q = (uint32_t)(2 * qscale * matrix[j]) & 0xFFFF;
    const uint32_t a = (uint16_t)(v < 0 ? -v : v);
    const int level = (int)(((2 * a * q + q) & 0xFFFF) >> 5);
    block[j] = wrap16h(v > 0 ? level : -level);
    parity ^= block[j] & 1;
  }
  block[63] ^= parity;
}

// mpeg4_is_resync and ff_mpeg4_decode_video_packet_header: where a resync
// marker follows (MCBPC stuffing before it passed over), read the video
// packet header after it (its macroblock number must be next_mb; a quantiser
// of 0 keeps the running one; the header extension is read and passed over,
// as FFmpeg does) and return 1, else 0 with the reader past any stuffing;
// an error code where the header is wrong.
// `kind` 0 I, 1 P, 2 B; with `later` (a B-VOP whose next macroblock is
// skipped unread) a marker of a later macroblock is left for then, as
// FFmpeg's SLICE_OK leaves it.
int video_packet(Bits& r, int kind, int f_code, int b_code, int n_mb, int next_mb,
                 int quant_precision, int time_bits, bool later, int& quant) {
  uint32_t v = r.peek(16);
  const int pict = kind == 0 ? 1 : 2;
  while (kind != 2 && v <= 0xFF && (v >> (8 - pict)) == 1) {
    r.pos += 8 + pict;
    v = r.peek(16);
  }
  if (r.pos + 8 >= 8 * r.cap || v != kResyncPrefix[r.pos & 7]) return 0;
  const int64_t start = r.pos;
  r.pos = (r.pos + 1 + 7) & ~(int64_t)7;
  const int fb = f_code > b_code ? f_code : b_code;
  const int prefix = kind == 0 ? 16 : (kind == 1 ? 15 + f_code : 15 + (fb > 2 ? fb : 2));
  int zeros = 0;
  while (zeros < 32 && !r.read(1)) ++zeros;
  if (zeros < prefix) {
    r.pos = start;
    return 0;
  }
  if (zeros != prefix) return kResync;
  int bits = 1;
  while ((1 << bits) < n_mb) ++bits;  // av_log2(n_mb - 1) + 1, at least 1
  const int mb = (int)r.read(bits);
  if (later && mb > next_mb) {
    r.pos = start;
    return 0;
  }
  if (mb != next_mb) return kResync;
  quant = (int)r.read(quant_precision);
  if (r.read(1)) {  // header_extension_code
    while (r.read(1))
      if (r.pos > 8 * r.cap) return kShort;
    if (!r.read(1)) return kMarker;
    r.read(time_bits);
    if (!r.read(1)) return kMarker;
    r.read(2 + 3 + 3 * kind);  // vop_coding_type, intra_dc_vlc_thr, f_code, b_code
  }
  return 1;
}

// C's division toward zero, b > 0.
inline int cdiv(int a, int b) { return a < 0 ? -(-a / b) : a / b; }

// Colocated flags (io/mpeg4.py's COLOCATED_*).
constexpr int kColSkipped = 1, kColFour = 2, kColIntra = 4;

// A macroblock's six blocks' vectors from one vector (16x16: the chroma one
// as FFmpeg's H.263 path derives it) or four (apply_8x8's hpel_motion clips
// and chroma_4mv_motion), relative to each block, in half samples.
void block_vectors(const int* vx, const int* vy, int n, int mb_x, int mb_y, int width, int height,
                   int* jx, int* jy) {
  if (n == 1) {
    for (int k = 0; k < 4; ++k) jx[k] = vx[0], jy[k] = vy[0];
    jx[4] = 2 * ((vx[0] >> 1) >> 1) + ((vx[0] & 1) | ((vx[0] >> 1) & 1));
    jy[4] = 2 * ((vy[0] >> 1) >> 1) + ((vy[0] & 1) | ((vy[0] >> 1) & 1));
  } else {
    int sum_x = 0, sum_y = 0;
    for (int k = 0; k < 4; ++k) {
      const int x0 = 16 * mb_x + 8 * (k & 1), y0 = 16 * mb_y + 8 * (k >> 1);
      const int sx = clampi(x0 + (vx[k] >> 1), -16, width);
      const int sy = clampi(y0 + (vy[k] >> 1), -16, height);
      jx[k] = 2 * (sx - x0) + (sx != width ? vx[k] & 1 : 0);
      jy[k] = 2 * (sy - y0) + (sy != height ? vy[k] & 1 : 0);
      sum_x += vx[k], sum_y += vy[k];
    }
    const int cx = kChromaRound[sum_x & 15] + ((sum_x >> 3) & ~1);
    const int cy = kChromaRound[sum_y & 15] + ((sum_y >> 3) & ~1);
    const int sx = clampi(8 * mb_x + (cx >> 1), -8, width >> 1);
    const int sy = clampi(8 * mb_y + (cy >> 1), -8, height >> 1);
    jx[4] = 2 * (sx - 8 * mb_x) + (sx != width >> 1 ? cx & 1 : 0);
    jy[4] = 2 * (sy - 8 * mb_y) + (sy != height >> 1 ? cy & 1 : 0);
  }
  jx[5] = jx[4], jy[5] = jy[4];
}

// A B-VOP's macroblocks (mpeg4_decode_mb's B branch): a macroblock whose
// co-located one the future reference skipped is skipped unread (forward,
// zero vector, no residual); else MODB, MB_TYPE, CBPB, DBQUANT, the forward
// and backward vectors (predicted from the last of their direction, both
// reset at each row and video packet), direct mode's delta scaled by
// ff_mpeg4_set_direct_mv, the blocks as a P-VOP's. One M3 job of 8 int32 a
// block: mb * 6 + block, coefficient row or -1, forward x, y, backward x, y,
// directions (1 forward, 2 backward, 3 both), 0.
int decode_b(Bits& r, const int64_t* params, const int32_t* col, int16_t* coefs, int32_t* jobs,
             int64_t& n_coefs, int64_t& n_jobs, int& mb) {
  const int mb_w = (int)params[0], mb_h = (int)params[1];
  int qscale = (int)params[3];
  const int f_code = (int)params[4];
  const bool resync = params[6] != 0;
  const int width = (int)params[8], height = (int)params[9];
  const bool mpeg_quant = params[10] != 0;
  const int64_t* inter_matrix = params + 75;
  const int quant_precision = (int)params[139], time_bits = (int)params[140];
  const int b_code = (int)params[141], pp = (int)params[142], pb = (int)params[143];
  const Tables& t = tables();
  const int n_mb = mb_w * mb_h;
  int last[2][2] = {};
  int err = kOk;
  for (mb = 0; mb < n_mb && !err; ++mb) {
    const int mb_x = mb % mb_w, mb_y = mb / mb_w;
    if (mb_x == 0) memset(last, 0, sizeof(last));
    const int32_t* c = col + 9 * mb;
    int cbp = 0, dirs = 1, nv = 1, fx[4] = {}, fy[4] = {}, bx[4] = {}, by[4] = {};
    if (!(c[0] & kColSkipped)) {
      int mb_type = 0, dx = 0, dy = 0;
      if (!r.read(1)) {
        const int no_cbp = r.read(1);
        while (!r.read(1))
          if (++mb_type > 3) return kBadCode;
        cbp = no_cbp ? 0 : (int)r.read(6);
        if (mb_type && cbp && r.read(1)) qscale = clampi(qscale + 4 * (int)r.read(1) - 2, 1, 31);
        if (mb_type == 1 || mb_type == 3) {
          last[0][0] = motion(r, last[0][0], f_code, err);
          if (!err) last[0][1] = motion(r, last[0][1], f_code, err);
        }
        if (!err && (mb_type == 1 || mb_type == 2)) {
          last[1][0] = motion(r, last[1][0], b_code, err);
          if (!err) last[1][1] = motion(r, last[1][1], b_code, err);
        }
        if (!err && mb_type == 0) {
          dx = motion(r, 0, 1, err);
          if (!err) dy = motion(r, 0, 1, err);
        }
        if (err) return err;
      }
      if (mb_type == 0) {  // direct
        dirs = 3;
        nv = c[0] & kColFour ? 4 : 1;
        for (int i = 0; i < nv; ++i) {
          const int px = c[1 + 2 * i], py = c[2 + 2 * i];
          fx[i] = cdiv(px * pb, pp) + dx, fy[i] = cdiv(py * pb, pp) + dy;
          bx[i] = dx ? fx[i] - px : cdiv(px * (pb - pp), pp);
          by[i] = dy ? fy[i] - py : cdiv(py * (pb - pp), pp);
        }
      } else {
        dirs = mb_type == 1 ? 3 : (mb_type == 2 ? 2 : 1);
        fx[0] = last[0][0], fy[0] = last[0][1], bx[0] = last[1][0], by[0] = last[1][1];
      }
    }
    int jfx[6], jfy[6], jbx[6], jby[6];
    block_vectors(fx, fy, nv, mb_x, mb_y, width, height, jfx, jfy);
    block_vectors(bx, by, nv, mb_x, mb_y, width, height, jbx, jby);
    const int qmul = mpeg_quant ? 1 : qscale << 1, qadd = mpeg_quant ? 0 : (qscale - 1) | 1;
    for (int n = 0; n < 6; ++n) {
      int row = -1;
      if (cbp & (32 >> n)) {
        int block[64] = {};
        err = tcoef(r, block, -1, false, kZigzag, qmul, qadd);
        if (err) return err;
        if (mpeg_quant) dequantise_mpeg_inter(block, qscale, inter_matrix);
        row = (int)n_coefs++;
        for (int k = 0; k < 64; ++k) coefs[64 * (int64_t)row + k] = wrap16h(block[k]);
      }
      int32_t* j = jobs + 8 * n_jobs++;
      j[0] = mb * 6 + n, j[1] = row, j[2] = jfx[n], j[3] = jfy[n], j[4] = jbx[n], j[5] = jby[n];
      j[6] = dirs, j[7] = 0;
    }
    if (r.pos > 8 * r.cap) return kShort;
    if (resync && mb + 1 < n_mb) {
      int quant = 0;
      const bool later = (col[9 * (mb + 1)] & kColSkipped) != 0;
      const int packet = video_packet(r, 2, f_code, b_code, n_mb, mb + 1, quant_precision,
                                      time_bits, later, quant);
      if (packet > 1) return packet;
      if (packet) {
        if (quant) qscale = quant;
        memset(last, 0, sizeof(last));  // ff_mpeg4_clean_buffers
      }
    }
  }
  (void)t;
  return err;
}

}  // namespace

// params: macroblocks a row and a column, the VOP's kind (0 I, 1 P, 2 B), quantiser, f_code,
// intra_dc_vlc_thr's threshold, resync markers possible, the first bit of the
// macroblocks, the VOL's width and height, MPEG quantisation, its intra and
// inter matrices (64 each, raster order), quant_precision, the bits of
// vop_time_increment, b_code, and a B-VOP's pp_time and pb_time. coefs: (6 *
// macroblocks, 64) int16; jobs: (2, 6 * macroblocks, 4) int32, M1's then
// M2's, or a B-VOP's M3 jobs (6 * macroblocks, 8); counts: coefficient rows,
// M1 jobs, M2 (or M3) jobs, and the macroblock an error stopped at.
// colocated_in: a B-VOP's future reference's co-located macroblocks;
// colocated_out: an I- or P-VOP's, (macroblocks, 9) int32 each: flags (1
// skipped, 2 four vectors, 4 intra) and the four luma blocks' vectors as
// FFmpeg's motion_val holds them once the VOP is decoded.
extern "C" int sleap_mpeg4_decode_vop(const uint8_t* data, int64_t size, const int64_t* params,
                                      int16_t* coefs, int32_t* jobs, int64_t* counts,
                                      const int32_t* colocated_in, int32_t* colocated_out) {
  const int mb_w = (int)params[0], mb_h = (int)params[1];
  if (params[2] == 2) {
    Bits rb{data, size, params[7]};
    int64_t n_coefs = 0, n_jobs = 0;
    int mb = 0;
    const int err = decode_b(rb, params, colocated_in, coefs, jobs, n_coefs, n_jobs, mb);
    counts[0] = n_coefs, counts[1] = 0, counts[2] = n_jobs, counts[3] = err ? mb : mb_w * mb_h;
    return err;
  }
  const bool P = params[2] == 1;
  int qscale = (int)params[3];
  const int f_code = (int)params[4], dc_threshold = (int)params[5];
  const bool resync = params[6] != 0;
  Bits r{data, size, params[7]};
  const int width = (int)params[8], height = (int)params[9];
  const bool mpeg_quant = params[10] != 0;
  const int64_t* intra_matrix = params + 11;  // raster order, where mpeg_quant
  const int64_t* inter_matrix = params + 75;
  const int quant_precision = (int)params[139], time_bits = (int)params[140];
  const Tables& t = tables();
  const int n_mb = mb_w * mb_h;
  const int lw = 2 * mb_w + 1, cw = mb_w + 1, vw = 2 * mb_w + 2;
  const int n_luma = (2 * mb_h + 1) * lw, n_chroma = (mb_h + 1) * cw;
  // DC and AC predictors with a border row and column (1024 and 0), then the
  // b8 motion vectors with a border row and a border column either side.
  int* dc[3];
  int16_t* ac[3];
  int* buf = new int[n_luma + 2 * n_chroma];
  int16_t* acbuf = new int16_t[16 * (n_luma + 2 * n_chroma)]();
  int* mv = new int[2 * (2 * mb_h + 1) * vw]();
  int* qtab = new int[n_mb];
  uint8_t* mbflag = new uint8_t[n_mb]();
  for (int k = 0; k < n_luma + 2 * n_chroma; ++k) buf[k] = 1024;
  dc[0] = buf, dc[1] = buf + n_luma, dc[2] = buf + n_luma + n_chroma;
  ac[0] = acbuf, ac[1] = acbuf + 16 * n_luma, ac[2] = acbuf + 16 * (n_luma + n_chroma);
  int32_t* intra_jobs = jobs;
  int32_t* inter_jobs = jobs + 4 * 6 * (int64_t)n_mb;
  int64_t n_coefs = 0, n_intra = 0, n_inter = 0;
  int err = kOk, mb = 0;
  auto cell = [&](int n, int x, int y, int& g) {
    if (n < 4) { g = 0; return (2 * y + (n >> 1) + 1) * lw + 2 * x + (n & 1) + 1; }
    g = n - 3;
    return (y + 1) * cw + x + 1;
  };
  // A video packet's first macroblock, and whether the macroblock being
  // decoded is in its first row (up to the macroblock below the first).
  int resync_x = 0, resync_y = 0;
  bool first_line = true;
  for (; mb < n_mb && !err; ++mb) {
    const int mb_x = mb % mb_w, mb_y = mb / mb_w;
    if (mb_x == resync_x && mb_y == resync_y + 1) first_line = false;
    bool intra = !P, skipped = false, dquant = false;
    int cbpc = 0;
    if (P) {
      for (;;) {
        if (r.read(1)) { skipped = true; break; }
        cbpc = r.vlc(t.inter_mcbpc);
        if (cbpc < 0) { err = kBadCode; break; }
        if (cbpc != 20) break;
      }
      if (err) break;
      if (!skipped) intra = cbpc & 4, dquant = cbpc & 8;
    } else {
      do { cbpc = r.vlc(t.intra_mcbpc); } while (cbpc == 8);
      if (cbpc < 0) { err = kBadCode; break; }
      dquant = cbpc & 4;
    }
    const int base = 2 * mb_y * vw + 2 * mb_x + 1;  // the b8 row above block 0
    if (skipped || !intra) {
      int cbp = 0, vectors = 1, vx[4] = {}, vy[4] = {};
      mbflag[mb] = skipped ? kColSkipped : ((cbpc & 16) ? kColFour : 0);
      if (!skipped) {
        const int cbpy = r.vlc(t.cbpy);
        if (cbpy < 0) { err = kBadCode; break; }
        cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
        if (dquant) qscale = clampi(qscale + kDquant[r.read(2)], 1, 31);
        vectors = cbpc & 16 ? 4 : 1;
        for (int n = 0; n < vectors && !err; ++n) {  // ff_h263_pred_motion
          const int at = base + vw * (1 + (n >> 1)) + (n & 1);
          static const int kOff[4] = {2, 1, 1, -1};
          int* stored_a = mv + 2 * (at - 1);
          int a[2] = {stored_a[0], stored_a[1]};
          int b[2] = {mv[2 * (at - vw)], mv[2 * (at - vw) + 1]};
          int c[2] = {mv[2 * (at - vw + kOff[n])], mv[2 * (at - vw + kOff[n]) + 1]};
          if (first_line && n < 2) {
            for (int d = 0; d < 2; ++d) {
              if (n == 0 && mb_x == resync_x) {
                a[d] = b[d] = c[d] = 0;
              } else if (mb_x + 1 == resync_x) {  // left of the packet's first
                if (n == 0 && mb_x == 0) a[d] = b[d] = c[d];
                else b[d] = 0;
              } else {
                b[d] = c[d] = a[d];
              }
            }
          } else if (first_line && n == 2 && mb_x == resync_x) {
            a[0] = a[1] = stored_a[0] = stored_a[1] = 0;  // FFmpeg zeroes the stored vector too
          }
          const int px = median3(a[0], b[0], c[0]), py = median3(a[1], b[1], c[1]);
          vx[n] = motion(r, px, f_code, err);
          if (!err) vy[n] = motion(r, py, f_code, err);
          mv[2 * at] = vx[n], mv[2 * at + 1] = vy[n];
        }
        if (err) break;
      }
      // Each job's vector relative to its block (half samples); the flag of
      // FFmpeg's 8-wide half-pel functions (chroma, a 4MV macroblock's luma).
      int jx[6], jy[6], flag[6];
      if (vectors == 1) set_vector(mv, base, vw, vx[0], vy[0]);
      block_vectors(vx, vy, vectors, mb_x, mb_y, width, height, jx, jy);
      for (int n = 0; n < 6; ++n) flag[n] = n > 3 || vectors == 4 ? kNarrow : 0;
      const int qmul = mpeg_quant ? 1 : qscale << 1, qadd = mpeg_quant ? 0 : (qscale - 1) | 1;
      for (int n = 0; n < 6 && !err; ++n) {
        int row = -1;
        if (cbp & (32 >> n)) {
          int block[64] = {};
          err = tcoef(r, block, -1, false, kZigzag, qmul, qadd);
          if (mpeg_quant) dequantise_mpeg_inter(block, qscale, inter_matrix);
          row = (int)n_coefs++;
          for (int k = 0; k < 64; ++k) coefs[64 * (int64_t)row + k] = wrap16h(block[k]);
        }
        int32_t* j = inter_jobs + 4 * n_inter++;
        j[0] = (mb * 6 + n) | flag[n], j[1] = row, j[2] = jx[n], j[3] = jy[n];
      }
      if (err) break;
      for (int n = 0; n < 6; ++n) {  // ff_clean_intra_table_entries
        int g;
        const int k = cell(n, mb_x, mb_y, g);
        dc[g][k] = 1024;
        memset(ac[g] + 16 * k, 0, 16 * sizeof(int16_t));
      }
    } else {
      const int ac_pred = r.read(1);
      const int cbpy = r.vlc(t.cbpy);
      if (cbpy < 0) { err = kBadCode; break; }
      const int cbp = (cbpc & 3) | (cbpy << 2);
      const bool use_dc_vlc = qscale < dc_threshold;
      if (dquant) qscale = clampi(qscale + kDquant[r.read(2)], 1, 31);
      for (int n = 0; n < 6 && !err; ++n) {
        int block[64] = {};
        int g;
        const int k = cell(n, mb_x, mb_y, g);
        int* grid = dc[g];
        const int step = g ? cw : lw;
        const int scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
        int a = grid[k - 1], b = grid[k - 1 - step], c = grid[k - step];
        if (first_line && n != 3) {  // neighbours outside the video packet
          if (n != 2) b = c = 1024;
          if (n != 1 && mb_x == resync_x) b = a = 1024;
        }
        if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
        const bool top = (a > b ? a - b : b - a) < (b > c ? b - c : c - b);
        const int pred = ((top ? c : a) + (scale >> 1)) / scale;
        int i = -1;
        if (use_dc_vlc) {
          const int sz = r.vlc(n < 4 ? t.dc_lum : t.dc_chrom);
          if (sz < 0) { err = kBadCode; break; }
          int level = 0;
          if (sz) {
            level = (int)r.read(sz);
            if (!(level >> (sz - 1))) level -= (1 << sz) - 1;
            if (sz > 8) r.read(1);  // marker
          }
          block[0] = level;
          i = 0;
        }
        if (cbp & (32 >> n)) {
          const uint8_t* scan = ac_pred ? (top ? kAltHorizontal : kAltVertical) : kZigzag;
          err = tcoef(r, block, i, true, scan, 1, 0);
          if (err) break;
        }
        block[0] = wrap16h(block[0] + pred);
        int stored = block[0] * scale;
        if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
        grid[k] = stored;
        int16_t* mine = ac[g] + 16 * k;
        if (ac_pred) {
          if (top) {
            const int nq = mb_y ? qtab[mb - mb_w] : qscale;
            const int16_t* pv = ac[g] + 16 * (k - step);
            const bool same = mb_y == 0 || nq == qscale || n == 2 || n == 3;
            for (int j = 1; j < 8; ++j)
              block[j] = wrap16h(block[j] + (same ? pv[8 + j] : rounded_div(pv[8 + j] * nq, qscale)));
          } else {
            const int nq = mb_x ? qtab[mb - 1] : qscale;
            const int16_t* pv = ac[g] + 16 * (k - 1);
            const bool same = mb_x == 0 || nq == qscale || n == 1 || n == 3;
            for (int j = 1; j < 8; ++j)
              block[8 * j] = wrap16h(block[8 * j] + (same ? pv[j] : rounded_div(pv[j] * nq, qscale)));
          }
        }
        mine[0] = mine[8] = 0;
        for (int j = 1; j < 8; ++j) mine[j] = (int16_t)block[8 * j], mine[8 + j] = (int16_t)block[j];
        const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        block[0] *= scale;
        if (mpeg_quant) {
          dequantise_mpeg_intra(block, qscale, intra_matrix);
        } else {
          for (int j = 1; j < 64; ++j) {
            const int v = block[j];
            if (v) block[j] = v > 0 ? v * qmul + qadd : v * qmul - qadd;
          }
        }
        const int64_t row = n_coefs++;
        for (int j = 0; j < 64; ++j) coefs[64 * row + j] = wrap16h(block[j]);
        int32_t* job = intra_jobs + 4 * n_intra++;
        job[0] = mb * 6 + n, job[1] = (int32_t)row, job[2] = 0, job[3] = 0;
      }
      if (err) break;
      set_vector(mv, base, vw, 0, 0);
      mbflag[mb] = kColIntra;
    }
    qtab[mb] = qscale;
    if (r.pos > 8 * size) { err = kShort; break; }
    if (resync && mb + 1 < n_mb) {
      int quant = 0;
      const int packet = video_packet(r, P ? 1 : 0, f_code, 1, n_mb, mb + 1, quant_precision,
                                      time_bits, false, quant);
      if (packet > 1) { err = packet; break; }
      if (packet) {
        resync_x = (mb + 1) % mb_w, resync_y = (mb + 1) / mb_w, first_line = true;
        if (quant) qscale = quant;
        // ff_mpeg4_clean_buffers: the AC predictors from the top-left
        // neighbour's last block on, through the left neighbour's.
        memset(ac[0] + 16 * (2 * resync_y * lw + 2 * resync_x), 0, 16 * (2 * lw + 1) * sizeof(int16_t));
        for (int g = 1; g < 3; ++g)
          memset(ac[g] + 16 * (resync_y * cw + resync_x), 0, 16 * (cw + 1) * sizeof(int16_t));
      }
    }
  }
  if (!err)
    for (int k = 0; k < n_mb; ++k) {
      const int base = 2 * (k / mb_w) * vw + 2 * (k % mb_w) + 1;
      const int at[4] = {base + vw, base + vw + 1, base + 2 * vw, base + 2 * vw + 1};
      int32_t* c = colocated_out + 9 * k;
      c[0] = mbflag[k];
      for (int b = 0; b < 4; ++b) c[1 + 2 * b] = mv[2 * at[b]], c[2 + 2 * b] = mv[2 * at[b] + 1];
    }
  delete[] buf;
  delete[] acbuf;
  delete[] mv;
  delete[] qtab;
  delete[] mbflag;
  counts[0] = n_coefs, counts[1] = n_intra, counts[2] = n_inter, counts[3] = mb;
  return err;
}

#ifdef __CUDACC__

namespace {

constexpr int kBlocksPerCta = 16;

struct Planes {
  uint8_t* p[3];
};
struct RefPlanes {
  const uint8_t* p[3];
};

// A job's plane, its block's top-left sample and the plane's width and height.
__device__ __forceinline__ void origin(int pos, int mb_w, int mb_h, int& plane, int& x, int& y,
                                       int& w, int& h) {
  pos &= kNarrow - 1;
  const int mb = pos / 6, n = pos - 6 * mb;
  const int mx = mb % mb_w, my = mb / mb_w;
  if (n < 4) {
    plane = 0, x = 16 * mx + 8 * (n & 1), y = 16 * my + 8 * (n >> 1), w = 16 * mb_w, h = 16 * mb_h;
  } else {
    plane = n - 3, x = 8 * mx, y = 8 * my, w = 8 * mb_w, h = 8 * mb_h;
  }
}

// Pass 1 of the IDCT (simple or Xvid's): row `lane` of coefficient row `c`
// into ws.
template <bool kXvid>
__device__ __forceinline__ void idct_rows(const int16_t* __restrict__ coefs, int64_t c, int lane,
                                          int16_t* ws) {
  const int16_t* src = coefs + 64 * c + 8 * lane;
  int32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = src[k];
  if (kXvid)
    xvid_row(x, lane, ws + 8 * lane);
  else
    simple_row(x, ws + 8 * lane);
}

// Pass 2: column `lane` of ws, the values before saturation.
template <bool kXvid>
__device__ __forceinline__ void idct_column(const int16_t* ws, int lane, int32_t (&v)[8]) {
  if (kXvid)
    xvid_column(ws, lane, v);
  else
    simple_column(ws, lane, v);
}

// A sample position clamped into a plane of `n` samples: emulated edges.
__device__ __forceinline__ int clampi_d(int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); }

// Column `lane` of an 8x8 block's half-pel prediction from `src` (a w x h
// plane) at (x, y) moved by (mvx, mvy) half samples, every position clamped
// to the plane: (a + b + 1 - r) >> 1, (a + b + c + d + 2 - r) >> 2, and, with
// `approx` at r = 1, MMXEXT's 8-wide no_rnd x and y halves.
__device__ __forceinline__ void predict_column(const uint8_t* __restrict__ src, int x, int y,
                                               int mvx, int mvy, int lane, int w, int h,
                                               int rounding, bool approx, int (&out)[8]) {
  const int hx = mvx & 1, hy = mvy & 1;
  const int sx = x + (mvx >> 1) + lane, sy = y + (mvy >> 1);
  const int c0 = clampi_d(sx, w), c1 = clampi_d(sx + 1, w);
  const int row0 = clampi_d(sy, h);
  int a = src[(int64_t)row0 * w + c0], bb = src[(int64_t)row0 * w + c1];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int row1 = clampi_d(sy + k + 1, h);
    const int c = src[(int64_t)row1 * w + c0], d = src[(int64_t)row1 * w + c1];
    int p;
    if (hx && hy) {
      p = (a + bb + c + d + 2 - rounding) >> 2;
    } else if (hx) {
      p = approx ? ((a > 0 ? a - 1 : 0) + bb + 1) >> 1 : (a + bb + 1 - rounding) >> 1;
    } else if (hy) {
      if (approx)
        p = (k & 1) ? ((a > 0 ? a - 1 : 0) + c + 1) >> 1 : (a + (c > 0 ? c - 1 : 0) + 1) >> 1;
      else
        p = (a + c + 1 - rounding) >> 1;
    } else {
      p = a;
    }
    out[k] = p;
    a = c, bb = d;
  }
}

template <bool kXvid>
__global__ void __launch_bounds__(kBlocksPerCta * 8)
mpeg4_intra_kernel(const int16_t* __restrict__ coefs, const int32_t* __restrict__ jobs, int64_t n,
                   int mb_w, Planes out) {
  __shared__ int16_t ws[kBlocksPerCta][64];
  __shared__ __align__(8) uint8_t px[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < n;
  int4 job = make_int4(0, 0, 0, 0);
  if (live) {
    job = reinterpret_cast<const int4*>(jobs)[b];
    idct_rows<kXvid>(coefs, job.y, lane, ws[local]);
  }
  __syncthreads();
  if (live) {
    int32_t v[8];
    idct_column<kXvid>(ws[local], lane, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) px[local][8 * k + lane] = clamp255(v[k]);
  }
  __syncthreads();
  if (live) {
    int plane, x, y, w, h;
    origin(job.x, mb_w, 1, plane, x, y, w, h);
    *reinterpret_cast<uint2*>(out.p[plane] + (int64_t)(y + lane) * w + x) =
        *reinterpret_cast<const uint2*>(&px[local][8 * lane]);
  }
}

template <bool kXvid>
__global__ void __launch_bounds__(kBlocksPerCta * 8)
mpeg4_inter_kernel(const int16_t* __restrict__ coefs, const int32_t* __restrict__ jobs, int64_t n,
                   int mb_w, int mb_h, int rounding, RefPlanes ref, Planes out) {
  __shared__ int16_t ws[kBlocksPerCta][64];
  __shared__ __align__(8) uint8_t px[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < n;
  int4 job = make_int4(0, -1, 0, 0);
  if (live) {
    job = reinterpret_cast<const int4*>(jobs)[b];
    if (job.y >= 0) idct_rows<kXvid>(coefs, job.y, lane, ws[local]);
  }
  __syncthreads();
  int plane = 0, x = 0, y = 0, w = 0, h = 0;
  if (live) {
    origin(job.x, mb_w, mb_h, plane, x, y, w, h);
    int32_t res[8] = {};
    if (job.y >= 0) idct_column<kXvid>(ws[local], lane, res);
    int p[8];
    predict_column(ref.p[plane], x, y, job.z, job.w, lane, w, h, rounding,
                   rounding && (job.x & kNarrow), p);
#pragma unroll
    for (int k = 0; k < 8; ++k) px[local][8 * k + lane] = clamp255(p[k] + res[k]);
  }
  __syncthreads();
  if (live)
    *reinterpret_cast<uint2*>(out.p[plane] + (int64_t)(y + lane) * w + x) =
        *reinterpret_cast<const uint2*>(&px[local][8 * lane]);
}

// M3: a B-VOP's block: the forward prediction from `past`, the backward one
// from `future`, or both averaged as (f + b + 1) >> 1, rounding 0; then the
// IDCT residual added with saturation. Job (8 int32): mb * 6 + block,
// coefficient row or -1, forward x, y, backward x, y, directions (1
// forward, 2 backward, 3 both), 0.
template <bool kXvid>
__global__ void __launch_bounds__(kBlocksPerCta * 8)
mpeg4_bidir_kernel(const int16_t* __restrict__ coefs, const int32_t* __restrict__ jobs, int64_t n,
                   int mb_w, int mb_h, RefPlanes past, RefPlanes future, Planes out) {
  __shared__ int16_t ws[kBlocksPerCta][64];
  __shared__ __align__(8) uint8_t px[kBlocksPerCta][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool live = b < n;
  int4 j0 = make_int4(0, -1, 0, 0), j1 = make_int4(0, 0, 0, 0);
  if (live) {
    j0 = reinterpret_cast<const int4*>(jobs)[2 * b];
    j1 = reinterpret_cast<const int4*>(jobs)[2 * b + 1];
    if (j0.y >= 0) idct_rows<kXvid>(coefs, j0.y, lane, ws[local]);
  }
  __syncthreads();
  int plane = 0, x = 0, y = 0, w = 0, h = 0;
  if (live) {
    origin(j0.x, mb_w, mb_h, plane, x, y, w, h);
    int32_t res[8] = {};
    if (j0.y >= 0) idct_column<kXvid>(ws[local], lane, res);
    const int dirs = j1.z;
    int f[8], p[8];
    if (dirs & 1) predict_column(past.p[plane], x, y, j0.z, j0.w, lane, w, h, 0, false, f);
    if (dirs & 2) predict_column(future.p[plane], x, y, j1.x, j1.y, lane, w, h, 0, false, p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = dirs == 3 ? (f[k] + p[k] + 1) >> 1 : (dirs == 1 ? f[k] : p[k]);
      px[local][8 * k + lane] = clamp255(v + res[k]);
    }
  }
  __syncthreads();
  if (live)
    *reinterpret_cast<uint2*>(out.p[plane] + (int64_t)(y + lane) * w + x) =
        *reinterpret_cast<const uint2*>(&px[local][8 * lane]);
}

}  // namespace

// `xvid` picks the instantiation: 0 FFmpeg's simple IDCT, 1 Xvid's.
extern "C" int sleap_mpeg4_intra(const void* coefs, const void* jobs, int64_t n, int mb_w, int xvid,
                                 void* y, void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  const Planes out{{(uint8_t*)y, (uint8_t*)u, (uint8_t*)v}};
  const unsigned grid = (unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta);
  auto kernel = xvid ? mpeg4_intra_kernel<true> : mpeg4_intra_kernel<false>;
  kernel<<<grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)jobs, n, mb_w, out);
  return (int)cudaGetLastError();
}

extern "C" int sleap_mpeg4_inter(const void* coefs, const void* jobs, int64_t n, int mb_w, int mb_h,
                                 int rounding, int xvid, const void* ry, const void* ru,
                                 const void* rv, void* y, void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  const RefPlanes ref{{(const uint8_t*)ry, (const uint8_t*)ru, (const uint8_t*)rv}};
  const Planes out{{(uint8_t*)y, (uint8_t*)u, (uint8_t*)v}};
  const unsigned grid = (unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta);
  auto kernel = xvid ? mpeg4_inter_kernel<true> : mpeg4_inter_kernel<false>;
  kernel<<<grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)jobs, n, mb_w, mb_h, rounding, ref, out);
  return (int)cudaGetLastError();
}

extern "C" int sleap_mpeg4_bidir(const void* coefs, const void* jobs, int64_t n, int mb_w, int mb_h,
                                 int xvid, const void* py, const void* pu, const void* pv,
                                 const void* fy, const void* fu, const void* fv, void* y, void* u,
                                 void* v, void* stream) {
  if (n <= 0) return 0;
  const RefPlanes past{{(const uint8_t*)py, (const uint8_t*)pu, (const uint8_t*)pv}};
  const RefPlanes future{{(const uint8_t*)fy, (const uint8_t*)fu, (const uint8_t*)fv}};
  const Planes out{{(uint8_t*)y, (uint8_t*)u, (uint8_t*)v}};
  const unsigned grid = (unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta);
  auto kernel = xvid ? mpeg4_bidir_kernel<true> : mpeg4_bidir_kernel<false>;
  kernel<<<grid, kBlocksPerCta * 8, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)jobs, n, mb_w, mb_h, past, future, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
