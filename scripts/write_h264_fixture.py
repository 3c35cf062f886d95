#!/usr/bin/env python3
"""Write H.264 ``.mp4`` files whose decoded frames are known exactly, with
no encoder: test support for the port's MP4 demuxer and NVDEC reader.

Every frame is coded losslessly. An IDR frame is all I_PCM macroblocks (the
samples written raw); a P frame codes each macroblock that equals the one
before it as ``P_Skip`` and every other one as I_PCM. With deblocking off
(``disable_deblocking_filter_idc`` 1), a skipped macroblock's motion vector
is zero (its neighbours are skipped with zero motion or intra), so by the
standard the decoded Y, U and V planes equal the written samples bit for
bit. The stream is Baseline profile, CAVLC, ``pic_order_cnt_type`` 2 (output
order is decoding order), one slice a frame, one reference frame, with SPS
frame cropping for display sizes that are no multiple of 16 (they must be
even: 4:2:0 crops in steps of 2) and a VUI that says no frame is reordered.

The container is a minimal MP4 (``ftyp``, ``mdat``, ``moov`` with one video
track). The options exercise the demuxer: ``co64`` chunk offsets, several
chunks (a multi-entry ``stsc``, with bytes between chunks as interleaved
audio would leave), a ``ctts`` box, and NAL length sizes 1, 2 and 4. A
length size of 1 holds no I_PCM slice (at least 386 bytes), so it is only
for :func:`write_mp4` with short NAL units.

    python3 scripts/write_h264_fixture.py OUT.mp4 [--frames 12] [--width 100]
        [--height 72] [--gray] [--idr-every 4] [--co64] [--seed 0] [--y4m OUT.y4m]

writes seeded moving-block frames (and, with ``--y4m``, the same planes as a
raw ``.y4m`` that OpenCV reads, for comparison).
"""

from __future__ import annotations

import argparse
import re
import struct
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

LEVEL_IDC = 40  # level 4.0: frames up to 8192 macroblocks (1024^2 is 4096)
LOG2_MAX_FRAME_NUM = 16


class BitWriter:
    """Big-endian bits, with the exp-Golomb codes of H.264 (7.2)."""

    def __init__(self):
        self.bits: List[str] = []

    def u(self, n: int, value: int) -> None:
        if n:
            self.bits.append(format(value, f"0{n}b"))

    def ue(self, value: int) -> None:
        code = format(value + 1, "b")
        self.bits.append("0" * (len(code) - 1) + code)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> None:
        self.bits.append("0" * (-len("".join(self.bits)) % 8))

    def trailing(self) -> None:
        """rbsp_trailing_bits: a one, then zeros to the byte boundary."""
        self.u(1, 1)
        self.align_zero()

    def take(self) -> bytes:
        """The bytes written so far (a whole number of them); starts over."""
        s = "".join(self.bits)
        assert len(s) % 8 == 0, "not byte-aligned"
        self.bits = []
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


_EMULATION = re.compile(b"\x00\x00(?=[\x00-\x03])")


def nal_unit(nal_ref_idc: int, nal_type: int, rbsp: bytes) -> bytes:
    """A NAL unit (no start code): its header byte, then the RBSP with an
    emulation-prevention byte after every ``00 00`` that a byte of 0-3
    follows (7.4.1)."""
    return bytes([(nal_ref_idc << 5) | nal_type]) + _EMULATION.sub(b"\x00\x00\x03", rbsp)


def coded_size(width: int, height: int) -> Tuple[int, int]:
    if width % 2 or height % 2 or width <= 0 or height <= 0:
        raise ValueError(f"display size {width}x{height}: 4:2:0 needs even sizes")
    return -(-width // 16) * 16, -(-height // 16) * 16


def sps_pps(width: int, height: int) -> Tuple[bytes, bytes]:
    """The sequence and picture parameter sets (NAL units) of the stream."""
    cw, ch = coded_size(width, height)
    b = BitWriter()
    b.u(8, 66)  # profile_idc: Baseline
    b.u(8, 0xC0)  # constraint_set0 and 1: Constrained Baseline
    b.u(8, LEVEL_IDC)
    b.ue(0)  # seq_parameter_set_id
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    b.ue(2)  # pic_order_cnt_type
    b.ue(1)  # max_num_ref_frames
    b.u(1, 0)  # gaps_in_frame_num_value_allowed_flag
    b.ue(cw // 16 - 1)
    b.ue(ch // 16 - 1)
    b.u(1, 1)  # frame_mbs_only_flag
    b.u(1, 1)  # direct_8x8_inference_flag
    crop = (cw - width) // 2, (ch - height) // 2  # in 2-sample units (4:2:0, frames)
    b.u(1, int(any(crop)))
    if any(crop):
        for offset in (0, crop[0], 0, crop[1]):  # left, right, top, bottom
            b.ue(offset)
    b.u(1, 1)  # vui_parameters_present_flag
    b.u(9, 0)  # aspect ratio .. pic_struct: none present
    b.u(1, 1)  # bitstream_restriction_flag
    b.u(1, 1)  # motion_vectors_over_pic_boundaries_flag
    for value in (0, 0, 15, 15, 0, 1):  # bytes/bits denominators, mv lengths,
        b.ue(value)  # max_num_reorder_frames 0, max_dec_frame_buffering 1
    b.trailing()
    sps = nal_unit(3, 7, b.take())

    b.ue(0)  # pic_parameter_set_id
    b.ue(0)  # seq_parameter_set_id
    b.u(1, 0)  # entropy_coding_mode_flag: CAVLC
    b.u(1, 0)  # bottom_field_pic_order_in_frame_present_flag
    b.ue(0)  # num_slice_groups_minus1
    b.ue(0)  # num_ref_idx_l0_default_active_minus1
    b.ue(0)  # num_ref_idx_l1_default_active_minus1
    b.u(1, 0)  # weighted_pred_flag
    b.u(2, 0)  # weighted_bipred_idc
    b.se(0)  # pic_init_qp_minus26
    b.se(0)  # pic_init_qs_minus26
    b.se(0)  # chroma_qp_index_offset
    b.u(1, 1)  # deblocking_filter_control_present_flag
    b.u(1, 0)  # constrained_intra_pred_flag
    b.u(1, 0)  # redundant_pic_cnt_present_flag
    b.trailing()
    return sps, nal_unit(3, 8, b.take())


def macroblocks(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(macroblocks, 384) uint8: each macroblock's 256 luma samples, then 64
    Cb and 64 Cr, in raster order (the order of pcm_sample_luma/chroma),
    from coded-size planes."""
    ch, cw = y.shape
    rows, cols = ch // 16, cw // 16

    def blocks(plane, n):
        return plane.reshape(rows, n, cols, n).transpose(0, 2, 1, 3).reshape(rows * cols, n * n)

    return np.concatenate([blocks(y, 16), blocks(u, 8), blocks(v, 8)], axis=1)


def slice_nal(mbs: np.ndarray, prev: Optional[np.ndarray], frame_num: int, idr_id: int) -> bytes:
    """One frame as one slice: an IDR slice of I_PCM macroblocks when
    ``prev`` is None, else a P slice that skips every macroblock equal to
    ``prev``'s."""
    idr = prev is None
    b = BitWriter()
    b.ue(0)  # first_mb_in_slice
    b.ue(7 if idr else 5)  # slice_type: I or P, as every slice of the picture
    b.ue(0)  # pic_parameter_set_id
    b.u(LOG2_MAX_FRAME_NUM, frame_num % (1 << LOG2_MAX_FRAME_NUM))
    if idr:
        b.ue(idr_id)
    else:
        b.u(1, 0)  # num_ref_idx_active_override_flag
        b.u(1, 0)  # ref_pic_list_modification_flag_l0
    if idr:
        b.u(1, 0)  # no_output_of_prior_pics_flag
        b.u(1, 0)  # long_term_reference_flag
    else:
        b.u(1, 0)  # adaptive_ref_pic_marking_mode_flag: sliding window
    b.se(0)  # slice_qp_delta
    b.ue(1)  # disable_deblocking_filter_idc: off
    coded = np.arange(len(mbs)) if idr else np.flatnonzero((mbs != prev).any(axis=1))
    parts, last = [], -1
    for k in coded.tolist():
        if not idr:
            b.ue(k - last - 1)  # mb_skip_run
        b.ue(25 if idr else 30)  # mb_type I_PCM (in an I slice / in a P slice)
        b.align_zero()  # pcm_alignment_zero_bit
        parts.append(b.take())
        parts.append(mbs[k].tobytes())
        last = k
    if not idr and last < len(mbs) - 1:
        b.ue(len(mbs) - 1 - last)
    b.trailing()
    parts.append(b.take())
    return nal_unit(3 if idr else 2, 5 if idr else 1, b"".join(parts))


def pad_planes(y, u, v) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Planes of the display size padded to the coded size (edge samples
    repeated; the decoder crops them away)."""
    h, w = y.shape
    cw, ch = coded_size(w, h)
    return (np.pad(y, ((0, ch - h), (0, cw - w)), mode="edge"),
            np.pad(u, ((0, (ch - h) // 2), (0, (cw - w) // 2)), mode="edge"),
            np.pad(v, ((0, (ch - h) // 2), (0, (cw - w) // 2)), mode="edge"))


def encode(y: np.ndarray, u: np.ndarray, v: np.ndarray, idr_every: int = 0):
    """Planes (frames, H, W), (frames, H/2, W/2) x 2 -> (sps, pps, one slice
    NAL unit a frame, sync flags). An IDR frame every ``idr_every`` frames
    (0: only the first)."""
    n, h, w = y.shape
    if u.shape != (n, h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes {u.shape} and {v.shape} do not fit luma {y.shape}")
    sps, pps = sps_pps(w, h)
    nals, sync, prev, idr_count, frame_num = [], [], None, 0, 0
    for i in range(n):
        mbs = macroblocks(*pad_planes(y[i], u[i], v[i]))
        if idr_every and i % idr_every == 0:
            prev = None
        if prev is None:
            frame_num = 0
            nals.append(slice_nal(mbs, None, 0, idr_count % 2))
            idr_count += 1
        else:
            frame_num += 1
            nals.append(slice_nal(mbs, prev, frame_num, 0))
        sync.append(prev is None)
        prev = mbs
    return sps, pps, nals, sync


# --------------------------------------------------------------------------- #
# The MP4 container
# --------------------------------------------------------------------------- #


def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_mp4(path: str, sps: bytes, pps: bytes, samples: Sequence[Sequence[bytes]],
              sync: Sequence[bool], width: int, height: int, fps=30,
              nal_length_size: int = 4, co64: bool = False,
              chunks: Optional[Sequence[int]] = None, ctts: Optional[Sequence[int]] = None,
              profile: Tuple[int, int, int] = (66, 0xC0, LEVEL_IDC)) -> dict:
    """An MP4 of one H.264 video track. ``samples``: the NAL units of each
    access unit in decoding order; ``sync``: which are sync samples (all of
    them: no ``stss``). ``chunks``: samples a chunk (default one chunk),
    with 5 bytes between chunks; ``ctts``: a composition offset a sample in
    frame durations. Returns the sample table as written (what a demuxer
    must read back)."""
    fps = Fraction(fps).limit_denominator(100000)
    scale = max(1, -(-1000 // fps.numerator))
    timescale, delta = fps.numerator * scale, fps.denominator * scale
    n = len(samples)
    if any(len(nal) >= 1 << (8 * nal_length_size) for nals in samples for nal in nals):
        raise ValueError(f"a NAL unit does not fit a {nal_length_size}-byte length")
    data = [b"".join(len(nal).to_bytes(nal_length_size, "big") + nal for nal in nals)
            for nals in samples]
    chunks = list(chunks) if chunks else [n]
    if sum(chunks) != n or min(chunks) < 1:
        raise ValueError(f"chunks {chunks} do not hold {n} samples")

    ftyp = box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41")
    gap = b"\xee" * 5 if len(chunks) > 1 else b""
    mdat_body, chunk_offsets, offsets, k = [], [], [], 0
    pos = len(ftyp) + 8
    for size in chunks:
        chunk_offsets.append(pos)
        for d in data[k:k + size]:
            offsets.append(pos)
            mdat_body.append(d)
            pos += len(d)
        k += size
        mdat_body.append(gap)
        pos += len(gap)
    mdat = box(b"mdat", *mdat_body)

    duration = n * delta
    stsc, prev = [], None
    for i, size in enumerate(chunks):
        if size != prev:
            stsc.append(struct.pack(">3I", i + 1, size, 1))
            prev = size
    avcc = box(b"avcC", bytes([1, *profile, 0xFC | (nal_length_size - 1), 0xE1]),
               struct.pack(">H", len(sps)), sps, b"\x01", struct.pack(">H", len(pps)), pps)
    avc1 = box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
               struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
               bytes([0]) + bytes(31), struct.pack(">Hh", 0x18, -1), avcc)
    tables = [full_box(b"stsd", 0, 0, struct.pack(">I", 1), avc1),
              full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if ctts is not None:
        signed = min(ctts) < 0  # version 1: signed offsets
        tables.append(full_box(b"ctts", int(signed), 0, struct.pack(">I", n),
                               *(struct.pack(">Ii" if signed else ">II", 1, c * delta)
                                 for c in ctts)))
    if not all(sync):
        sync_numbers = [i + 1 for i, s in enumerate(sync) if s]
        tables.append(full_box(b"stss", 0, 0, struct.pack(">I", len(sync_numbers)),
                               struct.pack(f">{len(sync_numbers)}I", *sync_numbers)))
    tables += [
        full_box(b"stsc", 0, 0, struct.pack(">I", len(stsc)), *stsc),
        full_box(b"stsz", 0, 0, struct.pack(">II", 0, n), struct.pack(f">{n}I", *map(len, data))),
        full_box(b"co64" if co64 else b"stco", 0, 0, struct.pack(">I", len(chunk_offsets)),
                 struct.pack(f">{len(chunk_offsets)}{'Q' if co64 else 'I'}", *chunk_offsets)),
    ]
    minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)),
               box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     full_box(b"url ", 0, 1))),
               box(b"stbl", *tables))
    mdia = box(b"mdia",
               full_box(b"mdhd", 0, 0,
                        struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0)),
               full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\x00"),
               minf)
    trak = box(b"trak",
               full_box(b"tkhd", 0, 3, struct.pack(">5I", 0, 0, 1, 0, duration), bytes(8),
                        struct.pack(">hhhH", 0, 0, 0, 0), MATRIX,
                        struct.pack(">II", width << 16, height << 16)),
               mdia)
    mvhd = full_box(b"mvhd", 0, 0, struct.pack(">4I", 0, 0, timescale, duration),
                    struct.pack(">IH", 0x10000, 0x100), bytes(10), MATRIX, bytes(24),
                    struct.pack(">I", 2))
    with open(path, "wb") as f:
        f.write(ftyp + mdat + box(b"moov", mvhd, trak))
    return {"sizes": [len(d) for d in data], "offsets": offsets, "sync": list(sync),
            "timescale": timescale, "delta": delta,
            "ctts": [c * delta for c in ctts] if ctts is not None else [0] * n}


def write_h264_mp4(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray, fps=30,
                   idr_every: int = 0, **container) -> dict:
    """Planes -> an H.264 ``.mp4`` (see :func:`encode` and :func:`write_mp4`);
    returns the sample table as written."""
    sps, pps, nals, sync = encode(y, u, v, idr_every)
    return write_mp4(path, sps, pps, [[nal] for nal in nals], sync, y.shape[2], y.shape[1],
                     fps=fps, **container)


def gray_planes(frames: np.ndarray):
    """(frames, H, W[, 1]) gray frames as planes: Y the frames, U = V = 128."""
    y = np.asarray(frames, np.uint8).reshape(frames.shape[:3])
    c = np.full((y.shape[0], y.shape[1] // 2, y.shape[2] // 2), 128, np.uint8)
    return y, c, c.copy()


def write_y4m(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray, fps: int = 30) -> None:
    """The same planes as a raw 4:2:0 ``.y4m``, which OpenCV's FFmpeg
    backend reads and converts with the same rule as decoded video."""
    n, h, w = y.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for i in range(n):
            f.write(b"FRAME\n" + y[i].tobytes() + u[i].tobytes() + v[i].tobytes())


def moving_planes(n: int, width: int, height: int, seed: int = 0, gray: bool = False):
    """Seeded planes in 1-255 over a still background, with a block that
    moves a few macroblocks a frame (so P frames mix P_Skip and I_PCM)."""
    rng = np.random.default_rng(seed)
    y = np.repeat(rng.integers(1, 256, (1, height, width), dtype=np.uint8), n, axis=0)
    u = np.repeat(rng.integers(1, 256, (1, height // 2, width // 2), dtype=np.uint8), n, axis=0)
    v = np.repeat(rng.integers(1, 256, (1, height // 2, width // 2), dtype=np.uint8), n, axis=0)
    size = max(2, min(width, height) // 4) // 2 * 2
    for i in range(n):
        x0 = (i * 10) % max(1, width - size) // 2 * 2
        y0 = (i * 6) % max(1, height - size) // 2 * 2
        y[i, y0:y0 + size, x0:x0 + size] = rng.integers(1, 256, (size, size), dtype=np.uint8)
        c0, cs = (y0 // 2, x0 // 2), size // 2
        u[i, c0[0]:c0[0] + cs, c0[1]:c0[1] + cs] = rng.integers(1, 256, (cs, cs), dtype=np.uint8)
        v[i, c0[0]:c0[0] + cs, c0[1]:c0[1] + cs] = rng.integers(1, 256, (cs, cs), dtype=np.uint8)
    if gray:
        u[:] = 128
        v[:] = 128
    return y, u, v


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--width", type=int, default=100)
    p.add_argument("--height", type=int, default=72)
    p.add_argument("--gray", action="store_true")
    p.add_argument("--idr-every", type=int, default=4)
    p.add_argument("--co64", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--y4m", default=None)
    a = p.parse_args(argv)
    planes = moving_planes(a.frames, a.width, a.height, a.seed, a.gray)
    table = write_h264_mp4(a.out, *planes, idr_every=a.idr_every, co64=a.co64)
    if a.y4m:
        write_y4m(a.y4m, *planes)
    print(f"{a.out}: {a.frames} frames of {a.width}x{a.height}, {sum(table['sync'])} sync, "
          f"{sum(table['sizes'])} bytes of samples")


if __name__ == "__main__":
    main()
