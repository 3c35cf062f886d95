"""A pure-Python ISO-BMFF (``.mp4``, ``.mov``, QuickTime) demuxer for H.264,
Motion-JPEG and MPEG-4 Part 2 video, and what the card's readers share of a
demuxed track.

:class:`Mp4Video` reads what a decoder needs from the file's first video
track, found by content, whatever the file's extension: the sample entry
(``avc1``/``avc3`` with ``avcC``: profile, NAL length size, SPS and PPS, the
display size from the SPS's frame cropping; or ``jpeg``/``mjpa``, one JPEG a
sample, at the ``VisualSampleEntry``'s size; or ``mp4v`` whose ``esds`` names
MPEG-4 Visual (objectTypeIndication 0x20), its DecoderSpecificInfo the VOL
header, one VOP a sample), the sample table (sizes from
``stsz``, offsets from ``stco``/``co64`` and ``stsc``, sync samples from
``stss``, where its absence means every sample is one, and timing from
``stts``/``ctts``), and the edit list (``edts/elst``, versions 0 and 1).

Frames are numbered as OpenCV's FFmpeg backend numbers them. Its count
(``CAP_PROP_FRAME_COUNT``) is ``stts``'s samples and its fps the samples over
their duration, edit list or not. Its ``read()`` sequence is what is left
after FFmpeg's mov demuxer applies the edit list (``mov_fix_index``,
:func:`edit_packets`): each edit starts at the last sync sample at or before
its media time, decodes on to the first sync sample that reaches its end,
and the decoder drops every packet presented outside the edit. Empty edits
(media time -1) only delay the start; an edit may repeat samples. Without
an edit list frame ``i`` is the ``i``-th sample in presentation order
(decoding time plus ``ctts``). :meth:`Track.to_annexb` gives an H.264
packet as an Annex-B byte stream (a start code before each NAL unit), with
the SPS and PPS in front of the packet that decoding starts from. Any other
codec (``mjpb``, whose frames carry no markers, ``mjp2``, an ``mp4v`` entry
of MPEG-1 or MPEG-2 video, ...) raises :class:`NotImplementedError` naming it.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

START_CODE = b"\x00\x00\x00\x01"
_TODO = "(ROADMAP.md, queue 1, item 3g: other codecs and containers)"
INT_MAX = (1 << 31) - 1
#: Sample entries by the codec the card decodes them with.
ENTRIES = {b"avc1": "h264", b"avc3": "h264", b"jpeg": "mjpeg", b"mjpa": "mjpeg",
           b"mp4v": "mpeg4"}
#: ISO-BMFF top-level boxes a file may start with (from FFmpeg's ``mov_probe``).
TOP_LEVEL = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"udta", b"uuid")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not read on the card yet {_TODO}; read it with "
                               f"--video.device cpu (cv2). The card reads Motion-JPEG and MPEG-4 "
                               f"Part 2 in AVI, QuickTime/ISO-BMFF and Matroska files, AVI files of "
                               f"uncompressed frames, and H.264 in ISO-BMFF and Matroska files.")


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """FFmpeg's ``av_reduce``: ``num / den`` as the nearest fraction whose
    terms are at most ``limit`` (a convergent of its continued fraction, or
    the best semiconvergent), for non-negative terms."""
    g = math.gcd(num, den) or 1
    num, den = num // g, den // g
    if num <= limit and den <= limit:
        return num, den
    a0, a1 = (0, 1), (1, 0)
    while den:
        x, rest = divmod(num, den)
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1, num, den = a1, a2, den, rest
    return a1


def av_rescale(a: int, b: int, c: int) -> int:
    """FFmpeg's ``av_rescale``: ``a * b / c`` rounded to nearest, halves away
    from zero."""
    q = (abs(a) * b + c // 2) // c
    return q if a >= 0 else -q


def _boxes(data: bytes, start: int = 0,
           end: Optional[int] = None) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, payload end) of the boxes in ``data[start:end]``."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"box {kind!r} at byte {pos} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


def _find(data: bytes, path: List[bytes], start: int = 0, end: Optional[int] = None):
    """The payload (start, end) of the first box along ``path``, or None."""
    for kind, a, b in _boxes(data, start, end):
        if kind == path[0]:
            return (a, b) if len(path) == 1 else _find(data, path[1:], a, b)
    return None


def _top_level_moov(f, size: int) -> bytes:
    """The ``moov`` box's payload, read from its place among the top-level
    boxes (``mdat`` is skipped, not read)."""
    pos = 0
    while pos + 8 <= size:
        f.seek(pos)
        head = f.read(16)
        length, kind = struct.unpack_from(">I4s", head)
        hlen = 8
        if length == 1:
            length, hlen = struct.unpack_from(">Q", head, 8)[0], 16
        elif length == 0:
            length = size - pos
        if length < hlen:
            break
        if kind == b"moov":
            f.seek(pos + hlen)
            return f.read(length - hlen)
        pos += length
    raise _unsupported(f"{getattr(f, 'name', 'this file')}: a file with no 'moov' box (not an "
                       f"ISO-BMFF container)")


class BitReader:
    """Bits of an RBSP (emulation-prevention bytes removed)."""

    def __init__(self, rbsp: bytes):
        self.value = int.from_bytes(rbsp, "big")
        self.left = 8 * len(rbsp)

    def u(self, n: int) -> int:
        if n > self.left:
            raise ValueError("parameter set ends early")
        self.left -= n
        return (self.value >> self.left) & ((1 << n) - 1)

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def rbsp(nal: bytes) -> bytes:
    """A NAL unit's payload without its header byte and emulation-prevention
    bytes (``00 00 03`` -> ``00 00``)."""
    out, zeros = bytearray(), 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def parse_sps(nal: bytes) -> Dict[str, int]:
    """The fields of an H.264 SPS (7.3.2.1.1) that give the picture: the
    profile, chroma format, bit depths and the cropped (display) size."""
    r = BitReader(rbsp(nal))
    sps = {"profile_idc": r.u(8)}
    r.u(16)  # constraint flags, level_idc
    r.ue()  # seq_parameter_set_id
    sps.update(chroma_format_idc=1, bit_depth_luma=8, bit_depth_chroma=8)
    separate_planes = 0
    if sps["profile_idc"] in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        sps["chroma_format_idc"] = r.ue()
        if sps["chroma_format_idc"] == 3:
            separate_planes = r.u(1)
        sps["bit_depth_luma"] = 8 + r.ue()
        sps["bit_depth_chroma"] = 8 + r.ue()
        r.u(1)  # qpprime_y_zero_transform_bypass_flag
        if r.u(1):  # seq_scaling_matrix_present_flag
            for i in range(8 if sps["chroma_format_idc"] != 3 else 12):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    r.ue()  # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed_flag
    width_mbs, height_units = r.ue() + 1, r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field_flag
    r.u(1)  # direct_8x8_inference_flag
    crop = (r.ue(), r.ue(), r.ue(), r.ue()) if r.u(1) else (0, 0, 0, 0)
    chroma = 0 if separate_planes else sps["chroma_format_idc"]
    sub_w, sub_h = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}[chroma]
    unit_x = sub_w if chroma else 1
    unit_y = (sub_h if chroma else 1) * (2 - frame_mbs_only)
    sps["coded_width"] = 16 * width_mbs
    sps["coded_height"] = 16 * height_units * (2 - frame_mbs_only)
    sps["width"] = sps["coded_width"] - unit_x * (crop[0] + crop[1])
    sps["height"] = sps["coded_height"] - unit_y * (crop[2] + crop[3])
    sps["frame_mbs_only"] = frame_mbs_only
    return sps


def parse_avcc(avcc: bytes, filename: str) -> Tuple[int, List[bytes], List[bytes]]:
    """An ``avcC`` record (ISO 14496-15 5.3.3.1; Matroska's
    ``V_MPEG4/ISO/AVC`` ``CodecPrivate``): (NAL length size, SPSs, PPSs)."""
    try:
        nal_length_size = (avcc[4] & 3) + 1
        sps, pps, pos = [], [], 6
        for out, count in ((sps, avcc[5] & 0x1F), (pps, None)):
            if count is None:
                count, pos = avcc[pos], pos + 1
            for _ in range(count):
                n = struct.unpack_from(">H", avcc, pos)[0]
                out.append(bytes(avcc[pos + 2:pos + 2 + n]))
                pos += 2 + n
    except (IndexError, struct.error) as e:
        raise ValueError(f"{filename}: a truncated 'avcC' record") from e
    return nal_length_size, sps, pps


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """An MPEG-4 descriptor's (tag, body start, body end) at ``pos``: its size
    in up to four bytes of seven bits, the high bit continuing."""
    tag, size, pos = data[pos], 0, pos + 1
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def parse_esds(esds: bytes, filename: str) -> Tuple[int, bytes]:
    """An ``esds`` box body's objectTypeIndication and DecoderSpecificInfo
    (an MPEG-4 Visual stream's VOL header), as FFmpeg's ``ff_mp4_read_dec_config_descr``
    reads them."""
    try:
        tag, a, end = _descriptor(esds, 4)  # after the full box's version and flags
        if tag != 0x03:
            raise ValueError
        flags = esds[a + 2]
        a += 3 + (2 if flags & 0x80 else 0)  # ES_ID, flags, dependsOn_ES_ID
        if flags & 0x40:  # a URL
            a += 1 + esds[a]
        a += 2 if flags & 0x20 else 0  # OCR_ES_Id
        tag, a, end = _descriptor(esds, a)
        if tag != 0x04:
            raise ValueError
        oti = esds[a]
        a += 13
        info = b""
        if a < end:
            tag, b, e = _descriptor(esds, a)
            if tag == 0x05:
                info = esds[b:e]
        return oti, info
    except (ValueError, IndexError):
        raise ValueError(f"{filename}: an 'esds' box without an ES and decoder configuration "
                         f"descriptor") from None


def edit_packets(dts: np.ndarray, pts: np.ndarray, sync: np.ndarray, has_ctts: bool,
                 edits: Sequence[Tuple[int, int]], media_timescale: int, movie_timescale: int):
    """FFmpeg's ``mov_fix_index``: the packets the mov demuxer hands its
    decoder for ``edits`` ((duration in the movie's timescale, media time in
    the track's), in order). Returns each packet's sample, whether its frame
    is kept (presented inside its edit; the decoder drops the rest) and its
    edit's number. Empty edits (media time -1) give no packets. An edit
    starts at :func:`_edit_start`'s sample and runs to the first sync sample
    whose end reaches the edit's end (with ``ctts``, to the second, for the
    B-frames that may trail it)."""
    n = len(dts)
    if not len(edits):
        return np.arange(n), np.ones(n, bool), np.zeros(n, np.int64)
    packets, keep, edit_of = [], [], []
    for e, (duration, media_time) in enumerate(edits):
        if media_time == -1:
            continue
        end = media_time + av_rescale(duration, media_timescale, movie_timescale)
        after_end = False
        for k in range(_edit_start(dts, pts, sync, has_ctts, media_time), n):
            packets.append(k)
            keep.append(media_time <= pts[k] < end)
            edit_of.append(e)
            frame_duration = dts[k + 1] - dts[k] if k + 1 < n else end - media_time
            if pts[k] + frame_duration >= end and sync[k]:
                if has_ctts and not after_end:
                    after_end = True
                    continue
                break
    return (np.array(packets, np.int64), np.array(keep, bool).reshape(-1),
            np.array(edit_of, np.int64))


def _edit_start(dts, pts, sync, has_ctts: bool, media_time: int) -> int:
    """``find_prev_closest_index``: the last sync sample decoded at or before
    ``media_time`` (with ``ctts``: also presented at or before it); else,
    without ``ctts``, the last sample decoded by then; else the first."""
    last = int(np.searchsorted(dts, media_time, "right")) - 1
    syncs = np.flatnonzero(sync[:last + 1])
    if has_ctts:
        syncs = syncs[pts[syncs] <= media_time]
        return int(syncs[-1]) if len(syncs) else 0
    return int(syncs[-1]) if len(syncs) else max(last, 0)


class Track:
    """A demuxed video track as the card's readers take it.

    Samples are the container's frames in file (decoding) order, with
    ``sync`` flags. Packets are what the demuxer hands the decoder, in order:
    ``packets[k]`` is packet ``k``'s sample (an edit list may skip or repeat
    samples). Presentation frame ``i``, cv2's ``i``-th ``read()``, is packet
    ``order[i]``; ``rank[k]`` is packet ``k``'s frame, -1 where the decoder
    drops it. ``frames`` and ``fps`` are cv2's ``CAP_PROP_FRAME_COUNT`` and
    ``CAP_PROP_FPS``, which need not equal :attr:`readable`. ``kind`` is
    "h264" (then ``nal_length_size``, ``sps``, ``pps`` and the SPS's
    ``format``) or "mjpeg"."""

    filename: str
    kind: str
    sync: np.ndarray
    nal_length_size: int
    sps: List[bytes]
    pps: List[bytes]

    def _present(self, packets: np.ndarray, keep: np.ndarray, keys: Sequence[np.ndarray] = ()):
        """Set ``packets``, ``order`` and ``rank``: the kept packets in file
        order, or sorted by ``keys`` (``np.lexsort``'s, the last the primary)."""
        self.packets = np.asarray(packets, np.int64)
        kept = np.flatnonzero(keep)
        if len(keys):
            kept = kept[np.lexsort([np.asarray(k)[kept] for k in keys])]
        self.order = kept
        self.rank = np.full(len(self.packets), -1, np.int64)
        self.rank[kept] = np.arange(len(kept))
        if self.kind == "h264":
            if not self.sps:
                raise ValueError(f"{self.filename}: the 'avcC' record holds no SPS")
            self.format = parse_sps(self.sps[0])

    @property
    def readable(self) -> int:
        """Frames ``read()`` gives before it fails."""
        return len(self.order)

    def sync_before(self, frame: int) -> int:
        """The packet of the last sync sample at or before presentation frame
        ``frame``'s packet: where decoding it starts."""
        k = int(self.order[frame])
        syncs = np.flatnonzero(self.sync[self.packets[:k + 1]])
        if not len(syncs):
            raise ValueError(f"{self.filename}: no sync sample before frame {frame}")
        return int(syncs[-1])

    def read_sample(self, f, k: int) -> bytes:
        raise NotImplementedError

    def read_packet(self, f, k: int) -> bytes:
        return self.read_sample(f, int(self.packets[k]))

    def read(self, f, i: int) -> bytes:
        """Presentation frame ``i``'s bytes from the open file ``f``."""
        if not 0 <= i < self.readable:
            raise KeyError(f"Unable to load frame {i} from {self.filename}.")
        return self.read_packet(f, int(self.order[i]))

    def to_annexb(self, sample: bytes, parameter_sets: bool = False) -> bytes:
        """An H.264 sample's length-prefixed NAL units as Annex-B, with the
        SPS and PPS first when ``parameter_sets``."""
        out = [START_CODE + nal for nal in (self.sps + self.pps)] if parameter_sets else []
        pos, n = 0, self.nal_length_size
        while pos < len(sample):
            if pos + n > len(sample):
                raise ValueError(f"{self.filename}: a NAL length runs past its sample")
            size = int.from_bytes(sample[pos:pos + n], "big")
            if pos + n + size > len(sample):
                raise ValueError(f"{self.filename}: a NAL unit runs past its sample")
            out.append(START_CODE + sample[pos + n:pos + n + size])
            pos += n + size
        return b"".join(out)


@dataclass
class Mp4Video(Track):
    """The first video track of an ISO-BMFF file (``.mp4``, ``.mov``, ...).

    Per sample, in decoding order: ``sizes``, ``offsets``, ``sync``, ``dts``
    and ``cts`` (``ctts`` offsets) in ``timescale`` units; the track's
    ``duration`` (the sum of ``stts``) over ``samples`` (its count);
    ``codec`` the sample entry's fourcc and ``entry_size`` its (width,
    height); ``edits`` the edit list as (duration in ``movie_timescale``
    units, media time) pairs, empty without one."""

    filename: str
    codec: str
    sizes: np.ndarray
    offsets: np.ndarray
    sync: np.ndarray
    dts: np.ndarray
    cts: np.ndarray
    timescale: int
    duration: int
    samples: int
    entry_size: Tuple[int, int] = (0, 0)
    nal_length_size: int = 0
    sps: List[bytes] = field(default_factory=list)
    pps: List[bytes] = field(default_factory=list)
    movie_timescale: int = 0
    edits: List[Tuple[int, int]] = field(default_factory=list)
    has_ctts: bool = False
    config: bytes = b""  # MPEG-4 Part 2: the VOL header (esds's DecoderSpecificInfo)

    @classmethod
    def open(cls, filename: str) -> "Mp4Video":
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"Could not find video file named {filename}.")
        with open(filename, "rb") as f:
            head = f.read(12)
            if head[:4] == b"RIFF" or head[:4] == b"\x1a\x45\xdf\xa3":
                ext = os.path.splitext(filename)[1]
                raise _unsupported(f"{filename}: an AVI or Matroska container named {ext} given "
                                   f"to the ISO-BMFF demuxer")
            moov = _top_level_moov(f, os.fstat(f.fileno()).st_size)
        mvhd = _find(moov, [b"mvhd"])
        movie_timescale = 0
        if mvhd:
            movie_timescale = struct.unpack_from(">I", moov, mvhd[0] + (20 if moov[mvhd[0]] == 1 else 12))[0]
        for kind, a, b in _boxes(moov):
            if kind != b"trak":
                continue
            hdlr = _find(moov, [b"mdia", b"hdlr"], a, b)
            if hdlr and moov[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                return cls._from_trak(filename, moov, a, b, movie_timescale)
        raise ValueError(f"{filename}: no video track")

    @classmethod
    def _from_trak(cls, filename: str, moov: bytes, a: int, b: int,
                   movie_timescale: int) -> "Mp4Video":
        mdhd = _find(moov, [b"mdia", b"mdhd"], a, b)
        version = moov[mdhd[0]]
        timescale = struct.unpack_from(">I", moov, mdhd[0] + (20 if version == 1 else 12))[0]
        stbl = _find(moov, [b"mdia", b"minf", b"stbl"], a, b)
        tables = {kind: (s, e) for kind, s, e in _boxes(moov, *stbl)}

        s, _ = tables[b"stsd"]
        entry_size, fourcc = struct.unpack_from(">I4s", moov, s + 8)
        name = fourcc.decode("latin-1")
        kind = ENTRIES.get(fourcc)
        if kind is None:
            what = {b"mjpb": "Motion-JPEG format B ('mjpb': its frames carry no JPEG markers)",
                    b"mjp2": "Motion JPEG 2000 ('mjp2')"}.get(fourcc, f"video coded as {name!r}")
            raise _unsupported(f"{filename}: {what}")
        width, height = struct.unpack_from(">HH", moov, s + 16 + 24)
        config = {}
        if kind == "mpeg4":
            esds = _find(moov, [b"esds"], s + 16 + 78, s + 8 + entry_size)
            if esds is None:
                raise ValueError(f"{filename}: an 'mp4v' entry without 'esds'")
            oti, info = parse_esds(moov[esds[0]:esds[1]], filename)
            if oti != 0x20:
                raise _unsupported(f"{filename}: an 'mp4v' entry of objectTypeIndication "
                                   f"{oti:#x} (not MPEG-4 Visual)")
            config = {"config": info}
        if kind == "h264":
            avcc = _find(moov, [b"avcC"], s + 16 + 78, s + 8 + entry_size)
            if avcc is None:
                raise ValueError(f"{filename}: an {name} entry without 'avcC'")
            config = dict(zip(("nal_length_size", "sps", "pps"),
                              parse_avcc(moov[avcc[0]:avcc[1]], filename)))

        def table(kind, fmt, per=1, offset=8):
            """A full box's entries: a count at ``offset - 4``, then ``per``
            values an entry; (entries, per) int64."""
            s, _ = tables[kind]
            count = struct.unpack_from(">I", moov, s + offset - 4)[0]
            values = np.frombuffer(moov, np.dtype(fmt), count * per, s + offset)
            return values.astype(np.int64).reshape(count, per)

        if b"stsz" not in tables:
            raise _unsupported(f"{filename}: sample sizes other than 'stsz' (compact 'stz2')")
        s, _ = tables[b"stsz"]
        fixed, count = struct.unpack_from(">II", moov, s + 4)
        sizes = np.full(count, fixed, np.int64) if fixed else table(b"stsz", ">u4", 1, 12)[:, 0]
        n = len(sizes)

        chunks = (table(b"co64", ">u8") if b"co64" in tables else table(b"stco", ">u4"))[:, 0]
        stsc = table(b"stsc", ">u4", 3)
        # Samples a chunk: each stsc entry holds from its first chunk to the next entry's.
        first = np.append(stsc[:, 0] - 1, len(chunks))
        per_chunk = np.repeat(stsc[:, 1], np.diff(first))
        if per_chunk.sum() < n:
            raise ValueError(f"{filename}: the chunks hold {per_chunk.sum()} of {n} samples")
        chunk_of = np.repeat(np.arange(len(chunks)), per_chunk)[:n]
        first_sample = (np.cumsum(per_chunk) - per_chunk)[chunk_of]
        before = np.cumsum(sizes) - sizes  # bytes of the samples before each one
        offsets = chunks[chunk_of] + before - before[first_sample]

        sync = np.ones(n, bool)
        if b"stss" in tables:
            sync[:] = False
            sync[table(b"stss", ">u4")[:, 0] - 1] = True
        stts = table(b"stts", ">u4", 2)
        deltas = np.repeat(stts[:, 1], stts[:, 0])[:n]
        dts = np.cumsum(deltas) - deltas
        cts = np.zeros(n, np.int64)
        if b"ctts" in tables:
            ctts = table(b"ctts", ">u4", 2)
            offs = ctts[:, 1]
            if moov[tables[b"ctts"][0]] == 1:  # version 1: signed offsets
                offs = offs.astype(np.uint32).view(np.int32).astype(np.int64)
            cts = np.repeat(offs, ctts[:, 0])[:n]
        edits = _edit_list(filename, moov, a, b)
        return cls(filename, name, sizes, offsets, sync, dts, cts, timescale,
                   int((stts[:, 0] * stts[:, 1]).sum()), int(stts[:, 0].sum()), (width, height),
                   movie_timescale=movie_timescale, edits=edits, has_ctts=b"ctts" in tables,
                   **config)

    def __post_init__(self):
        self.kind = ENTRIES[self.codec.encode("latin-1")]
        if self.edits and not self.movie_timescale:
            raise _unsupported(f"{self.filename}: an edit list under a movie timescale of 0")
        pts = self.dts + self.cts
        packets, keep, edit_of = edit_packets(self.dts, pts, self.sync, self.has_ctts, self.edits,
                                              self.timescale, self.movie_timescale)
        # H.264 frames leave the decoder in presentation order within an edit;
        # Motion-JPEG and MPEG-4 Part 2 (I- and P-VOPs) frames in the order
        # they went in.
        keys = (pts[packets], edit_of) if self.kind == "h264" else ()
        self._present(packets, keep, keys)

    @property
    def frames(self) -> int:
        """cv2's frame count: ``stts``'s samples, whatever the edit list."""
        return self.samples

    @property
    def fps(self) -> float:
        """Samples over the track's duration, as FFmpeg's ``avg_frame_rate``."""
        if not self.duration:
            return 0.0
        num, den = av_reduce(self.timescale * self.samples, self.duration, INT_MAX)
        return num / den

    @property
    def width(self) -> int:
        return self.format["width"] if self.kind == "h264" else self.entry_size[0]

    @property
    def height(self) -> int:
        return self.format["height"] if self.kind == "h264" else self.entry_size[1]

    def read_sample(self, f, k: int) -> bytes:
        f.seek(int(self.offsets[k]))
        data = f.read(int(self.sizes[k]))
        if len(data) != self.sizes[k]:
            raise ValueError(f"{self.filename}: sample {k} runs past the end of the file")
        return data


def _edit_list(filename: str, moov: bytes, a: int, b: int) -> List[Tuple[int, int]]:
    """A ``trak``'s ``edts/elst`` as (segment duration, media time) pairs;
    an edit of another rate than 1, or of a negative media time but -1,
    raises naming it."""
    elst = _find(moov, [b"edts", b"elst"], a, b)
    if elst is None:
        return []
    s, e = elst
    version = moov[s]
    (count,) = struct.unpack_from(">I", moov, s + 4)
    fmt = ">QqHH" if version == 1 else ">IiHH"
    size = struct.calcsize(fmt)
    if s + 8 + count * size > e:
        raise ValueError(f"{filename}: an 'elst' of {count} edits runs past its box")
    edits = []
    for duration, media_time, rate, frac in struct.iter_unpack(fmt, moov[s + 8:s + 8 + count * size]):
        if (rate, frac) != (1, 0):
            raise _unsupported(f"{filename}: an edit of rate {rate + frac / 65536}")
        if media_time < -1:
            raise _unsupported(f"{filename}: an edit of media time {media_time}")
        edits.append((duration, media_time))
    return edits
