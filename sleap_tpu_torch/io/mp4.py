"""A pure-Python ISO-BMFF (``.mp4``, ``.mov``) demuxer for H.264 video.

It reads what a decoder needs from the file's first video track: the
``stsd`` entry (``avc1``/``avc3`` with ``avcC``: profile, NAL length size,
SPS and PPS), the sample table (sizes from ``stsz``, offsets from
``stco``/``co64`` and ``stsc``, sync samples from ``stss``, where its absence
means every sample is one, and timing from ``stts``/``ctts``), the frame
rate, and the display size from the SPS's frame cropping.

Frame ``i``, as OpenCV numbers frames, is the ``i``-th sample in
presentation order (decoding time plus ``ctts``). :meth:`Mp4Video.to_annexb`
gives a sample (:meth:`Mp4Video.read_sample`) as an Annex-B byte stream (a
start code before each NAL unit), with the SPS and PPS in front of the
sample that decoding starts from. Any other codec or container raises :class:`NotImplementedError`
naming it.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

EXTS = ("mp4", "mov")
START_CODE = b"\x00\x00\x00\x01"
_TODO = "(ROADMAP.md, queue 1, item 3g: other codecs and containers)"


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not read on the card yet {_TODO}; only AVI files of "
                               f"Motion-JPEG or uncompressed frames, and H.264 in .mp4 or .mov, "
                               f"are.")


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


@dataclass
class Mp4Video:
    """The first video track of an ``.mp4``/``.mov`` file, H.264 only.

    Per sample, in decoding order: ``sizes``, ``offsets``, ``sync``,
    ``dts`` and ``cts`` (``ctts`` offsets) in ``timescale`` units, and
    the track's ``duration`` (the sum of ``stts``);
    ``order[i]`` is the decoding index of presentation frame ``i``."""

    filename: str
    codec: str
    nal_length_size: int
    sps: List[bytes]
    pps: List[bytes]
    sizes: np.ndarray
    offsets: np.ndarray
    sync: np.ndarray
    dts: np.ndarray
    cts: np.ndarray
    timescale: int
    duration: int

    @classmethod
    def open(cls, filename: str) -> "Mp4Video":
        ext = os.path.splitext(filename)[1].lower().lstrip(".")
        if ext not in EXTS:
            raise _unsupported(f"{filename}: the .{ext} container")
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"Could not find video file named {filename}.")
        with open(filename, "rb") as f:
            head = f.read(12)
            if head[:4] == b"RIFF" or head[:4] == b"\x1a\x45\xdf\xa3":
                raise _unsupported(f"{filename}: an AVI or Matroska container named .{ext}")
            moov = _top_level_moov(f, os.fstat(f.fileno()).st_size)
        for kind, a, b in _boxes(moov):
            if kind != b"trak":
                continue
            hdlr = _find(moov, [b"mdia", b"hdlr"], a, b)
            if hdlr and moov[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                return cls._from_trak(filename, moov, a, b)
        raise ValueError(f"{filename}: no video track")

    @classmethod
    def _from_trak(cls, filename: str, moov: bytes, a: int, b: int) -> "Mp4Video":
        mdhd = _find(moov, [b"mdia", b"mdhd"], a, b)
        version = moov[mdhd[0]]
        timescale = struct.unpack_from(">I", moov, mdhd[0] + (20 if version == 1 else 12))[0]
        stbl = _find(moov, [b"mdia", b"minf", b"stbl"], a, b)
        tables = {kind: (s, e) for kind, s, e in _boxes(moov, *stbl)}

        s, _ = tables[b"stsd"]
        entry_size, fourcc = struct.unpack_from(">I4s", moov, s + 8)
        name = fourcc.decode("latin-1")
        if fourcc not in (b"avc1", b"avc3"):
            raise _unsupported(f"{filename}: video coded as {name!r}")
        avcc = _find(moov, [b"avcC"], s + 16 + 78, s + 8 + entry_size)
        if avcc is None:
            raise ValueError(f"{filename}: an {name} entry without 'avcC'")
        c = avcc[0]
        nal_length_size = (moov[c + 4] & 3) + 1
        sps, pps, pos = [], [], c + 6
        for out, count in ((sps, moov[c + 5] & 0x1F), (pps, None)):
            if count is None:
                count, pos = moov[pos], pos + 1
            for _ in range(count):
                n = struct.unpack_from(">H", moov, pos)[0]
                out.append(bytes(moov[pos + 2:pos + 2 + n]))
                pos += 2 + n

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
        return cls(filename, name, nal_length_size, sps, pps, sizes, offsets, sync, dts, cts,
                   timescale, int(deltas.sum()))

    # -- derived ----------------------------------------------------------- #
    def __post_init__(self):
        self.order = np.argsort(self.dts + self.cts, kind="stable")  # presentation -> decoding
        self.rank = np.empty_like(self.order)  # decoding -> presentation
        self.rank[self.order] = np.arange(len(self.order))
        if not self.sps:
            raise ValueError(f"{self.filename}: 'avcC' holds no SPS")
        self.format = parse_sps(self.sps[0])

    @property
    def frames(self) -> int:
        return len(self.sizes)

    @property
    def fps(self) -> float:
        """Samples over the track's duration, as FFmpeg's ``avg_frame_rate``."""
        return self.timescale * self.frames / self.duration if self.duration else 0.0

    @property
    def width(self) -> int:
        return self.format["width"]

    @property
    def height(self) -> int:
        return self.format["height"]

    def sync_before(self, frame: int) -> int:
        """The decoding index of the last sync sample at or before the
        sample of presentation frame ``frame``: where decoding it starts."""
        d = int(self.order[frame])
        syncs = np.flatnonzero(self.sync[:d + 1])
        if not len(syncs):
            raise ValueError(f"{self.filename}: no sync sample before frame {frame}")
        return int(syncs[-1])

    def read_sample(self, f, k: int) -> bytes:
        f.seek(int(self.offsets[k]))
        data = f.read(int(self.sizes[k]))
        if len(data) != self.sizes[k]:
            raise ValueError(f"{self.filename}: sample {k} runs past the end of the file")
        return data

    def to_annexb(self, sample: bytes, parameter_sets: bool = False) -> bytes:
        """A sample's length-prefixed NAL units as Annex-B, with the SPS and
        PPS first when ``parameter_sets``."""
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
