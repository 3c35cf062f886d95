"""A pure-Python Matroska (``.mkv``, WebM) demuxer for the card's media route:
the first video track, read as OpenCV's FFmpeg backend (``libavformat``'s
``matroskadec.c``) reads it.

The file is EBML: each element an ID (its length-marker bits kept, as the
specification writes IDs), a size (its marker dropped; all ones means
unknown, as a live writer leaves a cluster it never closed) and a body.
:class:`MkvVideo` reads

- the EBML header (DocType ``matroska`` or ``webm``);
- ``Info``: ``TimecodeScale`` (1 000 000 ns by default) and ``Duration``;
- ``Tracks``: the first video track's ``CodecID``, ``CodecPrivate``,
  ``PixelWidth``/``PixelHeight``, ``DefaultDuration`` and
  ``ContentEncodings``. ``V_MJPEG`` and ``V_MS/VFW/FOURCC`` whose
  BITMAPINFOHEADER names a Motion-JPEG fourcc (:func:`avi.bitmap_info`) are
  Motion-JPEG; ``V_MPEG4/ISO/SP``, ``/ASP`` and ``/AP``, and
  ``V_MS/VFW/FOURCC`` of an MPEG-4 fourcc (the bytes after the
  BITMAPINFOHEADER then hold any VOL header), are MPEG-4 Part 2, their
  ``CodecPrivate`` the VOL header; ``V_MPEG4/ISO/AVC`` is H.264, its
  ``CodecPrivate`` an ``avcC`` (:func:`mp4.parse_avcc`). Header stripping (``ContentCompAlgo``
  3) puts its bytes back in front of every frame; zlib, bzlib, LZO and
  encryption raise naming them;
- the index: each ``Cluster``'s ``Timecode`` and its ``SimpleBlock``\\ s and
  ``BlockGroup``\\ s (a ``Block``, key unless it has a ``ReferenceBlock``),
  laced blocks (Xiph, EBML or fixed-size lacing) one frame a lace, by one
  walk over the clusters' and blocks' heads at open: no frame is read.
  ``Cues`` are not read: the walk reads every block's head anyway, and
  covers files without Cues and unknown-size clusters alike.

Decoding order is file order. Presentation order is by block timecode for
H.264 (the decoder reorders) and file order for Motion-JPEG (``mjpegdec``
outputs frames as they come) and MPEG-4 Part 2 (I- and P-VOPs). FFmpeg gives a Matroska stream no frame count,
so cv2's ``CAP_PROP_FRAME_COUNT`` is ``floor(duration * fps + 0.5)`` of the
segment's ``Duration`` (:attr:`MkvVideo.frames`), and may differ from the
frames ``read()`` gives (:attr:`~sleap_tpu_torch.io.mp4.Track.readable`).
Its fps is ``1e9 / DefaultDuration`` reduced to terms of at most 30000; a
track without ``DefaultDuration``, whose rate FFmpeg guesses from the
timestamps of the first packets, raises.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.io import avi, mp4, mpeg4

EBML_MAGIC = b"\x1a\x45\xdf\xa3"
DOCTYPE = 0x4282
SEGMENT = 0x18538067
INFO, TIMECODESCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACKENTRY, TRACKNUMBER, TRACKTYPE, CODECID, CODECPRIVATE = (0x1654AE6B, 0xAE, 0xD7, 0x83,
                                                                     0x86, 0x63A2)
DEFAULTDURATION, VIDEO, PIXELWIDTH, PIXELHEIGHT = 0x23E383, 0xE0, 0xB0, 0xBA
CONTENTENCODINGS, CONTENTENCODING, CONTENTENCODINGTYPE = 0x6D80, 0x6240, 0x5033
CONTENTCOMPRESSION, CONTENTCOMPALGO, CONTENTCOMPSETTINGS, CONTENTENCRYPTION = (0x5034, 0x4254,
                                                                              0x4255, 0x5035)
CLUSTER, TIMECODE, SIMPLEBLOCK, BLOCKGROUP, BLOCK, REFERENCEBLOCK = (0x1F43B675, 0xE7, 0xA3, 0xA0,
                                                                     0xA1, 0xFB)
#: Elements that end an unknown-size cluster: the segment's other children
#: (Cluster, Cues, SeekHead, Info, Tracks, Tags, Chapters, Attachments).
_TOP_LEVEL = frozenset({CLUSTER, 0x1C53BB6B, 0x114D9B74, INFO, TRACKS, 0x1254C367, 0x1043A770,
                        0x1941A469})
#: ContentCompAlgo values refused, by name.
_COMPRESSION = {0: "zlib", 1: "bzlib", 2: "LZO"}
CODECS = {"V_MJPEG": "mjpeg", "V_MPEG4/ISO/AVC": "h264", "V_MS/VFW/FOURCC": "mjpeg",
          "V_MPEG4/ISO/SP": "mpeg4", "V_MPEG4/ISO/ASP": "mpeg4", "V_MPEG4/ISO/AP": "mpeg4"}
#: cv2's frame count without a ``Duration``: FFmpeg's unset duration
#: (``AV_NOPTS_VALUE``) taken as a number.
NOPTS = -(1 << 63)


def _vint(data: bytes, pos: int, marker: bool) -> Tuple[Optional[int], int]:
    """An EBML variable-size integer at ``pos``: (value, next position). IDs
    keep their marker bit; sizes drop it, and all ones is None (unknown)."""
    if pos >= len(data) or not data[pos]:
        raise ValueError(f"no EBML number of at most 8 bytes at byte {pos}")
    n = 9 - data[pos].bit_length()
    if len(data) < pos + n:
        raise ValueError(f"an EBML number runs past its data at byte {pos}")
    value = int.from_bytes(data[pos:pos + n], "big")
    if marker:
        return value, pos + n
    value &= (1 << (7 * n)) - 1
    return (None if value == (1 << (7 * n)) - 1 else value), pos + n


def _elements(data: bytes, start: int = 0, end: Optional[int] = None):
    """(ID, body start, body end) of the elements in ``data[start:end]``."""
    end = len(data) if end is None else end
    pos = start
    while pos < end:
        ident, pos = _vint(data, pos, True)
        size, pos = _vint(data, pos, False)
        stop = end if size is None else pos + size
        if stop > end:
            raise ValueError(f"an EBML element {ident:#x} runs past its parent")
        yield ident, pos, stop
        pos = stop


def _uint(body: bytes) -> int:
    return int.from_bytes(body, "big")


def _float(body: bytes) -> float:
    return struct.unpack(">f" if len(body) == 4 else ">d", body)[0] if body else 0.0


def _children(data: bytes, start: int, end: int) -> Dict[int, bytes]:
    """The first body of each child element's ID."""
    out: Dict[int, bytes] = {}
    for ident, a, b in _elements(data, start, end):
        out.setdefault(ident, data[a:b])
    return out


class _Reader:
    """Element heads of an open file, read at given positions."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def head(self, pos: int) -> Tuple[int, Optional[int], int]:
        """(ID, size or None, body start) of the element at ``pos``."""
        self.f.seek(pos)
        data = self.f.read(16)
        ident, at = _vint(data, 0, True)
        size, at = _vint(data, at, False)
        return ident, size, pos + at

    def body(self, start: int, end: int) -> bytes:
        self.f.seek(start)
        return self.f.read(end - start)


@dataclass
class MkvVideo(mp4.Track):
    """The first video track of a Matroska file: per frame (a block, or a
    lace of one) in file order, ``offsets``, ``sizes`` (the bytes stored:
    header stripping's ``strip`` goes in front of them), ``sync`` and ``timecodes`` (in
    ``timecode_scale`` ns units); ``duration`` the segment's ``Duration`` in
    the same units, None without one."""

    filename: str
    codec_id: str
    kind: str
    width: int
    height: int
    offsets: np.ndarray
    sizes: np.ndarray
    sync: np.ndarray
    timecodes: np.ndarray
    default_duration: int
    timecode_scale: int = 1000000
    duration: Optional[float] = None
    strip: bytes = b""
    nal_length_size: int = 0
    sps: List[bytes] = field(default_factory=list)
    pps: List[bytes] = field(default_factory=list)
    config: bytes = b""  # MPEG-4 Part 2: the VOL header (CodecPrivate, or past the BITMAPINFOHEADER)
    fourcc: str = ""  # V_MS/VFW/FOURCC's compression

    @classmethod
    def open(cls, filename: str) -> "MkvVideo":
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"Could not find video file named {filename}.")
        with open(filename, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if f.read(4) != EBML_MAGIC:
                raise ValueError(f"{filename} is not an EBML (Matroska) file.")
            r = _Reader(f)
            _, n, start = r.head(0)
            doctype = _children(r.body(start, start + n), 0, n).get(DOCTYPE, b"matroska")
            doctype = doctype.rstrip(b"\0").decode("latin-1")
            if doctype not in ("matroska", "webm"):
                raise mp4._unsupported(f"{filename}: an EBML file of DocType {doctype!r}")
            ident, n, seg = r.head(start + n)
            if ident != SEGMENT:
                raise ValueError(f"{filename}: no Matroska Segment after the EBML header.")
            seg_end = size if n is None else min(size, seg + n)
            return cls._from_segment(filename, r, seg, seg_end)

    @classmethod
    def _from_segment(cls, filename: str, r: _Reader, seg: int, seg_end: int) -> "MkvVideo":
        heads: Dict[int, Tuple[int, int]] = {}  # the first Info and Tracks
        first_cluster = None
        pos = seg
        while pos < seg_end and (INFO not in heads or TRACKS not in heads or first_cluster is None):
            ident, n, body = r.head(pos)
            if ident == CLUSTER:
                first_cluster = pos if first_cluster is None else first_cluster
                if n is None:
                    break
            elif n is None:
                raise ValueError(f"{filename}: an unknown-size element {ident:#x} in the segment.")
            heads.setdefault(ident, (body, body + n))
            pos = body + n
        if INFO not in heads or TRACKS not in heads:
            raise ValueError(f"{filename}: a Matroska segment without Info or Tracks.")
        info = _children(r.body(*heads[INFO]), 0, heads[INFO][1] - heads[INFO][0])
        scale = _uint(info.get(TIMECODESCALE, b"")) or 1000000
        duration = _float(info[DURATION]) if DURATION in info else None
        track = _video_track(filename, r.body(*heads[TRACKS]))
        clusters = _walk_clusters(r, first_cluster, seg_end)
        offsets, sizes, sync, timecodes = _blocks(r, clusters, track["number"])
        if not len(offsets):
            raise ValueError(f"{filename}: the video track has no frames.")
        return cls(filename, track["codec_id"], track["kind"], track["width"], track["height"],
                   offsets, sizes, sync, timecodes, track["default_duration"], scale, duration,
                   track["strip"], *track["avc"], config=track["config"], fourcc=track["fourcc"])

    def __post_init__(self):
        if not self.default_duration:
            raise mp4._unsupported(
                f"{self.filename}: a Matroska video track without DefaultDuration (FFmpeg guesses "
                f"its frame rate from the first packets' timestamps, which the port does not "
                f"model)")
        n = len(self.sizes)
        keys = (self.timecodes,) if self.kind == "h264" else ()
        self._present(np.arange(n), np.ones(n, bool), keys)

    @property
    def fps(self) -> float:
        """cv2's fps: ``1e9 / DefaultDuration`` reduced as FFmpeg reduces it."""
        num, den = mp4.av_reduce(1000000000, self.default_duration, 30000)
        return num / den

    @property
    def frames(self) -> int:
        """cv2's count, ``floor(seconds * fps + 0.5)``: the seconds of
        ``Duration`` at FFmpeg's microseconds; without one, FFmpeg's unset
        stream duration in the stream's time base."""
        if self.duration is not None:
            microseconds = int(self.duration * self.timecode_scale * 1000 / 1000000)
            seconds = microseconds / 1000000
        else:
            seconds = 0.0
        if seconds < 1e-6:
            num, den = mp4.av_reduce(self.timecode_scale, 1000000000, mp4.INT_MAX)
            seconds = NOPTS * (num / den)
        return int(math.floor(seconds * self.fps + 0.5))

    def read_sample(self, f, k: int) -> bytes:
        f.seek(int(self.offsets[k]))
        data = f.read(int(self.sizes[k]))
        if len(data) != self.sizes[k]:
            raise ValueError(f"{self.filename}: frame {k} runs past the end of the file")
        return self.strip + data


def _video_track(filename: str, tracks: bytes) -> dict:
    """The first video ``TrackEntry``: number, codec, size, DefaultDuration,
    stripped header bytes and H.264 configuration."""
    for ident, a, b in _elements(tracks):
        if ident != TRACKENTRY:
            continue
        entry = _children(tracks, a, b)
        if _uint(entry.get(TRACKTYPE, b"")) != 1:
            continue
        codec_id = entry.get(CODECID, b"").rstrip(b"\0").decode("latin-1")
        private = entry.get(CODECPRIVATE, b"")
        kind = CODECS.get(codec_id)
        fourcc, config = "", private
        if codec_id == "V_MS/VFW/FOURCC":
            if len(private) < 40:
                raise ValueError(f"{filename}: a V_MS/VFW/FOURCC track without BITMAPINFOHEADER")
            fourcc = avi.bitmap_info(private)[3]
            config = private[40:]
            kind = ("mjpeg" if fourcc.upper() in avi.MJPEG_FOURCCS else
                    "mpeg4" if fourcc.upper() in mpeg4.FOURCCS else None)
            if kind is None:
                raise mp4._unsupported(f"{filename}: Matroska V_MS/VFW/FOURCC video of fourcc "
                                       f"{fourcc!r}")
        elif kind is None:
            raise mp4._unsupported(f"{filename}: Matroska video of CodecID {codec_id!r}")
        video = _children(entry.get(VIDEO, b""), 0, len(entry.get(VIDEO, b"")))
        avc = (0, [], [])
        if kind == "h264":
            avc = mp4.parse_avcc(private, filename)
        return {"number": _uint(entry.get(TRACKNUMBER, b"")), "codec_id": codec_id, "kind": kind,
                "width": _uint(video.get(PIXELWIDTH, b"")),
                "height": _uint(video.get(PIXELHEIGHT, b"")),
                "default_duration": _uint(entry.get(DEFAULTDURATION, b"")),
                "strip": _header_stripping(filename, entry.get(CONTENTENCODINGS)), "avc": avc,
                "config": config if kind == "mpeg4" else b"", "fourcc": fourcc}
    raise ValueError(f"{filename}: no video track")


def _header_stripping(filename: str, encodings: Optional[bytes]) -> bytes:
    """The bytes header stripping removed from each frame; other content
    encodings raise naming them."""
    if encodings is None:
        return b""
    found = [_children(encodings, a, b) for ident, a, b in _elements(encodings)
             if ident == CONTENTENCODING]
    if len(found) > 1:
        raise mp4._unsupported(f"{filename}: {len(found)} combined Matroska content encodings")
    if not found:
        return b""
    enc = found[0]
    if _uint(enc.get(CONTENTENCODINGTYPE, b"")) == 1 or CONTENTENCRYPTION in enc:
        raise mp4._unsupported(f"{filename}: encrypted Matroska frames")
    comp = _children(enc.get(CONTENTCOMPRESSION, b""), 0, len(enc.get(CONTENTCOMPRESSION, b"")))
    algo = _uint(comp.get(CONTENTCOMPALGO, b""))
    if algo != 3:
        name = _COMPRESSION.get(algo, f"algorithm {algo}")
        raise mp4._unsupported(f"{filename}: Matroska frames compressed with {name}")
    return comp.get(CONTENTCOMPSETTINGS, b"")


def _walk_clusters(r: _Reader, pos: Optional[int], seg_end: int) -> List[Tuple[int, int]]:
    """Every cluster from ``pos`` on, by their heads; an unknown-size one
    ends at the first element that is not its child."""
    out = []
    while pos is not None and pos < seg_end:
        ident, n, body = r.head(pos)
        if n is None:
            if ident != CLUSTER:
                raise ValueError(f"{r.f.name}: an unknown-size element {ident:#x} in the segment.")
            end = body
            while end < seg_end:
                child, m, at = r.head(end)
                if child in _TOP_LEVEL or m is None:
                    break
                end = at + m
            out.append((body, end))
            pos = end
            continue
        if ident == CLUSTER:
            out.append((body, body + n))
        pos = body + n
    return out


def _lace_sizes(head: bytes, pos: int, flags: int, total: int) -> Tuple[List[int], int]:
    """Sizes of a block's frames, its ``total`` bytes from ``pos`` on (the
    lace head, if any, then the frames), and where its first frame starts."""
    lacing = (flags >> 1) & 3
    if not lacing:
        return [total], pos
    count, start = head[pos] + 1, pos
    pos += 1
    sizes: List[int] = []
    if lacing == 1:  # Xiph: each size as a run of 255s and a last byte
        for _ in range(count - 1):
            n = 0
            while head[pos] == 255:
                n, pos = n + 255, pos + 1
            sizes.append(n + head[pos])
            pos += 1
    elif lacing == 3:  # EBML: the first size, then signed differences
        n, pos = _vint(head, pos, False)
        sizes.append(n)
        for _ in range(count - 2):
            at = pos
            raw, pos = _vint(head, pos, True)
            width = pos - at
            sizes.append(sizes[-1] + (raw & ((1 << (7 * width)) - 1)) - ((1 << (7 * width - 1)) - 1))
    rest = total - (pos - start) - sum(sizes)
    if lacing == 2:  # fixed-size
        if rest % count:
            raise ValueError(f"a fixed-size lace of {count} frames in {rest} bytes")
        return [rest // count] * count, pos
    if rest < 0 or min(sizes, default=0) < 0:
        raise ValueError("a lace's sizes run past its block")
    return sizes + [rest], pos


def _blocks(r: _Reader, clusters: List[Tuple[int, int]], number: int):
    """Every frame of track ``number`` in ``clusters``, from the heads of
    their blocks: offsets, sizes, key flags and timecodes."""
    offsets, sizes, sync, timecodes = [], [], [], []

    def block(start: int, end: int, cluster_tc: int, key: Optional[bool]):
        head = r.body(start, min(end, start + 64))
        track, pos = _vint(head, 0, False)
        if track != number:
            return
        rel, flags = struct.unpack_from(">hB", head, pos)
        if (flags >> 1) & 3:  # a lace head may be long: read the block
            head = r.body(start, end)
        lace, first = _lace_sizes(head, pos + 3, flags, end - start - pos - 3)
        at = start + first
        for n in lace:
            offsets.append(at)
            sizes.append(n)
            sync.append(bool(flags & 0x80) if key is None else key)
            timecodes.append(cluster_tc + rel)
            at += n

    def children(a: int, b: int):
        pos = a
        while pos < b:
            ident, n, body = r.head(pos)
            end = b if n is None else body + n
            yield ident, body, end
            pos = end

    for a, b in clusters:
        cluster_tc = 0
        for ident, body, end in children(a, b):
            if ident == TIMECODE:
                cluster_tc = _uint(r.body(body, end))
            elif ident == SIMPLEBLOCK:
                block(body, end, cluster_tc, None)
            elif ident == BLOCKGROUP:
                group = list(children(body, end))
                key = not any(i == REFERENCEBLOCK for i, _, _ in group)
                for i, s, e in group:
                    if i == BLOCK:
                        block(s, e, cluster_tc, key)
    return (np.array(offsets, np.int64), np.array(sizes, np.int64), np.array(sync, bool),
            np.array(timecodes, np.int64))
