"""A RIFF AVI muxer for Motion-JPEG, and a reader of its chunks: the port's
video container where neither imageio (with ffmpeg) nor cv2 is installed
(:class:`sleap_tpu_torch.io.videowriter.VideoWriterMJPEG`).

The layout (Microsoft's AVI 1.0, with OpenDML 1.02's extension):

- ``RIFF 'AVI '``: ``LIST 'hdrl'`` holding ``avih`` (``round(1e6 / fps)`` µs
  a frame) and one ``LIST 'strl'`` of ``strh`` (``vids``, ``MJPG``, rate and
  scale from ``fps``), ``strf`` (a BITMAPINFOHEADER of compression
  ``MJPG``) and room for an ``indx`` super-index; room for ``LIST 'odml'``;
  then ``LIST 'movi'`` of ``00dc`` chunks, one JPEG each, padded to an even
  size; then ``idx1``, each entry's offset counted from the ``movi``
  fourcc.
- Once a RIFF would pass :data:`RIFF_LIMIT` (AVI 1.0's 1 GB), the frames go
  on in ``RIFF 'AVIX'`` segments of their own ``LIST 'movi'``. Every
  segment's ``movi`` then ends in an ``ix00`` standard index, ``strl``'s room
  becomes the ``indx`` super-index of those, and ``LIST 'odml'`` holds
  ``dmlh`` with the total frame count. ``idx1`` covers the first RIFF, as
  AVI 1.0 readers expect. A file that stays under the limit keeps the room
  as ``JUNK`` chunks, which every reader skips.

The frames' bytes are written as given: :func:`read_frames` gives them
back, whichever segment they are in.

:class:`AviVideo` is the demuxer of the card's media route
(:class:`sleap_tpu_torch.io.video.MediaVideo`): it reads any AVI's first
video stream as OpenCV's FFmpeg backend (``libavformat``'s ``avidec.c``)
reads it, and :class:`AviReader` decodes its Motion-JPEG, MPEG-4 Part 2
(the fourccs ``riff.c`` maps to it: ``FMP4``, ``XVID``, ``DIVX``, ``mp4v``,
...) or uncompressed frames. Its frame count is ``strh``'s ``dwLength`` and its fps ``dwRate /
dwScale``, which are cv2's ``CAP_PROP_FRAME_COUNT`` and ``CAP_PROP_FPS``.
Frames come from the OpenDML ``indx``/``ix##`` indexes where ``strl`` has
one (across ``AVIX`` segments), else from ``idx1`` (its offsets counted
from ``movi`` or from the file's start, as ``avi_read_idx1`` decides by the
first entry), else from a walk of ``movi``; ``LIST 'rec '``, ``JUNK``, odd
sizes and other streams' chunks are passed over. A zero-length chunk (a
dropped frame) takes no index entry, so, as in cv2, frame ``i`` is the
``i``-th chunk with data and reads past the last of them fail, while the
count still includes them.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from sleap_tpu_torch.io import mjpeg, mpeg4

#: The most bytes one RIFF may hold before the next frame opens an AVIX
#: segment (AVI 1.0's limit); tests lower it to write OpenDML files.
RIFF_LIMIT = 1 << 30
#: Segments the super-index has room for (RIFF_LIMIT bytes each).
MAX_SEGMENTS = 256
AVIF_HASINDEX, AVIF_ISINTERLEAVED = 0x10, 0x100
AVIIF_KEYFRAME = 0x10
_INDX_BYTES = 24 + 16 * MAX_SEGMENTS
_DMLH_BYTES = 248


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def rate_scale(fps: float) -> Tuple[int, int]:
    """``strh``'s (dwRate, dwScale): ``fps`` as a fraction of small terms
    (30000 / 1001 for 29.97)."""
    if not fps > 0:
        raise ValueError(f"fps must be positive, not {fps}.")
    f = Fraction(fps).limit_denominator(1001)
    return f.numerator, f.denominator


class AviWriter:
    """Write Motion-JPEG frames, each a JPEG's bytes, to ``filename``."""

    def __init__(self, filename: str, width: int, height: int, fps: float):
        self.width, self.height, self.fps = int(width), int(height), float(fps)
        self.rate, self.scale = rate_scale(fps)
        self._f: BinaryIO = open(filename, "wb")
        self._frames = 0
        self._largest = 0
        self._segments: List[dict] = []  # per RIFF: starts, movi, frame (pos, size) list
        self._index_entries: List[Tuple[int, int, int]] = []  # ix00 (offset, size, frames)
        self._riff_frames0 = 0
        self._write_header()
        self._open_segment(first=True)

    # -- layout -------------------------------------------------------------- #
    def _write_header(self) -> None:
        f = self._f
        f.write(b"RIFF\0\0\0\0AVI ")
        hdrl = bytearray()
        avih = struct.pack("<14I", round(1e6 / self.fps), 0, 0, AVIF_HASINDEX | AVIF_ISINTERLEAVED,
                           0, 0, 1, 0, self.width, self.height, 0, 0, 0, 0)
        hdrl += _chunk(b"avih", avih)
        strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIiI4h", 0, 0, 0, 0, self.scale, self.rate, 0, 0,
                                        0, -1, 0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG",
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        self._indx_at = 24 + len(hdrl) + 8 + len(strl)  # the JUNK later turned indx
        strl += _chunk(b"JUNK", b"\0" * _INDX_BYTES)
        hdrl += _chunk(b"LIST", strl)
        self._odml_at = 12 + 12 + len(hdrl)
        hdrl += _chunk(b"JUNK", b"\0" * (4 + 8 + _DMLH_BYTES))
        f.write(_chunk(b"LIST", b"hdrl" + bytes(hdrl)))
        self._avih_at = 12 + 12 + 8  # avih's body
        self._strh_at = self._avih_at + 56 + 12 + 8  # strh's body

    def _open_segment(self, first: bool) -> None:
        f = self._f
        riff = 0 if first else f.tell()
        if not first:
            f.write(b"RIFF\0\0\0\0AVIX")
        movi = f.tell()
        f.write(b"LIST\0\0\0\0movi")
        self._segments.append({"riff": riff, "movi": movi, "frames": []})

    def _patch(self, pos: int, fmt: str, *values) -> None:
        here = self._f.tell()
        self._f.seek(pos)
        self._f.write(struct.pack(fmt, *values))
        self._f.seek(here)

    def _close_segment(self, opendml: bool) -> None:
        """End the current RIFF: its ix00 (OpenDML), the movi's size, idx1
        (the first RIFF), and the RIFF's size."""
        f, seg = self._f, self._segments[-1]
        if opendml:
            at = f.tell()
            body = struct.pack("<HBBI4sQI", 2, 0, 1, len(seg["frames"]), b"00dc", seg["movi"], 0)
            body += b"".join(struct.pack("<II", pos + 8 - seg["movi"], size) for pos, size in seg["frames"])
            f.write(_chunk(b"ix00", body))
            self._index_entries.append((at, 8 + len(body), len(seg["frames"])))
        end = f.tell()
        self._patch(seg["movi"] + 4, "<I", end - seg["movi"] - 8)
        if seg["riff"] == 0:
            base = seg["movi"] + 8
            f.write(_chunk(b"idx1", b"".join(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME,
                                                         pos - base, size)
                                             for pos, size in seg["frames"])))
            self._riff_frames0 = len(seg["frames"])
        self._patch(seg["riff"] + 4, "<I", f.tell() - seg["riff"] - 8)

    # -- frames -------------------------------------------------------------- #
    def add(self, jpeg: bytes) -> None:
        """Append one frame's JPEG bytes as a ``00dc`` chunk."""
        jpeg = bytes(jpeg)
        seg = self._segments[-1]
        size = 8 + len(jpeg) + (len(jpeg) & 1)
        # Room kept in the first RIFF for its idx1 and each segment's ix00.
        reserve = 16 * (len(seg["frames"]) + 1) + 32 + 8 * (len(seg["frames"]) + 1) + 32
        if seg["frames"] and self._f.tell() + size + reserve - seg["riff"] > RIFF_LIMIT:
            if len(self._segments) == MAX_SEGMENTS:
                raise ValueError(f"An AVI holds at most {MAX_SEGMENTS} RIFF segments here.")
            self._close_segment(opendml=True)
            self._open_segment(first=False)
            seg = self._segments[-1]
        seg["frames"].append((self._f.tell(), len(jpeg)))
        self._f.write(_chunk(b"00dc", jpeg))
        self._frames += 1
        self._largest = max(self._largest, len(jpeg))

    def close(self) -> None:
        if self._f.closed:
            return
        opendml = len(self._segments) > 1
        self._close_segment(opendml)
        total = self._frames
        self._patch(self._avih_at + 16, "<I", self._riff_frames0 if opendml else total)
        self._patch(self._avih_at + 28, "<I", self._largest + 8)
        self._patch(self._strh_at + 32, "<II", total, self._largest + 8)
        if opendml:
            indx = struct.pack("<HBBI4s3I", 4, 0, 0, len(self._index_entries), b"00dc", 0, 0, 0)
            indx += b"".join(struct.pack("<QII", off, size, n) for off, size, n in self._index_entries)
            indx += b"\0" * (_INDX_BYTES - len(indx))
            self._patch(self._indx_at, "<4sI", b"indx", _INDX_BYTES)
            self._patch(self._indx_at + 8, f"<{_INDX_BYTES}s", indx)
            odml = b"odml" + _chunk(b"dmlh", struct.pack("<I", total) + b"\0" * (_DMLH_BYTES - 4))
            self._patch(self._odml_at, f"<4sI{len(odml)}s", b"LIST", len(odml), odml)
        self._f.close()

    def __enter__(self) -> "AviWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_frames(filename: str) -> List[bytes]:
    """The payload of every frame with data of an AVI's video stream, in
    frame order, through every RIFF segment (:class:`AviVideo`)."""
    video = AviVideo.open(filename)
    with open(filename, "rb") as f:
        return [video.read(f, i) for i in range(len(video.offsets))]


# --------------------------------------------------------------------------- #
# The demuxer of the card's media route
# --------------------------------------------------------------------------- #

#: Fourccs FFmpeg's AVI demuxer hands to its Motion-JPEG decoder (``riff.c``),
#: upper-cased, less Avid's, whose field layouts ``mjpegdec`` special-cases.
MJPEG_FOURCCS = frozenset({"MJPG", "LJPG", "DMB1", "MJPA", "JR24", "ACDV", "QIVG", "SLMJ",
                           "CJPG", "IJPG", "MTSJ", "ZJPG", "MMJP"})
#: Fourccs of raw 8-bit gray frames.
GRAY_FOURCCS = frozenset({"Y800", "GREY", "Y8  "})


def bitmap_info(header: bytes) -> Tuple[int, int, int, str]:
    """A BITMAPINFOHEADER's (width, signed height, bits a pixel, compression
    fourcc): AVI's ``strf`` and Matroska's ``V_MS/VFW/FOURCC`` private data."""
    width, height, _planes, bit_count, compression = struct.unpack_from("<iiHH4s", header, 4)
    return width, height, bit_count, compression.decode("latin-1")


@dataclass
class AviVideo:
    """An AVI file's first video stream: its format (``strf``'s
    BITMAPINFOHEADER), its timing (``strh``), and where each frame with
    data lies (``offsets``, ``sizes``: the chunk bodies, in frame order)."""

    filename: str
    compression: str  # biCompression as a fourcc, "\0\0\0\0" for BI_RGB
    bit_count: int
    width: int
    height: int  # strf's biHeight, signed: negative means rows top-down
    rate: int
    scale: int
    length: int
    offsets: np.ndarray
    sizes: np.ndarray
    palette: Optional[np.ndarray] = None  # (entries, 4) B, G, R, 0
    index: str = "idx1"  # where the frames were found: "indx", "idx1" or "movi"
    stream: int = 0  # the video stream's number, its chunks' "##"
    streams: int = 1
    headers: Dict[str, bytes] = field(default_factory=dict, repr=False)

    @classmethod
    def open(cls, filename: str) -> "AviVideo":
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"Could not find video file named {filename}.")
        with open(filename, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            head = f.read(12)
            if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise ValueError(f"{filename} is not a RIFF AVI file.")
            riff_end = min(size, 8 + struct.unpack_from("<I", head, 4)[0])
            top = _chunks(f, 12, riff_end)
            hdrl = next((c for c in top if c[0] == b"LIST" and c[3] == b"hdrl"), None)
            movi = next((c for c in top if c[0] == b"LIST" and c[3] == b"movi"), None)
            if hdrl is None or movi is None:
                raise ValueError(f"{filename}: an AVI needs LIST 'hdrl' and LIST 'movi'.")
            f.seek(hdrl[1] + 12)
            video = cls._video_stream(filename, f.read(hdrl[2] - 4))
            ident = b"%02d" % video.stream
            if video.headers.get("indx"):
                pos, sizes = _odml_index(f, video.headers["indx"], ident, size)
                video.index = "indx"
            else:
                idx1 = next((c for c in top if c[0] == b"idx1"), None)
                if idx1 is not None:
                    f.seek(idx1[1] + 8)
                    pos, sizes = _idx1_index(f.read(idx1[2]), f, movi, ident, video.streams)
                else:
                    pos, sizes = _movi_walk(f, movi[1] + 12, movi[1] + 8 + movi[2], ident)
                    video.index = "movi"
        keep = sizes > 0
        video.offsets = pos[keep] + 8
        video.sizes = sizes[keep]
        return video

    @classmethod
    def _video_stream(cls, filename: str, hdrl: bytes) -> "AviVideo":
        frame_period = 0
        stream = 0
        found = None
        for fourcc, a, n, kind in _chunks_in(hdrl, 0, len(hdrl)):
            if fourcc == b"avih" and n >= 4:
                frame_period = struct.unpack_from("<I", hdrl, a + 8)[0]
            if fourcc != b"LIST" or kind != b"strl":
                continue
            parts = {c.decode("latin-1"): hdrl[b + 8:b + 8 + m]
                     for c, b, m, _ in _chunks_in(hdrl, a + 12, a + 8 + n)}
            strh = parts.get("strh", b"")
            if found is None and strh[:4] == b"vids":
                found = (stream, parts)
            stream += 1
        if found is None:
            raise ValueError(f"{filename}: no video stream.")
        index, parts = found
        strh, strf = parts["strh"], parts.get("strf", b"")
        if len(strh) < 36 or len(strf) < 40:
            raise ValueError(f"{filename}: the video stream's strh or strf is truncated.")
        scale, rate, _start, length = struct.unpack_from("<IIII", strh, 20)
        if not (scale and rate):  # avidec.c's repair of broken writers' headers
            rate, scale = (1000000, frame_period) if frame_period else (25, 1)
        width, height, bit_count, compression = bitmap_info(strf)
        extra = strf[40:]
        palette = None
        if extra and bit_count <= 8:  # avidec.c: the last entries of the extradata
            n = min((1 << bit_count) * 4, len(extra)) // 4
            palette = np.frombuffer(extra[len(extra) - 4 * n:], np.uint8).reshape(n, 4)
        video = cls(filename, compression, bit_count, abs(width), height, rate, scale,
                    length, np.zeros(0, np.int64), np.zeros(0, np.int64), palette, stream=index,
                    streams=stream, headers=parts)
        return video

    @property
    def frames(self) -> int:
        """cv2's ``CAP_PROP_FRAME_COUNT``: ``strh``'s ``dwLength``."""
        return int(self.length)

    @property
    def fps(self) -> float:
        """cv2's ``CAP_PROP_FPS``: ``dwRate / dwScale``."""
        return self.rate / self.scale

    @property
    def codec(self) -> str:
        """"mjpeg", "mpeg4", "bgr24", "bgra", "pal8" or "gray"; raise naming
        a codec the card route does not decode."""
        tag = self.compression.upper()
        if tag == "\0\0\0\0":
            kinds = {24: "bgr24", 32: "bgra", 8: "pal8"}
            if self.bit_count not in kinds:
                raise mjpeg.unsupported(
                    f"{self.filename}: {self.bit_count}-bit uncompressed (BI_RGB) AVI")
            if self.bit_count == 8 and self.palette is None:
                raise mjpeg.unsupported(f"{self.filename}: 8-bit uncompressed AVI without a palette")
            return kinds[self.bit_count]
        if tag in MJPEG_FOURCCS:
            return "mjpeg"
        if tag in mpeg4.FOURCCS:
            return "mpeg4"
        if self.compression in GRAY_FOURCCS:
            return "gray"
        shown = self.compression if self.compression.isprintable() else repr(self.compression)
        raise mjpeg.unsupported(f"{self.filename}: AVI of codec {shown!r}")

    def read(self, f: BinaryIO, i: int) -> bytes:
        """The bytes of frame ``i`` from the open file ``f``."""
        if not 0 <= i < len(self.offsets):
            raise KeyError(f"Unable to load frame {i} from {self.filename}.")
        f.seek(int(self.offsets[i]))
        data = f.read(int(self.sizes[i]))
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.filename}: frame {i} runs past the end of the file.")
        return data


def _chunks_in(data: bytes, start: int, end: int):
    """(fourcc, position, size, list type or None) of each chunk of
    ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        kind = data[pos + 8:pos + 12] if fourcc in (b"LIST", b"RIFF") else None
        yield fourcc, pos, n, kind
        pos += 8 + n + (n & 1)


def _chunks(f: BinaryIO, start: int, end: int) -> List[Tuple[bytes, int, int, Optional[bytes]]]:
    """The chunks of a file from ``start`` to ``end``, by their headers."""
    out = []
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            break
        fourcc = head[:4]
        (n,) = struct.unpack_from("<I", head, 4)
        out.append((fourcc, pos, n, head[8:12] if fourcc in (b"LIST", b"RIFF") else None))
        pos += 8 + n + (n & 1)
    return out


def _is_stream_chunk(fourcc: bytes, streams: int) -> bool:
    return fourcc[:2].isdigit() and int(fourcc[:2]) < streams


def _movi_walk(f: BinaryIO, start: int, end: int, ident: bytes, entries=None):
    """Positions and sizes of the stream's chunks in ``movi``, in file
    order, through ``LIST`` (``rec ``) chunks."""
    top = entries is None
    entries = [] if top else entries
    for fourcc, pos, n, kind in _chunks(f, start, end):
        if fourcc == b"LIST":
            _movi_walk(f, pos + 12, pos + 8 + n, ident, entries)
        elif fourcc[:2] == ident and fourcc[2:] in (b"dc", b"db"):
            entries.append((pos, n))
    if top:
        return (np.array([p for p, _ in entries], np.int64).reshape(-1),
                np.array([n for _, n in entries], np.int64).reshape(-1))
    return None


def _first_packet(f: BinaryIO, start: int, end: int, streams: int) -> Optional[int]:
    """``avi_sync``'s first packet: the first chunk of any stream from
    ``start``, into lists and past ``JUNK``."""
    for fourcc, pos, n, kind in _chunks(f, start, end):
        if fourcc == b"LIST":
            found = _first_packet(f, pos + 12, pos + 8 + n, streams)
            if found is not None:
                return found
        elif _is_stream_chunk(fourcc, streams):
            return pos
    return None


def _idx1_index(body: bytes, f: BinaryIO, movi, ident: bytes, streams: int):
    """``avi_read_idx1``: the stream's entries, their offsets moved by the
    first entry's distance from the first packet, unless that entry already
    points just past ``movi`` and the first packet lies 500 bytes or more
    further (then the offsets are taken as the file's)."""
    movi_list = movi[1] + 8  # the position of the 'movi' fourcc
    first_packet = _first_packet(f, movi_list + 4, movi[1] + 8 + movi[2], streams)
    offset, last, pos_out, size_out = None, None, [], []
    for tag, _flags, pos, n in struct.iter_unpack("<4sIII", body[:len(body) // 16 * 16]):
        if not _is_stream_chunk(tag, streams) or tag[2:] == b"pc":
            continue
        if offset is None:
            offset = 0
            if first_packet is not None and (movi_list + 4 != pos or pos + 500 > first_packet):
                offset = first_packet - pos
        pos += offset
        if tag[:2] == ident and pos != last and n:
            pos_out.append(pos)
            size_out.append(n)
            last = pos
    return np.array(pos_out, np.int64), np.array(size_out, np.int64)


def _odml_index(f: BinaryIO, indx: bytes, ident: bytes, file_size: int):
    """OpenDML 1.02: the super index in ``strl``'s ``indx`` names each
    segment's standard index (``ix##``), whose entries give each chunk's
    body as an offset from the index's base (bit 31 of a size marks a
    frame that is not a key frame)."""
    longs, sub, index_type, entries, _chunk_id = struct.unpack_from("<HBBI4s", indx, 0)
    if index_type != 0 or longs != 4:  # AVI_INDEX_OF_INDEXES of 16-byte entries
        raise ValueError(f"{f.name}: an OpenDML indx of type {index_type} is not a super index.")
    pos_out, size_out = [], []
    for k in range(entries):
        off, _n, _dur = struct.unpack_from("<QII", indx, 24 + 16 * k)
        if off <= 0 or off >= file_size:
            continue
        f.seek(off)
        head = f.read(8 + 24)
        longs_k, _sub, type_k, count, _cid, base = struct.unpack_from("<HBBI4sQ", head, 8)
        if type_k != 1 or longs_k != 2:  # AVI_INDEX_OF_CHUNKS of 8-byte entries
            raise ValueError(f"{f.name}: an OpenDML standard index of type {type_k}.")
        table = np.frombuffer(f.read(8 * count), np.uint32).reshape(-1, 2).astype(np.int64)
        pos_out.append(table[:, 0] + base - 8)
        size_out.append(table[:, 1] & 0x7FFFFFFF)
    if not pos_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pos, sizes = np.concatenate(pos_out), np.concatenate(size_out)
    repeat = np.r_[False, pos[1:] == pos[:-1]]
    return pos[~repeat], sizes[~repeat]


def raw_frame(video: AviVideo, data: bytes) -> np.ndarray:
    """An uncompressed frame as cv2 gives it, on the host: (H, W, 3) BGR
    uint8, or (H, W, 1) for gray. Rows are 4-byte aligned where the chunk
    holds that many bytes, else packed (``rawdec.c``); a ``BI_RGB`` frame of
    positive height is stored bottom-up; a palette frame is looked up in
    ``strf``'s palette (swscale's ``pal8`` conversion copies the entries)."""
    codec = video.codec
    w, h = video.width, abs(video.height)
    depth = {"bgr24": 3, "bgra": 4, "pal8": 1, "gray": 1}[codec]
    row = w * depth
    stride = row + (-row % 4) if (row + (-row % 4)) * h <= len(data) else row
    if stride * (h - 1) + row > len(data):
        raise ValueError(f"{video.filename}: a {codec} frame of {w} x {h} needs {row * h} bytes, "
                         f"the chunk holds {len(data)}.")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8), (h, row), (stride, 1))
    if video.compression == "\0\0\0\0" and video.height > 0:
        rows = rows[::-1]
    px = rows.reshape(h, w, depth)
    if codec == "pal8":
        palette = np.zeros((256, 4), np.uint8)
        palette[:len(video.palette)] = video.palette
        return palette[px[..., 0], :3]
    if codec == "gray":
        return np.ascontiguousarray(px)
    return np.ascontiguousarray(px[..., :3])


class AviReader:
    """Frames of an :class:`AviVideo` on ``device``: Motion-JPEG through
    :class:`sleap_tpu_torch.io.mjpeg.MotionJpegReader` (J5 on the card),
    MPEG-4 Part 2 through :class:`sleap_tpu_torch.io.mpeg4.Mpeg4Reader` (M1,
    M2 and M3 on the card), raw frames unpacked on the host and copied once.
    A Motion-JPEG or raw read never decodes another frame; an MPEG-4 read
    decodes on from the I-VOP at or before the reference it needs."""

    def __init__(self, demux: AviVideo, device="cuda"):
        self.demux = demux
        self.device = torch.device(device)
        self.codec = demux.codec  # raises for a codec the card route does not decode
        if self.codec == "mjpeg":
            self._decoder = mjpeg.MotionJpegReader(demux, abs(demux.height), self.device)
        elif self.codec == "mpeg4":  # strf's extradata may hold the VOL
            self._decoder = mpeg4.Mpeg4Reader(demux, self.device, demux.headers["strf"][40:],
                                              demux.compression)
        else:
            self._f = open(demux.filename, "rb")

    def frame(self, i: int, channels: str = "bgr"):
        """Frame ``i``, (H, W, C) uint8 on the device: ``channels`` "bgr",
        "rgb" or "b" (the blue channel alone)."""
        if self.codec in ("mjpeg", "mpeg4"):
            return self._decoder.frame(i, channels)
        px = raw_frame(self.demux, self.demux.read(self._f, i))
        if px.shape[2] == 1:
            px = px if channels == "b" else np.repeat(px, 3, 2)
        else:
            px = {"bgr": px, "rgb": px[..., ::-1], "b": px[..., :1]}[channels]
        return torch.from_numpy(np.array(px)).to(self.device)

    def close(self) -> None:
        (self._decoder if self.codec in ("mjpeg", "mpeg4") else self._f).close()
