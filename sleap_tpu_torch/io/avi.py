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
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import BinaryIO, List, Tuple

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


def _walk(data: bytes, start: int, end: int, out: List[bytes]) -> None:
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if fourcc in (b"RIFF", b"LIST"):
            _walk(data, pos + 12, min(pos + 8 + size, end), out)
        elif fourcc == b"00dc":
            out.append(data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)


def read_frames(filename: str) -> List[bytes]:
    """The payload of every ``00dc`` chunk of an AVI, in file order, through
    every RIFF segment."""
    with open(filename, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{filename} is not a RIFF AVI file.")
    out: List[bytes] = []
    _walk(data, 0, len(data), out)
    return out
