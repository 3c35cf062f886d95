"""Write the QuickTime/ISO-BMFF and Matroska fixtures of the port's tests and
``chip_smoke.py`` phase 25 from a seed, and record what OpenCV's FFmpeg
backend reads from each.

    JAX_PLATFORMS=cpu python scripts/make_torch_container_fixtures.py [--records]

Writes, under ``tests/torch_data/containers``:

- ``.mov``: cv2's Motion-JPEG (``MJPG``, which FFmpeg's mov muxer stores
  as a ``jpeg`` sample entry with a one-edit ``elst``) at 100 x 72, colour
  and gray; the colour file re-tagged ``mjpa``; and the colour file with its
  ``elst`` replaced: a start trimmed by 2 frames, an empty edit first, two
  edits (frames 0-1, then 3-5), the trim as a version-1 ``elst``, and, with
  an ``stss`` that makes every third sample a sync sample, an edit that
  starts between sync samples; and with a ``ctts`` (composition offsets, as
  B-frame streams carry): a constant shift under an edit of that shift, an
  edit whose previous sync sample is presented after its start, and
  B-frame-like offsets under a trimming edit (the Motion-JPEG decoder does
  not reorder, so these hold the edit list's packet rule under ``ctts``);
- ``.mp4``: an I_PCM H.264 stream of 64 x 48 (``scripts/write_h264_fixture.py``,
  an IDR frame every 4) as written, and with an ``elst`` whose media time
  is 2 frames (between sync samples);
- ``.mkv``: cv2's Motion-JPEG, colour and gray; cv2's colour frames re-muxed
  by :func:`mkv_bytes` without ``Cues``, as ``BlockGroup``\\ s, in one
  unknown-size cluster, with header stripping, in Xiph-, EBML- and
  fixed-size-laced blocks (cv2 reads all three), as ``V_MS/VFW/FOURCC``,
  with a ``Duration`` that gives cv2 one frame less than it reads, and as
  a live writer leaves a file (one unknown-size cluster, no ``Duration``,
  no ``Cues``: cv2 counts ``AV_NOPTS_VALUE`` frames and its seeks miss);
  the I_PCM stream under ``V_MPEG4/ISO/AVC``;
- content routing: an AVI named ``.mkv`` and a Matroska file named ``.mov``;
- the clip of ``chip_smoke.py`` phase 25b: ``tests/torch_data/avi/gray_1024.avi``'s
  8 JPEG payloads, byte for byte, re-muxed into ``gray_1024.mov`` and
  ``gray_1024.mkv`` (25 fps), so the three containers hold the same frames;
- ``manifest.json``, of ``scripts/make_torch_avi_fixtures.py``'s schema:
  per file cv2's (FFmpeg backend) frame count, fps and the sha256 of every
  frame it reads in order (BGR, and the blue channel a gray ``MediaVideo``
  keeps), with, under ``seek``, any frame a seek (``CAP_PROP_POS_FRAMES``)
  gives that differs from the one read in order (only the files named in
  :data:`SEEK_DIFFERS` may have one).

``--records`` rewrites only ``manifest.json`` from the committed files.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_torch_avi_fixtures as avifix  # noqa: E402
import write_h264_fixture as h264  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_data", "containers")
AVI_DIR = os.path.join(REPO, "tests", "torch_data", "avi")
#: Fixtures whose seeks cv2 gets wrong, with why (ROADMAP.md queue 3, item 5).
SEEK_DIFFERS = {"live_100x72.mkv": "no Duration: cv2 counts AV_NOPTS_VALUE frames, clamps a seek "
                                   "to that negative count and does not seek: the next read gives "
                                   "the frame after the last one read"}
H264_FRAMES, H264_SIZE, H264_IDR_EVERY, H264_FPS = 10, (64, 48), 4, 30
#: A frame in cv2's .mov files: 1024 units of the 10240 Hz media timescale,
#: 100 of the movie's 1000.
MOV_FRAME, MOV_MOVIE_FRAME = 1024, 100

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


# --------------------------------------------------------------------------- #
# ISO-BMFF
# --------------------------------------------------------------------------- #

def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def elst(edits: Sequence[Tuple[int, int]], version: int = 0) -> bytes:
    """An ``elst`` box of (segment duration, media time) edits at rate 1."""
    fmt = ">QqHH" if version else ">IiHH"
    return box(b"elst", struct.pack(">II", version << 24, len(edits)),
               *(struct.pack(fmt, d, t, 1, 0) for d, t in edits))


def rebox(data: bytes, edits=None, stss: Optional[Sequence[int]] = None, version: int = 0,
          start: int = 0, end: Optional[int] = None, ctts: Optional[Sequence[int]] = None) -> bytes:
    """An ISO-BMFF file's boxes again, with the video track's ``edts``
    replaced by ``edits`` (added after ``tkhd`` where it had none) and, with
    ``stss``, those 1-based sync samples, with ``ctts``, those composition
    offsets, one a sample. The ``moov`` must follow the ``mdat`` (as cv2's
    and the H.264 writer's do), so no offset moves."""
    from sleap_tpu_torch.io import mp4

    out = b""
    for kind, a, b in mp4._boxes(data, start, len(data) if end is None else end):
        if kind == b"edts":
            continue
        body = rebox(data, edits, stss, version, a, b, ctts) if kind in CONTAINERS else data[a:b]
        if kind == b"stbl" and stss is not None:
            body += box(b"stss", struct.pack(">II", 0, len(stss)), *(struct.pack(">I", s) for s in stss))
        if kind == b"stbl" and ctts is not None:
            body += box(b"ctts", struct.pack(">II", 0, len(ctts)), *(struct.pack(">II", 1, c) for c in ctts))
        out += box(kind, body)
        if kind == b"tkhd" and edits is not None:
            out += box(b"edts", elst(edits, version))
    return out


def mov_bytes(jpegs: Sequence[bytes], width: int, height: int, timescale: int, delta: int,
              movie_timescale: int = 1000) -> bytes:
    """A QuickTime file of Motion-JPEG samples (``jpeg`` entries), laid out as
    FFmpeg's mov muxer lays out cv2's: ``ftyp``, ``wide``, ``mdat``, then a
    ``moov`` with a one-edit ``elst``."""
    n = len(jpegs)
    ftyp = box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  ")
    head = ftyp + box(b"wide")
    mdat = box(b"mdat", *jpegs)
    offset = len(head) + 8
    movie_duration = n * delta * movie_timescale // timescale
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    entry = box(b"jpeg", bytes(6), struct.pack(">H", 1), struct.pack(">HH4sII", 0, 0, b"FFMP", 0, 0x200),
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                struct.pack(">Hh", 24, -1))
    stbl = box(b"stbl", box(b"stsd", struct.pack(">II", 0, 1), entry),
               box(b"stts", struct.pack(">III", 0, 1, n), struct.pack(">I", delta)),
               box(b"stsc", struct.pack(">IIIII", 0, 1, 1, n, 1)),
               box(b"stsz", struct.pack(">III", 0, 0, n), *(struct.pack(">I", len(j)) for j in jpegs)),
               box(b"stco", struct.pack(">II", 0, 1), struct.pack(">I", offset)))
    minf = box(b"minf", box(b"vmhd", struct.pack(">I", 1), bytes(8)),
               box(b"dinf", box(b"dref", struct.pack(">II", 0, 1), box(b"url ", struct.pack(">I", 1)))),
               stbl)
    mdia = box(b"mdia", box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, timescale, n * delta, 0x7FFF, 0)),
               box(b"hdlr", struct.pack(">I", 0), b"mhlrvide", bytes(12), b"\0"), minf)
    tkhd = box(b"tkhd", struct.pack(">IIIIII", 3, 0, 0, 1, 0, movie_duration), bytes(8),
               struct.pack(">hhhH", 0, 0, 0, 0), matrix, struct.pack(">II", width << 16, height << 16))
    trak = box(b"trak", tkhd, box(b"edts", elst([(movie_duration, 0)])), mdia)
    mvhd = box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, movie_timescale, movie_duration),
               struct.pack(">IH", 0x10000, 0x100), bytes(10), matrix, bytes(24), struct.pack(">I", 2))
    return head + mdat + box(b"moov", mvhd, trak)


def read_payloads(path: str) -> List[bytes]:
    """Every frame's bytes of a file the card's demuxers read."""
    from sleap_tpu_torch.io import avi, mkv, mp4, video

    with open(path, "rb") as f:
        kind = video.container_of(f.read(12))
    demux = {"avi": avi.AviVideo, "matroska": mkv.MkvVideo, "isobmff": mp4.Mp4Video}[kind].open(path)
    n = len(demux.offsets) if kind == "avi" else demux.readable
    with open(path, "rb") as f:
        return [demux.read(f, i) for i in range(n)]


# --------------------------------------------------------------------------- #
# Matroska
# --------------------------------------------------------------------------- #

def ebml_id(ident: int) -> bytes:
    return ident.to_bytes((ident.bit_length() + 7) // 8, "big")


def ebml_size(n: Optional[int], width: Optional[int] = None) -> bytes:
    """A size as an EBML number (None: unknown, 8 bytes of ones)."""
    if n is None:
        return b"\x01" + b"\xff" * 7
    width = width or next(w for w in range(1, 9) if n < (1 << (7 * w)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def el(ident: int, body, unknown: bool = False) -> bytes:
    """An element: ``body`` bytes, a str, an unsigned int, a float or a list
    of elements."""
    if isinstance(body, bool) or isinstance(body, int):
        body = body.to_bytes(max(1, (body.bit_length() + 7) // 8), "big")
    elif isinstance(body, float):
        body = struct.pack(">d", body)
    elif isinstance(body, str):
        body = body.encode()
    elif isinstance(body, list):
        body = b"".join(body)
    return ebml_id(ident) + ebml_size(None if unknown else len(body)) + body


def lace(frames: Sequence[bytes], kind: str) -> Tuple[int, bytes]:
    """A block's lacing flag bits and lace head for ``frames``."""
    n = len(frames) - 1
    if kind == "xiph":
        head = b"".join(b"\xff" * (len(f) // 255) + bytes([len(f) % 255]) for f in frames[:-1])
        return 0x02, bytes([n]) + head
    if kind == "fixed":
        if len({len(f) for f in frames}) != 1:
            raise ValueError("fixed-size lacing needs frames of one size")
        return 0x04, bytes([n])
    head = ebml_size(len(frames[0]))
    for a, b in zip(frames[:-2], frames[1:-1]):
        d = len(b) - len(a)
        w = next(w for w in range(1, 9) if abs(d) < (1 << (7 * w - 1)) - 1)
        head += ((1 << (7 * w)) | (d + (1 << (7 * w - 1)) - 1)).to_bytes(w, "big")
    return 0x06, bytes([n]) + head


def mkv_bytes(frames: Sequence[bytes], timecodes: Sequence[int], width: int, height: int,
              codec_id: str = "V_MJPEG", private: Optional[bytes] = None,
              default_duration: int = 100_000_000, duration: Optional[float] = None,
              keys: Optional[Sequence[bool]] = None, cues: bool = True, groups: bool = False,
              unknown_cluster: bool = False, strip: Optional[bytes] = None,
              lacing: Optional[str] = None, doctype: str = "matroska", per_cluster: int = 2,
              encoding: Optional[bytes] = None) -> bytes:
    """A Matroska file of one video track (timecodes in ms, TimecodeScale
    1e6): a SeekHead naming Info, Tracks and (with ``cues``) Cues; clusters
    of ``per_cluster`` frames as SimpleBlocks (or ``groups``: BlockGroups,
    a ReferenceBlock on each frame that is not a key frame), or all frames
    in one unknown-size cluster, or (``lacing``) in one laced block;
    ``strip`` removed from each frame by header stripping, or ``encoding``
    another ContentCompression body. An unknown-size cluster comes in a
    segment of unknown size."""
    keys = list(keys) if keys is not None else [True] * len(frames)
    head = el(0x1A45DFA3, [el(0x4286, 1), el(0x42F7, 1), el(0x42F2, 4), el(0x42F3, 8),
                           el(0x4282, doctype), el(0x4287, 4), el(0x4285, 2)])
    info = [el(0x2AD7B1, 1000000)] + ([el(0x4489, float(duration))] if duration is not None else [])
    entry = [el(0xD7, 1), el(0x73C5, 1), el(0x83, 1), el(0x86, codec_id)]
    if default_duration:
        entry.append(el(0x23E383, default_duration))
    if private is not None:
        entry.append(el(0x63A2, private))
    if strip is not None or encoding is not None:
        comp = encoding if encoding is not None else el(0x5034, [el(0x4254, 3), el(0x4255, strip)])
        entry.append(el(0x6D80, [el(0x6240, [el(0x5031, 0), el(0x5032, 1), el(0x5033, 0), comp])]))
    entry.append(el(0xE0, [el(0xB0, width), el(0xBA, height)]))
    info, tracks = el(0x1549A966, info), el(0x1654AE6B, [el(0xAE, entry)])
    stored = [f[len(strip):] if strip is not None else f for f in frames]

    def seekhead(cues_at: int) -> bytes:
        """Each SeekPosition 8 bytes wide, so the head's size is known first."""
        seeks = [(0x1549A966, base), (0x1654AE6B, base + len(info))]
        seeks += [(0x1C53BB6B, cues_at)] if cues else []
        return el(0x114D9B74, [el(0x4DBB, [el(0x53AB, ebml_id(i)), el(0x53AC, p.to_bytes(8, "big"))])
                               for i, p in seeks])

    base = 0
    base = len(seekhead(0))
    pos = base + len(info) + len(tracks)  # cluster positions from the segment's data
    clusters, points = [], []
    if lacing is not None or unknown_cluster:
        groups_of = [range(len(frames))]
    else:
        groups_of = [range(i, min(i + per_cluster, len(frames))) for i in range(0, len(frames), per_cluster)]
    for ks in groups_of:
        tc = timecodes[ks[0]]
        body = [el(0xE7, tc)]
        if lacing is not None:
            flags, lace_head = lace([stored[k] for k in ks], lacing)
            body.append(el(0xA3, b"\x81" + struct.pack(">hB", 0, 0x80 | flags) + lace_head
                           + b"".join(stored[k] for k in ks)))
        for k in ([] if lacing is not None else ks):
            block = b"\x81" + struct.pack(">hB", timecodes[k] - tc, 0x80 if keys[k] and not groups else 0)
            if groups:
                body.append(el(0xA0, [el(0xA1, block + stored[k])]
                                     + ([] if keys[k] else [el(0xFB, b"\xff")])))
            else:
                body.append(el(0xA3, block + stored[k]))
            if keys[k]:
                points.append((timecodes[k], pos))
        cluster = el(0x1F43B675, body, unknown=unknown_cluster)
        clusters.append(cluster)
        pos += len(cluster)
    cue = el(0x1C53BB6B, [el(0xBB, [el(0xB3, t), el(0xB7, [el(0xF7, 1), el(0xF1, p)])])
                          for t, p in points]) if cues else b""
    body = seekhead(pos) + info + tracks + b"".join(clusters) + cue
    # A live writer leaves the segment's size unknown with its clusters'.
    return head + ebml_id(0x18538067) + ebml_size(None if unknown_cluster else len(body), 8) + body


# --------------------------------------------------------------------------- #
# The files
# --------------------------------------------------------------------------- #

def h264_planes():
    """The I_PCM H.264 fixtures' planes (seeded), and their stream."""
    planes = h264.moving_planes(H264_FRAMES, *H264_SIZE, seed=26)
    return planes, h264.encode(*planes, idr_every=H264_IDR_EVERY)


def avcc_record(sps: bytes, pps: bytes) -> bytes:
    return (bytes([1, 66, 0xC0, h264.LEVEL_IDC, 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
            + b"\x01" + struct.pack(">H", len(pps)) + pps)


def write_files():
    import cv2

    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    p = lambda name: os.path.join(OUT, name)  # noqa: E731
    write = lambda name, data: open(p(name), "wb").write(data)  # noqa: E731
    colour = [avifix.smooth(72, 100, 3, 60 + s) for s in range(6)]
    for ext in ("mov", "mkv"):
        avifix.cv2_writer_frames(p(f"cv2_mjpg_100x72.{ext}"), cv2.CAP_FFMPEG, "MJPG", (100, 72), colour)
        avifix.cv2_writer_frames(p(f"cv2_mjpg_gray_100x72.{ext}"), cv2.CAP_FFMPEG, "MJPG", (100, 72),
                                 [f[..., 1] for f in colour], color=False)
    mov = open(p("cv2_mjpg_100x72.mov"), "rb").read()
    write("mjpa_100x72.mov", mov.replace(b"jpeg", b"mjpa", 1))
    f, m = MOV_FRAME, MOV_MOVIE_FRAME
    write("elst_trim2_100x72.mov", rebox(mov, [(4 * m, 2 * f)]))
    write("elst_empty_first_100x72.mov", rebox(mov, [(2 * m, -1), (6 * m, 0)]))
    write("elst_two_100x72.mov", rebox(mov, [(2 * m, 0), (3 * m, 3 * f)]))
    write("elst_v1_trim2_100x72.mov", rebox(mov, [(4 * m, 2 * f)], version=1))
    write("elst_between_sync_100x72.mov", rebox(mov, [(3 * m, 2 * f)], stss=[1, 4]))
    # ctts as x264's B-frame streams carry it: every sample shifted by 2
    # frames and an edit whose media time is that shift; then an edit at
    # frame 3, whose sync sample before it (sample 3) is presented after it;
    # then B-frame-like offsets (presentation 1, 3, 2, 5, 4, 6) trimmed by 2.
    write("ctts_shift_100x72.mov", rebox(mov, [(6 * m, 2 * f)], ctts=[2 * f] * 6))
    write("ctts_between_sync_100x72.mov", rebox(mov, [(4 * m, 3 * f)], stss=[1, 4],
                                                ctts=[2 * f] * 6))
    write("ctts_reordered_100x72.mov", rebox(mov, [(4 * m, 3 * f)], stss=[1, 4],
                                             ctts=[c * f for c in (1, 2, 0, 2, 0, 1)]))

    planes, (sps, pps, slices, sync) = h264_planes()
    w, h = H264_SIZE
    delta = h264.write_mp4(p("h264_64x48.mp4"), sps, pps, [[s] for s in slices], sync, w, h,
                           fps=H264_FPS)["delta"]
    write("h264_elst_trim2_64x48.mp4", rebox(open(p("h264_64x48.mp4"), "rb").read(),
                                              [((H264_FRAMES - 2) * delta, 2 * delta)]))
    samples = [len(s).to_bytes(4, "big") + s for s in slices]
    ms = [round(k * 1000 / H264_FPS) for k in range(H264_FRAMES)]
    write("h264_64x48.mkv", mkv_bytes(samples, ms, w, h, "V_MPEG4/ISO/AVC", avcc_record(sps, pps),
                                      default_duration=round(1e9 / H264_FPS),
                                      duration=1000 * H264_FRAMES / H264_FPS, keys=sync, per_cluster=4))

    jpegs = read_payloads(p("cv2_mjpg_100x72.mkv"))
    tcs = [100 * k for k in range(6)]
    common = dict(duration=600.0)
    write("nocues_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, cues=False, **common))
    write("blockgroups_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, groups=True, **common))
    write("unknown_cluster_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, unknown_cluster=True,
                                                  cues=False, **common))
    write("header_stripping_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, strip=jpegs[0][:24], **common))
    write("laced_xiph_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, lacing="xiph", cues=False, **common))
    write("laced_ebml_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, lacing="ebml", cues=False, **common))
    longest = max(map(len, jpegs))  # FFmpeg's decoder stops at EOI: padding after it is inert
    write("laced_fixed_100x72.mkv", mkv_bytes([j + bytes(longest - len(j)) for j in jpegs], tcs,
                                              100, 72, lacing="fixed", cues=False, **common))
    bih = struct.pack("<IiiHH4sIiiII", 40, 100, 72, 1, 24, b"MJPG", 100 * 72 * 3, 0, 0, 0, 0)
    write("vfw_mjpg_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, "V_MS/VFW/FOURCC", bih, **common))
    write("short_duration_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, duration=549.0))
    write("live_100x72.mkv", mkv_bytes(jpegs, tcs, 100, 72, unknown_cluster=True, cues=False))

    shutil.copyfile(os.path.join(AVI_DIR, "pil_gray_100x72.avi"), p("avi_named.mkv"))
    shutil.copyfile(p("nocues_100x72.mkv"), p("matroska_named.mov"))

    clip = read_payloads(os.path.join(AVI_DIR, "gray_1024.avi"))
    write("gray_1024.mov", mov_bytes(clip, 1024, 1024, 12800, 512))
    write("gray_1024.mkv", mkv_bytes(clip, [40 * k for k in range(len(clip))], 1024, 1024,
                                     default_duration=40_000_000, duration=40.0 * len(clip)))


def record(path: str):
    """cv2's count, fps and frames of ``path``, read in order, and, by file,
    the frames its seeks give (at random, as ``cv2_record`` reads) where they
    differ from those."""
    import cv2

    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    count, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    seek = {}
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    for i in np.random.default_rng(0).permutation(len(frames)):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        if not (ok and np.array_equal(frame, frames[i])):
            seek[str(i)] = avifix.digest(frame) if ok else None
    cap.release()
    return count, fps, frames, seek


def write_records():
    files = {}
    for name in sorted(os.listdir(OUT)):
        if name == "manifest.json":
            continue
        count, fps, frames, seek = record(os.path.join(OUT, name))
        if seek and name not in SEEK_DIFFERS:
            raise AssertionError(f"{name}: cv2's seeks give other frames than its reads: {seek}")
        files[name] = {"frames": count, "fps": fps, "readable": len(frames),
                       "shape": list(frames[0].shape), "source": "cv2",
                       "bgr": [avifix.digest(f) for f in frames],
                       "gray": [avifix.digest(f[..., 0]) for f in frames]}
        if seek:
            files[name]["seek"] = seek
            files[name]["seek_note"] = SEEK_DIFFERS[name]
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump({"versions": avifix.cv2_versions(), "files": files}, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--records", action="store_true", help="only rewrite manifest.json")
    args = parser.parse_args(argv)
    if not args.records:
        write_files()
    write_records()
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(os.listdir(OUT))} files, {total / 1e6:.2f} MB in {OUT}")


if __name__ == "__main__":
    main()
