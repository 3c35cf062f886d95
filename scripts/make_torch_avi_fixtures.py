"""Write the AVI fixtures of the port's tests and ``chip_smoke.py`` phase 21
from a seed, and record what OpenCV's FFmpeg backend reads from each.

    JAX_PLATFORMS=cpu python scripts/make_torch_avi_fixtures.py [--records]

Writes, under ``tests/torch_data/avi``:

- Motion-JPEG: cv2's FFmpeg writer (fourcc ``MJPG``), its frames again with
  a ``CS=ITU601`` comment (limited range, as FFmpeg's encoder marks
  limited-range input), OpenCV's own MJPEG writer (``CAP_OPENCV_MJPEG``:
  JFIF, colour and gray, at even and odd sizes), PIL's gray, 4:2:2 and
  4:4:4 JPEGs and AVI1 frames without DHT (cv2's JPEGs, restart interval
  3) muxed with the port's ``AviWriter``; an OpenDML file (``RIFF_LIMIT``
  lowered); files without ``idx1``, with ``LIST 'rec '`` and an audio
  stream (``idx1`` offsets from the file's start), and with zero-length
  chunks; the IDCT probe clip (8 x 512 gray frames whose 64 blocks each
  hold one coefficient, at every position, 12 amplitudes and 9 quantiser
  values, then frames of random sparse blocks and random tables); and 8
  gray 1024^2 frames of ``chip_smoke.py`` phase 8a's kind (its blob paths
  and noise, with blobs of sigma 10 px, which the trained top-down pair in
  ``.convergence_runs`` finds where it misses most of 8a's 8 px ones; cv2's
  JPEGs at quality 50, so the file stays under 1 MB; OpenCV's own MJPEG
  writer makes frames of these that FFmpeg and libjpeg report corrupt);
- uncompressed: cv2's ``Y800``, and hand-built ``BI_RGB`` files (24-bit of
  odd width, top-down and bottom-up; 32-bit both ways; 8-bit with a
  palette) and a ``Y8`` file of packed rows;
- ``manifest.json``: per file, cv2's (FFmpeg backend) frame count, fps and
  the sha256 of every frame it reads (BGR, and the blue channel a gray
  ``MediaVideo`` keeps), so the card, which is held to these without cv2,
  and the tests read the same facts. cv2 5.0.0 crashes (a corrupted heap)
  on the frames of a bottom-up 24-bit file; that file's record holds the
  written frames and says so, and nothing here opens it with cv2.

``--records`` rewrites only ``manifest.json`` from the committed files.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "torch_data", "avi")
#: The fixture cv2 cannot read (it corrupts its heap), with why.
CV2_CRASHES = {"bgr24_bottomup_37x29.avi": "cv2 5.0.0 corrupts its heap reading bottom-up 24-bit "
                                           "BI_RGB frames"}


def chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def build_avi(path, width, height, compression, frames, bit_count=24, rate=25, scale=1,
              palette=None, idx1="movi", rec=False, audio=None, signed_height=None):
    """An AVI of one video stream (and, with ``audio``, a PCM stream whose
    chunks follow each frame's): ``compression`` a fourcc or None for
    ``BI_RGB``; ``idx1`` "movi" (offsets from the ``movi`` fourcc), "file"
    (from the file's start) or None; ``rec`` groups each frame with its
    audio in a ``LIST 'rec '``."""
    comp = compression or b"\0\0\0\0"
    n = len(frames)
    strh = b"vids" + comp + struct.pack("<IHHIIIIIIiI4h", 0, 0, 0, 0, scale, rate, 0, n, 0, -1, 0,
                                        0, 0, width, height)
    pal = b"" if palette is None else bytes(palette)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height if signed_height is None else signed_height,
                       1, bit_count, comp, 0, 0, 0, len(pal) // 4, 0) + pal
    strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf))
    streams = 1
    if audio is not None:
        streams = 2
        wave = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
        astrh = b"auds" + b"\0" * 4 + struct.pack("<IHHIIIIIIiI4h", 0, 0, 0, 0, 1, 8000, 0,
                                                  sum(len(a) // 2 for a in audio), 0, -1, 2, 0, 0, 0, 0)
        strl += chunk(b"LIST", b"strl" + chunk(b"strh", astrh) + chunk(b"strf", wave))
    avih = struct.pack("<14I", round(1e6 * scale / rate), 0, 0, 0x110 if idx1 else 0x100, n, 0,
                       streams, 0, width, abs(height), 0, 0, 0, 0)
    head = b"RIFF\0\0\0\0AVI " + chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl) \
        + chunk(b"JUNK", b"\0" * 64)
    movi_at = len(head)
    body = bytearray(b"movi")
    entries = []
    for i, frame in enumerate(frames):
        parts = [(b"00dc", frame)] + ([(b"01wb", audio[i])] if audio is not None else [])
        if rec:
            at = movi_at + 8 + len(body) + 12
            inner = bytearray(b"rec ")
            for fourcc, payload in parts:
                entries.append((fourcc, at + len(inner) - 4, len(payload)))
                inner += chunk(fourcc, payload)
            body += chunk(b"LIST", bytes(inner))
        else:
            for fourcc, payload in parts:
                entries.append((fourcc, movi_at + 8 + len(body), len(payload)))
                body += chunk(fourcc, payload)
    out = bytearray(head + b"LIST" + struct.pack("<I", len(body)) + bytes(body))
    if idx1:
        base = movi_at + 8 if idx1 == "movi" else 0
        out += chunk(b"idx1", b"".join(struct.pack("<4sIII", f, 0x10, pos - base, size)
                                       for f, pos, size in entries))
    out[4:8] = struct.pack("<I", len(out) - 8)
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def smooth(h, w, channels, seed):
    """Smooth shapes plus noise, the colour channels unlike each other."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = 110 + 70 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0)
    img = base[..., None] + rng.integers(-25, 25, (h, w, channels))
    if channels == 3:
        img[..., 1] = 255 - img[..., 1]
        img[..., 2] = xx * 255 / max(w, 1)
    return np.clip(img, 0, 255).astype(np.uint8)


def segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan."""
    out, pos = [], 2
    while data[pos] == 0xFF and data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def with_comment(data: bytes, text: bytes) -> bytes:
    return data[:2] + b"\xff\xfe" + struct.pack(">H", len(text) + 3) + text + b"\0" + data[2:]


def avi1_without_dht(data: bytes) -> bytes:
    """A JFIF JPEG as Motion-JPEG capture writes it: APP0 AVI1 (polarity 0,
    progressive) instead of JFIF, and no DHT segment."""
    out, last = bytearray(data[:2]), 2
    for marker, a, b in segments(data):
        out += data[last:a]
        if marker == 0xE0:
            out += b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + bytes(10)
        elif marker != 0xC4:
            out += data[a:b]
        last = b
    return bytes(out + data[last:])


def cv2_writer_frames(path, api, fourcc, size, frames, fps=10, color=True):
    import cv2

    writer = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*fourcc), fps, size, color)
    assert writer.isOpened(), path
    for frame in frames:
        writer.write(frame)
    writer.release()


def pil_jpeg(img, subsampling=None):
    from PIL import Image

    buf = io.BytesIO()
    kwargs = {} if subsampling is None else {"subsampling": subsampling}
    Image.fromarray(img if img.ndim == 2 else img[..., ::-1]).save(buf, "JPEG", quality=90, **kwargs)
    return buf.getvalue()


def mux(path, jpegs, w, h, fps=25.0):
    from sleap_tpu_torch.io import avi

    with avi.AviWriter(path, w, h, fps) as writer:
        for data in jpegs:
            writer.add(data)


def seg(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def gray_jpeg(coefs, quant, h, w) -> bytes:
    """A baseline gray JPEG of the given quantised coefficients (blocks, 64,
    natural order) and table, with the standard Huffman tables."""
    from sleap_tpu_torch.io import jpeg

    frame = jpeg.frame_layout(h, w, 1)
    quant = np.asarray(quant, np.uint8)
    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") \
        + seg(0xDB, b"\0" + quant[jpeg.ZIGZAG[:64]].tobytes()) \
        + seg(0xC0, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])) \
        + seg(0xC4, b"\x00" + jpeg.STD_HUFFMAN[0]) + seg(0xC4, b"\x10" + jpeg.STD_HUFFMAN[1]) \
        + seg(0xDA, b"\x01\x01\x00\x00\x3f\x00")
    return head + jpeg.encode_scan_plain(np.asarray(coefs, np.int16), frame) + b"\xff\xd9"


AMPLITUDES = (1, -1, 2, -3, 7, -16, 31, -64, 127, -255, 511, -1023)
QUANTS = (1, 2, 3, 5, 8, 16, 50, 99, 255)


def probe_frames(seed):
    """8 x 512 gray frames: block k of a probe frame holds one coefficient at
    natural position k (and a small DC), one frame per (table value,
    amplitude); then frames of random sparse blocks under random tables."""
    out = []
    for q in QUANTS:
        for a in AMPLITUDES:
            coefs = np.zeros((64, 64), np.int64)
            coefs[0, 0] = a
            for k in range(1, 64):
                coefs[k, k] = a
                coefs[k, 0] = k % 5 - 2
            out.append(gray_jpeg(coefs, np.full(64, q), 8, 512))
    rng = np.random.default_rng(seed)
    for t in range(60):
        quant = rng.integers(1, 256, 64) if t % 3 else np.full(64, rng.integers(1, 40))
        coefs = np.zeros((64, 64), np.int64)
        for k in range(64):
            n = rng.integers(1, 6)
            coefs[k, rng.integers(0, 64, n)] = rng.integers(-1023, 1024, n) >> rng.integers(0, 10, n)
        coefs[:, 0] = np.clip(coefs[:, 0], -1000, 1000) >> 1
        out.append(gray_jpeg(coefs, quant, 8, 512))
    return out


def bmp_rows(img, bits, top_down, pad=True):
    rows = []
    for row in (img if top_down else img[::-1]):
        if bits == 32:
            row = np.concatenate([row, np.full(row.shape[:1] + (1,), 7, np.uint8)], 1)
        raw = row.tobytes()
        rows.append(raw + b"\0" * ((-len(raw) % 4) if pad else 0))
    return b"".join(rows)


def write_files():
    import cv2

    from sleap_tpu_torch.io import avi

    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    p = lambda name: os.path.join(OUT, name)  # noqa: E731
    colour = [smooth(72, 100, 3, s) for s in range(6)]
    small = [smooth(48, 64, 3, 10 + s) for s in range(8)]
    odd = [smooth(29, 37, 3, 20 + s) for s in range(6)]

    cv2_writer_frames(p("cv2_mjpg_100x72.avi"), cv2.CAP_FFMPEG, "MJPG", (100, 72), colour)
    itu = [with_comment(f, b"CS=ITU601") for f in avi.read_frames(p("cv2_mjpg_100x72.avi"))]
    mux(p("cv2_mjpg_itu601_100x72.avi"), itu, 100, 72, 10)
    cv2_writer_frames(p("opencv_mjpeg_100x72.avi"), cv2.CAP_OPENCV_MJPEG, "MJPG", (100, 72), colour)
    cv2_writer_frames(p("opencv_mjpeg_37x29.avi"), cv2.CAP_OPENCV_MJPEG, "MJPG", (37, 29), odd)
    cv2_writer_frames(p("opencv_mjpeg_gray_37x29.avi"), cv2.CAP_OPENCV_MJPEG, "MJPG", (37, 29),
                      [f[..., 1] for f in odd], color=False)
    mux(p("pil_gray_100x72.avi"), [pil_jpeg(f[..., 0]) for f in colour], 100, 72)
    mux(p("pil_422_100x72.avi"), [pil_jpeg(f, 1) for f in colour], 100, 72)
    mux(p("pil_444_100x72.avi"), [pil_jpeg(f, 0) for f in colour], 100, 72)
    rst = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes() for f in colour]
    mux(p("avi1_nodht_100x72.avi"), [avi1_without_dht(f) for f in rst], 100, 72, 30000 / 1001)
    limit = avi.RIFF_LIMIT
    avi.RIFF_LIMIT = 12000
    try:
        mux(p("opendml_100x72.avi"), [cv2.imencode(".jpg", smooth(72, 100, 3, 30 + s))[1].tobytes()
                                      for s in range(12)], 100, 72, 15)
    finally:
        avi.RIFF_LIMIT = limit
    small_jpegs = [cv2.imencode(".jpg", f)[1].tobytes() for f in small]
    build_avi(p("noidx1_64x48.avi"), 64, 48, b"MJPG", small_jpegs, idx1=None, rate=24000, scale=1001)
    audio = [bytes(np.random.default_rng(s).integers(0, 256, 320 + 2 * s, dtype=np.uint8))
             for s in range(8)]
    build_avi(p("rec_audio_64x48.avi"), 64, 48, b"MJPG", small_jpegs, idx1="file", rec=True,
              audio=audio)
    build_avi(p("zero_chunks_64x48.avi"), 64, 48, b"MJPG",
              small_jpegs[:2] + [b""] + small_jpegs[2:5] + [b"", b""] + small_jpegs[5:], rate=15)
    cv2_writer_frames(p("cv2_y800.avi"), cv2.CAP_FFMPEG, "Y800", (37, 29),
                      [f[..., 0] for f in odd], color=False)
    build_avi(p("bgr24_topdown_37x29.avi"), 37, 29, None, [bmp_rows(f, 24, True) for f in odd],
              signed_height=-29)
    build_avi(p("bgr24_bottomup_37x29.avi"), 37, 29, None, [bmp_rows(f, 24, False) for f in odd])
    build_avi(p("bgra32_37x29.avi"), 37, 29, None, [bmp_rows(f, 32, False) for f in odd], bit_count=32)
    build_avi(p("bgra32_topdown_37x29.avi"), 37, 29, None, [bmp_rows(f, 32, True) for f in odd],
              bit_count=32, signed_height=-29)
    rng = np.random.default_rng(40)
    palette = rng.integers(0, 256, (200, 4), np.uint8)
    palette[:, 3] = 0
    indices = [rng.integers(0, 200, (29, 37), np.uint8) for _ in range(4)]
    build_avi(p("pal8_37x29.avi"), 37, 29, None, [bmp_rows(i[..., None], 8, False) for i in indices],
              bit_count=8, palette=palette.tobytes())
    build_avi(p("gray_y8_unpadded_37x29.avi"), 37, 29, b"Y8  ",
              [bmp_rows(f[..., 2:3], 8, True, pad=False) for f in odd], bit_count=8)
    mux(p("idct_probe.avi"), probe_frames(50), 512, 8)
    import chip_smoke

    xy = chip_smoke.cli_frames()[1][:8]
    frames = chip_smoke.moving_frames(xy, chip_smoke.IMG, 10.0, 200.0, seed=8)[..., 0]
    mux(p("gray_1024.avi"), [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 50])[1].tobytes()
                             for f in frames], 1024, 1024)


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_record(path):
    """cv2's count, fps and frames of ``path`` (FFmpeg backend), read in
    order; a read at random is checked to give the same frame."""
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
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    for i in np.random.default_rng(0).permutation(len(frames))[:4]:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        assert ok and np.array_equal(frame, frames[i]), (path, i)
    return count, fps, frames


def written_record(name):
    """The frames written to the file cv2 cannot read, and its header's
    count and fps (what the demuxer gives for the other files)."""
    from sleap_tpu_torch.io import avi

    video = avi.AviVideo.open(os.path.join(OUT, name))
    frames = [smooth(29, 37, 3, 20 + s) for s in range(6)]
    return video.frames, video.fps, frames


def cv2_versions() -> dict:
    """cv2's version and those of the FFmpeg libraries it was built with."""
    import cv2

    build = cv2.getBuildInformation()
    versions = {"cv2": cv2.__version__}
    for lib in ("avcodec", "avformat", "swscale"):
        line = next((ln for ln in build.splitlines() if ln.strip().startswith(lib + ":")), "")
        versions[lib] = line.split("(")[-1].rstrip(")") if "(" in line else line.strip()
    return versions


def write_records():
    files = {}
    for name in sorted(os.listdir(OUT)):
        if not name.endswith(".avi"):
            continue
        if name in CV2_CRASHES:
            count, fps, frames = written_record(name)
            source = "written frames: " + CV2_CRASHES[name]
        else:
            count, fps, frames = cv2_record(os.path.join(OUT, name))
            source = "cv2"
        files[name] = {"frames": count, "fps": fps, "readable": len(frames),
                       "shape": list(frames[0].shape), "source": source,
                       "bgr": [digest(f) for f in frames], "gray": [digest(f[..., 0]) for f in frames]}
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump({"versions": cv2_versions(), "files": files}, fh, indent=1, sort_keys=True)
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
