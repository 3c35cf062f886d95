"""Write the MPEG-4 Part 2 fixtures of the port's tests and ``chip_smoke.py``
phase 26 from a seed, and record what OpenCV's FFmpeg backend reads from each.

    JAX_PLATFORMS=cpu python scripts/make_torch_mpeg4_fixtures.py [--records]

Writes, under ``tests/torch_data/mpeg4``:

- cv2's own streams (libavcodec's encoder, through ``cv2.VideoWriter``) of
  one seeded colour scene at 200 x 120 (a size whose sides are no multiple
  of 16, so the padded macroblock area and the visible frame part ways):
  a textured canvas that pans faster than a macroblock a frame (vectors that
  reach past the frame's edges), a patch that stands still (skipped
  macroblocks), a square of fine noise (large levels: TCOEF escapes), and a
  scene cut inside the second GOP (intra macroblocks in a P-VOP); 36 frames,
  three GOPs of 12. The same clip as ``FMP4``, ``XVID`` and ``DIVX`` AVIs
  (the VOL in-band before each I-VOP), an ``mp4v`` ``.mp4`` and ``.mov``
  (the VOL in ``esds``) and an ``.mkv`` (``V_MPEG4/ISO/ASP``, the VOL in
  ``CodecPrivate``); cv2's AVI packets re-muxed as ``V_MPEG4/ISO/SP`` and as
  ``V_MS/VFW/FOURCC`` (``FMP4``) Matroska files;
- a gray scene at 96 x 64 (cv2 writes gray frames as 4:2:0 of neutral
  chroma), 24 frames;
- ``fmp4_gray_1024.avi``: 1024 x 1024 gray, 24 frames of four smooth animal-like
  blobs moving over a dim textured floor, the clip of ``chip_smoke.py``
  phase 26b;
- streams of ``scripts/write_mpeg4_fixture.py`` (random syntax elements:
  ``intra_dc_vlc_thr`` 1-7, every TCOEF escape, DQUANT everywhere, MCBPC
  stuffing, every ``f_code``), colour at 64 x 48 and 200 x 120, gray at 48
  x 32; and with the Simple Profile tools libavcodec's encoder does not use
  here: 4MV macroblocks, MPEG quantisation (loaded and default matrices),
  video packets (resync markers, header extensions), not-coded VOPs (cv2
  gives no frame for them: fewer frames read than the AVI counts); in AVIs;
- ``manifest.json``, of ``scripts/make_torch_avi_fixtures.py``'s schema:
  per file cv2's frame count, fps and the sha256 of every frame it reads in
  order (BGR, and the blue channel a gray ``MediaVideo`` keeps); cv2's
  seeks give the same frames for every file here (checked).

A rebuild writes every file byte for byte but cv2's own ``.mkv``, whose writer
puts random UIDs in (its frames, and so the manifest, stay the same).
``--records`` rewrites only ``manifest.json`` from the committed files.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
from typing import List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_torch_avi_fixtures as avifix  # noqa: E402
import make_torch_container_fixtures as containers  # noqa: E402
import write_mpeg4_fixture as writer  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_data", "mpeg4")
SIZE, FRAMES, FPS = (200, 120), 36, 25
#: The random-syntax streams: name -> (width, height, frames, GOP, seed, odds,
#: VOL options).
SYNTAX = {"syntax_64x48.avi": (64, 48, 24, 8, 1, {}, {}),
          "syntax_200x120.avi": (200, 120, 18, 6, 2, {}, {}),
          "syntax_gray_48x32.avi": (48, 32, 24, 12, 3, {"gray": True}, {}),
          "syntax_4mv_200x120.avi": (200, 120, 16, 8, 4, {"mv4": 0.4}, {}),
          "syntax_mpeg_quant_64x48.avi": (64, 48, 16, 8, 5, {"mv4": 0.2}, {
              "quant_type": 1, "intra_matrix": [int(v) for v in np.random.default_rng(5).integers(
                  1, 256, 64)], "inter_matrix": [9, 40, 200, 17, 64, 0]}),
          "syntax_mpeg_quant_default_48x32.avi": (48, 32, 12, 6, 6, {}, {"quant_type": 1}),
          "syntax_packets_200x120.avi": (200, 120, 16, 8, 7, {"packet": 0.25, "mv4": 0.2},
                                         {"resync": True}),
          "syntax_nvop_64x48.avi": (64, 48, 20, 10, 8, {"nvop": 0.3}, {})}


def blur(img: np.ndarray, k: int) -> np.ndarray:
    import cv2

    return cv2.GaussianBlur(img, (0, 0), k)


def scene(w: int, h: int, n: int, seed: int) -> List[np.ndarray]:
    """The colour scene's BGR frames."""
    rng = np.random.default_rng(seed)

    def canvas(s):
        r = np.random.default_rng(s)
        base = blur(r.integers(0, 256, (h + 400, w + 400, 3)).astype(np.float32), 3)
        base = (base - base.mean()) * 4 + 128
        return np.clip(base, 0, 255).astype(np.uint8)

    worlds = (canvas(seed + 1), canvas(seed + 2))
    still = worlds[0][:32, :48].copy()
    fine = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    frames = []
    for k in range(n):
        world = worlds[k >= 17]  # the cut: frame 17, inside the second GOP
        ox, oy = 200 + 19 * k % 180 - 90, 200 + 11 * k % 160 - 80
        f = world[oy:oy + h, ox:ox + w].copy()
        f[:32, :48] = still
        f[60:92, 120:152] = np.roll(fine, 3 * k, 1)
        frames.append(f)
    return frames


def gray_scene(w: int, h: int, n: int, seed: int) -> List[np.ndarray]:
    """A gray scene: smooth rings that drift, as BGR with equal channels."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    frames = []
    for k in range(n):
        v = 128 + 60 * np.sin((xx - 2.5 * k) / 6.0 + seed) * np.cos((yy + 1.5 * k) / 5.0)
        g = np.clip(v, 0, 255).astype(np.uint8)
        frames.append(np.repeat(g[..., None], 3, 2))
    return frames


def animals(size: int, n: int, seed: int) -> List[np.ndarray]:
    """Four elongated blobs (body and head) moving over a dim textured floor,
    gray as BGR with equal channels."""
    rng = np.random.default_rng(seed)
    floor = blur(rng.integers(0, 256, (size, size)).astype(np.float32), 4)
    floor = np.clip((floor - floor.mean()) * 3 + 40, 0, 255)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    start = rng.uniform(200, size - 200, (4, 2))
    vel = rng.uniform(-9, 9, (4, 2))
    angle = rng.uniform(0, np.pi, 4)
    frames = []
    for k in range(n):
        img = floor.copy()
        for a in range(4):
            cy, cx = start[a] + k * vel[a]
            th = angle[a] + 0.05 * k
            for along, sigma, peak in ((0.0, (34.0, 14.0), 190.0), (40.0, (12.0, 10.0), 215.0)):
                py, px = cy + along * np.sin(th), cx + along * np.cos(th)
                u = (xx - px) * np.cos(th) + (yy - py) * np.sin(th)
                v = -(xx - px) * np.sin(th) + (yy - py) * np.cos(th)
                img = np.maximum(img, peak * np.exp(-0.5 * ((u / sigma[0]) ** 2 + (v / sigma[1]) ** 2)))
        g = np.clip(img, 0, 255).astype(np.uint8)
        frames.append(np.repeat(g[..., None], 3, 2))
    return frames


def cv2_write(path: str, fourcc: str, frames: List[np.ndarray], color: bool = True) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), FPS, (w, h),
                          color)
    if not out.isOpened():
        raise RuntimeError(f"cv2 cannot write {path} as {fourcc}")
    for f in frames:
        out.write(f if color else f[..., 0])
    out.release()


def is_key(packet: bytes) -> bool:
    at = packet.find(b"\x00\x00\x01\xb6")
    return at >= 0 and packet[at + 4] >> 6 == 0


def write_files():
    from sleap_tpu_torch.io import avi, mkv

    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    w, h = SIZE
    frames = scene(w, h, FRAMES, 27)
    path = lambda name: os.path.join(OUT, name)  # noqa: E731
    cv2_write(path("fmp4_200x120.avi"), "FMP4", frames)
    cv2_write(path("xvid_200x120.avi"), "XVID", frames[:14])
    cv2_write(path("divx_200x120.avi"), "DIVX", frames[:14])
    for ext in ("mp4", "mov", "mkv"):
        cv2_write(path(f"mp4v_200x120.{ext}"), "mp4v", frames)
    packets = avi.read_frames(path("fmp4_200x120.avi"))
    keys = [is_key(p) for p in packets]
    times = [40 * k for k in range(len(packets))]
    config = mkv.MkvVideo.open(path("mp4v_200x120.mkv")).config
    first = mkv.MkvVideo.open(path("mp4v_200x120.mkv"))
    with open(first.filename, "rb") as f:
        mkv_packets = [first.read_sample(f, k) for k in range(len(first.sizes))]
    with open(path("sp_200x120.mkv"), "wb") as fh:
        fh.write(containers.mkv_bytes(mkv_packets, times, w, h, "V_MPEG4/ISO/SP", config,
                                      default_duration=40_000_000, duration=40.0 * len(packets),
                                      keys=keys))
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"FMP4", w * h * 3, 0, 0, 0, 0)
    with open(path("vfw_fmp4_200x120.mkv"), "wb") as fh:
        fh.write(containers.mkv_bytes(packets, times, w, h, "V_MS/VFW/FOURCC", bih,
                                      default_duration=40_000_000, duration=40.0 * len(packets),
                                      keys=keys))
    cv2_write(path("fmp4_gray_96x64.avi"), "FMP4", gray_scene(96, 64, 24, 5), color=False)
    cv2_write(path("fmp4_gray_1024.avi"), "FMP4", animals(1024, 24, 26), color=False)
    for name, (sw, sh, n, gop, seed, odds, vol) in SYNTAX.items():
        with open(path(name), "wb") as fh:
            fh.write(writer.avi_bytes(writer.stream(sw, sh, n, gop, seed, odds=odds, **vol), sw, sh))


def write_records():
    files = {}
    for name in sorted(os.listdir(OUT)):
        if name == "manifest.json":
            continue
        count, fps, frames, seek = containers.record(os.path.join(OUT, name))
        if seek:
            raise AssertionError(f"{name}: cv2's seeks give other frames than its reads: {seek}")
        files[name] = {"frames": count, "fps": fps, "readable": len(frames),
                       "shape": list(frames[0].shape), "source": "cv2",
                       "bgr": [avifix.digest(f) for f in frames],
                       "gray": [avifix.digest(f[..., 0]) for f in frames]}
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
