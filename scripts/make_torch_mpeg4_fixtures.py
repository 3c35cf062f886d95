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
#: The streams with B-VOPs (``write_mpeg4_fixture.bstream``): name ->
#: (fourcc, keyword arguments).
BSYNTAX = {
    "bvop_64x48.avi": ("FMP4", dict(width=64, height=48, frames=16, gop=8, bframes=2, seed=41,
                                    odds={"mv4": 0.3, "skip": 0.3, "intra": 0.15}, low_delay=0)),
    "bvop_simple_vol_48x32.avi": ("FMP4", dict(width=48, height=32, frames=12, gop=6, bframes=2,
                                               seed=42)),
    "bvop_gov_closed_64x48.avi": ("FMP4", dict(width=64, height=48, frames=16, gop=7, bframes=2,
                                               seed=43, gov="closed", leading=2, low_delay=0)),
    "bvop_gov_broken_64x48.avi": ("FMP4", dict(width=64, height=48, frames=16, gop=5, bframes=2,
                                               seed=44, gov="broken", low_delay=0,
                                               odds={"mv4": 0.3})),
    "bvop_open_200x120.avi": ("FMP4", dict(width=200, height=120, frames=20, gop=12, bframes=3,
                                           seed=45, gov="open", low_delay=0, resolution=30,
                                           odds={"mv4": 0.3, "skip": 0.25})),
    "bvop_packets_96x64.avi": ("FMP4", dict(width=96, height=64, frames=14, gop=7, bframes=2,
                                            seed=46, resync=True, low_delay=0,
                                            odds={"packet": 0.3, "mv4": 0.2, "bad_time": 0.3})),
    "bvop_mpeg_quant_48x32.avi": ("FMP4", dict(width=48, height=32, frames=12, gop=6, bframes=2,
                                               seed=47, quant_type=1, low_delay=0,
                                               inter_matrix=[9, 40, 200, 17, 64, 0])),
    "xvid_bvop_200x120.avi": ("XVID", dict(width=200, height=120, frames=18, gop=12, bframes=2,
                                           seed=48, user_data=b"XviD0064", low_delay=0,
                                           odds={"mv4": 0.3, "skip": 0.25})),
    "divx_packed_64x48.avi": ("DIVX", dict(width=64, height=48, frames=16, gop=8, bframes=2,
                                           seed=49, user_data=b"DivX503b1393p", packed=True,
                                           low_delay=0, odds={"mv4": 0.2})),
    "xvid_packed_64x48.avi": ("XVID", dict(width=64, height=48, frames=14, gop=7, bframes=1,
                                           seed=50, user_data=(b"XviD0064", b"DivX501b481p"),
                                           packed=True, low_delay=0)),
    # 26a's timings: gray 1024 x 1024, I, P and B-VOPs, few coded blocks.
    "xvid_gray_1024.avi": ("XVID", dict(width=1024, height=1024, frames=12, gop=12, bframes=2,
                                        seed=51, user_data=b"XviD0064", low_delay=0,
                                        odds={"gray": True, "residual": 0.1, "skip": 0.4,
                                              "intra": 0.02, "mv4": 0.1, "modb1": 0.3})),
}
XVID_IDCT = "xvid_idct_64x48.avi"


def idct_blocks(seed: int) -> List[List[List[int]]]:
    """The blocks of :data:`XVID_IDCT`'s intra VOPs (64 x 48: 72 blocks a
    VOP), to reach every corner of an IDCT: one coefficient at each of the
    64 positions at six magnitudes (the DC among them), DCs that saturate,
    full blocks of +-2047 (all one sign, random signs, random values),
    dense random blocks."""
    rng = np.random.default_rng(seed)
    flat = [128] + [0] * 63
    frames = []
    for val in (1, -1, 2047, -2047, 700, -1300):
        blocks = []
        for n in range(64):
            b = [128] + [0] * 63
            if n:
                b[n] = val
            else:
                b[0] = 128 + val // 16
            blocks.append(b)
        frames.append(blocks + [flat] * 8)
    frames.append([[int(rng.choice([0, 255, 256, 300, 700, 767]))] +
                   [int(rng.integers(-2047, 2048)) if j == k else 0 for j in range(1, 64)]
                   for k in range(72)])
    for mode in range(3):
        blocks = []
        for _ in range(72):
            if mode == 0:
                b = [2047 if rng.random() < 0.5 else -2047] * 64
            elif mode == 1:
                b = [int(v) for v in rng.choice([-2047, 2047], 64)]
            else:
                b = [int(v) for v in rng.integers(-2047, 2048, 64)]
            b[0] = int(rng.integers(0, 300))
            blocks.append(b)
        frames.append(blocks)
    for _ in range(2):
        blocks = []
        for _ in range(72):
            b = [int(rng.integers(0, 256))] + [0] * 63
            for j in rng.choice(63, int(rng.integers(1, 64)), replace=False) + 1:
                b[j] = int(rng.integers(-400, 400))
            blocks.append(b)
        frames.append(blocks)
    return frames


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
    for name, (fourcc, kw) in BSYNTAX.items():
        kw = dict(kw)
        sw, sh, n, gop, bframes, seed = (kw.pop(k) for k in ("width", "height", "frames", "gop",
                                                                "bframes", "seed"))
        with open(path(name), "wb") as fh:
            fh.write(writer.avi_bytes(writer.bstream(sw, sh, n, gop, bframes, seed, **kw), sw, sh,
                                      fourcc.encode()))
    with open(path(XVID_IDCT), "wb") as fh:
        fh.write(writer.avi_bytes([writer.coefficient_vop(64, 48, blocks, b"XviD0064")
                                   for blocks in idct_blocks(52)], 64, 48, b"XVID"))


def write_records():
    files = {}
    for name in sorted(os.listdir(OUT)):
        if name == "manifest.json":
            continue
        count, fps, frames, seek = containers.record(os.path.join(OUT, name))
        if seek and name not in BSYNTAX:
            raise AssertionError(f"{name}: cv2's seeks give other frames than its reads: {seek}")
        files[name] = {"frames": count, "fps": fps, "readable": len(frames),
                       "shape": list(frames[0].shape), "source": "cv2",
                       "bgr": [avifix.digest(f) for f in frames],
                       "gray": [avifix.digest(f[..., 0]) for f in frames]}
        if seek:  # the port follows cv2's reads (ROADMAP.md queue 3, item 5)
            files[name]["seek"] = seek
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
