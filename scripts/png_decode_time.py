"""Time the port's PNG decoder (``sleap_tpu_torch.io.png.decode``) on
grayscale frames of 384^2 and 1024^2 whose rows all use one filter, for each
of the five PNG row filters, and whose rows cycle through all five ("mixed",
as an adaptive encoder may pick them); it runs on the host CPU only.

    python3 scripts/png_decode_time.py [--repeats 3]

Prints one JSON line per (size, filter): the median ms a frame of
``--repeats`` decodes, and the host's CPU model and core count.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import struct
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sleap_tpu_torch.io import png  # noqa: E402

FILTERS = ("none", "sub", "up", "average", "paeth", "mixed")


def encode(img: np.ndarray, kind: int) -> bytes:
    """A grayscale PNG of (H, W) uint8 ``img`` with every row filtered by
    ``kind``, as the PNG specification defines the filters; kind 5 filters
    row y by y % 5."""
    h, w = img.shape
    x = img.astype(np.int64)
    up = np.vstack([np.zeros((1, w), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, 1), np.int64), x[:, :-1]])
    upleft = np.hstack([np.zeros((h, 1), np.int64), up[:, :-1]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kinds = np.arange(h) % 5 if kind == 5 else np.full(h, kind)
    preds = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])
    pred = preds[kinds, np.arange(h)]
    rows = np.hstack([kinds[:, None], (x - pred) % 256]).astype(np.uint8)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def frame(size: int, seed: int = 0) -> np.ndarray:
    """Two Gaussian blobs (sigma 14 px) over noise, as the test fixtures."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    img = rng.integers(0, 8, (size, size)).astype(np.float64)
    for cx, cy in ((0.3 * size, 0.3 * size), (0.7 * size, 0.65 * size)):
        img += 200 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 14.0**2))
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    host = {"cpu": platform.processor() or platform.machine(), "cores": os.cpu_count()}
    for size in (384, 1024):
        img = frame(size)
        for kind, name in enumerate(FILTERS):
            data = encode(img, kind)
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                out = png.decode(data, device="cpu")
                times.append(time.perf_counter() - t0)
            if not np.array_equal(out[..., 0], img):
                raise SystemExit(f"decode of the {name} frame at {size}^2 is wrong")
            print(json.dumps({"size": size, "filter": name, "ms": 1e3 * float(np.median(times)),
                              "bytes": len(data), "host": host}), flush=True)


if __name__ == "__main__":
    main()
