"""Write the BMP and TIFF fixtures of the port's tests and ``chip_smoke.py``
phase 19 with cv2, PIL (built with libtiff) and a small writer of its own for
the layouts neither writes (tiles, planar-separate samples, big-endian
files, the floating-point predictor, RLE-coded BMPs, the headers the port
refuses), from a seed; nothing is downloaded.

    JAX_PLATFORMS=cpu python scripts/make_torch_still_fixtures.py

Writes, under ``tests/torch_data/stills``:

- ``*.bmp`` and ``*.tif``: small stills of smooth content (a few KB each)
  and two 1024^2 TIFFs as cv2 writes them (uint8 gray, and uint16 gray of
  12-bit values);
- ``decoded.json``: for each file, the sha256 of ``cv2.imdecode(buf,
  cv2.IMREAD_UNCHANGED)``'s bytes with its shape and dtype, or the feature
  the port refuses (named in its error), so the card, which has no cv2, can
  hold the port's decoders to cv2's output;
- ``encoded.json``: the sha256 and length of ``cv2.imencode(".bmp" or
  ".tif", frame)`` for the frames cv2 decodes from the committed files
  (BMP of the uint8 ones, TIFF of every one) and for crops of the 1024^2
  frames, so the card can hold the port's encoders to cv2's bytes.

Both records name the cv2 and libtiff that wrote them. ``--records``
rewrites only the two JSON files from the committed stills.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_data", "stills")
BIG = 1024

#: Crops (W, H) of the 1024^2 frames that encoded.json records, at (1, 1).
CROPS = ((1, 1), (3, 50), (1023, 1021))


def smooth(h: int, w: int, channels: int, seed: int, dtype=np.uint8) -> np.ndarray:
    """Smooth shapes and gradients (no noise: the files stay small), each
    channel its own."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    phase = np.random.default_rng(seed).uniform(0, 6, channels)
    chans = [0.5 + 0.35 * np.sin(xx / (w / 5.0 + 1) + p) * np.cos(yy / (h / 4.0 + 1) - p)
             + 0.1 * (xx + yy) / (h + w) for p in phase]
    img = np.stack(chans, -1)
    if dtype == np.float32:
        return img.astype(np.float32)
    top = np.iinfo(dtype).max
    return np.clip(np.rint(img * top), 0, top).astype(dtype)


# --------------------------------------------------------------------------- #
# TIFF layouts neither cv2 nor PIL writes
# --------------------------------------------------------------------------- #


def tiff_bytes(img, order="<", compression=1, predictor=1, planar=1, tile=None, rows=None,
               photometric=None, sample_format=None, bits=None, magic=42, orientation=None):
    """A one-page TIFF of ``img`` (H, W) or (H, W, C) in RGB(A) order, with
    no compression (1) or deflate (8), the horizontal (2) or floating-point
    (3) predictor, chunky (1) or separate (2) samples, strips of ``rows``
    rows or ``tile`` (W, H) tiles."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    dt = img.dtype
    photo = photometric if photometric is not None else (1 if c == 1 else 2)
    fmt = sample_format or (3 if dt.kind == "f" else 2 if dt.kind == "i" else 1)
    planes = [img] if planar == 1 else [img[..., s:s + 1] for s in range(c)]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(t)
        else:
            chunks += [plane[y:y + (rows or h)] for y in range(0, h, rows or h)]
    blobs = []
    for chunk in chunks:
        if predictor == 2:  # on words of the sample's size, as libtiff's horDiff
            words = chunk.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[dt.itemsize])
            diff = words.copy()
            diff[:, 1:] = words[:, 1:] - words[:, :-1]
            raw = diff.astype(diff.dtype.newbyteorder(order)).tobytes()
        elif predictor == 3:  # bytes by significance, then differenced
            r, cw, cc = chunk.shape
            b = chunk.astype(">" + dt.str[1:]).view(np.uint8).reshape(r, cw * cc, dt.itemsize)
            b = np.ascontiguousarray(b.transpose(0, 2, 1)).reshape(r, -1)
            diff = b.copy()
            diff[:, cc:] = b[:, cc:] - b[:, :-cc]
            raw = diff.tobytes()
        else:
            raw = chunk.astype(dt.newbyteorder(order)).tobytes()
        blobs.append(zlib.compress(raw) if compression == 8 else raw)
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [bits or 8 * dt.itemsize] * c),
               (259, 3, [compression]), (262, 3, [photo]), (277, 3, [c]), (284, 3, [planar]),
               (339, 3, [fmt] * c)]
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, None),
                    (325, 4, [len(b) for b in blobs])]
    else:
        entries += [(273, 4, None), (278, 3, [rows or h]), (279, 4, [len(b) for b in blobs])]
    out = bytearray((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", magic, 0))
    offsets = []
    for b in blobs:
        offsets.append(len(out))
        out += b + bytes(len(b) & 1)
    ifd = len(out)
    struct.pack_into(order + "I", out, 4, ifd)
    entries.sort(key=lambda e: e[0])
    data_at = ifd + 2 + 12 * len(entries) + 4
    table, tail = bytearray(struct.pack(order + "H", len(entries))), bytearray()
    for tag, typ, values in entries:
        values = offsets if values is None else values
        raw = struct.pack(order + ("H" if typ == 3 else "I") * len(values), *values)
        if len(raw) <= 4:
            table += struct.pack(order + "HHI", tag, typ, len(values)) + raw.ljust(4, b"\0")
        else:
            table += struct.pack(order + "HHII", tag, typ, len(values), data_at + len(tail))
            tail += raw + bytes(len(raw) & 1)
    return bytes(out + table + b"\0\0\0\0" + tail)


def pil_tiff(img, mode, compression, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", compression=compression, **kw)
    return buf.getvalue()


def tiffs(cv2) -> dict:
    """name -> (file bytes, feature the port refuses or None)."""
    from PIL import Image

    def enc(img):
        ok, buf = cv2.imencode(".tif", img)
        assert ok
        return buf.tobytes()

    out = {
        "cv2_gray_100x72": enc(smooth(72, 100, 1, 1)[..., 0]),
        "cv2_bgr_37x29": enc(smooth(29, 37, 3, 2)),
        "cv2_bgra_37x29": enc(smooth(29, 37, 4, 3)),
        "cv2_gray16_100x72": enc(smooth(72, 100, 1, 4, np.uint16)[..., 0]),
        "cv2_bgr16_37x29": enc(smooth(29, 37, 3, 5, np.uint16)),
        "cv2_float_37x29": enc(smooth(29, 37, 1, 6, np.float32)[..., 0]),
        "cv2_bgr_float_13x9": enc(smooth(9, 13, 3, 7, np.float32)),
        "cv2_gray_3x50": enc(smooth(50, 3, 1, 8)[..., 0]),
        "cv2_gray_1024": enc(smooth(BIG, BIG, 1, 9)[..., 0]),
        # 12-bit values, as a scientific camera's
        "cv2_gray16_1024": enc(smooth(BIG, BIG, 1, 10)[..., 0].astype(np.uint16) * 16),
    }
    rgb = smooth(29, 37, 3, 11)
    out["pil_gray_lzw_37x29"] = pil_tiff(rgb, "L", "tiff_lzw")
    out["pil_gray_raw_37x29"] = pil_tiff(rgb, "L", "raw")
    out["pil_rgb_deflate_37x29"] = pil_tiff(rgb, "RGB", "tiff_adobe_deflate")
    out["pil_rgb_zip_37x29"] = pil_tiff(rgb, "RGB", "tiff_deflate")
    out["pil_rgb_packbits_37x29"] = pil_tiff(rgb, "RGB", "packbits")
    rgba = np.concatenate([rgb, smooth(29, 37, 1, 12)], -1)
    out["pil_rgba_lzw_37x29"] = pil_tiff(rgba, "RGBA", "tiff_lzw")  # unassociated alpha
    buf = io.BytesIO()
    Image.fromarray(smooth(29, 37, 1, 13, np.uint16)[..., 0]).save(buf, "TIFF", compression="tiff_lzw")
    out["pil_gray16_lzw_37x29"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(smooth(29, 37, 1, 14, np.float32)[..., 0]).save(buf, "TIFF")
    out["pil_float_raw_37x29"] = buf.getvalue()
    buf = io.BytesIO()
    pages = [Image.fromarray(smooth(29, 37, 3, 15 + i)) for i in range(3)]
    pages[0].save(buf, "TIFF", compression="tiff_lzw", save_all=True, append_images=pages[1:])
    out["pil_rgb_3pages_37x29"] = buf.getvalue()
    hand = {
        "hand_gray_tiles_deflate_37x29": tiff_bytes(smooth(29, 37, 1, 20), compression=8, tile=(16, 16)),
        "hand_rgb16_tiles_37x29": tiff_bytes(smooth(29, 37, 3, 21, np.uint16), tile=(16, 16)),
        "hand_rgb_planar_deflate_37x29": tiff_bytes(smooth(29, 37, 3, 22), compression=8, planar=2,
                                                    rows=7),
        "hand_rgba_planar_tiles_37x29": tiff_bytes(smooth(29, 37, 4, 23), compression=8, planar=2,
                                                   tile=(16, 16)),
        "hand_gray16_be_pred2_37x29": tiff_bytes(smooth(29, 37, 1, 24, np.uint16), ">", 8, 2, rows=5),
        "hand_float_pred3_37x29": tiff_bytes(smooth(29, 37, 1, 25, np.float32), compression=8,
                                             predictor=3, rows=8),
        "hand_rgb_float_pred3_be_13x9": tiff_bytes(smooth(9, 13, 3, 26, np.float32), ">", 8, 3),
        "hand_float_pred2_37x29": tiff_bytes(smooth(29, 37, 1, 27, np.float32), compression=8,
                                             predictor=2),
    }
    out.update(hand)
    files = {name: (data, None) for name, data in out.items()}
    gray = smooth(29, 37, 1, 30)
    files.update({
        "refused_bigtiff": (b"II+\0\x08\0\0\0" + bytes(16), "BigTIFF"),
        "refused_jpeg": (pil_tiff(rgb, "RGB", "jpeg"), "JPEG-in-TIFF"),
        "refused_ccitt": (pil_tiff(rgb, "1", "group4"), "CCITT"),
        "refused_bilevel": (pil_tiff(rgb, "1", "raw"), "bilevel"),
        "refused_palette": (pil_tiff(rgb, "P", "raw"), "palette"),
        "refused_min_is_white": (tiff_bytes(gray, photometric=0), "min-is-white"),
        "refused_signed": (tiff_bytes(gray.astype(np.int16)), "signed"),
        "refused_float64": (tiff_bytes(gray.astype(np.float64)), "64-bit"),
        "refused_planar16": (tiff_bytes(smooth(9, 13, 3, 31, np.uint16), planar=2), "planar-separate"),
        "refused_orientation": (tiff_bytes(gray, orientation=3), "orientation"),
    })
    return files


# --------------------------------------------------------------------------- #
# BMP layouts
# --------------------------------------------------------------------------- #


def bmp_bytes(pixels, bits, palette=None, compression=0, top_down=False, header=40, masks=None,
              rle=None) -> bytes:
    """A BMP of ``pixels``: (H, W) palette indexes for ``bits`` <= 8,
    (H, W) 16-bit words, or (H, W, 3 or 4) bytes B G R (A); ``rle`` the
    coded rows instead; ``masks`` after a 40-byte header, or in a longer
    one."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if rle is None:
        rows = []
        for row in pixels:
            if bits == 1:
                raw = np.packbits(row.astype(np.uint8)).tobytes()
            elif bits == 4:
                r = np.concatenate([row, [0] * (len(row) % 2)]).astype(np.uint8)
                raw = ((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes()
            elif bits == 16:
                raw = row.astype("<u2").tobytes()
            else:
                raw = row.astype(np.uint8).tobytes()
            rows.append(raw + bytes(-len(raw) % 4))
        data = b"".join(rows if top_down else rows[::-1])
    else:
        data = rle
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                       len(data), 2835, 2835, len(pal) // 4, 0)
    if header > 40:
        m = list(masks or (0, 0, 0, 0)) + [0] * 4
        info += (struct.pack("<IIII", *m[:4]) + b"BGRs").ljust(header - 40, b"\0")
    after = struct.pack("<III", *masks[:3]) if masks is not None and header == 40 else b""
    offset = 14 + len(info) + len(after) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + after + pal + data


def rle_rows(idx, bits) -> bytes:
    """RLE8 or RLE4 of (H, W) indexes, bottom row first: each row as runs
    (RLE4: of one index), an absolute block where a row starts with three
    different indexes, a delta over the middle of the second row, an
    end-of-line escape after each row, and an end-of-bitmap escape a row
    early (the top row is left to index 0)."""
    h, w = idx.shape
    out = bytearray()
    for n, r in enumerate(range(h - 1, 0, -1)):
        row = idx[r]
        x = 0
        if n == 1 and w >= 8:  # a delta: skip four pixels, no rows
            out += bytes([1, row[0] if bits == 8 else row[0] << 4 | row[0], 0, 2, 4, 0])
            x = 5
        elif w >= 4 and len(set(row[:3].tolist())) == 3:
            k = 4 if bits == 4 else 3
            vals = row[:k].astype(np.uint8)
            if bits == 4:
                raw = bytes(((vals[0::2] << 4) | vals[1::2]).tolist())
            else:
                raw = vals.tobytes()
            out += bytes([0, k]) + raw + bytes(len(raw) & 1)
            x = k
        while x < w:
            j = x
            while j < w and row[j] == row[x] and j - x < 255:
                j += 1
            out += bytes([j - x, row[x] if bits == 8 else row[x] << 4 | row[x]])
            x = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmps(cv2) -> dict:
    """name -> (file bytes, feature the port refuses or None)."""
    def enc(img):
        ok, buf = cv2.imencode(".bmp", img)
        assert ok
        return buf.tobytes()

    from PIL import Image

    def pil(img, mode):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "BMP")
        return buf.getvalue()

    gray_pal = np.stack([np.arange(256)] * 3 + [np.zeros(256)], 1).astype(np.uint8)
    rng = np.random.default_rng(40)
    colour_pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    idx16 = (smooth(29, 37, 1, 41)[..., 0] // 16).astype(np.uint8)
    idx8 = (smooth(29, 37, 1, 42)[..., 0] // 4).astype(np.uint8)
    words = smooth(29, 37, 1, 43, np.uint16)[..., 0]
    bgra = smooth(29, 37, 4, 44)
    rgb = smooth(29, 37, 3, 45)
    files = {
        "cv2_gray_100x72": enc(smooth(72, 100, 1, 46)[..., 0]),
        "cv2_bgr_37x29": enc(smooth(29, 37, 3, 47)),
        "cv2_bgra_3x50": enc(smooth(50, 3, 4, 48)),
        "pil_1bit_37x29": pil(rgb, "1"),
        "pil_gray_37x29": pil(rgb, "L"),
        "pil_palette_37x29": pil(rgb, "P"),
        "pil_rgb_37x29": pil(rgb, "RGB"),
        "pil_rgba_37x29": pil(np.concatenate([rgb, smooth(29, 37, 1, 49)], -1), "RGBA"),
        "hand_4bit_gray_37x29": bmp_bytes(idx16, 4, gray_pal[::17]),
        "hand_4bit_colour_37x29": bmp_bytes(idx16, 4, colour_pal[:16]),
        "hand_8bit_colour_top_down_37x29": bmp_bytes(idx8, 8, colour_pal[:64], top_down=True),
        "hand_555_37x29": bmp_bytes(words, 16),
        "hand_565_37x29": bmp_bytes(words, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "hand_24bit_top_down_37x29": bmp_bytes(rgb, 24, top_down=True),
        "hand_32bit_v4_37x29": bmp_bytes(bgra, 32, compression=3, header=108,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "hand_32bit_rgb_37x29": bmp_bytes(bgra, 32),
        "hand_rle8_gray_37x29": bmp_bytes(idx8, 8, gray_pal, compression=1, rle=rle_rows(idx8, 8)),
        "hand_rle8_colour_37x29": bmp_bytes(idx8, 8, colour_pal[:64], compression=1,
                                            rle=rle_rows(idx8, 8)),
        "hand_rle4_colour_37x29": bmp_bytes(idx16, 4, colour_pal[:16], compression=2,
                                            rle=rle_rows(idx16, 4)),
    }
    files = {name: (data, None) for name, data in files.items()}
    core = b"BM" + struct.pack("<IHHI", 26 + 3 * 4, 0, 0, 26) + struct.pack("<IHHHH", 12, 2, 2, 1, 24)
    files.update({
        "refused_os2": (core + bytes(12), "OS/2"),
        "refused_jpeg": (bmp_bytes(rgb, 24, compression=4), "JPEG"),
        "refused_565_v5": (bmp_bytes(words, 16, compression=3, header=124,
                                     masks=(0xF800, 0x7E0, 0x1F, 0)), "bitfields"),
    })
    return files


# --------------------------------------------------------------------------- #
# Records
# --------------------------------------------------------------------------- #


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def versions(cv2) -> dict:
    from PIL import features

    return {"cv2": cv2.__version__, "libtiff": features.version("libtiff")}


def committed(ext: str):
    return sorted(f[:-len(ext) - 1] for f in os.listdir(OUT) if f.endswith("." + ext))


def write_records(cv2) -> None:
    """decoded.json (whose refusals are kept) and encoded.json, from the
    committed files."""
    path = os.path.join(OUT, "decoded.json")
    old = json.load(open(path))["stills"] if os.path.exists(path) else {}
    decoded, encoded = {}, {}
    for ext in ("bmp", "tif"):
        for name in committed(ext):
            key = f"{name}.{ext}"
            with open(os.path.join(OUT, key), "rb") as fh:
                data = fh.read()
            if "refused" in old.get(key, {}):
                decoded[key] = old[key]
                continue
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
            assert img is not None, key
            decoded[key] = digest(img)
            frames = {key: img}
            if img.shape[:2] == (BIG, BIG):
                for w, h in CROPS:
                    frames[f"{key}_crop_{w}x{h}"] = np.ascontiguousarray(img[1:1 + h, 1:1 + w])
            for fname, frame in frames.items():
                for fmt in ("bmp", "tif"):
                    if fmt == "bmp" and frame.dtype != np.uint8:
                        continue
                    ok, buf = cv2.imencode("." + fmt, frame)
                    assert ok
                    encoded[f"{fname}.{fmt}"] = {"sha256": hashlib.sha256(buf.tobytes()).hexdigest(),
                                                 "bytes": int(buf.size), "shape": list(frame.shape),
                                                 "dtype": str(frame.dtype)}
    for name, record in (("decoded.json", {"stills": decoded}), ("encoded.json", {"frames": encoded})):
        with open(os.path.join(OUT, name), "w") as fh:
            json.dump({"versions": versions(cv2), **record}, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(f"wrote decoded.json ({len(decoded)} files) and encoded.json ({len(encoded)} frames)")


def main() -> None:
    import argparse

    import cv2

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--records", action="store_true", help="write only the two JSON records")
    if parser.parse_args().records:
        write_records(cv2)
        return
    os.makedirs(OUT, exist_ok=True)
    refused = {}
    for ext, files in (("tif", tiffs(cv2)), ("bmp", bmps(cv2))):
        for name, (data, feature) in files.items():
            with open(os.path.join(OUT, f"{name}.{ext}"), "wb") as fh:
                fh.write(data)
            if feature:
                refused[f"{name}.{ext}"] = {"refused": feature}
    with open(os.path.join(OUT, "decoded.json"), "w") as fh:
        json.dump({"stills": refused}, fh)
    write_records(cv2)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(os.listdir(OUT))} files under {OUT}: {total / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
