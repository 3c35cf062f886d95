"""Write the JPEG fixtures of the port's tests and ``chip_smoke.py`` phase 13
with cv2 and the JAX package's writer, from a seed; nothing is downloaded.

    JAX_PLATFORMS=cpu python scripts/make_torch_jpeg_fixtures.py

Writes, under ``tests/torch_data``:

- ``jpeg/*.jpg``: small stills as ``cv2.imencode(".jpg", ...)`` writes them
  (baseline, standard or optimised Huffman tables): gray; colour sampled
  4:4:4, 4:2:2 and 4:2:0; sizes 100 x 72 and 37 x 29 (no multiple of the
  MCU); quality 50 and 95; one with a restart interval
  (``IMWRITE_JPEG_RST_INTERVAL``), one with optimised tables
  (``IMWRITE_JPEG_OPTIMIZE``), two 3 and 2 px wide (chroma planes
  libjpeg-turbo replicates); and a 1024^2 gray and a 1024^2 colour (4:2:0)
  still at cv2's default quality 95;
- ``jpeg/*progressive*.jpg``: progressive stills, as cv2 writes them
  (``IMWRITE_JPEG_PROGRESSIVE``: libjpeg's ``jpeg_simple_progression``
  script, Huffman tables optimised per scan) in gray, 4:2:0, 4:2:2 and
  4:4:4, with a restart interval, at 37 x 29 and 3 x 50, and the two 1024^2
  frames; as PIL writes them (``progressive=True, optimize=True``); and one
  of cv2's cut after its third scan (an incomplete script, which
  libjpeg-turbo decodes with block smoothing), and more cut ones (after the
  DC scan alone, 4:4:0, CMYK, and a gray one whose frame header declares
  1x2 sampling);
- ``jpeg/{c440,c411}_*.jpg``: cv2's 4:4:0 and 4:1:1 samplings, baseline and
  progressive; ``adobe_rgb_37x29.jpg`` and ``ids_rgb_37x29.jpg`` (RGB as
  stored, by an Adobe transform of 0 or component ids 'R', 'G', 'B');
  ``pil_cmyk_*.jpg`` (PIL's CMYK) and ``ycck_37x29.jpg`` (its Adobe
  transform set to 2); two 1024^2 frames of two blob animals
  (``make_torch_still_fixtures.animal_scene``), 4:4:0 and a progressive one
  cut after three scans;
- ``jpeg_pkg.slp``: a training package of 16 gray 1024^2 frames, each with
  four Gaussian blob animals (sigma 8 px) on a smooth, lightly textured
  background (no noise: about 70 KB a frame), labeled with a two-node user
  instance per blob, written by
  ``sleap_tpu.io.slp.write_labels(save_frame_data=True,
  image_format="jpg")`` (cv2's JPEG at quality 95);
- ``jpeg/decoded.json``: for each still and each row of the package, the
  sha256 of ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)``'s bytes with its
  shape (or the feature the port must refuse), so the card, which has no
  cv2, can hold its decoders to cv2's output;
- ``jpeg/encoded.json``: the sha256 (and length) of ``cv2.imencode(".jpg",
  frame)`` at cv2's defaults for each still's decoded frame but the
  progressive ones, and for crops (W x H) of the 1024^2 stills' frames to
  1x1, 3x50, 17x33 and 1023x1021, so the card can hold its encoder (J3, J4
  and the host entropy coder) to cv2's bytes;
- ``jpeg/rendered.json``: the sha256 of the JAX package's ``render_frame``
  for each of ``jpeg_pkg.slp``'s 16 frames at scale 1, and at scale 0.5 on
  ``resize_image``'s half-size frame, as ``save_labeled_video`` draws them.

The records name the cv2, libjpeg-turbo, Pillow and numpy that wrote them.
``--records`` writes only ``encoded.json`` and ``rendered.json``, from the
committed stills and package, and leaves every other file as it is;
``--stills`` writes only the stills and their entries in ``decoded.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

OUT = os.path.join(REPO, "tests", "torch_data")
SEED, PKG_FRAMES, PKG_SIZE, SIGMA, AMPLITUDE = 0, 16, 1024, 8.0, 200.0
HALF_SPAN = 6.0


def still(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth shapes and a little noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = 110 + 70 * np.sin(xx / (w / 6.0)) * np.cos(yy / (h / 5.0))
    img = base[..., None] + rng.normal(0, 6, (h, w, channels))
    if channels == 3:
        img[..., 1] = 255 - img[..., 1]
        img[..., 2] = 40 + 180 * xx / max(w - 1, 1)
    return np.clip(img, 0, 255).astype(np.uint8)


def background(size: int, noise: float, rng) -> np.ndarray:
    """A smooth gradient with a faint texture, as a lit arena floor, plus
    Gaussian noise of ``noise`` grey levels."""
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    smooth = 30 + 25 * (xx + yy) / (2 * size) + 6 * np.sin(xx / 37.0) * np.sin(yy / 53.0)
    smooth += 2 * np.sin(xx / 2.7 + yy / 3.9)
    return smooth + rng.normal(0, noise, (size, size))


def package_frames():
    """(frames (n, S, S, 1) uint8, blob centres (n, 4, 2) xy): four blobs
    moving a few px a frame over one background."""
    rng = np.random.default_rng(SEED)
    bg = background(PKG_SIZE, 0.0, rng)
    starts = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]]) * PKG_SIZE
    steps = rng.uniform(-3, 3, (4, 2))
    centres = starts[None] + np.arange(PKG_FRAMES)[:, None, None] * steps[None]
    yy, xx = np.mgrid[:PKG_SIZE, :PKG_SIZE]
    frames = np.empty((PKG_FRAMES, PKG_SIZE, PKG_SIZE, 1), np.uint8)
    r = int(3 * SIGMA) + 1
    for i, points in enumerate(centres):
        img = bg.copy()
        for x, y in points:
            y0, x0 = int(y) - r, int(x) - r
            win = (slice(y0, y0 + 2 * r + 1), slice(x0, x0 + 2 * r + 1))
            img[win] += AMPLITUDE * np.exp(-((xx[win] - x) ** 2 + (yy[win] - y) ** 2)
                                           / (2 * SIGMA**2))
        frames[i, ..., 0] = np.clip(img, 0, 255)
    return frames, centres


def stills(cv2):
    """name -> (image, cv2.imencode parameters)."""
    s = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    sampling = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
    out = {}
    for (w, h), q in (((100, 72), 95), ((37, 29), 50)):
        out[f"gray_{w}x{h}_q{q}"] = (still(h, w, 1, w + q)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, q])
        for name, flag in sampling.items():
            out[f"c{name}_{w}x{h}_q{q}"] = (still(h, w, 3, w + q + int(name)),
                                           [cv2.IMWRITE_JPEG_QUALITY, q, s, flag])
    out["c420_100x72_q90_rst2"] = (still(72, 100, 3, 1), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                          cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["gray_100x72_q80_rst1"] = (still(72, 100, 1, 2)[..., 0],
                                   [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    out["c422_100x72_q75_optimized"] = (still(72, 100, 3, 3), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                                               cv2.IMWRITE_JPEG_OPTIMIZE, 1, s,
                                                               sampling["422"]])
    p = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    out["c420_100x72_progressive"] = (still(72, 100, 3, 4), p)
    out["gray_100x72_progressive"] = (still(72, 100, 1, 7)[..., 0], p)
    out["c422_100x72_progressive"] = (still(72, 100, 3, 8), p + [s, sampling["422"]])
    out["c444_100x72_progressive"] = (still(72, 100, 3, 9), p + [s, sampling["444"]])
    out["c420_100x72_progressive_rst3"] = (still(72, 100, 3, 10), p + [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    out["gray_37x29_progressive"] = (still(29, 37, 1, 11)[..., 0], p + [cv2.IMWRITE_JPEG_QUALITY, 50])
    out["c420_37x29_progressive"] = (still(29, 37, 3, 12), p)
    out["c420_3x50_progressive"] = (still(50, 3, 3, 13), p)
    # Chroma planes 1 and 2 samples wide: replicated, not fancy-upsampled.
    out["c420_3x50_q90"] = (still(50, 3, 3, 5), [cv2.IMWRITE_JPEG_QUALITY, 90, s, sampling["420"]])
    out["c422_2x9_q90"] = (still(9, 2, 3, 6), [cv2.IMWRITE_JPEG_QUALITY, 90, s, sampling["422"]])
    rng = np.random.default_rng(SEED + 1)
    big = background(PKG_SIZE, 1.0, rng)
    out["gray_1024"] = (np.clip(big + 60, 0, 255).astype(np.uint8), [])
    colour = np.stack([big + 20, 200 - big, big + 90], -1)
    out["c420_1024"] = (np.clip(colour, 0, 255).astype(np.uint8), [])
    out["gray_1024_progressive"] = (out["gray_1024"][0], p)
    out["c420_1024_progressive"] = (out["c420_1024"][0], p)
    # cv2's other two samplings: 4:4:0 (h1v2, fancy-upsampled) and 4:1:1
    # (h4v1, replicated).
    for name in ("440", "411"):
        flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + name)
        out[f"c{name}_37x29_q75"] = (still(29, 37, 3, 20 + int(name)), [cv2.IMWRITE_JPEG_QUALITY, 75, s, flag])
        out[f"c{name}_100x72_progressive"] = (still(72, 100, 3, 21 + int(name)), p + [s, flag])
    # Two 1024^2 frames of animals (two blobs the trained top-down pair
    # finds): 4:4:0, and a progressive one that still_files cuts short.
    from make_torch_still_fixtures import animal_scene

    out["animals_c440_1024"] = (animal_scene(PKG_SIZE, 60, 3), [s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    out["animals_c420_1024_progressive"] = (animal_scene(PKG_SIZE, 61, 3), p)
    return out


def pil_stills() -> dict:
    """name -> JPEG bytes as PIL writes them with ``progressive=True,
    optimize=True``: its scan script with spectral selection and successive
    approximation, and its own optimised tables."""
    import io

    from PIL import Image

    out = {}
    for name, (img, quality, sampling) in {
            "pil_gray_100x72_progressive": (still(72, 100, 1, 14)[..., 0], 90, 0),
            "pil_c420_100x72_progressive": (still(72, 100, 3, 15), 85, 2),
            "pil_c444_37x29_progressive": (still(29, 37, 3, 16), 75, 0)}.items():
        buf = io.BytesIO()
        Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(
            buf, "JPEG", progressive=True, optimize=True, quality=quality, subsampling=sampling)
        out[name] = buf.getvalue()
    return out


def pil_cmyk(img: np.ndarray, **kw) -> bytes:
    """A CMYK JPEG as PIL writes it (Adobe marker, transform 0: the
    inverted CMYK that libjpeg and cv2 read)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def with_adobe(data: bytes, transform: int) -> bytes:
    """``data`` without its JFIF marker, with an Adobe APP14 marker of
    ``transform`` (0: RGB or CMYK as stored, 2: YCCK)."""
    import struct

    (length,) = struct.unpack(">H", data[4:6])
    assert data[2:4] == b"\xff\xe0"
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body + data[4 + length:]


def with_ids(data: bytes, ids) -> bytes:
    """``data`` without its JFIF marker, with its components renamed
    ``ids`` in the frame and every scan header."""
    import struct

    (length,) = struct.unpack(">H", data[4:6])
    out = bytearray(data[:2] + data[4 + length:])
    sof = next(out.index(m) for m in (b"\xff\xc0", b"\xff\xc2") if m in out)
    old = [out[sof + 10 + 3 * i] for i in range(len(ids))]
    for i, ident in enumerate(ids):
        out[sof + 10 + 3 * i] = ident
    for at in [i for i in range(len(out) - 1) if out[i:i + 2] == b"\xff\xda"]:
        for k in range(out[at + 4]):
            out[at + 5 + 2 * k] = ids[old.index(out[at + 5 + 2 * k])]
    return bytes(out)


def with_sampling(data: bytes, hv: int) -> bytes:
    """A one-component ``data`` whose frame header declares sampling ``hv``
    (h << 4 | v): the entropy-coded data stays as it is (a lone
    component's scans walk its blocks one by one whatever it declares),
    but libjpeg's iMCU rows become ``v`` block rows."""
    out = bytearray(data)
    sof = next(out.index(m) for m in (b"\xff\xc0", b"\xff\xc2") if m in out)
    assert out[sof + 9] == 1, "one component"
    out[sof + 11] = hv
    return bytes(out)


def truncated(data: bytes, scans: int) -> bytes:
    """``data`` cut before its ``scans``-th scan header, with an EOI."""
    at = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"][scans]
    return data[:at] + b"\xff\xd9"


def still_files(cv2) -> dict:
    """name -> the bytes of every committed still."""
    out = {}
    for name, (img, params) in stills(cv2).items():
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        out[name] = buf.tobytes()
    out.update(pil_stills())
    # Progressive files cut short, which libjpeg-turbo decodes with block
    # smoothing: after the first three scans (DC, luma 1-5, Cr: Cb has no AC
    # data, so its DC is smoothed too), after the DC scan alone, and more.
    out["c420_100x72_progressive_truncated"] = truncated(out["c420_100x72_progressive"], 3)
    out["gray_37x29_progressive_dc_only"] = truncated(out["gray_37x29_progressive"], 1)
    out["c440_100x72_progressive_truncated"] = truncated(out["c440_100x72_progressive"], 2)
    out["animals_c420_1024_progressive_truncated"] = truncated(out.pop("animals_c420_1024_progressive"), 3)
    # A gray one cut after two scans whose frame header declares 1x2
    # sampling: iMCU rows of two block rows, 37 rows high (5 block rows) so
    # that smoothing's window names the zeroed row past the last.
    ok, gray = cv2.imencode(".jpg", still(37, 29, 1, 32)[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    out["gray_29x37_v2_progressive_truncated"] = with_sampling(truncated(gray.tobytes(), 2), 0x12)
    # Colour spaces other than YCbCr: RGB (Adobe transform 0, or ids 'R',
    # 'G', 'B'), CMYK as PIL writes it, YCCK (its Adobe transform set to 2).
    rgb = out["c444_37x29_q50"]
    out["adobe_rgb_37x29"] = with_adobe(rgb, 0)
    out["ids_rgb_37x29"] = with_ids(rgb, [82, 71, 66])
    cmyk = np.concatenate([still(29, 37, 3, 30), still(29, 37, 1, 31)], -1)
    out["pil_cmyk_37x29"] = pil_cmyk(cmyk, quality=80)
    out["pil_cmyk_37x29_progressive"] = pil_cmyk(cmyk, quality=80, progressive=True)
    out["pil_cmyk_37x29_progressive_truncated"] = truncated(out["pil_cmyk_37x29_progressive"], 2)
    ycck = bytearray(out["pil_cmyk_37x29"])
    ycck[ycck.index(b"Adobe") + 11] = 2
    out["ycck_37x29"] = bytes(ycck)
    return out


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


#: Crops (W, H) of the 1024^2 stills' frames that encoded.json records,
#: taken at (1, 1): a pixel, a column narrower than a chroma sample, sizes
#: past one MCU that no MCU divides, and the full frame less its edges.
CROPS = ((1, 1), (3, 50), (17, 33), (1023, 1021))
CROP_AT = 1


def encode_frames(cv2) -> dict:
    """name -> the frame encoded.json holds the encoding of: each committed
    still but the progressive ones as cv2 decodes it, and the crops."""
    jpeg_dir = os.path.join(OUT, "jpeg")
    out = {}
    for name in sorted(stills(cv2)):
        if "progressive" in name:
            continue
        img = cv2.imread(os.path.join(jpeg_dir, name + ".jpg"), cv2.IMREAD_UNCHANGED)
        out[name] = img
        if name.endswith("_1024"):
            for w, h in CROPS:
                out[f"{name}_crop_{w}x{h}"] = np.ascontiguousarray(
                    img[CROP_AT:CROP_AT + h, CROP_AT:CROP_AT + w])
    return out


def versions(cv2) -> dict:
    import PIL

    jpeg_line = [line for line in cv2.getBuildInformation().splitlines() if "JPEG:" in line]
    return {"cv2": cv2.__version__, "jpeg": jpeg_line[0].split(":", 1)[1].strip() if jpeg_line else "",
            "pillow": PIL.__version__, "numpy": np.__version__}


def write_records(cv2) -> None:
    """encoded.json and rendered.json, from the committed stills and package."""
    from sleap_tpu.core.labels import Labels
    from sleap_tpu.io import visuals

    record = {"versions": versions(cv2), "frames": {}}
    for name, img in encode_frames(cv2).items():
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        record["frames"][name] = {"sha256": hashlib.sha256(buf.tobytes()).hexdigest(),
                                  "bytes": int(buf.size), "shape": list(img.shape)}
    with open(os.path.join(OUT, "jpeg", "encoded.json"), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    labels = Labels.load_file(os.path.join(OUT, "jpeg_pkg.slp"))
    rendered = {"versions": versions(cv2), "scales": {}}
    for scale in (1.0, 0.5):
        out = []
        for i in range(len(labels.video.backend.embedded_frame_inds)):
            img = labels.video.get_frame(i)
            if scale != 1.0:
                img = visuals.resize_image(img, scale)
            drawn = visuals.render_frame(labels, img, i, scale=scale)
            out.append({"sha256": hashlib.sha256(drawn.tobytes()).hexdigest(), "shape": list(drawn.shape)})
        rendered["scales"][str(scale)] = out
    with open(os.path.join(OUT, "jpeg", "rendered.json"), "w") as fh:
        json.dump(rendered, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print("wrote encoded.json and rendered.json")


def main() -> None:
    import argparse

    import cv2

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--records", action="store_true",
                        help="write only encoded.json and rendered.json")
    parser.add_argument("--stills", action="store_true",
                        help="write only the stills and their records in decoded.json")
    args = parser.parse_args()
    if args.records:
        write_records(cv2)
        return

    from sleap_tpu.core.instance import Instance, LabeledFrame
    from sleap_tpu.core.labels import Labels
    from sleap_tpu.core.skeleton import Skeleton
    from sleap_tpu.io.slp import write_labels
    from sleap_tpu.io.video import Video

    jpeg_dir = os.path.join(OUT, "jpeg")
    os.makedirs(jpeg_dir, exist_ok=True)
    record = {"versions": versions(cv2), "stills": {}, "package": []}
    for name, data in still_files(cv2).items():
        path = os.path.join(jpeg_dir, name + ".jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        reads = [cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) for _ in range(3)]
        assert reads[0] is not None and all(np.array_equal(reads[0], r) for r in reads), name
        record["stills"][name] = digest(reads[0])
        print(f"wrote {path}: {len(data)} bytes")
    if args.stills:
        with open(os.path.join(jpeg_dir, "decoded.json")) as fh:
            record["package"] = json.load(fh)["package"]
        with open(os.path.join(jpeg_dir, "decoded.json"), "w") as fh:
            json.dump(record, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return

    frames, centres = package_frames()
    skeleton = Skeleton("Skeleton-0")
    skeleton.add_node("A")
    skeleton.add_node("B")
    skeleton.add_edge("A", "B")
    video = Video.from_numpy(frames)
    lfs = [LabeledFrame(video=video, frame_idx=i, instances=[
        Instance(skeleton=skeleton, points=np.array([[x - HALF_SPAN, y], [x + HALF_SPAN, y]]))
        for x, y in points]) for i, points in enumerate(centres)]
    path = os.path.join(OUT, "jpeg_pkg.slp")
    write_labels(path, Labels(labeled_frames=lfs), save_frame_data=True, image_format="jpg")
    import h5py

    with h5py.File(path, "r") as f:
        for row in f["video0/video"][:]:
            img = cv2.imdecode(np.frombuffer(row.tobytes(), np.uint8), cv2.IMREAD_UNCHANGED)
            record["package"].append(digest(img))
    print(f"wrote {path}: {os.path.getsize(path)} bytes")
    with open(os.path.join(jpeg_dir, "decoded.json"), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    write_records(cv2)


if __name__ == "__main__":
    main()
