"""Still images in and out of users' files on the port's own codecs: what
``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` and ``cv2.imencode("." + fmt,
img)`` do for the JAX package's image folders, ``.pkg.slp`` and HDF5 frame
rows and ImgStores, for PNG (:mod:`~sleap_tpu_torch.io.png`), JPEG
(:mod:`~sleap_tpu_torch.io.jpeg`: J6, J1 and J2 decode and J3 and J4 encode
on the card), BMP (:mod:`~sleap_tpu_torch.io.bmp`) and TIFF
(:mod:`~sleap_tpu_torch.io.tiff`); :func:`imread` is ``cv2.imread``'s
view of a file's bytes, which image folders read through.

A still is decoded by what its bytes are, as cv2 decodes it, whatever its
file's extension or row's ``format`` says; it is encoded in the format
named (``png``, ``jpg``/``jpeg``, ``bmp``, ``tif``/``tiff``). Each codec
runs on ``device``'s route; another format raises naming itself.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from sleap_tpu_torch.io import bmp, jpeg, png, tiff

Device = Union[str, torch.device]
FORMATS = ("png", "jpg", "jpeg", "bmp", "tif", "tiff")


def kind_of(data: bytes) -> str:
    """``png``, ``jpg``, ``bmp`` or ``tif`` by the leading bytes, else
    ``""``."""
    head = bytes(data[:4])
    if head == png.SIGNATURE[:4]:
        return "png"
    if head[:2] == b"\xff\xd8":
        return "jpg"
    if head[:2] == b"BM":
        return "bmp"
    if head in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "tif"
    return ""


def imdecode(data: bytes, device: Device = "cuda", what: str = "the image") -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` on ``device``'s route:
    (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, in the file's dtype."""
    kind = kind_of(data)
    if kind == "png":
        return png.imdecode(data, device)
    if kind == "jpg":
        return jpeg.imdecode(data, device)
    if kind == "bmp":
        return bmp.imdecode(data, device)
    if kind == "tif":
        return tiff.imdecode(data, device)
    raise ValueError(f"{what} is not a PNG, JPEG, BMP or TIFF image (it starts with "
                     f"{bytes(data[:8])!r}): the port reads those.")


def imread(data: bytes, device: Device = "cuda", what: str = "the image") -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` of a file's bytes: as
    :func:`imdecode`, but None for a TIFF whose orientation (5 to 8)
    transposes a frame that is not square, which ``imread`` refuses where
    ``imdecode`` reads it (OpenCV's ``imread_`` allocates the header's H x W
    and fails when the decoder hands back W x H)."""
    if kind_of(data) == "tif" and tiff.transposed(data):
        return None
    return imdecode(data, device, what)


def check_format(fmt: str) -> str:
    """``fmt`` lower-cased without a leading dot; raise where the port does
    not write it."""
    fmt = fmt.lower().lstrip(".")
    if fmt not in FORMATS:
        raise NotImplementedError(f"Writing {fmt!r} images is not ported: the port writes "
                                  f"{', '.join(FORMATS)}.")
    return fmt


def imencode(img: np.ndarray, fmt: str, device: Device = "cuda") -> bytes:
    """``cv2.imencode("." + fmt, img)[1].tobytes()`` for the formats the
    port writes: JPEG (J3 and J4 on the card) and TIFF (LZW in host C on the
    card) on ``device``'s route, PNG and BMP on the host; JPEG, BMP and
    TIFF byte for byte as cv2 writes them."""
    fmt = check_format(fmt)
    if fmt == "png":
        return png.imencode(".png", img)[1].tobytes()
    if fmt in ("jpg", "jpeg"):
        return jpeg.imencode(img, device)
    if fmt == "bmp":
        return bmp.imencode(img, device)
    return tiff.imencode(img, device)
