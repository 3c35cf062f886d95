"""A loopbio ImgStore directory store of PNG, JPEG, BMP or TIFF frames,
without ``cv2`` or ``yaml``: a copy of :mod:`sleap_tpu.io.dirimgstore` on
the port's codecs (:mod:`sleap_tpu_torch.io.stills`: JPEG, BMP and TIFF
files are the bytes ``cv2.imwrite`` writes, JPEG and TIFF encoded on the
store's ``device``) and a reader and writer of the YAML subset
``metadata.yaml`` holds. A store of another class (loopbio's
``VideoImgStore``, frames in video-file chunks) opens through loopbio's
``imgstore`` package, as the JAX package opens every store where that
package is installed; without it, opening one raises ``ImportError``
naming it.

- ``new_for_filename(path)`` -> a store open for reading;
- ``new_for_format(fmt, mode="w", basedir=..., imgshape=..., imgdtype=...,
  chunksize=...)`` -> a store open for writing;
- store methods: ``add_image``, ``get_image``, ``get_next_image``,
  ``frame_count``, ``frame_min``, ``frame_max``, ``close``.

On disk, as loopbio's ``DirectoryImgStore``::

    basedir/
      metadata.yaml          # {"__store": {class, format, chunksize, imgshape,
                             #              imgdtype, version}}
      000000/                # chunk 0
        000000.png ...       # images, named by their index in the chunk
        index.npz            # {"frame_number": [...], "frame_time": [...]}
      000001/ ...

``metadata.yaml`` is read and written through the port's YAML subset
(:mod:`sleap_tpu_torch.io.yamlsubset`), as PyYAML's ``safe_load`` reads it
and ``safe_dump`` writes it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.io import stills
from sleap_tpu_torch.io.yamlsubset import yaml_dump, yaml_load

STORE_MD_FILENAME = "metadata.yaml"
_CHUNK_INDEX = "index.npz"


# --------------------------------------------------------------------------- #
# The store
# --------------------------------------------------------------------------- #


def _chunk_dir(basedir: str, chunk_n: int) -> str:
    return os.path.join(basedir, "%06d" % chunk_n)


def _image_path(basedir: str, chunk_n: int, within_idx: int, ext: str) -> str:
    return os.path.join(_chunk_dir(basedir, chunk_n), "%06d.%s" % (within_idx, ext))


class DirectoryImgStore:
    """Directory-of-images frame store (PNG, JPEG, BMP or TIFF) with
    loopbio's layout. Frames are decoded, and JPEG and TIFF frames encoded,
    on ``device``'s route."""

    def __init__(
        self,
        basedir: str,
        mode: str,
        imgshape: Optional[Tuple[int, ...]] = None,
        imgdtype: str = "uint8",
        chunksize: int = 200,
        fmt: str = "png",
        device="cuda",
    ):
        self.basedir = basedir
        self.mode = mode
        self.format = fmt
        self.chunksize = int(chunksize)
        self.imgshape = tuple(imgshape) if imgshape is not None else None
        self.imgdtype = np.dtype(imgdtype).name
        self.device = device
        self._closed = False
        # frame_number -> (chunk_n, within_idx); insertion order == store order
        self._index: Dict[int, Tuple[int, int]] = {}
        self._frame_times: Dict[int, float] = {}
        self._cursor = 0  # store-order position for get_next_image

        if mode == "w":
            stills.check_format(fmt)
            os.makedirs(basedir, exist_ok=True)
            self._pending_numbers: List[int] = []
            self._pending_times: List[float] = []
            self._n_written = 0
        elif mode == "r":
            self._load()
        else:
            raise ValueError(f"Unsupported mode: {mode!r}")

    # ------------------------------------------------------------------ write

    def add_image(self, img: np.ndarray, frame_number: int, frame_time: float):
        if self.mode != "w":
            raise IOError("Store is not open for writing.")
        img = np.asarray(img)
        if self.imgshape is None:
            self.imgshape = img.shape
        chunk_n, within = divmod(self._n_written, self.chunksize)
        os.makedirs(_chunk_dir(self.basedir, chunk_n), exist_ok=True)
        out = img[..., 0] if (img.ndim == 3 and img.shape[-1] == 1) else img
        data = stills.imencode(out, self.format, self.device)
        with open(_image_path(self.basedir, chunk_n, within, self.format), "wb") as fh:
            fh.write(data)
        self._pending_numbers.append(int(frame_number))
        self._pending_times.append(float(frame_time))
        self._index[int(frame_number)] = (chunk_n, within)
        self._frame_times[int(frame_number)] = float(frame_time)
        self._n_written += 1
        if within == self.chunksize - 1:
            self._flush_chunk_index(chunk_n)

    def _flush_chunk_index(self, chunk_n: int):
        start = chunk_n * self.chunksize
        numbers = self._pending_numbers[start : start + self.chunksize]
        times = self._pending_times[start : start + self.chunksize]
        if numbers:
            np.savez(
                os.path.join(_chunk_dir(self.basedir, chunk_n), _CHUNK_INDEX),
                frame_number=np.asarray(numbers, dtype=np.int64),
                frame_time=np.asarray(times, dtype=np.float64),
            )

    def _write_metadata(self):
        md = {
            "__store": {
                "class": "DirectoryImgStore",
                "version": 1,
                "format": self.format,
                "chunksize": self.chunksize,
                "imgshape": [int(n) for n in self.imgshape or ()],
                "imgdtype": self.imgdtype,
            }
        }
        with open(os.path.join(self.basedir, STORE_MD_FILENAME), "w") as f:
            f.write(yaml_dump(md))

    # ------------------------------------------------------------------- read

    def _load(self):
        with open(os.path.join(self.basedir, STORE_MD_FILENAME)) as f:
            md = yaml_load(f.read())
        if not isinstance(md, dict) or not isinstance(md.get("__store"), dict):
            raise ValueError(f"{self.basedir}: {STORE_MD_FILENAME} has no __store mapping.")
        md = md["__store"]
        self.format = md["format"]
        self.chunksize = int(md["chunksize"])
        self.imgshape = tuple(md.get("imgshape") or ())
        self.imgdtype = md.get("imgdtype", "uint8")
        chunk_n = 0
        while True:
            index_path = os.path.join(_chunk_dir(self.basedir, chunk_n), _CHUNK_INDEX)
            if not os.path.exists(index_path):
                break
            with np.load(index_path) as idx:
                for within, (fn, ft) in enumerate(
                    zip(idx["frame_number"], idx["frame_time"])
                ):
                    self._index[int(fn)] = (chunk_n, within)
                    self._frame_times[int(fn)] = float(ft)
            chunk_n += 1
        if not self._index:
            raise IOError(f"Empty or unreadable image store: {self.basedir}")

    def _read(self, frame_number: int) -> Tuple[np.ndarray, Tuple[int, float]]:
        chunk_n, within = self._index[frame_number]
        path = _image_path(self.basedir, chunk_n, within, self.format)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise IOError(f"Unable to read stored frame: {path}") from e
        img = stills.imdecode(data, self.device, path)
        if self.imgshape and len(self.imgshape) == 3 and img.ndim == 2:
            img = img[..., None]
        return img, (frame_number, self._frame_times[frame_number])

    def get_image(
        self, frame_number: Optional[int] = None, frame_index: Optional[int] = None
    ) -> Tuple[np.ndarray, Tuple[int, float]]:
        """Fetch by original frame number, or by position in the store."""
        if frame_number is None:
            if frame_index is None:
                raise ValueError("Provide frame_number or frame_index.")
            numbers = list(self._index)
            if not -len(numbers) <= frame_index < len(numbers):
                raise ValueError(
                    f"Frame index {frame_index} out of range "
                    f"(store holds {len(numbers)} frames)."
                )
            frame_number = numbers[frame_index]
        elif frame_number not in self._index:
            raise ValueError(f"Frame number {frame_number} not in store.")
        img, meta = self._read(int(frame_number))
        self._cursor = list(self._index).index(int(frame_number)) + 1
        return img, meta

    def get_next_image(self) -> Tuple[np.ndarray, Tuple[int, float]]:
        numbers = list(self._index)
        if self._cursor >= len(numbers):
            self._cursor = 0
        img, meta = self._read(numbers[self._cursor])
        self._cursor += 1
        return img, meta

    # ------------------------------------------------------------------ props

    @property
    def frame_count(self) -> int:
        return len(self._index) if self.mode == "r" else self._n_written

    @property
    def frame_min(self) -> int:
        return min(self._index) if self._index else 0

    @property
    def frame_max(self) -> int:
        return max(self._index) if self._index else 0

    def close(self):
        if self._closed:
            return
        if self.mode == "w":
            last_chunk = max((self._n_written - 1) // self.chunksize, 0)
            self._flush_chunk_index(last_chunk)
            self._write_metadata()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def store_class(basedir: str) -> str:
    """The ``class`` ``metadata.yaml`` gives the store at ``basedir``."""
    with open(os.path.join(basedir, STORE_MD_FILENAME)) as f:
        md = yaml_load(f.read())
    if not isinstance(md, dict) or not isinstance(md.get("__store"), dict):
        raise ValueError(f"{basedir}: {STORE_MD_FILENAME} has no __store mapping.")
    return str(md["__store"].get("class", "DirectoryImgStore"))


def new_for_filename(path: str, device="cuda"):
    """Open an existing store from its directory or metadata.yaml path: a
    directory store whose frames decode on ``device``'s route, or a store
    of another class (frames in video-file chunks) through loopbio's
    ``imgstore.new_for_filename``, imported here (``device`` does not
    apply: that package decodes on the host)."""
    basedir = path[: -len(STORE_MD_FILENAME)].rstrip("/\\") if path.endswith(
        STORE_MD_FILENAME
    ) else path
    kind = store_class(basedir)
    if kind != "DirectoryImgStore":
        try:
            import imgstore
        except ImportError as e:
            raise ImportError(f"{basedir} is a {kind} (frames in video-file chunks), which loopbio's "
                              "imgstore package reads; it is not installed. Directory stores of "
                              "PNG, JPEG, BMP or TIFF frames are read without it.") from e
        return imgstore.new_for_filename(os.path.join(basedir, STORE_MD_FILENAME))
    return DirectoryImgStore(basedir=basedir, mode="r", device=device)


def new_for_format(
    fmt: str,
    mode: str = "w",
    basedir: str = "",
    imgshape: Optional[Tuple[int, ...]] = None,
    imgdtype: str = "uint8",
    chunksize: int = 200,
    device="cuda",
    **_unused,
) -> DirectoryImgStore:
    """Create a new write-mode store. Only image (per-frame file) formats are
    supported; video formats like ``mjpeg/avi`` fall back to ``png``. JPEG
    and TIFF frames are encoded on ``device``."""
    if "/" in fmt:  # video container formats are not supported by the fallback
        fmt = "png"
    return DirectoryImgStore(
        basedir=basedir,
        mode=mode,
        imgshape=imgshape,
        imgdtype=imgdtype,
        chunksize=chunksize,
        fmt=fmt,
        device=device,
    )
