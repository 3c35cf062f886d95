"""Videos: uniform frame access over several storage backends.

A copy of :mod:`sleap_tpu.io.video` without ``attr`` and ``h5py``: frames
come back as numpy (H, W, C) arrays from

- :class:`HDF5Video`: raw frames in an HDF5 dataset (``channels_last`` or
  ``channels_first``), or encoded frames embedded in a ``.pkg.slp`` with
  their ``frame_numbers`` and ``source_video``, read by the port's own HDF5
  reader (:mod:`sleap_tpu_torch.io.hdf5`) and its PNG, JPEG, BMP and TIFF
  decoders (:mod:`~sleap_tpu_torch.io.stills`) on the backend's
  ``device``: on the card (the default) the compiled PNG unfilter, the JPEG
  kernels and the compiled TIFF codecs, on the CPU their plain versions;
- :class:`NumpyVideo`: an in-memory array or a ``.npy`` file;
- :class:`MediaVideo` (mp4, mov, mkv, avi, ...): on the card
  (``device="cuda"``, the default) the container picked by content and
  demuxed by the port (:mod:`~sleap_tpu_torch.io.avi`,
  :mod:`~sleap_tpu_torch.io.mp4` with edit lists applied,
  :mod:`~sleap_tpu_torch.io.mkv`); Motion-JPEG in any of them through
  FFmpeg's decoding (:mod:`~sleap_tpu_torch.io.mjpeg`, kernel J5), AVI's
  uncompressed frames on the host, and H.264 in ISO-BMFF or Matroska through
  NVDEC (:mod:`~sleap_tpu_torch.io.nvdec`), each with OpenCV's colour
  conversion (:mod:`~sleap_tpu_torch.io.yuv`) and no fallback; with
  ``device="cpu"`` any format through ``cv2``;
- :class:`SingleImageVideo`: still images, PNG, JPEG, BMP and TIFF through
  the port's decoders on its ``device``;
- :class:`ImgStoreVideo`: a loopbio ImgStore: a directory store of PNG,
  JPEG, BMP or TIFF frames (:mod:`sleap_tpu_torch.io.dirimgstore`), or a
  store of video-file chunks through loopbio's ``imgstore`` package;
- :class:`DummyVideo`, a placeholder of a given shape.

:class:`Video` wraps a backend and (de)serializes it as the ``videos_json``
entries of ``.slp`` files. Videos compare as the JAX package's do: by
backend type, filename and dataset (an in-memory video only to itself), and
hash by identity.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.io import dirimgstore, hdf5, stills

Device = Union[str, torch.device]


def _import_cv2(what: str, hint: str = "On the card (device='cuda') Motion-JPEG in AVI, "
                "QuickTime/MP4 and Matroska files, raw AVI frames, and H.264 (through NVDEC) are "
                "read without cv2; other media can be converted to an HDF5 dataset or embedded in "
                "a .slp."):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (OpenCV), which is not installed. {hint}") from e
    return cv2


@dataclass(eq=False)
class DummyVideo:
    """A placeholder video of blank frames."""

    filename: str = ""
    height: int = 2000
    width: int = 2000
    frames: int = 10000
    channels: int = 1
    dummy: bool = True

    @property
    def test_frame(self) -> np.ndarray:
        return self.get_frame(0)

    def get_frame(self, idx: int) -> np.ndarray:
        return np.zeros((self.height, self.width, self.channels), dtype="uint8")


@dataclass(eq=False)
class MediaVideo:
    """A media file (mp4, avi, ...), read under a lock; sequential reads do
    not seek.

    ``device`` "cuda" (the default) picks the route by the file's content,
    whatever its extension (:func:`_card_reader`): an AVI, ISO-BMFF
    (QuickTime, MP4) or Matroska file of Motion-JPEG or MPEG-4 Part 2
    (``mp4v``, ``FMP4``, ``XVID``, ``DIVX``: I- and P-VOPs,
    :mod:`~sleap_tpu_torch.io.mpeg4`), or an AVI of uncompressed frames, is
    demuxed and decoded as OpenCV's FFmpeg backend decodes it, on the card,
    with the frame count, fps and frame numbering cv2 gives (edit lists
    applied); H.264 in ISO-BMFF or Matroska goes through NVDEC and is
    converted there as OpenCV would. Any other codec or container, an
    MPEG-4 tool the card does not decode, or a card without NVDEC for H.264,
    raises (no fallback). ``device`` "cpu" reads through OpenCV. The device is not a field: ``.slp`` files do
    not record it. ``grayscale`` None detects it from the first frame (all
    channels equal); ``bgr`` flips OpenCV's BGR to RGB.
    """

    filename: str = None
    grayscale: Optional[bool] = None
    bgr: bool = True
    dataset: str = ""
    input_format: str = ""
    device: dataclasses.InitVar[Device] = "cuda"

    EXTS = ("mp4", "avi", "mov", "mj2", "mkv")

    def __post_init__(self, device: Device = "cuda"):
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._reader_ = None
        self._test_frame_ = None

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def _reader(self):
        """cv2's ``VideoCapture`` on the CPU; on the card an
        :class:`~sleap_tpu_torch.io.nvdec.NvdecReader`."""
        if self._reader_ is None:
            if not os.path.isfile(self.filename):
                raise FileNotFoundError(f"Could not find video file named {self.filename}.")
            if self._on_card:
                self._reader_ = _card_reader(self.filename, self.device)
            else:
                cv2 = _import_cv2(f"Reading the media video {self.filename}")
                self._reader_ = cv2.VideoCapture(self.filename)
        return self._reader_

    @property
    def test_frame(self) -> np.ndarray:
        if self._test_frame_ is None:
            self._test_frame_ = self.get_frame(0, grayscale=False)
        return self._test_frame_

    @property
    def fps(self) -> float:
        if self._on_card:
            return self._reader.demux.fps
        cv2 = _import_cv2(f"Reading the media video {self.filename}")
        return self._reader.get(cv2.CAP_PROP_FPS)

    @property
    def frames(self) -> int:
        if self._on_card:
            return self._reader.demux.frames
        cv2 = _import_cv2(f"Reading the media video {self.filename}")
        return int(self._reader.get(cv2.CAP_PROP_FRAME_COUNT))

    @property
    def is_grayscale(self) -> bool:
        if self.grayscale is None:
            frame = self.test_frame
            self.grayscale = bool(np.all(frame[..., 0] == frame[..., -1]))
        return self.grayscale

    @property
    def channels(self) -> int:
        return 1 if self.is_grayscale else self.test_frame.shape[2]

    @property
    def height(self) -> int:
        return self.test_frame.shape[0]

    @property
    def width(self) -> int:
        return self.test_frame.shape[1]

    @property
    def dtype(self):
        return self.test_frame.dtype

    def reset(
        self,
        filename: Optional[str] = None,
        grayscale: Optional[bool] = None,
        bgr: Optional[bool] = None,
    ) -> None:
        """Drop the open reader and cached test frame, and optionally
        repoint or reconfigure the backend. ``grayscale`` omitted means
        detect it again from the file, whether or not a filename is passed
        (the reference's behaviour; the JAX package re-detects only with a
        new filename)."""
        if self._reader_ is not None and self._on_card:
            self._reader_.close()
        elif self._reader_ is not None:
            self._reader_.release()
        self._reader_ = None
        self._test_frame_ = None
        if filename is not None:
            self.filename = filename
        self.grayscale = grayscale
        if bgr is not None:
            self.bgr = bgr

    def get_frame(self, idx: int, grayscale: Optional[bool] = None) -> np.ndarray:
        if self._on_card:
            return self._card_frame(idx, grayscale)
        cv2 = _import_cv2(f"Reading the media video {self.filename}")
        with self._lock:
            reader = self._reader
            if reader.get(cv2.CAP_PROP_POS_FRAMES) != idx:
                reader.set(cv2.CAP_PROP_POS_FRAMES, idx)
            success, frame = reader.read()
        if not success or frame is None:
            raise KeyError(f"Unable to load frame {idx} from {self.filename}.")
        if grayscale is None:
            grayscale = self.is_grayscale
        if grayscale:
            frame = frame[..., 0][..., None]
        elif self.bgr:
            frame = frame[..., ::-1]
        return frame

    def _card_frame(self, idx: int, grayscale: Optional[bool]) -> np.ndarray:
        """The card's frame as OpenCV gives it: the blue channel alone for
        gray (what the CPU route keeps), else RGB, or BGR with ``bgr``
        False. An AVI reader decodes to those channels; NVDEC's NV12 frame
        is converted on the card."""
        from sleap_tpu_torch.io import avi, mjpeg, mpeg4, yuv

        if grayscale is None:
            grayscale = self.is_grayscale
        channels = "b" if grayscale else ("rgb" if self.bgr else "bgr")
        with self._lock:
            reader = self._reader
            if isinstance(reader, (avi.AviReader, mjpeg.MotionJpegReader, mpeg4.Mpeg4Reader)):
                return reader.frame(idx, channels).cpu().numpy()
            nv12 = reader.frame(idx)
        return yuv.nv12_to_frame(nv12, reader.height, channels).cpu().numpy()


def container_of(head: bytes) -> Optional[str]:
    """The container a file's leading bytes name, as FFmpeg's probes find
    it: "avi" (``RIFF ... AVI ``), "matroska" (the EBML magic) or "isobmff"
    (a top-level box: ``ftyp``, ``moov``, ``mdat``, ``free``, ``skip``,
    ``wide``, ...); else None."""
    from sleap_tpu_torch.io import mkv, mp4

    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[:4] == mkv.EBML_MAGIC:
        return "matroska"
    if head[4:8] in mp4.TOP_LEVEL:
        return "isobmff"
    return None


def _card_reader(filename: str, device: torch.device):
    """The card's reader of a media file, by its content, whatever its
    extension: the container by its leading bytes (:func:`container_of`),
    then the codec: an AVI's :class:`~sleap_tpu_torch.io.avi.AviReader`,
    Motion-JPEG's :class:`~sleap_tpu_torch.io.mjpeg.MotionJpegReader`,
    MPEG-4 Part 2's :class:`~sleap_tpu_torch.io.mpeg4.Mpeg4Reader`, or
    H.264's NVDEC reader."""
    from sleap_tpu_torch.io import avi, mjpeg, mkv, mp4, mpeg4, nvdec

    with open(filename, "rb") as f:
        head = f.read(12)
    kind = container_of(head)
    if kind == "avi":
        return avi.AviReader(avi.AviVideo.open(filename), device)
    if kind is None:
        ext = os.path.splitext(filename)[1]
        raise mp4._unsupported(f"{filename}: the {ext} container whose leading bytes {head[:8]!r} "
                               f"name no AVI, Matroska or ISO-BMFF file")
    demux = (mkv.MkvVideo if kind == "matroska" else mp4.Mp4Video).open(filename)
    if demux.kind == "mjpeg":
        return mjpeg.MotionJpegReader(demux, demux.height, device)
    if demux.kind == "mpeg4":
        return mpeg4.Mpeg4Reader(demux, device, config=demux.config,
                                 fourcc=getattr(demux, "fourcc", ""))
    return nvdec.NvdecReader(demux, device)


@dataclass(eq=False)
class HDF5Video:
    """Frames in an HDF5 dataset: raw (frames, H, W, C) or (frames, C, H,
    W), or encoded PNG, JPEG, BMP or TIFF rows of a ``.pkg.slp`` (a ``format`` attribute,
    with a ``frame_numbers`` sibling mapping original frame numbers to
    rows, and the original video's JSON under ``source_video``).

    With ``convert_range``, frames whose maximum is at most 1 are scaled to
    uint8. With ``enable_source_video``, a frame missing from the file is
    read from the recorded source video.
    """

    filename: str = None
    dataset: str = None
    input_format: str = "channels_last"
    convert_range: bool = True
    enable_source_video: bool = True
    device: dataclasses.InitVar[Device] = "cuda"  # where a source video is read; LZF's route

    EXTS = ("h5", "hdf5", "slp")

    def __post_init__(self, device: Device = "cuda"):
        self.device = device
        self._file_ = None
        self._dataset_ = None
        self._format_ = ""
        self._frame_map: Optional[Dict[int, int]] = None
        self._source_video_dict = None

    def _open(self) -> hdf5.Dataset:
        if self._file_ is None:
            self._file_ = hdf5.File(self.filename, device=self.device)
            name = self.dataset
            if name is None or name not in self._file_:
                raise KeyError(f"Dataset {self.dataset!r} not found in {self.filename}.")
            obj = self._file_[name]
            if isinstance(obj, hdf5.Group) and "video" in obj:
                obj = obj["video"]  # embedded frames live under <dataset>/video
            self._dataset_ = obj
            fmt = obj.attrs.get("format", "")
            self._format_ = fmt.decode() if isinstance(fmt, bytes) else str(fmt)
            parent = obj.parent
            if "frame_numbers" in parent:
                self._frame_map = {int(n): i for i, n in enumerate(parent["frame_numbers"][:])}
            if "source_video" in parent and "json" in parent["source_video"].attrs:
                raw = parent["source_video"].attrs["json"]
                self._source_video_dict = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        return self._dataset_

    @property
    def embedded_frame_inds(self) -> List[int]:
        """Original frame numbers in the file's row order."""
        self._open()
        if self._frame_map is None:
            return list(range(self.frames))
        return list(self._frame_map.keys())

    @property
    def has_embedded_images(self) -> bool:
        """True when the file caches per-frame images: a frame-number
        mapping exists, or the rows are encoded."""
        self._open()
        if self._frame_map is not None:
            return len(self._frame_map) > 0
        return bool(self._format_)

    @property
    def source_video_available(self) -> bool:
        """True when a frame missing from the file is read from the
        recorded source video."""
        self._open()
        return self.enable_source_video and self._source_video_dict is not None

    @property
    def source_video(self) -> Optional["Video"]:
        self._open()
        if self._source_video_dict is None:
            return None
        return Video.from_dict(self._source_video_dict, device=self.device)

    @property
    def test_frame(self) -> np.ndarray:
        if not self.embedded_frame_inds:
            raise ValueError(f"{self.filename}: no frames are embedded in this package.")
        return self.get_frame(self.embedded_frame_inds[0])

    @property
    def frames(self) -> int:
        return self._open().shape[0]

    def _dim(self, channels_last: int, channels_first: int, of_frame: int) -> int:
        if self.has_embedded_images:
            return self.test_frame.shape[of_frame]
        shape = self._open().shape
        return shape[channels_first] if self.input_format == "channels_first" else shape[channels_last]

    @property
    def channels(self) -> int:
        return self._dim(3, 1, 2)

    @property
    def height(self) -> int:
        return self._dim(1, 2, 0)

    @property
    def width(self) -> int:
        return self._dim(2, 3, 1)

    @property
    def dtype(self):
        return self.test_frame.dtype

    @property
    def last_frame_idx(self) -> int:
        """The highest original frame number where a frame-number mapping
        exists, else the last row."""
        self._open()
        if self._frame_map:
            return max(self._frame_map.keys())
        return self.frames - 1

    def reset(self) -> None:
        """Release the open file; the next read opens it again."""
        if self._file_ is not None:
            self._file_.close()
        self.__post_init__(self.device)

    def close(self) -> None:
        """Release the open file."""
        self.reset()

    def get_frame(self, idx: int) -> np.ndarray:
        ds = self._open()
        row, missing = idx, False
        if self._frame_map is not None:
            missing = idx not in self._frame_map
            row = self._frame_map.get(idx, idx)
        elif not 0 <= idx < ds.shape[0]:
            missing = True
        if missing:
            if self.enable_source_video and self._source_video_dict is not None:
                return self.source_video.get_frame(idx)
            raise IndexError(f"Frame {idx} not embedded in {self.filename}.")
        frame = ds[row]
        if self._format_:
            frame = stills.imdecode(np.asarray(frame).tobytes(), self.device,
                                    f"frames of {self.filename}")
            # No channel flip: frames are encoded straight from RGB arrays,
            # so cv2's BGR order on decode gives back the original order.
            if frame.ndim == 2:
                frame = frame[..., None]
        elif self.input_format == "channels_first":
            frame = np.transpose(frame, (1, 2, 0))
        if self.convert_range and np.max(frame) <= 1.0:
            frame = (frame * 255).astype(np.uint8)
        return frame


@dataclass(eq=False)
class NumpyVideo:
    """Frames (frames, H, W, C) from an in-memory array or a ``.npy`` file;
    (frames, H, W) gains a channel axis."""

    filename: Union[str, np.ndarray] = None

    EXTS = ("npy", "npz")

    def __post_init__(self):
        self._data_ = None

    @property
    def data(self) -> np.ndarray:
        if self._data_ is None:
            if isinstance(self.filename, np.ndarray):
                arr = self.filename
                self.filename = "numpy_video"
            else:
                arr = np.load(self.filename, mmap_mode="r")
            self._data_ = arr[..., None] if arr.ndim == 3 else arr
        return self._data_

    @property
    def frames(self) -> int:
        return self.data.shape[0]

    @property
    def height(self) -> int:
        return self.data.shape[1]

    @property
    def width(self) -> int:
        return self.data.shape[2]

    @property
    def channels(self) -> int:
        return self.data.shape[3]

    @property
    def test_frame(self) -> np.ndarray:
        return self.get_frame(0)

    @property
    def dtype(self):
        return self.data.dtype

    def reset(self) -> None:
        pass

    def get_frame(self, idx: int) -> np.ndarray:
        return np.asarray(self.data[idx])


@dataclass(eq=False)
class SingleImageVideo:
    """Still images (one per frame) read as RGB: PNG, JPEG, BMP and TIFF
    through the port's decoders on ``device`` (the card's routes by default,
    their plain versions with "cpu"), in the file's dtype (a 16-bit TIFF
    stays uint16). The device is not a field: ``.slp`` files do not record
    it."""

    filename: Optional[str] = None
    filenames: List[str] = field(default_factory=list)
    height_: Optional[int] = None
    width_: Optional[int] = None
    channels_: Optional[int] = None
    grayscale: Optional[bool] = None
    device: dataclasses.InitVar[Device] = "cuda"

    EXTS = ("jpg", "jpeg", "png", "bmp", "tif", "tiff")

    def __post_init__(self, device: Device = "cuda"):
        self.device = device
        self._cache: Dict[int, np.ndarray] = {}
        if not self.filenames and self.filename:
            self.filenames = [self.filename]
        if self.filename is None and self.filenames:
            self.filename = self.filenames[0]

    @property
    def test_frame(self) -> np.ndarray:
        return self.get_frame(0)

    @property
    def frames(self) -> int:
        return len(self.filenames)

    @property
    def height(self) -> int:
        return self.height_ or self.test_frame.shape[0]

    @property
    def width(self) -> int:
        return self.width_ or self.test_frame.shape[1]

    @property
    def channels(self) -> int:
        return self.channels_ or self.test_frame.shape[2]

    @property
    def dtype(self):
        return self.test_frame.dtype

    @property
    def is_grayscale(self) -> bool:
        if self.grayscale is None:
            frame = self.test_frame
            self.grayscale = bool(frame.shape[-1] == 1 or np.all(frame[..., 0] == frame[..., -1]))
        return self.grayscale

    def reset(self, filename: Optional[str] = None, filenames: Optional[List[str]] = None,
              grayscale: Optional[bool] = None) -> None:
        """Drop the cached frames and sizes, and optionally point at other
        images (not both ``filename`` and ``filenames``); a new image
        detects grayscale again unless ``grayscale`` is given."""
        if filename is not None and filenames:
            raise ValueError("Cannot specify both filename and filenames on reset.")
        self._cache = {}
        self.height_ = self.width_ = self.channels_ = None
        if filename is not None:
            self.filename = filename
            self.filenames = [filename]
        elif filenames:
            self.filenames = list(filenames)
            self.filename = self.filenames[0]
        if grayscale is not None:
            self.grayscale = grayscale
        elif filename is not None or filenames:
            self.grayscale = None

    def _read(self, path: str) -> np.ndarray:
        """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``, or None where the
        file cannot be read."""
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return None
        return stills.imread(data, self.device, path)

    def get_frame(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            img = self._read(self.filenames[idx])
            if img is None:
                raise KeyError(f"Unable to read image {self.filenames[idx]}.")
            if img.ndim == 2:
                img = img[..., None]
            elif img.shape[-1] >= 3:
                img = img[..., 2::-1]  # BGR(A) -> RGB
            if self.grayscale:
                img = img[..., :1]
            self._cache[idx] = img
        return self._cache[idx]


@dataclass(eq=False)
class ImgStoreVideo:
    """Frames of a loopbio ImgStore directory store
    (:mod:`sleap_tpu_torch.io.dirimgstore`), by original frame number
    (``index_by_original``) or by position in the store; decoded on
    ``device``'s route."""

    filename: str = ""
    index_by_original: bool = True
    device: dataclasses.InitVar[Device] = "cuda"

    def __post_init__(self, device: Device = "cuda"):
        self.device = device
        path = self.filename
        if os.path.isdir(path):
            path = os.path.join(path, dirimgstore.STORE_MD_FILENAME)
        self._store = dirimgstore.new_for_filename(path, device=device)
        self._img, _ = self._store.get_next_image()

    @property
    def frames(self) -> int:
        return self._store.frame_count

    @property
    def height(self) -> int:
        return self._img.shape[0]

    @property
    def width(self) -> int:
        return self._img.shape[1]

    @property
    def channels(self) -> int:
        return 1 if self._img.ndim == 2 else self._img.shape[2]

    @property
    def dtype(self):
        return self._img.dtype

    @property
    def last_frame_idx(self) -> int:
        """The highest original frame number when indexing by them, else
        the last position."""
        return self._store.frame_max if self.index_by_original else self.frames - 1

    def get_frame(self, idx: int) -> np.ndarray:
        if self.index_by_original:
            img, _ = self._store.get_image(frame_number=idx)
        else:
            img, _ = self._store.get_image(frame_number=None, frame_index=idx)
        return img[..., None] if img.ndim == 2 else img


def imencode_rows(frames: Sequence[np.ndarray], fmt: str, device: Device = "cuda") -> List[np.ndarray]:
    """Each frame encoded as ``cv2.imencode("." + fmt, frame)`` would, as a
    row of int8 (the layout of a ``.pkg.slp``'s embedded frames): PNG and
    BMP on the host, JPEG and TIFF on ``device``'s route
    (:func:`stills.imencode`); JPEG, BMP and TIFF byte for byte as cv2
    writes them."""
    stills.check_format(fmt)
    return [np.frombuffer(stills.imencode(frame, fmt, device), np.int8) for frame in frames]


def write_encoded(group: hdf5.WritableGroup, name: str, rows: List[np.ndarray], fmt: str,
                  shape: Tuple[int, int, int]) -> None:
    """Encoded rows as ``name``: int8 (frames, longest row), zero-padded,
    deflated one row a chunk, with the ``format``, ``channels``, ``height``
    and ``width`` attributes."""
    longest = max((len(r) for r in rows), default=0)
    ds = group.create_dataset(name, shape=(len(rows), longest), dtype="int8",
                              chunks=(1, longest) if rows and longest else None)
    for i, r in enumerate(rows):
        ds[i, :len(r)] = r
    ds.attrs["format"] = fmt
    ds.attrs["height"], ds.attrs["width"], ds.attrs["channels"] = shape


BackendType = Union[MediaVideo, HDF5Video, NumpyVideo, SingleImageVideo, DummyVideo, ImgStoreVideo]


def _backend(bcls, filename: str, fields: Dict[str, Any], device: Device) -> BackendType:
    """A backend of its fields, and of the device a media file decodes on
    where the backend takes one."""
    if "device" in inspect.signature(bcls).parameters:
        fields = {**fields, "device": device}
    return bcls(filename=filename, **fields)


_BACKENDS = {cls.__name__: cls for cls in (MediaVideo, HDF5Video, NumpyVideo, SingleImageVideo,
                                            DummyVideo, ImgStoreVideo)}


class Video:
    """A backend behind one interface: ``get_frame``, ``num_frames``,
    ``shape``; unknown attributes are the backend's. ``Video(array)`` is
    ``Video.from_numpy(array)``."""

    def __init__(self, backend: Union[BackendType, np.ndarray]):
        if isinstance(backend, np.ndarray):
            backend = NumpyVideo(filename=backend)
        self.backend = backend

    def __getattr__(self, name):
        if name == "backend" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.backend, name)

    def __repr__(self) -> str:
        return f"Video(filename={self.filename!r}, backend={type(self.backend).__name__})"

    @property
    def num_frames(self) -> int:
        return self.backend.frames

    @property
    def last_frame_idx(self) -> int:
        """The highest frame index: the backend's where it has one (the
        highest original frame number of embedded frames), else the last
        frame."""
        backend_idx = getattr(self.backend, "last_frame_idx", None)
        return backend_idx if backend_idx is not None else self.num_frames - 1

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        b = self.backend
        return (b.frames, b.height, b.width, b.channels)

    def __len__(self) -> int:
        return self.num_frames

    def get_frame(self, idx: int) -> np.ndarray:
        """Frame ``idx`` as an (H, W, C) array."""
        return self.backend.get_frame(idx)

    def get_frames(self, idxs: Union[int, Sequence[int]]) -> np.ndarray:
        if np.isscalar(idxs):
            idxs = [int(idxs)]
        return np.stack([self.get_frame(i) for i in idxs], axis=0)

    def get_frames_safely(self, idxs: Sequence[int]) -> Tuple[List[int], Optional[np.ndarray]]:
        """The frames that can be read, with their indices (None when no
        frame can)."""
        out_idxs, frames = [], []
        for i in idxs:
            try:
                frames.append(self.get_frame(i))
                out_idxs.append(i)
            except Exception:
                continue
        return out_idxs, (np.stack(frames, axis=0) if frames else None)

    def __getitem__(self, idxs) -> np.ndarray:
        """Always (n, H, W, C), a scalar index included."""
        if isinstance(idxs, slice):
            idxs = list(range(*idxs.indices(self.num_frames)))
        return self.get_frames(idxs)

    @property
    def is_missing(self) -> bool:
        fn = getattr(self.backend, "filename", None)
        if fn is None or isinstance(fn, np.ndarray) or isinstance(self.backend, DummyVideo):
            return False
        return not os.path.exists(fn)

    @property
    def filename(self) -> str:
        fn = getattr(self.backend, "filename", "")
        return fn if isinstance(fn, str) else "numpy_video"

    def __eq__(self, other) -> bool:
        """The JAX package's video equality: the same backend type, filename
        and dataset; an in-memory video equals only itself (the JAX
        package's in-memory videos all compare equal once read, since their
        filename becomes "numpy_video")."""
        if not isinstance(other, Video):
            return NotImplemented
        if type(self.backend) is not type(other.backend):
            return False
        if isinstance(self.backend, NumpyVideo):
            return self.backend is other.backend
        if getattr(self.backend, "filename", None) != getattr(other.backend, "filename", None):
            return False
        return getattr(self.backend, "dataset", None) == getattr(other.backend, "dataset", None)

    def __hash__(self) -> int:
        return id(self)

    def matches(self, other: "Video") -> bool:
        return self == other

    # -- construction and serialization ------------------------------------ #
    @classmethod
    def from_numpy(cls, data: np.ndarray) -> "Video":
        return cls(NumpyVideo(filename=np.asarray(data)))

    @classmethod
    def from_filename(cls, filename: str, device: Device = "cuda", **kwargs) -> "Video":
        """A backend chosen by the filename's extension; keyword arguments
        the backend does not take are dropped. ``device`` is where a media
        video is decoded (and an HDF5 video's source video)."""
        filename = fixup_path(filename)
        low = filename.lower()
        if low.endswith(HDF5Video.EXTS):
            keep, bcls = ("dataset", "input_format", "convert_range"), HDF5Video
        elif low.endswith(NumpyVideo.EXTS):
            keep, bcls = (), NumpyVideo
        elif low.endswith(MediaVideo.EXTS):
            keep, bcls = ("grayscale", "bgr"), MediaVideo
        elif low.endswith(SingleImageVideo.EXTS):
            keep = ("filenames", "height_", "width_", "channels_", "grayscale")
            bcls = SingleImageVideo
        else:
            raise ValueError(f"Could not detect video backend for: {filename}")
        return cls(_backend(bcls, filename, {k: v for k, v in kwargs.items() if k in keep}, device))

    @classmethod
    def from_media(cls, filename: str, device: Device = "cuda", **kwargs) -> "Video":
        """A media file (mp4, avi, ...) decoded on ``device``."""
        kwargs = {k: v for k, v in kwargs.items() if k in ("grayscale", "bgr")}
        return cls(MediaVideo(filename=fixup_path(filename), device=device, **kwargs))

    @classmethod
    def from_image_filenames(cls, filenames: List[str], device: Device = "cuda", **kwargs) -> "Video":
        """Still images, one a frame, decoded on ``device``."""
        return cls(SingleImageVideo(filenames=list(filenames), device=device, **kwargs))

    @classmethod
    def from_hdf5(cls, dataset: str, filename: str, input_format: str = "channels_last",
                  convert_range: bool = True, device: Device = "cuda") -> "Video":
        return cls(HDF5Video(filename=filename, dataset=dataset, input_format=input_format,
                             convert_range=convert_range, device=device))

    def _device(self, device: Optional[Device]) -> Device:
        """``device``, else this backend's, else the card."""
        return device if device is not None else getattr(self.backend, "device", "cuda")

    def write_hdf5(self, group: hdf5.WritableGroup, dataset: str,
                   frame_numbers: Optional[List[int]] = None, format: str = "",
                   index_by_original: bool = True, device: Optional[Device] = None) -> None:
        """:meth:`to_hdf5`'s datasets, into the group of a file being
        written: ``<dataset>/video`` (raw frames, gzip level 9; or encoded
        rows with ``format``, JPEG and TIFF encoded on ``device``, by
        default this video's), ``<dataset>/frame_numbers`` and ``<dataset>/source_video``
        (this video's JSON)."""
        if frame_numbers is None:
            frame_numbers = list(range(self.num_frames))
        frames = self.get_frames(frame_numbers) if frame_numbers else np.zeros((1, 1, 1, 1))
        if format:
            write_encoded(group, dataset + "/video",
                          imencode_rows(frames, format, self._device(device)), format,
                          (self.height, self.width, self.channels))
        else:
            group.create_dataset(dataset + "/video", data=frames, compression="gzip",
                                 compression_opts=9)
        if index_by_original:
            group.create_dataset(dataset + "/frame_numbers",
                                 data=np.asarray(frame_numbers, dtype=np.int64), compression=None)
        group.require_group(dataset + "/source_video").attrs["json"] = json.dumps(self.to_dict())

    def to_hdf5(self, path: str, dataset: str, frame_numbers: Optional[List[int]] = None,
                format: str = "", index_by_original: bool = True,
                device: Optional[Device] = None) -> "Video":
        """Copy frames into an HDF5 file (added to the file where it exists,
        as h5py's mode "a") and return a video of them that decodes on
        ``device`` (by default this video's), where JPEG and TIFF rows are
        encoded too; the layout of the JAX package's ``Video.to_hdf5``: see
        :meth:`write_hdf5`."""
        with hdf5.Writer(path, "a", device=self._device(device)) as f:
            self.write_hdf5(f, dataset, frame_numbers, format, index_by_original, device)
        return Video(HDF5Video(filename=path, dataset=dataset + "/video", input_format="channels_last",
                               convert_range=False, device=self._device(device)))

    def to_imgstore(self, path: str, frame_numbers: Optional[List[int]] = None,
                    format: str = "png", index_by_original: bool = True,
                    device: Optional[Device] = None) -> "Video":
        """Copy frames into a PNG, JPEG, BMP or TIFF ImgStore at ``path`` and
        return a video of it that decodes on ``device`` (by default this
        video's), where JPEG and TIFF frames are encoded too; an empty selection stores one
        blank frame, as the JAX package does."""
        import time

        if frame_numbers is None:
            frame_numbers = list(range(self.num_frames))
        store = dirimgstore.new_for_format(format, mode="w", basedir=path,
                                           imgshape=(self.height, self.width, self.channels),
                                           chunksize=1000, device=self._device(device))
        for i in frame_numbers:
            store.add_image(self.get_frame(i), i, time.time())
        if not frame_numbers:
            store.add_image(np.zeros((self.height, self.width, self.channels), np.uint8), 0,
                            time.time())
        store.close()
        return Video(ImgStoreVideo(filename=path, index_by_original=index_by_original,
                                   device=self._device(device)))

    @classmethod
    def from_dict(cls, d: Dict[str, Any], video_search=None, device: Device = "cuda") -> "Video":
        """From a ``videos_json`` entry, ``{"backend": {...fields...}}``:
        by its ``type`` where it names one, else by its fields and the
        filename's extension (an unknown one gives a :class:`DummyVideo`).
        ``device`` is where a media video is decoded."""
        bd = dict(d.get("backend", d))
        bd.pop("backend", None)
        explicit = bd.pop("type", None)
        filename = bd.pop("filename", None) or bd.pop("file", None)
        if video_search is not None:
            filename = video_search(filename) or filename
        if explicit in _BACKENDS:
            bcls = _BACKENDS[explicit]
            names = {f.name for f in dataclasses.fields(bcls)}
            fields = {k: v for k, v in bd.items() if k in names}
            return cls(_backend(bcls, filename, fields, device))
        if bd.get("dummy"):
            keep = ("height", "width", "frames", "channels", "dummy")
            return cls(DummyVideo(filename=filename or "", **{k: v for k, v in bd.items() if k in keep}))
        if bd.get("filenames"):
            return cls(SingleImageVideo(filename=filename, filenames=bd["filenames"],
                                        grayscale=bd.get("grayscale"), device=device))
        try:
            return cls.from_filename(filename, device=device, **bd)
        except ValueError:
            return cls(DummyVideo(filename=filename or ""))

    def to_dict(self) -> Dict[str, Any]:
        b = self.backend
        d = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        if isinstance(d.get("filename"), np.ndarray):
            d["filename"] = "numpy_video"
        d["type"] = type(b).__name__
        d.setdefault("dataset", getattr(b, "dataset", "") or "")
        d.setdefault("input_format", getattr(b, "input_format", "") or "")
        return {"backend": d}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def load_video(
    filename: str,
    grayscale: Optional[bool] = None,
    dataset: Optional[str] = None,
    channels_first: bool = False,
    device: Device = "cuda",
    **kwargs,
) -> Video:
    """Open a video from disk: a media file (decoded on ``device``), an
    HDF5 dataset (embedded ``.slp`` frames too), a ``.npy`` array, a still
    image, or a directory of images (one frame each)."""
    if os.path.isdir(filename):
        files = sorted(
            os.path.join(filename, f)
            for f in os.listdir(filename)
            if f.lower().endswith(SingleImageVideo.EXTS)
        )
        if not files:
            raise ValueError(f"No images found in directory: {filename}")
        return Video(SingleImageVideo(filenames=files, grayscale=grayscale, device=device))
    if grayscale is not None:
        kwargs["grayscale"] = grayscale
    if dataset is not None:
        kwargs["dataset"] = dataset
    if channels_first:
        kwargs["input_format"] = "channels_first"
    return Video.from_filename(filename, device=device, **kwargs)


def fixup_path(path: str, search_paths: Optional[List[str]] = None) -> str:
    """``path`` if it exists, else its basename in the working directory or
    in (or under) one of ``search_paths``, else ``path`` unchanged."""
    if not isinstance(path, str) or os.path.exists(path):
        return path
    basename = os.path.basename(path)
    candidates = [os.path.join(os.getcwd(), basename)]
    for sp in search_paths or []:
        candidates.append(os.path.join(sp, basename))
        candidates.append(os.path.join(sp, path))
    for c in candidates:
        if os.path.exists(c):
            return c
    return path
