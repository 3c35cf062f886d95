"""NVDEC, the card's video decoder, and the CUDA driver through ``ctypes``.

``libnvcuvid.so.1`` ships with the NVIDIA driver; the Video Codec SDK's
headers (``nvcuvid.h``, ``cuviddec.h``) are not part of the CUDA toolkit
since CUDA 10, so the structs below are declared here with the public SDK's
layout (Video Codec SDK 12.1; the fields used have kept their offsets since
SDK 9). Pictures the parser hands over (``CUVIDPICPARAMS``) pass through as
opaque pointers.

:class:`NvdecReader` decodes an H.264 :class:`~sleap_tpu_torch.io.mp4.Track`
(an ISO-BMFF :class:`~sleap_tpu_torch.io.mp4.Mp4Video` or a Matroska
:class:`~sleap_tpu_torch.io.mkv.MkvVideo`) into NV12 frames on the card:
the parser calls back on a new sequence (create the decoder), a picture to
decode (``cuvidDecodePicture``) and a picture to display (map it, copy it
into a torch tensor, unmap it). Each packet goes in with its presentation
index as timestamp (-1 for one an edit list drops), which the display
callback gets back, so frames are known by index whatever the reordering.

Traps, named where the code meets them:

- ``unsigned long`` is 8 bytes on Linux x86-64 (``CUVIDDECODECREATEINFO``,
  ``CUVIDSOURCEDATAPACKET``): ``c_ulong``, never ``c_uint``.
- The chroma plane of a mapped NV12 surface starts at
  ``ptr + pitch * ((surface_height + 1) & ~1)``, not at ``ptr + pitch * height``.
- The decoder runs in torch's primary context (``cuDevicePrimaryCtxRetain``
  on the reader's device) with a ``cuvidCtxLock``; every call pushes that
  context first, so a reader works from any thread (the predictors read
  frames in a prefetch thread).
- After a seek the parser is reset with an end-of-stream packet (whose
  pictures are dropped) and the next packet is marked a discontinuity.
- Anything but 8-bit 4:2:0 H.264 raises, naming the format.
"""

from __future__ import annotations

import ctypes
import threading
import time
from ctypes import POINTER, Structure, byref, c_int, c_longlong, c_short, c_ubyte, c_uint
from ctypes import c_ulong, c_ulonglong, c_ushort, c_void_p
from typing import Dict, Optional

import torch

# cudaVideoCodec: H.264, and the codecs phase 1 of chip_smoke.py asks about
CODECS = {"MPEG4": 2, "H264": 4, "HEVC": 8, "AV1": 11}
CHROMA_FORMATS = {0: "monochrome", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}
SURFACE_NV12 = 0
DEINTERLACE_WEAVE = 0
CREATE_PREFER_CUVID = 4
PKT_ENDOFSTREAM, PKT_TIMESTAMP, PKT_DISCONTINUITY, PKT_ENDOFPICTURE = 0x1, 0x2, 0x4, 0x8


class DecodeCaps(Structure):  # CUVIDDECODECAPS
    _fields_ = [
        ("eCodecType", c_int), ("eChromaFormat", c_int), ("nBitDepthMinus8", c_uint),
        ("reserved1", c_uint * 3),
        ("bIsSupported", c_ubyte), ("nNumNVDECs", c_ubyte), ("nOutputFormatMask", c_ushort),
        ("nMaxWidth", c_uint), ("nMaxHeight", c_uint), ("nMaxMBCount", c_uint),
        ("nMinWidth", c_ushort), ("nMinHeight", c_ushort),
        ("bIsHistogramSupported", c_ubyte), ("nCounterBitDepth", c_ubyte),
        ("nMaxHistogramBins", c_ushort), ("reserved3", c_uint * 10),
    ]


class VideoFormat(Structure):  # CUVIDEOFORMAT
    _fields_ = [
        ("codec", c_int), ("frame_rate_num", c_uint), ("frame_rate_den", c_uint),
        ("progressive_sequence", c_ubyte), ("bit_depth_luma_minus8", c_ubyte),
        ("bit_depth_chroma_minus8", c_ubyte), ("min_num_decode_surfaces", c_ubyte),
        ("coded_width", c_uint), ("coded_height", c_uint),
        ("display_left", c_int), ("display_top", c_int),
        ("display_right", c_int), ("display_bottom", c_int),
        ("chroma_format", c_int), ("bitrate", c_uint),
        ("aspect_x", c_int), ("aspect_y", c_int),
        ("video_signal_description", c_ubyte * 4), ("seqhdr_data_length", c_uint),
    ]


class ParserDispInfo(Structure):  # CUVIDPARSERDISPINFO
    _fields_ = [("picture_index", c_int), ("progressive_frame", c_int),
                ("top_field_first", c_int), ("repeat_first_field", c_int),
                ("timestamp", c_longlong)]


_SequenceCallback = ctypes.CFUNCTYPE(c_int, c_void_p, POINTER(VideoFormat))
_DecodeCallback = ctypes.CFUNCTYPE(c_int, c_void_p, c_void_p)  # CUVIDPICPARAMS*, opaque
_DisplayCallback = ctypes.CFUNCTYPE(c_int, c_void_p, POINTER(ParserDispInfo))


class ParserParams(Structure):  # CUVIDPARSERPARAMS
    _fields_ = [
        ("CodecType", c_int), ("ulMaxNumDecodeSurfaces", c_uint), ("ulClockRate", c_uint),
        ("ulErrorThreshold", c_uint), ("ulMaxDisplayDelay", c_uint),
        ("flags", c_uint),  # bAnnexb : 1, bMemoryOptimize : 1, uReserved : 30
        ("uReserved1", c_uint * 4), ("pUserData", c_void_p),
        ("pfnSequenceCallback", _SequenceCallback), ("pfnDecodePicture", _DecodeCallback),
        ("pfnDisplayPicture", _DisplayCallback), ("pfnGetOperatingPoint", c_void_p),
        ("pfnGetSEIMsg", c_void_p), ("pvReserved2", c_void_p * 5),
        ("pExtVideoInfo", c_void_p),
    ]


class SourceDataPacket(Structure):  # CUVIDSOURCEDATAPACKET
    _fields_ = [("flags", c_ulong), ("payload_size", c_ulong),
                ("payload", c_void_p), ("timestamp", c_longlong)]


class _Rect(Structure):
    _fields_ = [("left", c_short), ("top", c_short), ("right", c_short), ("bottom", c_short)]


class DecodeCreateInfo(Structure):  # CUVIDDECODECREATEINFO
    _fields_ = [
        ("ulWidth", c_ulong), ("ulHeight", c_ulong), ("ulNumDecodeSurfaces", c_ulong),
        ("CodecType", c_int), ("ChromaFormat", c_int),
        ("ulCreationFlags", c_ulong), ("bitDepthMinus8", c_ulong),
        ("ulIntraDecodeOnly", c_ulong), ("ulMaxWidth", c_ulong), ("ulMaxHeight", c_ulong),
        ("Reserved1", c_ulong), ("display_area", _Rect),
        ("OutputFormat", c_int), ("DeinterlaceMode", c_int),
        ("ulTargetWidth", c_ulong), ("ulTargetHeight", c_ulong),
        ("ulNumOutputSurfaces", c_ulong), ("vidLock", c_void_p),
        ("target_rect", _Rect), ("enableHistogram", c_ulong), ("Reserved2", c_ulong * 4),
    ]


class ProcParams(Structure):  # CUVIDPROCPARAMS
    _fields_ = [
        ("progressive_frame", c_int), ("second_field", c_int),
        ("top_field_first", c_int), ("unpaired_field", c_int),
        ("reserved_flags", c_uint), ("reserved_zero", c_uint),
        ("raw_input_dptr", c_ulonglong), ("raw_input_pitch", c_uint),
        ("raw_input_format", c_uint), ("raw_output_dptr", c_ulonglong),
        ("raw_output_pitch", c_uint), ("Reserved1", c_uint), ("output_stream", c_void_p),
        ("Reserved", c_uint * 46), ("histogram_dptr", c_void_p), ("Reserved2", c_void_p * 1),
    ]


_p = c_void_p
_CUDA = {  # CUresult name(args)
    "cuInit": [c_uint], "cuDeviceGet": [POINTER(c_int), c_int],
    "cuDevicePrimaryCtxRetain": [POINTER(c_void_p), c_int],
    "cuDevicePrimaryCtxRelease_v2": [c_int],
    "cuCtxPushCurrent_v2": [_p], "cuCtxPopCurrent_v2": [POINTER(c_void_p)],
    "cuGetErrorName": [c_int, POINTER(ctypes.c_char_p)],
}
_NVCUVID = {
    "cuvidGetDecoderCaps": [POINTER(DecodeCaps)],
    "cuvidCreateDecoder": [POINTER(c_void_p), POINTER(DecodeCreateInfo)],
    "cuvidDestroyDecoder": [_p],
    "cuvidDecodePicture": [_p, _p],
    "cuvidMapVideoFrame64": [_p, c_int, POINTER(c_ulonglong), POINTER(c_uint), POINTER(ProcParams)],
    "cuvidUnmapVideoFrame64": [_p, c_ulonglong],
    "cuvidCtxLockCreate": [POINTER(c_void_p), _p],
    "cuvidCtxLockDestroy": [_p],
    "cuvidCreateVideoParser": [POINTER(c_void_p), POINTER(ParserParams)],
    "cuvidParseVideoData": [_p, POINTER(SourceDataPacket)],
    "cuvidDestroyVideoParser": [_p],
}

_LOAD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def libraries() -> Dict[str, ctypes.CDLL]:
    """``{"cuda": libcuda, "nvcuvid": libnvcuvid}`` with every function's
    ``argtypes`` and ``restype`` declared; raise naming a library that does
    not load."""
    with _LOAD_LOCK:
        if not _LIBS:
            libs = {}
            for key, name, funcs in (("cuda", "libcuda.so.1", _CUDA),
                                     ("nvcuvid", "libnvcuvid.so.1", _NVCUVID)):
                try:
                    lib = ctypes.CDLL(name)
                except OSError as e:
                    raise RuntimeError(
                        f"NVDEC cannot be used: {name} does not load ({e}). The card reads media "
                        f"video only through NVDEC; pass device='cpu' to read it with cv2."
                    ) from e
                for fn, argtypes in funcs.items():
                    f = getattr(lib, fn)
                    f.argtypes, f.restype = argtypes, c_int
                libs[key] = lib
            if ctypes.sizeof(c_ulong) != 8 or ctypes.sizeof(c_void_p) != 8:
                raise RuntimeError("NVDEC's structs are declared for 64-bit Linux")
            _LIBS.update(libs)
    return _LIBS


CUDA_ERROR_OUT_OF_MEMORY = 2
# Where a container does not grant the NVIDIA driver's "video" capability
# (``NVIDIA_DRIVER_CAPABILITIES`` without it), the library loads and the
# parser runs, but every call that reaches the decoder engine fails, with
# CUDA_ERROR_OUT_OF_MEMORY.
REFUSED_HINT = ("Where a container is not granted the NVIDIA driver's 'video' capability, "
                "every NVDEC decoder call fails this way. The card reads media video only "
                "through NVDEC; pass device='cpu' to read it with cv2.")


class CudaError(RuntimeError):
    """A CUDA driver or NVDEC call that returned ``result``, not 0."""

    def __init__(self, call: str, result: int, message: str):
        super().__init__(message)
        self.call, self.result = call, result


def _check(result: int, call: str, detail: str = "") -> None:
    """Raise :class:`CudaError` for a ``result`` of ``call`` other than 0;
    an NVDEC call that runs out of memory names the likely cause."""
    if result != 0:
        name = ctypes.c_char_p()
        _LIBS["cuda"].cuGetErrorName(result, byref(name))
        hint = (f" {REFUSED_HINT}" if result == CUDA_ERROR_OUT_OF_MEMORY
                and call.startswith("cuvid") else "")
        raise CudaError(call, result, f"{call}{detail} failed: CUresult {result} "
                                      f"({(name.value or b'unknown').decode()}).{hint}")


class _PrimaryContext:
    """Torch's primary context of one device, made current around each use."""

    def __init__(self, device: torch.device):
        libs = libraries()
        torch.cuda.init()
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.cuda = libs["cuda"]
        _check(self.cuda.cuInit(0), "cuInit")
        dev = c_int()
        _check(self.cuda.cuDeviceGet(byref(dev), self.index), "cuDeviceGet")
        self.dev = dev.value
        self.ctx = c_void_p()
        _check(self.cuda.cuDevicePrimaryCtxRetain(byref(self.ctx), self.dev),
               "cuDevicePrimaryCtxRetain")

    def __enter__(self):
        _check(self.cuda.cuCtxPushCurrent_v2(self.ctx), "cuCtxPushCurrent")
        return self

    def __exit__(self, *exc):
        popped = c_void_p()
        _check(self.cuda.cuCtxPopCurrent_v2(byref(popped)), "cuCtxPopCurrent")

    def release(self) -> None:
        if self.ctx:
            self.cuda.cuDevicePrimaryCtxRelease_v2(self.dev)
            self.ctx = c_void_p()


def decoder_caps(codec: str = "H264", chroma_format: int = 1, bit_depth: int = 8,
                 device="cuda") -> Dict[str, int]:
    """``cuvidGetDecoderCaps`` for a codec (a key of :data:`CODECS`), chroma
    format (1: 4:2:0) and bit depth."""
    ctx = _PrimaryContext(torch.device(device))
    try:
        caps = DecodeCaps(eCodecType=CODECS[codec], eChromaFormat=chroma_format,
                          nBitDepthMinus8=bit_depth - 8)
        with ctx:
            _check(_LIBS["nvcuvid"].cuvidGetDecoderCaps(byref(caps)), "cuvidGetDecoderCaps",
                   f"({codec})")
    finally:
        ctx.release()
    return {"supported": caps.bIsSupported, "nvdecs": caps.nNumNVDECs,
            "output_formats": caps.nOutputFormatMask, "max_width": caps.nMaxWidth,
            "max_height": caps.nMaxHeight, "max_mbs": caps.nMaxMBCount,
            "min_width": caps.nMinWidth, "min_height": caps.nMinHeight}


class _DeviceView:
    """A pitched 2-D uint8 view of device memory, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, rows: int, cols: int, pitch: int):
        self.__cuda_array_interface__ = {"shape": (rows, cols), "strides": (pitch, 1),
                                         "typestr": "|u1", "data": (ptr, False), "version": 3}


class NvdecReader:
    """Frames of an H.264 :class:`~sleap_tpu_torch.io.mp4.Track` decoded
    by NVDEC: ``frame(i)`` is presentation frame ``i`` as an NV12 uint8
    tensor on the card, (H + H/2, W): the luma rows, then the interleaved
    chroma rows. Sequential reads decode forward; a read behind the decoder,
    or past a sync sample after it, starts again from the last sync sample
    at or before the frame. Thread-safe."""

    def __init__(self, demux, device="cuda"):
        fmt = demux.format
        if (fmt["chroma_format_idc"], fmt["bit_depth_luma"], fmt["bit_depth_chroma"]) != (1, 8, 8):
            raise NotImplementedError(
                f"{demux.filename}: H.264 in {CHROMA_FORMATS.get(fmt['chroma_format_idc'])} at "
                f"{fmt['bit_depth_luma']} bits; the card decodes 8-bit 4:2:0 only (ROADMAP.md, "
                f"queue 1, item 3g: other codecs and containers).")
        if demux.width % 2:
            raise NotImplementedError(f"{demux.filename}: an odd width in 4:2:0")
        self.demux = demux
        self._ctx = _PrimaryContext(torch.device(device))
        self.device = torch.device(torch.device(device).type, self._ctx.index)
        self._nv = _LIBS["nvcuvid"]
        self._lock = threading.RLock()
        self._ctx_lock = c_void_p()
        self._decoder = c_void_p()
        self._parser = c_void_p()
        self._format = None
        self.sequence: Optional[dict] = None  # the parser's last CUVIDEOFORMAT, in short
        self._surface_height = 0
        self._file = open(demux.filename, "rb")
        self._pos: Optional[int] = None  # next sample (decoding order) to feed; None: no stream
        self._ready: Dict[int, torch.Tensor] = {}  # displayed frames by presentation index
        self._discard = False
        self._error: Optional[BaseException] = None
        # The parser's callbacks: kept referenced for as long as it lives.
        self._callbacks = (_SequenceCallback(self._on_sequence), _DecodeCallback(self._on_decode),
                           _DisplayCallback(self._on_display))
        # Host seconds in cuvidParseVideoData (decoding and the callbacks) and
        # in copying mapped frames out; frames copied.
        self.timing = {"parse_s": 0.0, "copy_s": 0.0, "frames": 0}
        try:
            with self._ctx:
                _check(self._nv.cuvidCtxLockCreate(byref(self._ctx_lock), self._ctx.ctx),
                       "cuvidCtxLockCreate")
                params = ParserParams(CodecType=CODECS["H264"], ulMaxNumDecodeSurfaces=1,
                                      ulMaxDisplayDelay=0, pfnSequenceCallback=self._callbacks[0],
                                      pfnDecodePicture=self._callbacks[1],
                                      pfnDisplayPicture=self._callbacks[2])
                _check(self._nv.cuvidCreateVideoParser(byref(self._parser), byref(params)),
                       "cuvidCreateVideoParser")
        except BaseException:
            self.close()
            raise

    @property
    def height(self) -> int:
        return self.demux.height

    @property
    def width(self) -> int:
        return self.demux.width

    # -- the parser's callbacks (on the thread that feeds it) -------------- #
    def _fail(self, e: BaseException) -> int:
        self._error = self._error or e
        return 0

    def _on_sequence(self, _user, fmt_p) -> int:
        try:
            fmt = fmt_p.contents
            if (fmt.codec != CODECS["H264"] or fmt.chroma_format != 1
                    or fmt.bit_depth_luma_minus8 or fmt.bit_depth_chroma_minus8):
                raise NotImplementedError(
                    f"{self.demux.filename}: a sequence of codec {fmt.codec}, chroma "
                    f"{CHROMA_FORMATS.get(fmt.chroma_format)}, {8 + fmt.bit_depth_luma_minus8} "
                    f"bits; the card decodes 8-bit 4:2:0 H.264 only.")
            surfaces = max(int(fmt.min_num_decode_surfaces), 1)
            key = (fmt.coded_width, fmt.coded_height, fmt.display_left, fmt.display_top,
                   fmt.display_right, fmt.display_bottom, surfaces)
            self.sequence = {"codec": fmt.codec, "chroma_format": fmt.chroma_format,
                             "bit_depth": 8 + fmt.bit_depth_luma_minus8,
                             "coded": (fmt.coded_width, fmt.coded_height),
                             "display": key[2:6], "surfaces": surfaces}
            if self._decoder and key == self._format:
                return surfaces
            if self._decoder:
                _check(self._nv.cuvidDestroyDecoder(self._decoder), "cuvidDestroyDecoder")
                self._decoder = c_void_p()
            width = fmt.display_right - fmt.display_left
            height = fmt.display_bottom - fmt.display_top
            if (width, height) != (self.width, self.height):
                raise ValueError(f"{self.demux.filename}: NVDEC displays {width}x{height}, the "
                                 f"SPS says {self.width}x{self.height}")
            info = DecodeCreateInfo(
                ulWidth=fmt.coded_width, ulHeight=fmt.coded_height,
                ulNumDecodeSurfaces=surfaces, CodecType=fmt.codec, ChromaFormat=fmt.chroma_format,
                ulCreationFlags=CREATE_PREFER_CUVID, bitDepthMinus8=0,
                ulMaxWidth=fmt.coded_width, ulMaxHeight=fmt.coded_height,
                display_area=_Rect(fmt.display_left, fmt.display_top, fmt.display_right,
                                   fmt.display_bottom),
                OutputFormat=SURFACE_NV12, DeinterlaceMode=DEINTERLACE_WEAVE,
                ulTargetWidth=width, ulTargetHeight=height, ulNumOutputSurfaces=2,
                vidLock=self._ctx_lock)
            _check(self._nv.cuvidCreateDecoder(byref(self._decoder), byref(info)),
                   "cuvidCreateDecoder", f" for {self.demux.filename} ({width}x{height} H.264)")
            self._format, self._surface_height = key, height
            return surfaces
        except BaseException as e:  # noqa: BLE001 - raised again after the parse call
            return self._fail(e)

    def _on_decode(self, _user, pic) -> int:
        try:
            _check(self._nv.cuvidDecodePicture(self._decoder, pic), "cuvidDecodePicture")
            return 1
        except BaseException as e:  # noqa: BLE001
            return self._fail(e)

    def _on_display(self, _user, info_p) -> int:
        if not info_p or self._discard:  # end of stream, or pictures of a flush
            return 1
        try:
            info = info_p.contents
            if info.timestamp < 0:  # a packet the edit list drops (Track.rank -1)
                return 1
            proc = ProcParams(progressive_frame=info.progressive_frame,
                              second_field=info.repeat_first_field + 1,
                              top_field_first=info.top_field_first,
                              unpaired_field=int(info.repeat_first_field < 0),
                              output_stream=self._stream_handle())
            ptr, pitch = c_ulonglong(), c_uint()
            _check(self._nv.cuvidMapVideoFrame64(self._decoder, info.picture_index, byref(ptr),
                                                 byref(pitch), byref(proc)), "cuvidMapVideoFrame64")
            try:
                t0 = time.perf_counter()
                out = self._copy_out(ptr.value, pitch.value)
            finally:
                _check(self._nv.cuvidUnmapVideoFrame64(self._decoder, ptr.value),
                       "cuvidUnmapVideoFrame64")
            self.timing["copy_s"] += time.perf_counter() - t0
            self.timing["frames"] += 1
            self._ready[int(info.timestamp)] = out
            return 1
        except BaseException as e:  # noqa: BLE001
            return self._fail(e)

    def _stream_handle(self) -> int:
        """The stream NVDEC's post-processing of a mapped frame runs on."""
        return torch.cuda.current_stream(self.device).cuda_stream

    def _plane(self, ptr: int, rows: int, cols: int, pitch: int) -> torch.Tensor:
        """A pitched plane of a mapped surface, as a tensor view (no copy)."""
        return torch.as_tensor(_DeviceView(ptr, rows, cols, pitch), device=self.device)

    def _copy_out(self, ptr: int, pitch: int) -> torch.Tensor:
        """A mapped NV12 surface at ``ptr`` -> a new (H + ceil(H/2), W)
        uint8 tensor, complete before the surface is unmapped. NVDEC pads
        the luma plane to an even height; chroma starts there."""
        h, w = self.height, self.width
        out = torch.empty((h + (h + 1) // 2, w), dtype=torch.uint8, device=self.device)
        chroma = ptr + pitch * ((self._surface_height + 1) & ~1)
        out[:h].copy_(self._plane(ptr, h, w, pitch))
        out[h:].copy_(self._plane(chroma, (h + 1) // 2, w, pitch))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    # -- feeding ------------------------------------------------------------- #
    def _parse(self, payload: bytes, flags: int, timestamp: int = 0) -> None:
        buf = ctypes.create_string_buffer(payload, len(payload)) if payload else None
        packet = SourceDataPacket(flags=flags, payload_size=len(payload),
                                  payload=ctypes.cast(buf, c_void_p) if buf else None,
                                  timestamp=timestamp)
        self._error = None
        t0 = time.perf_counter()
        with self._ctx:
            result = self._nv.cuvidParseVideoData(self._parser, byref(packet))
        self.timing["parse_s"] += time.perf_counter() - t0
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        _check(result, "cuvidParseVideoData")

    def _flush(self, keep: bool) -> None:
        """An end-of-stream packet: the parser displays what it holds
        (dropped unless ``keep``) and starts over."""
        self._discard = not keep
        try:
            self._parse(b"", PKT_ENDOFSTREAM)
        finally:
            self._discard = False
        self._pos = None

    def frame(self, i: int) -> torch.Tensor:
        demux = self.demux
        if not 0 <= i < demux.readable:
            raise KeyError(f"Unable to load frame {i} from {demux.filename}.")
        with self._lock:
            if i not in self._ready:
                start = demux.sync_before(i)
                if self._pos is None or start > self._pos or int(demux.order[i]) < self._pos:
                    if self._pos is not None:
                        self._flush(keep=False)
                    self._ready.clear()
                    self._pos, first = start, True
                else:
                    first = False
                while i not in self._ready:
                    if self._pos is None or self._pos >= len(demux.packets):
                        self._flush(keep=True)
                        if i not in self._ready:
                            raise KeyError(f"Unable to load frame {i} from {demux.filename}.")
                        break
                    k = self._pos
                    data = demux.to_annexb(demux.read_packet(self._file, k), first)
                    flags = PKT_TIMESTAMP | PKT_ENDOFPICTURE | (PKT_DISCONTINUITY if first else 0)
                    self._parse(data, flags, int(demux.rank[k]))
                    self._pos, first = k + 1, False
            for j in [j for j in self._ready if j < i]:
                del self._ready[j]
            return self._ready[i]

    def close(self) -> None:
        with self._lock:
            if self._ctx.ctx:
                with self._ctx:
                    if self._parser:
                        self._nv.cuvidDestroyVideoParser(self._parser)
                    if self._decoder:
                        self._nv.cuvidDestroyDecoder(self._decoder)
                    if self._ctx_lock:
                        self._nv.cuvidCtxLockDestroy(self._ctx_lock)
                self._parser, self._decoder, self._ctx_lock = c_void_p(), c_void_p(), c_void_p()
                self._ctx.release()
            self._ready.clear()
            if not self._file.closed:
                self._file.close()
