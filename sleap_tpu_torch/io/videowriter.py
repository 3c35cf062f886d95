"""Video writing for ``sleap-render``: the JAX package's ``VideoWriter``
(``sleap_tpu/io/videowriter.py``), with its imageio and OpenCV backends,
and one more, :class:`VideoWriterMJPEG`, for a machine with neither.

:meth:`VideoWriter.safe_builder` tries imageio, then OpenCV, as the JAX
package does. Where imageio cannot open the file and OpenCV is not
installed (and the H100 has no hardware video encoder either), it writes
a Motion-JPEG AVI: each frame encoded by
:func:`sleap_tpu_torch.io.jpeg.imencode` (J3 and J4 on the card), muxed by
:mod:`sleap_tpu_torch.io.avi`. Only an ``.avi`` name takes that route; any
other raises an ``ImportError`` naming imageio and cv2. The backend chosen
is logged. A machine with cv2 writes with OpenCV, as the JAX package does;
this writer keeps ``sleap-render`` writing a video where neither is
installed.
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


class VideoWriter:
    """Factory facade: picks the best available backend."""

    @staticmethod
    def safe_builder(filename: str, height: int, width: int, fps: float = 30.0, device="cuda"):
        """imageio's writer, else OpenCV's, else (for ``.avi`` only) the
        Motion-JPEG writer encoding on ``device``."""
        try:
            writer = VideoWriterImageio(filename, height, width, fps)
        except Exception as imageio_error:
            try:
                writer = VideoWriterOpenCV(filename, height, width, fps)
            except ImportError as cv2_error:
                if os.path.splitext(filename)[1].lower() != ".avi":
                    raise ImportError(
                        f"No video writer for {filename}: imageio cannot write it "
                        f"({imageio_error}) and cv2 is not installed ({cv2_error}). Install "
                        "imageio with imageio-ffmpeg, or opencv-python, or write an .avi "
                        "(Motion-JPEG, which needs neither).") from cv2_error
                writer = VideoWriterMJPEG(filename, height, width, fps, device=device)
        logger.info("sleap-render writes %s with %s", filename, type(writer).__name__)
        return writer


def _gray_to_three(img: np.ndarray):
    """(H, W) or (H, W, 1) replicated to three channels (cv2's GRAY2BGR), or
    None for a frame that has three."""
    if img.ndim == 2:
        img = img[..., None]
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else None


class VideoWriterOpenCV:
    def __init__(self, filename: str, height: int, width: int, fps: float = 30.0):
        import cv2

        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self._writer = cv2.VideoWriter(filename, fourcc, fps, (width, height))

    def add_frame(self, img: np.ndarray, bgr: bool = False) -> None:
        gray = _gray_to_three(img)
        img = gray if gray is not None else (img if bgr else img[..., ::-1])
        self._writer.write(np.ascontiguousarray(img, dtype=np.uint8))

    def close(self) -> None:
        self._writer.release()


class VideoWriterImageio:
    def __init__(self, filename: str, height: int, width: int, fps: float = 30.0):
        import imageio

        self._writer = imageio.get_writer(filename, fps=fps)

    def add_frame(self, img: np.ndarray, bgr: bool = False) -> None:
        gray = _gray_to_three(img)
        img = gray if gray is not None else (img[..., ::-1] if bgr else img)
        self._writer.append_data(img.astype(np.uint8))

    def close(self) -> None:
        self._writer.close()


class VideoWriterMJPEG:
    """A Motion-JPEG AVI: each frame as :func:`jpeg.imencode` writes it (cv2's
    ``imencode(".jpg")`` bytes), on ``device``'s route."""

    def __init__(self, filename: str, height: int, width: int, fps: float = 30.0, device="cuda"):
        from sleap_tpu_torch.io import avi

        self.height, self.width, self.device = int(height), int(width), device
        self._writer = avi.AviWriter(filename, width, height, fps)

    def add_frame(self, img: np.ndarray, bgr: bool = False) -> None:
        from sleap_tpu_torch.io import jpeg

        img = np.asarray(img)
        gray = _gray_to_three(img)
        img = gray if gray is not None else (img if bgr else img[..., ::-1])
        if img.shape[:2] != (self.height, self.width):
            raise ValueError(f"A frame of {img.shape[:2]} in a video of {(self.height, self.width)}.")
        self._writer.add(jpeg.imencode(np.ascontiguousarray(img, dtype=np.uint8), self.device))

    def close(self) -> None:
        self._writer.close()
