"""Videos over in-memory frames.

The numpy backend of :class:`sleap_tpu.io.video.Video`, which is what
``predict`` builds for numpy frames. Media files and ``.slp``-embedded
videos need ``cv2`` or ``h5py`` and are not read by the port yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Video:
    """Frames (n, H, W, C) in memory; (n, H, W) gains a channel axis.
    Compared by identity, as the JAX package compares numpy videos."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        self.data = data[..., None] if data.ndim == 3 else data

    @classmethod
    def from_numpy(cls, data: np.ndarray) -> "Video":
        return cls(data)

    def __repr__(self) -> str:
        return f"Video(shape={self.shape})"

    @property
    def num_frames(self) -> int:
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
    def shape(self) -> Tuple[int, int, int, int]:
        return tuple(self.data.shape)

    def get_frame(self, idx: int) -> np.ndarray:
        """Frame ``idx`` as an (H, W, C) array."""
        return np.asarray(self.data[idx])
