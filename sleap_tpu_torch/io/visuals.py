"""``sleap-render``: draw tracked instances onto video frames (the JAX
package's ``sleap_tpu/io/visuals.py``, run as ``python -m
sleap_tpu_torch.io.visuals``).

Frames decode on their video's own route (J1 and J2 on the card for a JPEG
training package); lines and circles are drawn as cv2 draws them, bit for
bit, by :mod:`sleap_tpu_torch.io.draw`; resizing is cv2's, by
:func:`sleap_tpu_torch.data.resizing.resize_linear_uint8`; the video is
written by :meth:`sleap_tpu_torch.io.videowriter.VideoWriter.safe_builder`
(imageio, cv2, or a Motion-JPEG AVI encoded on ``device`` by J3 and J4
where neither is installed). ``--cpu`` decodes and encodes on the CPU.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.data.resizing import resize_linear_uint8
from sleap_tpu_torch.io import draw
from sleap_tpu_torch.io.videowriter import VideoWriter

logger = logging.getLogger(__name__)

# Default track palette (BGR), mirroring the reference's "standard" colors.
_PALETTE = [
    (0, 0, 255),
    (255, 0, 0),
    (0, 255, 0),
    (0, 255, 255),
    (255, 0, 255),
    (255, 255, 0),
    (128, 0, 255),
    (0, 128, 255),
]


def _color_for(labels: Labels, inst, fallback_idx: int) -> Tuple[int, int, int]:
    if inst.track is not None and inst.track in labels.tracks:
        return _PALETTE[labels.tracks.index(inst.track) % len(_PALETTE)]
    return _PALETTE[fallback_idx % len(_PALETTE)]


#: Solid-background fills (reference visuals.py:77 ``fill_values``).
_BACKGROUND_FILLS = {"black": 0, "grey": 127, "white": 255}


def apply_background(images: np.ndarray, background: str) -> np.ndarray:
    """Replace frame pixels with a solid fill (reference visuals.py:75-84)."""
    background = background.lower()
    if background == "original":
        return images
    if background not in _BACKGROUND_FILLS:
        raise ValueError(
            f"Invalid background color: {background}. Options include: "
            f"{', '.join(_BACKGROUND_FILLS)}"
        )
    return images * 0 + _BACKGROUND_FILLS[background]


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, (int(w * scale), int(h * scale)))``, bit for bit
    (:func:`resize_linear_uint8`); a (H, W, 1) frame keeps its channel."""
    h, w = img.shape[:2]
    new_w, new_h = int(w * scale), int(h * scale)
    return resize_linear_uint8(img, (new_h, new_w))


def resize_images(images: np.ndarray, scale: float) -> np.ndarray:
    """Batch resize (reference visuals.py:647)."""
    return np.stack([resize_image(img, scale) for img in images])


def render_frame(
    labels: Labels, img: np.ndarray, frame_idx: int, video=None,
    marker_size: int = 4, line_width: int = 2, scale: float = 1.0,
    show_edges: bool = True, offset_xy: Tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Draw one frame's instances on an image (BGR uint8): edges, then
    nodes, at end points rounded half to even here, as the JAX package
    rounds them before it calls cv2."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)  # cv2.COLOR_GRAY2BGR
    img = np.ascontiguousarray(img)
    video = video or labels.video
    lf = labels.find_first(video, frame_idx)
    if lf is None:
        return img
    for k, inst in enumerate(lf.instances):
        color = _color_for(labels, inst, k)
        pts = inst.numpy() * scale - np.asarray(offset_xy, np.float64)
        if show_edges:
            for src, dst in inst.skeleton.edge_inds:
                p1, p2 = pts[src], pts[dst]
                if np.isnan(p1).any() or np.isnan(p2).any():
                    continue
                draw.line(
                    img,
                    (int(round(p1[0])), int(round(p1[1]))),
                    (int(round(p2[0])), int(round(p2[1]))),
                    color,
                    line_width,
                )
        for p in pts:
            if np.isnan(p).any():
                continue
            draw.circle(
                img, (int(round(p[0])), int(round(p[1]))), marker_size, color, -1
            )
    return img


#: Frames per pipeline work item (reference visuals.py:745 renders in
#: chunks too; 16 keeps queue memory bounded at ~4 chunks x 16 frames).
_RENDER_CHUNK = 16


def save_labeled_video(
    filename: str,
    labels: Labels,
    video=None,
    frames: Optional[List[int]] = None,
    fps: float = 15.0,
    scale: float = 1.0,
    crop_size_xy: Optional[Tuple[int, int]] = None,
    background: str = "original",
    marker_size: int = 4,
    show_edges: bool = True,
    pipelined: bool = True,
    device="cuda",
) -> None:
    """Render an annotated video (reference visuals.py:510 ``save_labeled_video``).

    ``crop_size_xy`` crops each output frame around the instances' centroid,
    smoothed with a 5-frame running average (reference VideoMarkerThread
    ``_crop_centers`` deque, visuals.py:235-242). ``background`` replaces
    pixels with a solid fill: original | black | grey | white.

    ``pipelined=True`` overlaps the three stages — decode, mark, encode — in
    a reader -> marker -> writer thread pipeline over frame chunks, the same
    topology as the reference's multiprocess queue pipeline
    (visuals.py:30-107 ``reader``/``VideoMarkerThread``/``writer``). Threads
    suffice here: the decoders and encoders release the GIL, and the marker stage is
    sequential anyway (the crop-center running average is stateful). Frame
    order and output bytes are identical to the serial path.

    ``device``: where the Motion-JPEG writer encodes, where it is the
    writer :meth:`VideoWriter.safe_builder` chooses.
    """
    from collections import deque

    video = video or labels.video
    if frames is None:
        frames = sorted(lf.frame_idx for lf in labels.find(video))
    if not frames:
        raise ValueError("No frames to render.")
    h = int(video.height * scale)
    w = int(video.width * scale)
    if crop_size_xy:
        out_w, out_h = int(crop_size_xy[0]), int(crop_size_xy[1])
    else:
        out_w, out_h = w, h
    writer = VideoWriter.safe_builder(filename, height=out_h, width=out_w, fps=fps,
                                      device=device)
    crop_centers: deque = deque(maxlen=5)

    def mark(fi: int, img: np.ndarray) -> np.ndarray:
        """Background/resize/crop/draw for one frame (stateful via
        ``crop_centers`` — must be called in frame order)."""
        img = apply_background(img, background)
        if scale != 1.0:
            img = resize_image(img, scale)
        offset_xy = (0.0, 0.0)
        if crop_size_xy:
            lf = labels.find_first(video, fi)
            if lf is not None and len(lf.instances):
                pts = np.concatenate([inst.numpy() for inst in lf.instances])
                center = np.nanmean(pts, axis=0) * scale
                if np.isfinite(center).all():
                    crop_centers.append(center)
            cx, cy = (
                np.mean(crop_centers, axis=0)
                if crop_centers
                else (w / 2.0, h / 2.0)
            )
            x0 = int(np.clip(round(cx - out_w / 2), 0, max(w - out_w, 0)))
            y0 = int(np.clip(round(cy - out_h / 2), 0, max(h - out_h, 0)))
            if img.ndim == 2:
                img = img[..., None]
            img = img[y0 : y0 + out_h, x0 : x0 + out_w]
            # Pad if the video is smaller than the crop.
            if img.shape[0] < out_h or img.shape[1] < out_w:
                img = np.pad(
                    img,
                    ((0, out_h - img.shape[0]), (0, out_w - img.shape[1]), (0, 0)),
                )
            offset_xy = (float(x0), float(y0))
        return render_frame(
            labels, img, fi, video=video, marker_size=marker_size, scale=scale,
            show_edges=show_edges, offset_xy=offset_xy,
        )

    try:
        if pipelined:
            _render_pipelined(video, frames, mark, writer)
        else:
            for fi in frames:
                try:
                    img = video.get_frame(fi)
                except Exception:
                    continue
                writer.add_frame(mark(fi, img), bgr=True)
    finally:
        writer.close()
    logger.info("Saved rendered video: %s", filename)


def _render_pipelined(video, frames, mark, writer) -> None:
    """reader -> marker -> writer thread pipeline over frame chunks.

    Mirrors the reference's process pipeline (visuals.py:30-107): a decode
    thread chunks frames into a bounded queue, a marker thread draws (in
    order — the crop smoothing is stateful), and the caller thread encodes.
    Worker exceptions propagate to the caller; queues are bounded so a slow
    encoder backpressures decode instead of buffering the whole video.

    The workers wait on the queues in short turns and stop when the caller
    sets ``stop``: the JAX package's caller instead drains the queues to
    unblock them, which can take the marker's end-of-input marker from under
    it when the writer fails, and then waits for the marker forever.
    """
    import queue
    import threading

    q_decoded: "queue.Queue" = queue.Queue(maxsize=4)
    q_marked: "queue.Queue" = queue.Queue(maxsize=4)
    errors: list = []
    stop = threading.Event()

    def put(q, item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def reader():
        try:
            chunk = []
            for fi in frames:
                if stop.is_set():
                    return
                try:
                    img = video.get_frame(fi)
                except Exception:
                    continue
                chunk.append((fi, img))
                if len(chunk) >= _RENDER_CHUNK:
                    put(q_decoded, chunk)
                    chunk = []
            if chunk:
                put(q_decoded, chunk)
        except BaseException as e:  # propagate to the writer thread
            errors.append(e)
        finally:
            put(q_decoded, None)

    def marker():
        try:
            while not stop.is_set():
                try:
                    chunk = q_decoded.get(timeout=0.05)
                except queue.Empty:
                    continue
                if chunk is None:
                    break
                put(q_marked, [mark(fi, img) for fi, img in chunk])
        except BaseException as e:
            errors.append(e)
        finally:
            put(q_marked, None)

    threads = [
        threading.Thread(target=reader, name="sleap-render-reader", daemon=True),
        threading.Thread(target=marker, name="sleap-render-marker", daemon=True),
    ]
    for t in threads:
        t.start()
    try:
        while True:
            chunk = q_marked.get()
            if chunk is None:
                break
            for out in chunk:
                writer.add_frame(out, bgr=True)
    finally:
        stop.set()  # the workers give up their waits and end
        for t in threads:
            t.join()
    if errors:
        raise errors[0]


def main(args=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Render annotated video.")
    parser.add_argument("data_path", help="Path to labels (.slp).")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("-f", "--fps", type=float, default=15.0)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--frames", default="", help="e.g. 0-100 or 3,5,7")
    parser.add_argument("--video-index", type=int, default=0)
    parser.add_argument("--marker_size", type=int, default=4)
    parser.add_argument(
        "--background", default="original",
        help="original | black | grey | white (reference visuals.py:719)",
    )
    parser.add_argument(
        "--crop", default="",
        help="crop size around instances as WIDTH,HEIGHT (empty = full frame)",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="decode and encode on the CPU instead of the card",
    )
    ns = parser.parse_args(args)

    device = "cpu" if ns.cpu else "cuda"
    labels = Labels.load_file(ns.data_path, device=device)
    frames = None
    if ns.frames:
        frames = []
        for part in ns.frames.split(","):
            if "-" in part:
                a, b = part.split("-")
                frames.extend(range(int(a), int(b) + 1))
            elif part:
                frames.append(int(part))
    # Reference default naming (visuals.py:743): <data_path>.avi. The
    # OpenCV/imageio writer picks the codec from the extension.
    out = ns.output or (ns.data_path + ".avi")
    crop_size_xy = None
    if ns.crop:
        cw, ch = ns.crop.split(",")
        crop_size_xy = (int(cw), int(ch))
    save_labeled_video(
        out,
        labels,
        video=labels.videos[ns.video_index],
        frames=frames,
        fps=ns.fps,
        scale=ns.scale,
        crop_size_xy=crop_size_xy,
        background=ns.background,
        marker_size=ns.marker_size,
        device=device,
    )
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
