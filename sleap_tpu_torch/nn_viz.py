"""Matplotlib drawings of model outputs (port of :mod:`sleap_tpu.nn_viz`):
images, confidence maps, peaks, part affinity fields, instances and
skeleton preview PNGs.

matplotlib is imported inside each function. Arrays may be numpy or torch
tensors on any device; tensors are copied to the host first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor on any device (bf16 as float32), or the
    array itself."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("Drawing model outputs needs matplotlib, which is not installed.") from e
    return plt


def imgfig(size: float = 6, dpi: int = 72, scale: float = 1.0):
    """A borderless figure of ``size`` inches (a number or (w, h)) with one
    axes filling it."""
    plt = _pyplot()
    if not isinstance(size, (tuple, list)):
        size = (size, size)
    fig = plt.figure(figsize=(scale * size[0], scale * size[1]), dpi=dpi)
    ax = fig.add_axes([0, 0, 1, 1], frameon=False)
    ax.set_axis_off()
    return fig


def plot_img(img, dpi: int = 72, scale: float = 1.0):
    """An image in a borderless figure of its own pixel size."""
    img = np.squeeze(_host(img))
    fig = imgfig(size=float(max(img.shape[:2])) / dpi, dpi=dpi, scale=scale)
    ax = fig.axes[0]
    ax.imshow(
        img,
        cmap="gray" if img.ndim == 2 else None,
        origin="upper",
        extent=[-0.5, img.shape[1] - 0.5, img.shape[0] - 0.5, -0.5],
    )
    return fig


def plot_confmaps(confmaps, output_scale: float = 1.0) -> None:
    """Overlay (H, W, C) confidence maps on the current axes, one colour a
    channel."""
    plt = _pyplot()
    confmaps = _host(confmaps)
    ax = plt.gca()
    H, W, n = confmaps.shape
    colors = plt.cm.tab10(np.linspace(0, 1, max(n, 2)))
    composite = np.zeros((H, W, 4))
    for c in range(n):
        alpha = np.clip(confmaps[..., c], 0, 1)
        for k in range(3):
            composite[..., k] = np.maximum(composite[..., k], colors[c, k] * alpha)
        composite[..., 3] = np.maximum(composite[..., 3], alpha * 0.7)
    ax.imshow(composite, origin="upper",
              extent=[-0.5, W / output_scale - 0.5, H / output_scale - 0.5, -0.5])


def plot_peaks(pts_gt=None, pts_pr=None, paired: bool = False) -> None:
    """Ground-truth points as green dots and predicted ones as red crosses,
    joined pairwise with ``paired``."""
    plt = _pyplot()
    pts_gt = None if pts_gt is None else _host(pts_gt)
    pts_pr = None if pts_pr is None else _host(pts_pr)
    ax = plt.gca()
    if paired and pts_gt is not None and pts_pr is not None:
        for p1, p2 in zip(pts_gt.reshape(-1, 2), pts_pr.reshape(-1, 2)):
            ax.plot([p1[0], p2[0]], [p1[1], p2[1]], "r-", alpha=0.5, lw=1)
    if pts_gt is not None:
        pts = pts_gt.reshape(-1, 2)
        ax.plot(pts[:, 0], pts[:, 1], "g.", ms=8, label="GT")
    if pts_pr is not None:
        pts = pts_pr.reshape(-1, 2)
        ax.plot(pts[:, 0], pts[:, 1], "rx", ms=6, label="Predicted")


def plot_pafs(pafs, output_scale: float = 1.0, stride: int = 4, scale: float = 4.0) -> None:
    """Quiver plot of (H, W, 2 * edges) part affinity fields, every
    ``stride`` pixels."""
    plt = _pyplot()
    pafs = _host(pafs)
    ax = plt.gca()
    H, W = pafs.shape[:2]
    paf = pafs.reshape(H, W, -1, 2)
    yy, xx = np.mgrid[0:H:stride, 0:W:stride]
    for e in range(paf.shape[2]):
        u = paf[::stride, ::stride, e, 0]
        v = paf[::stride, ::stride, e, 1]
        ax.quiver(xx / output_scale, yy / output_scale, u, -v,
                  angles="xy", scale_units="xy", scale=1.0 / scale, width=0.002)


def plot_instance(instance, skeleton=None, cmap=None, color_by_node: bool = False,
                  **kwargs) -> None:
    """One instance (an ``Instance`` or (nodes, 2) points) on the current
    axes: its skeleton's edges where both ends are visible, and its
    points."""
    plt = _pyplot()
    ax = plt.gca()
    if isinstance(instance, torch.Tensor) or not hasattr(instance, "numpy"):
        pts = _host(instance)
    else:
        pts = instance.numpy()
    skeleton = skeleton or getattr(instance, "skeleton", None)
    if skeleton is not None:
        for src, dst in skeleton.edge_inds:
            p1, p2 = pts[src], pts[dst]
            if np.isnan(p1).any() or np.isnan(p2).any():
                continue
            ax.plot([p1[0], p2[0]], [p1[1], p2[1]], "-", lw=2, **kwargs)
    ax.plot(pts[:, 0], pts[:, 1], ".", ms=8, **kwargs)


def plot_instances(instances, **kwargs) -> None:
    for inst in instances:
        plot_instance(inst, **kwargs)


def generate_skeleton_preview_image(instance, box_size: int = 128) -> bytes:
    """PNG bytes of a small drawing of one pose (``box_size`` pixels
    square), drawn with the ``Agg`` backend."""
    import io

    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("Drawing a skeleton preview needs matplotlib, which is not "
                          "installed.") from e
    matplotlib.use("Agg")
    plt = _pyplot()
    fig = plt.figure(figsize=(2, 2), dpi=box_size // 2)
    ax = fig.add_axes([0, 0, 1, 1], frameon=False)
    ax.set_axis_off()
    plot_instance(instance)
    ax.invert_yaxis()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return buf.getvalue()
