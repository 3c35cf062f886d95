"""Batched pyramidal Lucas-Kanade optical flow (port of
:mod:`sleap_tpu.ops.optical_flow`).

The flow-shift tracker moves each prior instance's points onto the new frame
with this op. It is the JAX package's algorithm, step for step:

- a Gaussian pyramid of ``max_levels`` halvings, each a zero-padded "SAME"
  separable 5-tap ``[1, 4, 6, 4, 1] / 16`` blur (rows, then columns) and a
  ``[::2, ::2]`` subsample; it is written as shifted float32 adds, so no
  convolution library (and no TF32) takes part;
- per level, coarse to fine: the template patch and its central-difference
  gradients, the 2x2 structure tensor, its smaller eigenvalue as the
  ``well_posed`` test, then ``max_iters`` Newton steps in which a point
  stops moving once it is ``done`` (set after a step shorter than ``eps``)
  or ill-posed; between levels the flow doubles, ``g = 2 (g + d)``;
- status: finite input point, well posed at every level, and inside
  ``[0, W-1] x [0, H-1]``; errors are the mean |patch difference| at level 0.

Patches are bilinear samples with taps outside the image read as zero,
rows blended before columns, as the JAX form's ``Wy @ img @ Wx^T`` does;
here they are a two-tap gather from each pyramid level, padded by two zero
rows and columns on every side, so that a tap index clamped to the pad
reads zero. Every tensor carries a leading batch of frame pairs, so one call
tracks all pairs of a frame, and the fixed-count loops never read a value
back to the host. Plain tensor code on the inputs' device: the JAX op is
XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

# cv2.pyrDown's 5-tap kernel.
_PYR_KERNEL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
# Zero rows and columns around each pyramid level (see ``_sample_patches``).
_PAD = 2


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur and halve (..., H, W) float32 images to (..., ceil(H/2), ceil(W/2)).

    Only the kept rows and columns are blurred: each output depends on its
    own row's and column's taps, so this equals blurring everything first.
    """
    h, w = img.shape[-2:]
    rows = F.pad(img, (0, 0, 2, 2))
    n = (h + 1) // 2
    out = _PYR_KERNEL[0] * rows[..., 0:2 * n - 1:2, :]
    for t in range(1, 5):
        out = out + _PYR_KERNEL[t] * rows[..., t:t + 2 * n - 1:2, :]
    cols = F.pad(out, (2, 2))
    n = (w + 1) // 2
    res = _PYR_KERNEL[0] * cols[..., 0:2 * n - 1:2]
    for t in range(1, 5):
        res = res + _PYR_KERNEL[t] * cols[..., t:t + 2 * n - 1:2]
    return res


def build_pyramid(img: torch.Tensor, max_levels: int) -> List[torch.Tensor]:
    """Levels 0..max_levels of (B, H, W) images, each zero-padded by
    ``_PAD`` on every side, as :func:`lk_flow_pyramids` takes them."""
    img = img.float()
    levels = [img]
    for _ in range(max_levels):
        levels.append(pyr_down(levels[-1]))
    return [F.pad(level, (_PAD,) * 4) for level in levels]


def _last_taps(padded: torch.Tensor, device) -> torch.Tensor:
    """``[[[W]], [[H]]]`` of a padded level: the last tap index along x and
    y that :func:`_sample_patches` keeps (in the zero pad)."""
    h, w = padded.shape[-2] - 2 * _PAD, padded.shape[-1] - 2 * _PAD
    return torch.tensor([[[w]], [[h]]], dtype=torch.float32).to(device)


def _sample_patches(padded: torch.Tensor, centers: torch.Tensor, offsets: torch.Tensor,
                    taps01: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(B, P, w, w) bilinear patches of a padded (B, H+4, W+4) level
    around (B, P, 2) xy centers, zero beyond the image. ``offsets`` are the
    window's (w,) offsets, ``taps01`` is ``[0., 1.]`` and ``last`` is
    ``[[[W]], [[H]]]``, all on the device.

    Both axes and both taps of a sample go through each op at once: a
    tap's weight is ``1 - |coord - tap|``, the JAX form's hat weight for the
    same row or column. Tap indices clamp into the zero pad (rows -2..H+1,
    columns -2..W+1 of the image), where taps outside the image read zero.
    The two taps are summed rows first, then columns, each sum a single
    float32 add, as the JAX form's two contractions give.
    """
    B, hp, wp = padded.shape
    P, win = centers.shape[1], offsets.shape[0]
    coords = centers[..., :, None] + offsets  # (B, P, 2, w): x, then y
    taps = torch.floor(coords)[..., None] + taps01  # (B, P, 2, w, 2)
    weights = 1.0 - (coords[..., None] - taps).abs()
    index = (taps.clamp(min=-_PAD).minimum(last) + _PAD).long()
    ix, iy = index.unbind(2)  # (B, P, w, 2)
    flat = (iy.view(B, P, win, 1, 2, 1) * wp + ix.view(B, P, 1, win, 1, 2)).view(B, -1)
    vals = padded.reshape(B, -1).gather(1, flat).view(B, P, win, win, 2, 2)
    wx, wy = weights.unbind(2)
    cols = (wy.view(B, P, win, 1, 2, 1) * vals).sum(dim=-2)  # (B, P, w, w, 2 columns)
    return (wx.view(B, P, 1, win, 2) * cols).sum(dim=-1)


def lk_flow_pyramids(
    ref_pyr: Sequence[torch.Tensor],
    new_pyr: Sequence[torch.Tensor],
    points: torch.Tensor,
    window_size: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track (B, P, 2) xy points from each ref pyramid to its new pyramid
    (levels from :func:`build_pyramid`, (B, H+4, W+4) each).

    Returns shifted (B, P, 2) xy, NaN where the status is False, status
    (B, P) bool, and errors (B, P), the mean |patch difference| at level 0.
    """
    max_levels = len(ref_pyr) - 1
    dev = points.device
    half = (window_size - 1) // 2
    offsets = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    taps01 = torch.arange(2, dtype=torch.float32, device=dev)
    points = points.float()
    ok = ~torch.isnan(points).any(dim=-1)
    pts = torch.nan_to_num(points)
    P = pts.shape[1]
    # The template patch and its four neighbours one pixel along x and y.
    shifts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]).to(dev)

    g = torch.zeros_like(pts)  # flow carried from the coarser levels
    err = torch.zeros_like(pts[..., 0])
    for level in range(max_levels, -1, -1):
        rimg, nimg = ref_pyr[level], new_pyr[level]
        p = pts / (2.0 ** level)
        ref_grid = (offsets, taps01, _last_taps(rimg, dev))
        new_grid = (offsets, taps01, _last_taps(nimg, dev))
        five = _sample_patches(rimg, (p[:, None] + shifts[:, None]).flatten(1, 2), *ref_grid)
        patch_i, xp, xm, yp, ym = five.unflatten(1, (5, P)).unbind(1)
        grad = torch.stack([(xp - xm) / 2.0, (yp - ym) / 2.0], dim=2)  # (B, P, 2, w, w)
        gxx, gxy, gyy = ((grad[:, :, i] * grad[:, :, j]).sum(dim=(-2, -1))
                         for i, j in ((0, 0), (0, 1), (1, 1)))
        det = gxx * gyy - gxy * gxy
        trace = gxx + gyy
        min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) / 2.0
        well_posed = min_eig / float(window_size ** 2) > min_eig_threshold
        inv = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
        # delta = [[gyy, -gxy], [-gxy, gxx]] * inv @ b, as two columns times b.
        col0 = torch.stack([gyy * inv, -gxy * inv], dim=-1)
        col1 = torch.stack([-gxy * inv, gxx * inv], dim=-1)
        # frozen = done | ~well_posed, where done turns on after a step
        # shorter than eps and stays on.
        frozen = ~well_posed[..., None]

        d = torch.zeros_like(pts)
        pg = p + g
        for _ in range(max_iters):
            diff = patch_i - _sample_patches(nimg, pg + d, *new_grid)
            b = (grad * diff[:, :, None]).sum(dim=(-2, -1))  # (B, P, 2)
            delta = col0 * b[..., :1] + col1 * b[..., 1:]
            d = torch.where(frozen, d, d + delta)
            frozen = frozen | (delta.square().sum(dim=-1, keepdim=True).sqrt() < eps)
        g = 2.0 * (g + d) if level > 0 else g + d
        ok = ok & well_posed
        if level == 0:
            patch_j = _sample_patches(nimg, p + g, *new_grid)
            err = (patch_i - patch_j).abs().mean(dim=(-2, -1))

    new_pt = pts + g
    h = ref_pyr[0].shape[-2] - 2 * _PAD
    w = ref_pyr[0].shape[-1] - 2 * _PAD
    ok = (ok & (new_pt[..., 0] >= 0) & (new_pt[..., 0] <= w - 1)
          & (new_pt[..., 1] >= 0) & (new_pt[..., 1] <= h - 1))
    shifted = torch.where(ok[..., None], new_pt, torch.full_like(new_pt, float("nan")))
    return shifted, ok, err


def lk_flow(
    ref_img: torch.Tensor,
    new_img: torch.Tensor,
    points: torch.Tensor,
    window_size: int = 21,
    max_levels: int = 3,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track points from ``ref_img`` to ``new_img`` (the JAX ``lk_flow``).

    Args:
        ref_img / new_img: (H, W) grayscale, or (B, H, W) for B pairs.
        points: (P, 2) xy, or (B, P, 2); NaN points come out NaN with
            status False.

    Returns:
        shifted (.., P, 2) xy in ``new_img``, status (.., P) bool, errors
        (.., P) mean |patch difference|; batched as the inputs are.
    """
    batched = ref_img.dim() == 3
    if not batched:
        ref_img, new_img, points = ref_img[None], new_img[None], points[None]
    shifted, status, err = lk_flow_pyramids(
        build_pyramid(ref_img, max_levels), build_pyramid(new_img, max_levels), points,
        window_size=window_size, max_iters=max_iters, eps=eps,
        min_eig_threshold=min_eig_threshold,
    )
    if not batched:
        shifted, status, err = shifted[0], status[0], err[0]
    return shifted, status, err
