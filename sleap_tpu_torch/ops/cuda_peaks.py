"""Peak-finding kernels for Hopper: wrappers, plain versions, launch counts.

Two CUDA kernels (``csrc/peaks.cu``) replace the Pallas kernels of
:mod:`sleap_tpu.ops.pallas_peaks` on the top-down path:

``global_peaks`` <- ``find_global_peaks_integral_pallas`` / ``_peak_kernel``
    Per (sample, channel) map: the max, the first-occurrence argmax and the
    integral-regression centroid of the (2*half+1)^2 window around it (zero
    outside the map); xy is NaN below threshold. ``half < 0`` gives the
    unrefined grid peak (``find_global_peaks_rough``). Bound by reading the
    maps once: on the top-down main path (64 crops x 13 nodes of 40x40 f32)
    that is 832 maps x 1,600 x 4 B = 5.3 MB per batch, against a few hundred
    FLOPs per map. Design: one thread block per map reads it in place
    through the NHWC view's strides (no transpose copy, which would double
    the bytes), reduces (max, min index at max) with warp shuffles, and one
    warp takes the 25-tap window sum.

``local_peaks`` <- ``find_local_peaks_fused_pallas`` / ``_local_peaks_kernel``
    Strict 8-neighbour NMS above threshold (border = -inf), the top K by
    value with ties to the smallest row-major index, optional integral
    refinement on the raw map; empty slots are -inf. On large maps it is
    bound by reading them (each pixel and its 8 neighbours; neighbours hit
    L1); at the main path's 16 centroid maps of 64^2 (256 KB) it is bound by
    latency instead: one block per map gives 16 blocks for 132 SMs, and the
    K merge rounds are serial. Design: one block per map, threads stride
    over the pixels applying the NMS test from global memory (right at any
    H x W: a 512^2 map does not fit in shared memory), each thread keeps a
    sorted top-K of its own pixels, and K rounds of block argmax over the
    list heads merge them; then one warp per peak refines. K <= 64.

A CPU tensor runs the plain version (:func:`global_peaks_plain`,
:func:`local_peaks_plain`); a CUDA tensor launches the kernel, and anything
else raises. The plain versions are also what the tests and ``chip_smoke.py``
hold the kernels against. Tolerance: values, masks and integer peak
locations are exact; refined xy agree within 1e-4 px (window sums in
another order, FMA contraction).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MAX_K = 64


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #


def integral_regression(
    cms: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted centroid of (samples, height, width, channels) maps."""
    z = cms.sum(dim=(1, 2))
    x_hat = (xv.reshape(1, 1, -1, 1) * cms).sum(dim=(1, 2)) / z
    y_hat = (yv.reshape(1, -1, 1, 1) * cms).sum(dim=(1, 2)) / z
    return x_hat, y_hat


def extract_patches(
    maps: torch.Tensor, xy: torch.Tensor, map_inds: torch.Tensor, size: int
) -> torch.Tensor:
    """(size, size) patches of (n_maps, H, W) maps centred on integer peaks.

    Zero outside the map. NaN peaks read the patch at (0, 0); callers rely
    on the NaN of the peak itself instead.
    """
    half = size // 2
    H, W = maps.shape[1], maps.shape[2]
    padded = F.pad(maps, (half, half, half, half))
    x = torch.nan_to_num(xy[:, 0]).long().clamp(0, W - 1)
    y = torch.nan_to_num(xy[:, 1]).long().clamp(0, H - 1)
    offs = torch.arange(size, device=maps.device)
    rows = (y[:, None] + offs)[:, :, None]
    cols = (x[:, None] + offs)[:, None, :]
    return padded[map_inds[:, None, None], rows, cols]


def _integral_refine(maps: torch.Tensor, xy: torch.Tensor, map_inds: torch.Tensor,
                     half: int) -> torch.Tensor:
    size = 2 * half + 1
    patches = extract_patches(maps, xy, map_inds, size)[..., None]
    gv = torch.arange(size, dtype=torch.float32, device=maps.device) - half
    dx, dy = integral_regression(patches, xv=gv, yv=gv)
    return xy + torch.cat([dx, dy], dim=1)


def _flat_maps(cms: torch.Tensor) -> torch.Tensor:
    S, H, W, C = cms.shape
    return cms.permute(0, 3, 1, 2).reshape(S * C, H, W).float()


def global_peaks_plain(
    cms: torch.Tensor, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``global_peaks``'s contract in plain PyTorch.

    Args:
        cms: (S, H, W, C) maps.
        half: integral window half-size; < 0 for the grid peak.

    Returns:
        xy (S, C, 2), NaN below threshold; vals (S, C).
    """
    S, H, W, C = cms.shape
    maps = _flat_maps(cms)
    flat = maps.reshape(S * C, H * W)
    vals = flat.amax(dim=1)
    lin = torch.arange(H * W, device=cms.device)
    idx = torch.where(flat == vals[:, None], lin, H * W).amin(dim=1)  # first occurrence
    xy = torch.stack([idx % W, idx // W], dim=-1).float()
    if half >= 0:
        xy = _integral_refine(maps, xy, torch.arange(S * C, device=cms.device), half)
    xy = torch.where((vals < threshold)[:, None], float("nan"), xy)
    return xy.reshape(S, C, 2), vals.reshape(S, C)


def local_peaks_plain(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``local_peaks``'s contract in plain PyTorch.

    Args:
        cms: (S, H, W, C) maps.
        half: integral window half-size; < 0 for unrefined peaks.

    Returns:
        peaks (S, C, K, 2), NaN in empty slots; vals (S, C, K), -inf in
        empty slots.
    """
    S, H, W, C = cms.shape
    K = max_peaks
    maps = _flat_maps(cms)
    padded = F.pad(maps, (1, 1, 1, 1), value=float("-inf"))
    nbr = torch.full_like(maps, float("-inf"))
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) != (1, 1):
                nbr = torch.maximum(nbr, padded[:, dy:dy + H, dx:dx + W])
    is_peak = (maps > nbr) & (maps > threshold)
    masked = torch.where(is_peak, maps, float("-inf")).reshape(S * C, H * W)
    if H * W < K:
        masked = F.pad(masked, (0, K - H * W), value=float("-inf"))
    # Stable descending sort: equal values keep ascending index order.
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    peaks = torch.stack([idx % W, idx // W], dim=-1).float()
    if half >= 0:
        map_inds = torch.arange(S * C, device=cms.device).repeat_interleave(K)
        peaks = _integral_refine(maps, peaks.reshape(-1, 2), map_inds, half)
    peaks = torch.where(torch.isfinite(vals).reshape(-1, 1), peaks.reshape(-1, 2), float("nan"))
    return peaks.reshape(S, C, K, 2), vals.reshape(S, C, K)


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #


def _check_maps(cms: torch.Tensor) -> None:
    if cms.device.type != "cuda":
        raise ValueError(f"The CUDA peak kernels take CUDA tensors, got {cms.device}.")
    if cms.dtype != torch.float32 or cms.ndim != 4:
        raise ValueError(f"Expected (S, H, W, C) float32 maps, got {cms.dtype} {tuple(cms.shape)}.")
    if cms.shape[1] * cms.shape[2] >= 2**31:
        raise ValueError("Maps larger than 2**31 pixels are not supported.")


def _launch(name: str, cms: torch.Tensor, *args) -> None:
    from sleap_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), name)
    with torch.cuda.device(cms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cms.data_ptr(), *cms.stride(), *cms.shape, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}.")


def global_peaks_cuda(
    cms: torch.Tensor, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``global_peaks``; same contract as :func:`global_peaks_plain`."""
    _check_maps(cms)
    S, H, W, C = cms.shape
    xy = torch.empty((S, C, 2), dtype=torch.float32, device=cms.device)
    vals = torch.empty((S, C), dtype=torch.float32, device=cms.device)
    if S * C == 0:
        return xy, vals
    _launch("sleap_global_peaks", cms, float(threshold), int(half), xy.data_ptr(), vals.data_ptr())
    global_peaks_cuda.launches += 1
    return xy, vals


global_peaks_cuda.launches = 0


def local_peaks_cuda(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``local_peaks``; same contract as :func:`local_peaks_plain`."""
    _check_maps(cms)
    if not 1 <= max_peaks <= MAX_K:
        raise ValueError(f"The local peaks kernel takes 1 <= max_peaks <= {MAX_K}, got {max_peaks}.")
    S, H, W, C = cms.shape
    peaks = torch.empty((S, C, max_peaks, 2), dtype=torch.float32, device=cms.device)
    vals = torch.empty((S, C, max_peaks), dtype=torch.float32, device=cms.device)
    if S * C == 0:
        return peaks, vals
    _launch(
        "sleap_local_peaks", cms, int(max_peaks), float(threshold), int(half),
        peaks.data_ptr(), vals.data_ptr(),
    )
    local_peaks_cuda.launches += 1
    return peaks, vals


local_peaks_cuda.launches = 0


# --------------------------------------------------------------------------- #
# Device dispatch
# --------------------------------------------------------------------------- #


def global_peaks(cms: torch.Tensor, threshold: float, half: int):
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if cms.device.type == "cpu":
        return global_peaks_plain(cms, threshold, half)
    return global_peaks_cuda(cms, threshold, half)


def local_peaks(cms: torch.Tensor, max_peaks: int, threshold: float, half: int):
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if cms.device.type == "cpu":
        return local_peaks_plain(cms, max_peaks, threshold, half)
    return local_peaks_cuda(cms, max_peaks, threshold, half)
