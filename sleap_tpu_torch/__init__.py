"""PyTorch + CUDA port of sleap-tpu's inference paths (top-down,
single-instance, bottom-up, multiclass).

The JAX package (``sleap_tpu``) is the reference: this package mirrors its
module names (``models/``, ``data/``, ``ops/``, ``inference/``) and keeps its
public layouts (NHWC images and confidence maps, ``(samples, channels, K, 2)``
peaks, NaN/0/mask for empty slots) so each function can be checked against
its JAX counterpart on the same inputs.

The four Pallas kernels of those paths are hand-written CUDA kernels for
Hopper (``csrc/``, bound in ``ops/cuda_peaks.py`` and ``ops/cuda_crops.py``).
A CPU tensor runs the plain PyTorch version of each kernel; a CUDA tensor
launches the kernel or raises.

Nothing here imports JAX or the JAX package ``sleap_tpu``: run folders,
skeletons, videos, providers and ``Labels`` are the port's own copies in
plain Python (``config.py``, ``core/``, ``io/``, ``data/``), so
``load_model(folder)`` runs where only PyTorch is installed; orbax
checkpoints (``best_model.ckpt``) are read by the port's own zstd, OCDBT and
zarr readers (``io/``). ``h5py`` and
``cv2`` are imported only inside the functions that read Keras weights or
resize mixed-size frames. Entry points run on ``"cuda"`` unless the caller
passes another device.
"""


def load_model(*args, **kwargs):
    from sleap_tpu_torch.inference.predictors import load_model as _load_model

    return _load_model(*args, **kwargs)
