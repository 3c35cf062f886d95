"""PyTorch + CUDA port of sleap-tpu's top-down inference path.

The JAX package (``sleap_tpu``) is the reference: this package mirrors its
module names (``models/``, ``data/``, ``ops/``, ``inference/``) and keeps its
public layouts (NHWC images and confidence maps, ``(samples, channels, K, 2)``
peaks, NaN/0/mask for empty slots) so each function can be checked against
its JAX counterpart on the same inputs.

The three Pallas kernels on the top-down path are hand-written CUDA kernels
for Hopper (``csrc/``, bound in ``ops/cuda_peaks.py`` and ``ops/cuda_crops.py``).
A CPU tensor runs the plain PyTorch version of each kernel; a CUDA tensor
launches the kernel or raises. Nothing here imports JAX.
"""


def load_model(*args, **kwargs):
    from sleap_tpu_torch.inference.predictors import load_model as _load_model

    return _load_model(*args, **kwargs)
