"""PyTorch + CUDA port of sleap-tpu: inference (top-down, single-instance,
bottom-up, multiclass), flow-shift tracking, training and evaluation,
``.slp`` and video I/O, export (``torch.export`` programs of every
predictor), and the ``sleap-track``, ``sleap-train``, ``sleap-export`` and
``sleap-inspect`` CLIs (``python -m sleap_tpu_torch.cli.track``,
``python -m sleap_tpu_torch.cli.train``, ``python -m
sleap_tpu_torch.cli.export``, ``python -m sleap_tpu_torch.info.labels``),
and ``sleap-diagnostic`` (``python -m sleap_tpu_torch.diagnostic``);
the shipped training profiles are in ``training_profiles/``.

The JAX package (``sleap_tpu``) is the reference: this package mirrors its
module names (``models/``, ``data/``, ``ops/``, ``inference/``) and keeps its
public layouts (NHWC images and confidence maps, ``(samples, channels, K, 2)``
peaks, NaN/0/mask for empty slots) so each function can be checked against
its JAX counterpart on the same inputs.

The four Pallas kernels of those paths are hand-written CUDA kernels for
Hopper (``csrc/``, bound in ``ops/cuda_peaks.py`` and ``ops/cuda_crops.py``).
Each is a custom op, ``torch.ops.sleap_tpu_torch.*``: a CPU tensor runs the
plain PyTorch version of the kernel, a CUDA tensor launches the kernel, and
any other tensor raises.

Nothing here imports JAX or the JAX package ``sleap_tpu``: run folders,
skeletons, videos, providers and ``Labels`` are the port's own copies in
plain Python (``config.py``, ``core/``, ``io/``, ``data/``), so
``load_model(folder)`` runs where only PyTorch is installed; orbax
checkpoints (``best_model.ckpt``) are read by the port's own zstd, OCDBT and
zarr readers, and ``.slp`` files, HDF5 videos and Keras weights by its own
HDF5 reader and writer and still-image codecs (PNG, JPEG, BMP, TIFF:
``io/stills.py``). ``h5py`` is never imported; ``cv2`` only inside the
functions that read media videos on the CPU (frames of videos that differ
in size are resized by the port's own copy of OpenCV's bilinear resize,
``data/resizing.resize_linear_uint8``). Entry points run on ``"cuda"``
unless the caller passes another device.
"""


def load_model(*args, **kwargs):
    from sleap_tpu_torch.inference.predictors import load_model as _load_model

    return _load_model(*args, **kwargs)


def export_model(*args, **kwargs):
    """Export trained run folder(s) as a ``torch.export`` program
    (:func:`sleap_tpu_torch.inference.export.export_model`)."""
    from sleap_tpu_torch.inference.export import export_model as _export_model

    return _export_model(*args, **kwargs)


def load_file(*args, **kwargs):
    """Read a ``.slp`` file into the port's ``Labels``."""
    from sleap_tpu_torch.core.labels import load_file as _load_file

    return _load_file(*args, **kwargs)


def load_metrics(*args, **kwargs):
    """Read a run folder's saved evaluation metrics (``metrics.{split}.npz``)."""
    from sleap_tpu_torch.evals import load_metrics as _load_metrics

    return _load_metrics(*args, **kwargs)


def load_config(*args, **kwargs):
    """A training config from a JSON file or a run folder
    (:func:`sleap_tpu_torch.config.load_config`)."""
    from sleap_tpu_torch.config import load_config as _load_config

    return _load_config(*args, **kwargs)


def system_summary():
    """Print the CUDA devices (:func:`sleap_tpu_torch.system.summary`)."""
    from sleap_tpu_torch.system import summary

    summary()
