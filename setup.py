"""Package setup for sleap-tpu."""

from setuptools import find_packages, setup

setup(
    name="sleap-tpu",
    version="0.1.0",
    description=(
        "TPU-native multi-animal pose estimation and tracking (JAX/XLA/Pallas)"
    ),
    packages=find_packages(
        include=["sleap_tpu", "sleap_tpu.*", "sleap_tpu_torch", "sleap_tpu_torch.*"]
    ),
    package_data={
        "sleap_tpu": ["skeletons/*.json", "training_profiles/*.json"],
        "sleap_tpu_torch": ["csrc/*.cu", "skeletons/*.json", "training_profiles/*.json"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "attrs",
        "h5py",
        "networkx",
        "scipy",
        "opencv-python-headless",
    ],
    entry_points={
        "console_scripts": [
            "sleap-train=sleap_tpu.cli.train:main",
            "sleap-track=sleap_tpu.cli.track:main",
            "sleap-export=sleap_tpu.cli.export:main",
            "sleap-convert=sleap_tpu.io.convert:main",
            "sleap-render=sleap_tpu.io.visuals:main",
            "sleap-inspect=sleap_tpu.info.labels:main",
            "sleap-diagnostic=sleap_tpu.diagnostic:main",
        ],
    },
)
