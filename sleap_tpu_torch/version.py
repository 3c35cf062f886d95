"""Version of the PyTorch port, recorded in the provenance of the ``.slp``
files its CLI writes."""

__version__ = "0.1.0"
