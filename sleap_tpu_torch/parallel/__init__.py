"""Multi-card execution: device meshes (:mod:`.mesh`), data-parallel
inference and training, and the multi-host helpers (:mod:`.distributed`)."""
