"""Tools that describe and clean labels and run folders on the host:
``sleap-inspect`` (``labels``), the analysis export (``write_tracking_h5``),
instance metrics, per-frame statistics, alignment, labeling suggestions and
track cleaning (``metrics``, ``summary``, ``align``, ``suggestions``,
``trackcleaner``)."""
