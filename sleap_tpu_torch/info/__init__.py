"""Tools that describe labels files and run folders (``sleap-inspect``)."""
