"""The port's configuration (``ImageGameConfig``)."""
