"""Plain tensor functions of the image game (NCHW inside the port)."""
