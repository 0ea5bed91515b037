"""Episodic image datasets and the batch loader (host side, numpy uint8)."""
