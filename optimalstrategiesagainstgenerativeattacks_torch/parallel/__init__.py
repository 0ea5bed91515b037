"""Data-parallel training: one process a card, gradients all-reduced (``mesh.py``)."""
