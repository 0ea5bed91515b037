"""Baseline authenticators (Siamese, ArcFace) and their training."""
