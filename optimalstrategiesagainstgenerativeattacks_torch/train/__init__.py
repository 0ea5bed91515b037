"""Losses, game state, the image game's train step and loop, checkpoints and logger."""
