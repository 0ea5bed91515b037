"""Losses, game state and the image game's train step."""
