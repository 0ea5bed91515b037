"""``nn.Module`` building blocks of the image game."""
