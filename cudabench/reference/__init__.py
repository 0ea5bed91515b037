"""The plain f32 reference of the GIM image game (imports nothing of the program)."""
