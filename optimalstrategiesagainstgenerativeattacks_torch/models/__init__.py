"""The image game's authenticator and impersonator."""
