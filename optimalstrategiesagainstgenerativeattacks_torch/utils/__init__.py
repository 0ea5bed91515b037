"""The port's configuration (``ImageGameConfig``) and its ``args.json`` round-trip."""
