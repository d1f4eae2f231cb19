"""Checkpoints with mid-epoch resume, and scalar metric logging."""
