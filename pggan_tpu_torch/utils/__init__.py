"""Checkpoint files and sample images."""
