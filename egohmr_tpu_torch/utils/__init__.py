"""Checkpoint files."""
