"""Checkpoints, run logging and profiling."""
