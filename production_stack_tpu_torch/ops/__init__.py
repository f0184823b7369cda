"""Compute ops: PyTorch layers + hand-written CUDA paged attention."""
