"""Serving engine on PyTorch: continuous batching over a paged KV cache."""
