"""Shared helpers."""

from production_stack_tpu_torch.utils.log import init_logger

__all__ = ["init_logger"]
