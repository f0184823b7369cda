"""Model families as functions over PyTorch tensors (params are dicts)."""

from production_stack_tpu_torch.models.config import ModelConfig, get_model_config

__all__ = ["ModelConfig", "get_model_config"]
