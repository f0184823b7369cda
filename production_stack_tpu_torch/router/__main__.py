"""`python -m production_stack_tpu_torch.router` — router CLI entry.

Parity: reference pyproject.toml:32 `vllm-router` console script → app.main.
"""

from production_stack_tpu_torch.router.app import main

if __name__ == "__main__":
    main()
