"""The benchmark of the PyTorch and CUDA port (production_stack_tpu_torch):
one command, ``python3 portbench/run.py``, serves a cell's traffic
through ``AsyncLLMEngine.generate`` on one H100 and prints its metrics.
See run.py."""
