"""production-stack-tpu on PyTorch and CUDA: the serving engine ported to
NVIDIA Hopper.

Module paths mirror ``production_stack_tpu`` so each module's counterpart
is easy to find; this package imports ``torch`` and nothing of the JAX
package. Paged attention runs on hand-written CUDA kernels (``csrc/``:
ragged, decode and prefill) on the card, and on their plain PyTorch
versions for CPU tensors.

Layout:
  engine/    serving engine (scheduler, paged KV, runner, OpenAI server)
  models/    Llama-class decoder over the head-major paged cache
  ops/       layers, the gather-path oracle, the paged-attention kernels
  csrc/      CUDA C++ sources, built at first use
  utils/     logging
"""

__version__ = "0.1.0"
