"""Compiled serving programs: the port's counterpart of the JAX runner's
jitted program variants.

The JAX engine runs every round as one jitted program keyed by its
padded shape (the bucket tuple of ``_decode_fns``, ``_decode_multi_fns``
...), and counts each build as a compile event. Here a *program
variant* is one such key's static device buffers and, on the card, a
CUDA graph captured over them:

- ``inputs`` holds the static tensors the variant's function reads (a
  loop's carry is written back into them in place). The caller copies a
  dispatch's values into them before each run;
- on the card, the first run of a new variant executes the function
  eagerly on a side stream. That is the warm-up ``torch.cuda.graph``
  asks for (first-use uploads, the kernel library's load, cuBLAS
  handles), and it is that dispatch's real work. The function is then
  captured into a graph in the runner's shared memory pool, and every
  later run replays the graph;
- on the CPU there is no graph: each run calls the function eagerly on
  the same buffers, as a kernel wrapper computes its plain version on
  CPU tensors.

A replay runs no Python, so the kernel wrappers' launch counters do not
move: the launches made while capturing are recorded and added on every
replay. A graph's outputs live in the shared pool and stay valid only
until the next replay of any variant of that pool, so callers copy them
out first. Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.ops import paged_attention


class ProgramVariant:
    """One program key's static buffers and (on the card) its graph.

    `fn(inputs)` returns a tuple of output tensors. `pool` is the
    runner's graph pool handle; `guard()` returns the addresses the
    graph bakes in (the KV caches, the LoRA buffers), which must not
    move between capture and replay."""

    def __init__(self, kind: str, key: tuple, fn, inputs: dict,
                 device: torch.device, pool=None, guard=None):
        self.kind = kind
        self.key = key
        self.fn = fn
        self.inputs = inputs
        self.device = device
        self.pool = pool
        self.guard = guard
        self.graph = None
        self.outputs = None
        # kernel launches one replay makes, recorded at capture
        self.launches: dict[str, int] = {}
        # device memory the capture added to the shared pool (0 when it
        # fit in blocks earlier captures left free)
        self.pool_bytes = 0
        self.replays = 0
        self._addresses = None

    def run(self) -> tuple:
        """One execution on the current stream; returns the outputs."""
        if self.device.type != "cuda":
            return self.fn(self.inputs)
        if self.graph is None:
            return self._warm_and_capture()
        if self.guard is not None and self.guard() != self._addresses:
            raise RuntimeError(
                f"{self.kind} program {self.key}: a buffer its CUDA graph "
                "captured by address was reallocated (the KV caches and "
                "the LoRA buffers must be updated in place)")
        self.graph.replay()
        self.replays += 1
        paged_attention.add_launches(self.launches)
        return self.outputs

    def _warm_and_capture(self) -> tuple:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(self.inputs)
        cur.wait_stream(side)
        for t in out:
            # made on the side stream, read on this one
            t.record_stream(cur)
        before = paged_attention.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            # read inside: entering the capture empties the allocator's
            # cache, and what the capture allocates comes from the pool
            reserved = torch.cuda.memory_reserved(self.device)
            captured = self.fn(self.inputs)
        after = paged_attention.launch_counts()
        # the capture recorded these launches; it ran none of them
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        paged_attention.add_launches(
            {k: -n for k, n in self.launches.items()})
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.outputs = graph, captured
        if self.guard is not None:
            self._addresses = self.guard()
        return out
