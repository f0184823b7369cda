"""Compiled serving programs: the port's counterpart of the JAX runner's
jitted program variants.

The JAX engine runs every round as one jitted program keyed by its
padded shape (the bucket tuple of ``_decode_fns``, ``_decode_multi_fns``
...), and counts each build as a compile event. Here a *program
variant* is one such key's static device buffers and, on the card, a
CUDA graph captured over them:

- ``inputs`` holds the static tensors the variant's function reads (a
  loop's carry is written back into them in place; a scratch buffer,
  such as the embed programs' caches, is read and written in place).
  The caller copies a dispatch's values into them before each run;
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

A gated variant (``GatedProgramVariant``, the fused loop's iteration
under device stops) runs its forward only while some lane is live: the
test is made on the device at each replay, in a CUDA graph conditional
node built by csrc/graph_gate.cu around the captured forward (PyTorch
offers no conditional node of its own here).
Python's garbage collector is held off while a capture runs: a dead
runner collected mid-capture would destroy its graphs there, which the
capture does not permit.
"""

from __future__ import annotations

import gc

import torch

from production_stack_tpu_torch.ops import paged_attention


class ProgramVariant:
    """One program key's static buffers and (on the card) its graph.

    `fn(inputs)` returns a tuple of output tensors (None for an absent
    one). `pool` is the runner's graph pool handle; `guard()` returns
    the addresses the graph bakes in (the KV caches, the LoRA buffers),
    which must not move between capture and replay."""

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
        self._replay()
        self.replays += 1
        paged_attention.add_launches(self.launches)
        return self.outputs

    def _replay(self) -> None:
        self.graph.replay()

    def _capture(self) -> tuple:
        """Capture `fn` into the pool -> (graph, outputs, pool bytes
        added)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            # read inside: entering the capture empties the allocator's
            # cache, and what the capture allocates comes from the pool
            reserved = torch.cuda.memory_reserved(self.device)
            captured = self.fn(self.inputs)
        return (graph, captured,
                torch.cuda.memory_reserved(self.device) - reserved)

    def _warm_and_capture(self) -> tuple:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(self.inputs)
        cur.wait_stream(side)
        for t in out:
            # made on the side stream, read on this one
            if t is not None:
                t.record_stream(cur)
        before = paged_attention.launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph, captured, added = self._capture()
        finally:
            if collecting:
                gc.enable()
        after = paged_attention.launch_counts()
        # the capture recorded these launches; it ran none of them
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        paged_attention.add_launches(
            {k: -n for k, n in self.launches.items()})
        self.graph, self.outputs, self.pool_bytes = graph, captured, added
        if self.guard is not None:
            self._addresses = self.guard()
        return out


def _gate_fns() -> tuple:
    """csrc/graph_gate.cu's (build, launch, destroy) entries, the kernel
    library built and loaded on first use."""
    import ctypes

    from production_stack_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    vp = ctypes.c_void_p
    sigs = {"pst_graph_gate_build": [vp, vp, vp, ctypes.c_size_t, vp,
                                     ctypes.c_int, ctypes.POINTER(vp),
                                     ctypes.POINTER(vp)],
            "pst_graph_gate_launch": [vp, vp],
            "pst_graph_gate_destroy": [vp, vp]}
    fns = []
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns.append(fn)
    return tuple(fns)


class GatedProgramVariant(ProgramVariant):
    """A program `post(inputs, forward(inputs))` whose forward runs only
    while some lane is live: `done(inputs)` is a (b,) bool device tensor
    among the inputs, `forward` returns a float32 tensor. On the card the
    forward and `post` are captured as two graphs in the shared pool and
    joined by csrc/graph_gate.cu into one graph that zeroes the forward's
    output, tests `done` on the device and runs the forward under an IF
    conditional node, then `post`: a replay whose lanes are all done
    skips the forward, and `post` reads zeros. Its launches are counted
    on every replay, a skipped forward's too."""

    def __init__(self, kind: str, key: tuple, forward, post, done,
                 inputs: dict, device: torch.device, pool=None, guard=None):
        super().__init__(kind, key, lambda inp: post(inp, forward(inp)),
                         inputs, device, pool, guard)
        self.forward, self.post, self.done = forward, post, done
        # the built graph's (exec, graph) handles and its destroy entry
        self._gate = None
        self._destroy = None

    def _capture(self) -> tuple:
        import ctypes

        build, self._launch, self._destroy = _gate_fns()
        parts = []
        added = 0
        for fn in (lambda: self.forward(self.inputs),
                   lambda: self.post(self.inputs, parts[0][1])):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                out = fn()
            added += torch.cuda.memory_reserved(self.device) - reserved
            parts.append((graph, out))
        (fwd_graph, logits), (post_graph, captured) = parts
        done = self.done(self.inputs)
        if (logits.dtype != torch.float32 or not logits.is_contiguous()
                or done.dtype != torch.bool or not done.is_contiguous()):
            raise RuntimeError(
                f"{self.kind} program {self.key}: a gated forward needs a "
                "contiguous float32 output and a contiguous bool `done`")
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        rc = build(fwd_graph.raw_cuda_graph(), post_graph.raw_cuda_graph(),
                   logits.data_ptr(), logits.numel() * 4, done.data_ptr(),
                   done.numel(), ctypes.byref(exec_), ctypes.byref(graph))
        if rc:
            raise RuntimeError(f"{self.kind} program {self.key}: building "
                               f"its gated CUDA graph failed: CUDA error {rc}")
        self._gate = (exec_.value, graph.value)
        # the captured graphs hold the pool's blocks the built graph
        # addresses, the forward's output among them
        return (fwd_graph, post_graph, logits), captured, added

    def _replay(self) -> None:
        rc = self._launch(self._gate[0],
                          torch.cuda.current_stream(self.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{self.kind} program {self.key}: its gated "
                               f"CUDA graph's launch failed: CUDA error {rc}")

    def __del__(self):
        if self._gate is not None:
            self._destroy(*self._gate)
