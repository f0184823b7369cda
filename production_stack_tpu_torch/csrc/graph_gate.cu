// A CUDA graph whose first part runs only while some lane is live: the
// fused decode loop's iteration with the JAX loop's `while` test made on
// the device (engine/programs.GatedProgramVariant).
//
// PyTorch captures the iteration's forward and its sampling step as two
// graphs in the runner's shared memory pool (kept, not instantiated);
// pst_graph_gate_build joins them into one graph built here:
//
//   memset(out, 0) -> pst_any_live(done) -> IF { child: forward } -> child: post
//
// `pst_any_live` sets the IF node's condition to "some done[i] is false",
// so a launch whose lanes are all done skips the forward and the
// sampling step reads the zeros the memset left in its logits. The child
// nodes copy the captured graphs, which keep addressing PyTorch's pool:
// the caller keeps those graphs' tensors alive while the built graph
// lives. Plain C interface (ctypes); every entry returns a cudaError_t,
// 0 on success.

#include <cuda_runtime.h>
#include <stddef.h>

__global__ void pst_any_live(cudaGraphConditionalHandle handle,
                             const bool* done, int n) {
  unsigned live = 0;
  for (int i = 0; i < n; ++i) live |= done[i] ? 0u : 1u;
  cudaGraphSetConditional(handle, live);
}

extern "C" int pst_graph_gate_build(void* forward, void* post, void* out,
                                    size_t out_bytes, const void* done,
                                    int n, void** exec_out,
                                    void** graph_out) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t zero, test, gate, fwd_node, post_node;
  cudaMemsetParams mp = {};
  mp.dst = out;
  mp.value = 0;
  mp.elementSize = 4;
  mp.width = out_bytes / 4;
  mp.height = 1;
  void* args[] = {&handle, (void*)&done, &n};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)pst_any_live;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphExec_t exec = nullptr;
  if ((e = cudaGraphConditionalHandleCreate(&handle, g, 0, 0)) ||
      (e = cudaGraphAddMemsetNode(&zero, g, nullptr, 0, &mp)) ||
      (e = cudaGraphAddKernelNode(&test, g, &zero, 1, &kp)))
    goto fail;
  cp.conditional.handle = handle;
  if ((e = cudaGraphAddNode(&gate, g, &test, 1, &cp)) ||
      (e = cudaGraphAddChildGraphNode(&fwd_node, cp.conditional.phGraph_out[0],
                                      nullptr, 0, (cudaGraph_t)forward)) ||
      (e = cudaGraphAddChildGraphNode(&post_node, g, &gate, 1,
                                      (cudaGraph_t)post)) ||
      (e = cudaGraphInstantiate(&exec, g, 0)))
    goto fail;
  *exec_out = exec;
  *graph_out = g;
  return cudaSuccess;
fail:
  cudaGraphDestroy(g);
  return e;
}

extern "C" int pst_graph_gate_launch(void* exec, void* stream) {
  return cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int pst_graph_gate_destroy(void* exec, void* graph) {
  cudaError_t e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
  return e != cudaSuccess ? e : f;
}
