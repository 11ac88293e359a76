// A conditional WHILE node in a CUDA graph under stream capture: the
// device's counterpart of the JAX package's lax.while_loop for the LM
// solves (graphs.py:iterate).
//
// Inside the capture of a parent stream, `graph_while_begin` records a
// one-thread kernel that sets a new conditional handle from a bool flag in
// device memory, adds a WHILE node (CUDA 12.4+) after it to the graph the
// parent stream captures into, makes the node the parent's only capture
// dependency, and starts capturing a second stream into the node's body
// graph. The caller then issues the loop's body on that stream, ending
// with the flag of the next test, and `graph_while_end` records the same
// kernel there and ends the body's capture. At replay the node runs its
// body while the flag was true when last set: once the loop's condition
// fails, no more of the body runs, as JAX's loop stops. torch's
// CUDAGraph.begin_capture_to_if_node, which would give an IF node, is not
// in every torch with CUDA 12.8 (torch 2.11 lacks it), so the node is
// bound here, through the runtime's graph API.
//
// Nothing here computes: the kernel is the loop's test, one load and one
// call of cudaGraphSetConditional.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

// Begin a WHILE node on the graph that `parent` captures into: its
// condition from `flag` now, its body captured from `body` on. Returns a
// cudaError_t; the handle and the body graph go to `handle_out` and
// `body_out`.
extern "C" int graph_while_begin(void* parent, void* body, const bool* flag,
                                 unsigned long long* handle_out, void** body_out) {
  const cudaStream_t ps = (cudaStream_t)parent, bs = (cudaStream_t)body;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition_kernel<<<1, 1, 0, ps>>>(handle, flag);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph(bs, body_graph, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = (unsigned long long)handle;
  *body_out = (void*)body_graph;
  return 0;
}

// End the body begun by graph_while_begin: record the next test from
// `flag` on `body` and end its capture.
extern "C" int graph_while_end(void* body, unsigned long long handle, const bool* flag) {
  const cudaStream_t bs = (cudaStream_t)body;
  set_condition_kernel<<<1, 1, 0, bs>>>((cudaGraphConditionalHandle)handle, flag);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t graph;
  const cudaError_t end = cudaStreamEndCapture(bs, &graph);
  return (int)(e != cudaSuccess ? e : end);
}
