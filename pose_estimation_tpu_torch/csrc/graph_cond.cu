// Conditional nodes of a CUDA graph under stream capture: the device's
// counterparts of the JAX package's lax.while_loop (a WHILE node, for the
// LM solves, graphs.py:iterate) and lax.cond (an IF node, for the frame
// step's branches, graphs.py:cond).
//
// Inside the capture of a parent stream, `graph_while_begin` or
// `graph_if_begin` records a one-thread kernel that sets a new conditional
// handle from a bool flag in device memory, adds a conditional node (CUDA
// 12.4+) of its type after it to the graph the parent stream captures
// into, makes the node the parent's only capture dependency, and starts
// capturing a second stream into the node's body graph. The parent may itself be capturing a
// conditional body: the nodes nest. The caller then issues the body on
// that stream and ends it with `graph_while_end` or `graph_if_end`.
//
// WHILE: the body ends with the flag of the next test, and
// `graph_while_end` records the same kernel there; at replay the node runs
// its body while the flag was true when last set, so once the loop's
// condition fails no more of the body runs, as JAX's loop stops. IF: the
// node runs its body once if the flag was true before it, else skips it,
// as JAX runs one side of a lax.cond. torch's
// CUDAGraph.begin_capture_to_if_node is not in every torch with CUDA 12.8
// (torch 2.11 lacks it), so the nodes are bound here, through the
// runtime's graph API.
//
// Nothing here computes: the kernel is the branch's or the loop's test,
// one load and one call of cudaGraphSetConditional.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// Begin a conditional node of `type` on the graph that `parent` captures
// into, its condition from `flag` now, its body captured from `body` on.
int begin_conditional(cudaGraphConditionalNodeType type, void* parent, void* body,
                      const bool* flag, unsigned long long* handle_out, void** body_out) {
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
  params.conditional.type = type;
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

int end_body(cudaStream_t bs, cudaError_t e) {
  cudaGraph_t graph;
  const cudaError_t end = cudaStreamEndCapture(bs, &graph);
  return (int)(e != cudaSuccess ? e : end);
}

}  // namespace

// Begin a WHILE node: see begin_conditional. Returns a cudaError_t; the
// handle and the body graph go to `handle_out` and `body_out`.
extern "C" int graph_while_begin(void* parent, void* body, const bool* flag,
                                 unsigned long long* handle_out, void** body_out) {
  return begin_conditional(cudaGraphCondTypeWhile, parent, body, flag, handle_out, body_out);
}

// End the body begun by graph_while_begin: record the next test from
// `flag` on `body` and end its capture.
extern "C" int graph_while_end(void* body, unsigned long long handle, const bool* flag) {
  const cudaStream_t bs = (cudaStream_t)body;
  set_condition_kernel<<<1, 1, 0, bs>>>((cudaGraphConditionalHandle)handle, flag);
  return end_body(bs, cudaGetLastError());
}

// Begin an IF node: see begin_conditional.
extern "C" int graph_if_begin(void* parent, void* body, const bool* flag,
                              unsigned long long* handle_out, void** body_out) {
  return begin_conditional(cudaGraphCondTypeIf, parent, body, flag, handle_out, body_out);
}

// End the body begun by graph_if_begin.
extern "C" int graph_if_end(void* body) {
  return end_body((cudaStream_t)body, cudaSuccess);
}
