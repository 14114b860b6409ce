// Conditional IF nodes for a CUDA graph under stream capture: the device
// side of the driver's graph loop (krylov_tpu_torch/_graphs.py).
//
// Plain C interface, loaded with ctypes.  Needs CUDA 12.4 or later (a
// conditional node with a body captured from a stream).
//
// krylov_graph_if_begin(parent, flag, negate, body): in the graph that
// `parent` is capturing, (1) make a conditional handle, (2) capture a
// one-thread kernel that sets the handle to (*flag != negate) each time
// the graph runs, (3) add an IF node on that handle after it, make the IF
// node the parent stream's only dependency, and (4) start capturing `body`
// into the IF node's body graph.  Work enqueued on `body` until
// krylov_graph_if_end(body) runs on the device only when the flag read
// true (false with `negate`).  Nodes the parent captures afterwards
// depend on the whole IF node.
//
// The flag is read by the device when the graph is replayed, never by the
// host, so a solve that enqueues several replays reads its stop flag once.
// Bodies may hold IF nodes of their own (nested captures on other streams).
//
// The kernel reads one byte and calls cudaGraphSetConditional: it is the
// whole of what replaces the host's bool(stop) read of each step.

#include <cuda_runtime.h>

namespace {

__global__ void krylov_set_if(cudaGraphConditionalHandle handle, const bool* flag,
                              bool negate) {
  cudaGraphSetConditional(handle, (*flag != negate) ? 1u : 0u);
}

}  // namespace

extern "C" {

int krylov_graph_if_begin(void* parent, const void* flag, int negate, void* body) {
#if CUDART_VERSION >= 12040
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  krylov_set_if<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(flag), negate != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end at the kernel just captured
  err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(bs, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeThreadLocal);
#else
  (void)parent; (void)flag; (void)negate; (void)body;
  return cudaErrorNotSupported;
#endif
}

int krylov_graph_if_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// The CUDA runtime's version, for the error a too-old toolkit gives.
int krylov_graph_runtime_version() {
  int v = 0;
  cudaRuntimeGetVersion(&v);
  return v;
}

}  // extern "C"
