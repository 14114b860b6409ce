// Conditional IF and WHILE nodes for a CUDA graph under stream capture: the
// device side of the driver's graph loop (krylov_tpu_torch/_graphs.py).
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
//
// krylov_graph_while_begin(parent, counter, limit, body, handle): the same
// with a WHILE node, whose kernel sets the handle to (*counter < *limit)
// (two int64 device scalars); the handle is written to *handle.
// krylov_graph_while_end(body, counter, limit, handle) captures, as the
// body's last node, a kernel that adds one to *counter and sets the handle
// again, then ends the body's capture: the body runs while counter < limit,
// limit - counter times for a counter below the limit, and none otherwise.
// The counter is the loop's index; the body may read it.

#include <cuda_runtime.h>

namespace {

__global__ void krylov_set_if(cudaGraphConditionalHandle handle, const bool* flag,
                              bool negate) {
  cudaGraphSetConditional(handle, (*flag != negate) ? 1u : 0u);
}

__global__ void krylov_set_while(cudaGraphConditionalHandle handle, long long* counter,
                                 const long long* limit, int advance) {
  long long c = *counter + advance;
  if (advance) *counter = c;
  cudaGraphSetConditional(handle, c < *limit ? 1u : 0u);
}

#if CUDART_VERSION >= 12040
// A conditional node of `type` on a new handle after the kernel that
// `launch(handle)` captures on `parent`; starts capturing `body` into it.
template <typename Launch>
int begin_conditional(cudaStream_t ps, cudaStream_t bs, cudaGraphConditionalNodeType type,
                      cudaGraphConditionalHandle* out, Launch launch) {
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
  launch(handle);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end at the kernel just captured
  err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  if (out) *out = handle;
  return cudaStreamBeginCaptureToGraph(bs, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeThreadLocal);
}
#endif

}  // namespace

extern "C" {

int krylov_graph_if_begin(void* parent, const void* flag, int negate, void* body) {
#if CUDART_VERSION >= 12040
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  return begin_conditional(ps, static_cast<cudaStream_t>(body), cudaGraphCondTypeIf, nullptr,
                           [&](cudaGraphConditionalHandle h) {
                             krylov_set_if<<<1, 1, 0, ps>>>(h, static_cast<const bool*>(flag),
                                                            negate != 0);
                           });
#else
  (void)parent; (void)flag; (void)negate; (void)body;
  return cudaErrorNotSupported;
#endif
}

int krylov_graph_if_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

int krylov_graph_while_begin(void* parent, void* counter, const void* limit, void* body,
                             unsigned long long* handle) {
#if CUDART_VERSION >= 12040
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaGraphConditionalHandle h = 0;
  int err = begin_conditional(ps, static_cast<cudaStream_t>(body), cudaGraphCondTypeWhile, &h,
                              [&](cudaGraphConditionalHandle hh) {
                                krylov_set_while<<<1, 1, 0, ps>>>(
                                    hh, static_cast<long long*>(counter),
                                    static_cast<const long long*>(limit), 0);
                              });
  *handle = h;
  return err;
#else
  (void)parent; (void)counter; (void)limit; (void)body; (void)handle;
  return cudaErrorNotSupported;
#endif
}

int krylov_graph_while_end(void* body, void* counter, const void* limit,
                           unsigned long long handle) {
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  krylov_set_while<<<1, 1, 0, bs>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                    static_cast<long long*>(counter),
                                    static_cast<const long long*>(limit), 1);
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t ended = cudaStreamEndCapture(bs, &graph);
  return launched != cudaSuccess ? launched : ended;
}

// The CUDA runtime's version, for the error a too-old toolkit gives.
int krylov_graph_runtime_version() {
  int v = 0;
  cudaRuntimeGetVersion(&v);
  return v;
}

}  // extern "C"
