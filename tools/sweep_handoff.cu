// Latency of one hand-off in the triangular sweeps' chains, for the chain
// bound of S1 and S2 (tools/torch_sweeps.py --handoff builds this file with
// nvcc and loads it with ctypes; it is not part of the package's library).
//
// cluster_handoff: a cluster of C CTAs; each step thread 0 of every CTA
// publishes a value in its shared memory, the cluster barrier (arrive.release
// / wait.acquire, as S1's) follows, and every thread reads the next CTA's
// value through distributed shared memory and adds one: the step after
// depends on that read.  block_handoff: one CTA; each step every thread
// writes a value to shared memory, a block barrier, and every thread reads
// another warp's value (S2's hand-off from one level to the next).  Both
// double-buffer the published value by step parity, as the kernels do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// mode (both kernels): 0 nothing else; 1 each step also issues a load from
// device memory (`big`, far apart, past the L2 cache) consumed the step
// after, as S1 and S2 prefetch their next row or level; 2 each step also
// stores to device memory before the barrier.  cluster_handoff with
// `relaxed` arrives by barrier.cluster.arrive.relaxed (no ordering) instead.
__device__ __forceinline__ size_t far(int i, long long nbig) {
  return ((size_t)i * 1048576u + (size_t)(blockIdx.x * blockDim.x + threadIdx.x) * 8u) %
         (size_t)nbig;
}

__global__ void cluster_handoff(int steps, float* out, const float* big, long long nbig,
                                float* sink, int mode, int relaxed) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float slot[2];
  const int r = (int)cl.block_rank();
  const int C = (int)cl.num_blocks();
  float v = (float)r;
  float pre = mode == 1 ? big[far(0, nbig)] : 0.0f;
  if (threadIdx.x == 0) slot[0] = slot[1] = 0.0f;
  cl.sync();
  for (int i = 0; i < steps; ++i) {
    float nxt = 0.0f;
    if (mode == 1) nxt = big[far(i + 1, nbig)];
    if (mode == 2) sink[far(i, nbig)] = v;
    if (threadIdx.x == 0) slot[i & 1] = v;
    if (relaxed) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    v = *cl.map_shared_rank(&slot[i & 1], (r + 1) % C) + 1.0f + pre;
    pre = nxt;
  }
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

__global__ void block_handoff(int steps, float* out, const float* big, long long nbig,
                              float* sink, int mode) {
  __shared__ float slot[2][1024];
  const int t = threadIdx.x;
  float v = (float)t;
  float pre = mode == 1 ? big[far(0, nbig)] : 0.0f;
  for (int i = 0; i < steps; ++i) {
    float nxt = 0.0f;
    if (mode == 1) nxt = big[far(i + 1, nbig)];
    if (mode == 2) sink[far(i, nbig)] = v;
    slot[i & 1][t] = v;
    __syncthreads();
    v = slot[i & 1][(t + 33) % blockDim.x] + 1.0f + pre;
    pre = nxt;
  }
  out[t] = v;
}

extern "C" {

// One launch of `steps` hand-offs on `stream`: kind 0 a cluster of C CTAs
// of nt threads, kind 1 one CTA of nt threads; mode and relaxed as above,
// `big` and `sink` nbig floats each.  Returns a CUDA error code.
int sweep_handoff(int kind, int C, int nt, int steps, int mode, int relaxed, float* out,
                  const float* big, float* sink, long long nbig, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 1) {
    block_handoff<<<1, nt, 0, s>>>(steps, out, big, nbig, sink, mode);
    return (int)cudaGetLastError();
  }
  if (C > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(cluster_handoff, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, 1, 1);
  cfg.blockDim = dim3((unsigned)nt, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cluster_handoff, steps, out, big, nbig, sink, mode, relaxed);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
