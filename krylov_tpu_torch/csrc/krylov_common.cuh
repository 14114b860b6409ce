// Types and conversions shared by the kernels of csrc/*.cu.
//
// Each .cu file is compiled on its own and linked into one library with a
// plain C interface; everything here is a template, inline or an enum, so
// the files can all include it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes, shared with the Python wrappers (krylov_tpu_torch/ops/cuda_*.py)
enum {
  KRYLOV_F32 = 0,
  KRYLOV_BF16 = 1,
  KRYLOV_F64 = 2,
  KRYLOV_C64 = 3,
  KRYLOV_C128 = 4
};

// Complex value as two reals: the layout of torch.complex64/complex128.
// Products and sums follow the textbook formulas, as XLA's do; a real
// times a complex scales both parts, as a weak-typed Python float does.
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r, R i = R(0)) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ cplx<R> operator*(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

template <typename R>
__device__ __forceinline__ cplx<R> operator*(R a, cplx<R> b) {
  return cplx<R>(a * b.re, a * b.im);
}

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re + b.re, a.im + b.im);
}

template <typename R>
__device__ __forceinline__ cplx<R> operator-(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re - b.re, a.im - b.im);
}

template <typename R>
__device__ __forceinline__ cplx<R>& operator+=(cplx<R>& a, cplx<R> b) {
  a.re += b.re;
  a.im += b.im;
  return a;
}

typedef cplx<float> c64;
typedef cplx<double> c128;

template <typename A, typename T>
__device__ __forceinline__ A to_acc(T v) { return static_cast<A>(v); }
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

// Sum of one value per thread over the block, in a fixed order (shuffle tree
// inside each warp, then warp 0 over the warp sums): deterministic.
template <typename A>
__device__ A block_sum(A v) {
  __shared__ A warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? warp_sums[lane] : A(0);
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
}
