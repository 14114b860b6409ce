// Hand-written Hopper (sm_90a) kernel for block-sparse (BSR) operators:
// K12, Y = A X for ELL-padded BSR.
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_bsr.py).
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Format (the reference's): data (nbrows * max_blocks, R, C) row-major
// blocks, block row i's blocks at i * max_blocks ...; cols (nbrows,
// max_blocks) int32 block columns; zero blocks pointing at block column 0
// pad short block rows.  X is (nbcols * C, k) and Y (nbrows * R, k),
// row-major.
//
// ---------------------------------------------------------------------------
// K12: BSR SpMM.
//
// Replaces krylov_tpu/ops/pallas_bsr.py:bsr_spmm (_kernel).  Bound on this
// card: memory traffic for the block data, R * C values per stored block
// (padding included), read once; X's slabs are shared by the block rows
// that use the same block column, so they come from L2.  The TPU's
// Precision.HIGHEST asks for f32-accurate products, so both kernels
// multiply with plain FMAs in the data's own type: no TF32, no wgmma.
// Every sum is taken in a fixed order and there are no atomics, so a
// product repeats bit for bit.  Two kernels; krylov_bsr_spmm sends a call
// to the streamed one when `streamed` is set, which the wrapper does from
// the type, the shape and the alignment alone (k12_streamed there): rows of
// a block a whole number of 16-byte pieces (C * sizeof(T) % 16 == 0), all of
// k in KRYLOV_BSR_ROW_BYTES (k * sizeof(T) <= 128: 32 float columns), and
// data, x and y on 16-byte boundaries.  Everything else takes the general
// kernel.  Both are instantiated for f32, f64, complex64 and complex128.
//
// The streamed kernel.  The block data of one block row is one contiguous
// run and each value is used by one output row only, so it is streamed and
// not gathered.  A warp owns a work item: 32 rows of one block row (lane =
// row), all max_blocks blocks, all k columns, with its sums in registers
// (acc[KQ], KQ the number of columns rounded up).  It walks the item in
// stages of one block's 32 rows x 128 bytes of columns (32 floats) with the
// matching rows of the block's X slab (at most 128 bytes each), through a
// ring of KRYLOV_BSR_STAGES stages of its own in shared memory, filled by
// 16-byte cp.async copies (coalesced: eight lanes a staged row; they bypass
// L1 and the registers) and guarded by __syncwarp only: warps never wait for
// each other, and the KRYLOV_BSR_WARPS warps of a thread block only share
// its launch.  A staged row is padded to 144 bytes, so the lanes' 16-byte
// reads of their own rows fall on distinct banks; the X values are read by
// all lanes from one address (a broadcast), as 16-byte vectors where k is
// exactly KQ.  The cols of the block row are read by the warp once a block,
// when the stage's copies start, KRYLOV_BSR_STAGES stages ahead of their use.
// With the whole of k inside the warp, the block data is read from device
// memory once for any k the kernel takes.  Bytes in flight: two stages of
// 4.6 KB of block data a warp and some 20 warps an SM, against the ~17 KB an
// SM that 3.35 TB/s needs at the memory's latency; the general kernel had a
// few 16-byte requests a warp.  Measured on an H100 80GB HBM3 (700 W),
// device time inside a CUDA graph (tools/torch_kernel_sweep.py), f32: 4096
// block rows x 3 blocks of 32^2 at k = 1 / 8 / 16: 22.4 / 24.6 / 31.1 us
// (the general kernel 56.7 / 80.5 / 161.4; the bytes' bound 17.5 at k = 8);
// 256 x 3 blocks of 128^2 at k = 1 / 8: 21.8 / 23.5 us (21.5 / 51.1).
// Stages 2..4 and 1..8 warps a thread block stay within 24.6..30.1 us at
// the first shape: a warp of its own thread block (no warp waits for a
// slot until its whole block has left) and the smaller ring (more warps an
// SM) are each worth about 1 us.
//
// The general kernel: one warp per output row (block row i, row r) and
// column tile of KT columns (KT a power of two up to KRYLOV_BSR_COLS, the
// smallest that holds k).  Lane (g, q) = (lane / KT, lane % KT) takes
// column q of the tile and the block columns g, g + 32 / KT, ...; the warp
// walks the row's max_blocks blocks in order.  So each load of X reads
// 32 / KT slab rows of KT consecutive values (coalesced), the block's
// values are broadcast to the KT lanes of a group, and each lane keeps one
// partial sum.  The 32 / KT partials of a column meet in a fixed shuffle
// tree, and the first group's lanes store KT consecutive outputs.  It is
// latency-bound (82.6 us at 4096 x 3 blocks of 32^2, k = 8, on the H100
// 80GB HBM3 at 700 W, 21 % of the bytes' bound): 16-byte requests for the
// block data, the address chain cols -> X paid by every short-lived warp,
// and the block data streamed again for every column tile.  Two earlier
// versions were slower still: one thread block per block row with a
// barrier per 16 block columns (144-189 us at 256 x 3 blocks of 128^2),
// and a lane per block column holding all KT sums (133.9 us at the first
// shape).
// ---------------------------------------------------------------------------

#include "krylov_common.cuh"

#define KRYLOV_BSR_COLS 8  // columns of X per tile
#define KRYLOV_BSR_THREADS 256

__device__ __forceinline__ float shfl_down(float v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_down(double v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_down(cplx<R> v, int o) {
  return cplx<R>(shfl_down(v.re, o), shfl_down(v.im, o));
}

template <typename T, int KT>
__global__ void __launch_bounds__(KRYLOV_BSR_THREADS)
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, long long nrows,
                int max_blocks, int R, int C, int k) {
  constexpr int G = 32 / KT;  // lane groups, each over every G-th block column
  // the warp index is the same on all 32 lanes, so a warp exits whole
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  const int q = lane % KT;
  const int g = lane / KT;
  const long long i = row / R;
  const int r = (int)(row - i * R);
  const int col = blockIdx.y * KT + q;
  T acc = T(0);
  if (col < k) {
    // the next block's column is loaded a block ahead, so the X reads,
    // which wait on it, do not stall the start of every block
    int cnext = cols[i * max_blocks];
    for (int b = 0; b < max_blocks; ++b) {
      const long long blk = i * max_blocks + b;
      const int cb = cnext;
      if (b + 1 < max_blocks) cnext = cols[blk + 1];
      const T* arow = data + (blk * R + r) * C;
      const T* xb = x + (long long)cb * C * k + col;
      for (int c = g; c < C; c += G) acc += arow[c] * xb[(long long)c * k];
    }
  }
#pragma unroll
  for (int o = 16; o >= KT; o >>= 1) acc += shfl_down(acc, o);
  if (g == 0 && col < k) y[row * k + col] = acc;
}

// ---------------------------------------------------------------------------
// The streamed kernel.
// ---------------------------------------------------------------------------
#ifndef KRYLOV_BSR_STAGES
#define KRYLOV_BSR_STAGES 2  // stages of a warp's ring
#endif
#ifndef KRYLOV_BSR_WARPS
#define KRYLOV_BSR_WARPS 1  // warps (work items) of a thread block
#endif
#define KRYLOV_BSR_ROW_BYTES 128   // bytes of a block's row in one stage; the most k * sizeof(T)
#define KRYLOV_BSR_ROW_STRIDE 144  // a staged row with its padding
#define KRYLOV_BSR_SLICE 32        // rows of a work item: one a lane

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ void bsr_cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void bsr_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bsr_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct BsrArgs {
  const T* data;
  const int* cols;
  const T* x;
  T* y;
  int nbrows, max_blocks, R, C, k;
};

// Bytes of one stage: KRYLOV_BSR_SLICE padded rows of block data and the X
// rows that go with them.
static int bsr_stage_bytes(int k) {
  return KRYLOV_BSR_SLICE * KRYLOV_BSR_ROW_STRIDE + KRYLOV_BSR_ROW_BYTES * k;
}

template <typename T, int KQ, bool EXACT>
__global__ void __launch_bounds__(32 * KRYLOV_BSR_WARPS)
bsr_spmm_streamed_kernel(const BsrArgs<T> a, long long nitems, int slices, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char bsr_ring[];
  constexpr int VL = 16 / sizeof(T);                 // values of a 16-byte piece
  constexpr int CC = KRYLOV_BSR_ROW_BYTES / sizeof(T);  // block columns of a stage
  static_assert(!EXACT || KQ % VL == 0, "vector reads of X need whole pieces");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the item is the same on all 32 lanes, so a warp exits whole
  const long long item = blockIdx.x * (long long)KRYLOV_BSR_WARPS + warp;
  if (item >= nitems) return;
  const long long i = item / slices;
  const int r0 = (int)(item - i * slices) * KRYLOV_BSR_SLICE;
  const int nr = min(KRYLOV_BSR_SLICE, a.R - r0);
  const int nchunks = (a.C + CC - 1) / CC;
  const int nstages = a.max_blocks * nchunks;
  unsigned char* ring = bsr_ring + (size_t)warp * KRYLOV_BSR_STAGES * stage_bytes;

  // Stage t: block t / nchunks of the block row, its columns c0 .. c0 + cc - 1,
  // rows r0 .. r0 + nr - 1, and rows c0 .. c0 + cc - 1 of the block's X slab.
  auto fill = [&](int t) {
    const int b = t / nchunks;
    const int c0 = (t - b * nchunks) * CC;
    const int cc = min(CC, a.C - c0);
    const int np = cc / VL;  // 16-byte pieces of a staged row
    unsigned char* a_s = ring + (size_t)(t % KRYLOV_BSR_STAGES) * stage_bytes;
    const long long blk = i * a.max_blocks + b;
    const T* a_g = a.data + ((blk * a.R + r0) * (long long)a.C + c0);
    for (int idx = lane; idx < nr * np; idx += 32) {
      const int r = idx / np;
      const int j = idx - r * np;
      bsr_cp_async16(a_s + r * KRYLOV_BSR_ROW_STRIDE + 16 * j, a_g + (long long)r * a.C + j * VL);
    }
    const T* x_g = a.x + ((long long)a.cols[blk] * a.C + c0) * a.k;
    unsigned char* x_s = a_s + KRYLOV_BSR_SLICE * KRYLOV_BSR_ROW_STRIDE;
    const int nx = cc * a.k / VL;  // cc is a whole number of pieces
    for (int idx = lane; idx < nx; idx += 32) bsr_cp_async16(x_s + 16 * idx, x_g + idx * VL);
  };

  T acc[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) acc[q] = T(0);
  // one copy group a stage, empty once past the last, so "all but the newest
  // STAGES - 1 groups have landed" always means stage t
  for (int t = 0; t < KRYLOV_BSR_STAGES; ++t) {
    if (t < nstages) fill(t);
    bsr_cp_async_commit();
  }
  for (int t = 0; t < nstages; ++t) {
    bsr_cp_async_wait<KRYLOV_BSR_STAGES - 1>();
    __syncwarp();  // every lane's copies of stage t are visible to the warp
    const int c0 = (t % nchunks) * CC;
    const int np = min(CC, a.C - c0) / VL;
    const unsigned char* a_s = ring + (size_t)(t % KRYLOV_BSR_STAGES) * stage_bytes;
    const T* x_s = reinterpret_cast<const T*>(a_s + KRYLOV_BSR_SLICE * KRYLOV_BSR_ROW_STRIDE);
    if (lane < nr) {
      const unsigned char* arow = a_s + lane * KRYLOV_BSR_ROW_STRIDE;
      for (int j = 0; j < np; ++j) {
        const Vec16<T> av = *reinterpret_cast<const Vec16<T>*>(arow + 16 * j);
#pragma unroll
        for (int v = 0; v < VL; ++v) {
          const T* xr = x_s + (j * VL + v) * a.k;
          if constexpr (EXACT) {
#pragma unroll
            for (int q0 = 0; q0 < KQ; q0 += VL) {
              const Vec16<T> xv = *reinterpret_cast<const Vec16<T>*>(xr + q0);
#pragma unroll
              for (int u = 0; u < VL; ++u) acc[q0 + u] += av.v[v] * xv.v[u];
            }
          } else {
#pragma unroll
            for (int q = 0; q < KQ; ++q) {
              if (q < a.k) acc[q] += av.v[v] * xr[q];
            }
          }
        }
      }
    }
    __syncwarp();  // the stage is read; its slot may be filled again
    if (t + KRYLOV_BSR_STAGES < nstages) fill(t + KRYLOV_BSR_STAGES);
    bsr_cp_async_commit();
  }
  if (lane < nr) {
    T* yr = a.y + (i * a.R + r0 + lane) * (long long)a.k;
    if constexpr (EXACT) {
#pragma unroll
      for (int q0 = 0; q0 < KQ; q0 += VL) {
        Vec16<T> out;
#pragma unroll
        for (int u = 0; u < VL; ++u) out.v[u] = acc[q0 + u];
        *reinterpret_cast<Vec16<T>*>(yr + q0) = out;
      }
    } else {
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        if (q < a.k) yr[q] = acc[q];
      }
    }
  }
}

// Whether the streamed kernel takes this call: decided by the wrapper from
// the same facts (k12_streamed), checked here because a misaligned 16-byte
// copy faults.
template <typename T>
static bool bsr_streamed_ok(const BsrArgs<T>& a) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.data) | reinterpret_cast<uintptr_t>(a.x) |
                         reinterpret_cast<uintptr_t>(a.y);
  return (a.C * sizeof(T)) % 16 == 0 && a.k * sizeof(T) <= KRYLOV_BSR_ROW_BYTES &&
         bits % 16 == 0;
}

template <typename T, int KQ, bool EXACT>
static int launch_streamed_as(const BsrArgs<T>& a, cudaStream_t s) {
  const int slices = (a.R + KRYLOV_BSR_SLICE - 1) / KRYLOV_BSR_SLICE;
  const long long nitems = (long long)a.nbrows * slices;
  const long long gx = (nitems + KRYLOV_BSR_WARPS - 1) / KRYLOV_BSR_WARPS;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int stage_bytes = bsr_stage_bytes(a.k);
  const int smem = KRYLOV_BSR_WARPS * KRYLOV_BSR_STAGES * stage_bytes;
  const auto kernel = bsr_spmm_streamed_kernel<T, KQ, EXACT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)gx, 32 * KRYLOV_BSR_WARPS, smem, s>>>(a, nitems, slices, stage_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int KQ>
static int launch_streamed_kq(const BsrArgs<T>& a, cudaStream_t s) {
  return a.k == KQ ? launch_streamed_as<T, KQ, true>(a, s)
                   : launch_streamed_as<T, KQ, false>(a, s);
}

// KQ: the smallest of 1, 2, 4, 8 pieces of 16 bytes that holds k columns.
template <typename T>
static int launch_streamed(const BsrArgs<T>& a, cudaStream_t s) {
  constexpr int VL = 16 / sizeof(T);
  if (!bsr_streamed_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.k <= VL) return launch_streamed_kq<T, VL>(a, s);
  if (a.k <= 2 * VL) return launch_streamed_kq<T, 2 * VL>(a, s);
  if (a.k <= 4 * VL) return launch_streamed_kq<T, 4 * VL>(a, s);
  return launch_streamed_kq<T, 8 * VL>(a, s);
}

// ---------------------------------------------------------------------------
// The general kernel's launch.
// ---------------------------------------------------------------------------
template <typename T, int KT>
static void launch_tile(dim3 g, const T* d, const int* cols, const T* xt, T* yt,
                        long long nrows, int max_blocks, int R, int C, int k,
                        cudaStream_t s) {
  bsr_spmm_kernel<T, KT><<<g, KRYLOV_BSR_THREADS, 0, s>>>(d, cols, xt, yt, nrows,
                                                         max_blocks, R, C, k);
}

template <typename T>
static int launch_bsr(int streamed, const void* data, const int* cols, const void* x, void* y,
                      int nbrows, int max_blocks, int R, int C, int k,
                      cudaStream_t s) {
  if (streamed) {
    return launch_streamed(BsrArgs<T>{static_cast<const T*>(data), cols,
                                      static_cast<const T*>(x), static_cast<T*>(y), nbrows,
                                      max_blocks, R, C, k},
                           s);
  }
  const long long nrows = (long long)nbrows * R;
  const long long warps_per_block = KRYLOV_BSR_THREADS / 32;
  const long long gx = (nrows + warps_per_block - 1) / warps_per_block;
  int kt = 1;
  while (kt < k && kt < KRYLOV_BSR_COLS) kt *= 2;
  const long long gy = (k + kt - 1) / kt;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)gx, (unsigned)gy);
  const T* d = static_cast<const T*>(data);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (kt) {
    case 1: launch_tile<T, 1>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    case 2: launch_tile<T, 2>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    case 4: launch_tile<T, 4>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    default: launch_tile<T, 8>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int krylov_bsr_row_bytes() { return KRYLOV_BSR_ROW_BYTES; }

// K12.  tt: dtype code of data, x and y (f32, f64, c64, c128); streamed:
// nonzero for the streamed kernel (refused when its conditions do not hold).
int krylov_bsr_spmm(int tt, int streamed, const void* data, const int* cols, const void* x,
                    void* y, int nbrows, int max_blocks, int R, int C, int k,
                    void* stream) {
  if (nbrows < 1 || max_blocks < 1 || R < 1 || C < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case KRYLOV_F32: return launch_bsr<float>(streamed, data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_F64: return launch_bsr<double>(streamed, data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_C64: return launch_bsr<c64>(streamed, data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_C128: return launch_bsr<c128>(streamed, data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
