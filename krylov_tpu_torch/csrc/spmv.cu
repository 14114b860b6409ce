// Hand-written Hopper (sm_90a) kernels for general sparsity: CSR SpMV (K10)
// and CSR SpMM (K11).
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_spmv.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Format: CSR with int32 row pointers (n + 1) and int32 column indices, f32
// or bf16 values; x and y are f32 and every sum is taken in f32.  The TPU's
// PET page-ELL format (build_pet, _schedule_slots, the Dekker one-hot
// selection matmuls) exists because Mosaic has a single 128-lane gather;
// Hopper gathers x directly, so the kernels read plain CSR.
//
// There are no atomics: every row's sum is taken in an order fixed by the
// matrix alone, so a product repeats bit for bit.

#include "krylov_common.cuh"

#define KRYLOV_SPMV_THREADS 256
// entries each lane of a row's lane group sums, at least, before the row
// gets twice the lanes (K10's row sums out of shared memory)
#ifndef KRYLOV_SPMV_LANE_ENTRIES
#define KRYLOV_SPMV_LANE_ENTRIES 4
#endif

template <typename TV>
__device__ __forceinline__ float value_f32(TV v) { return to_acc<float>(v); }

// Four neighbouring stored values as one streaming load (16 bytes of f32, 8
// of bf16; p aligned to that).
__device__ __forceinline__ void load_values4(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_values4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// ---------------------------------------------------------------------------
// K10: CSR SpMV, y = A x.
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matvec (_pet_matvec_padded,
// _pet_kernel).  Bound on this card: memory traffic.  Bytes per call: 8 per
// stored entry for f32 values (value + int32 column; 6 for bf16), 4 per row
// for the row pointers and 4 per row for y, plus x once when the columns
// are local (x's reuse then hits L1/L2).
//
// Design: stream the entries, not the rows (CSR-stream, Greathouse and Daga
// 2014).  The host cuts the rows once per matrix into runs of whole rows
// that hold at most CAP - 3 stored entries (csr_runs in the wrapper); a
// block takes one run.  Phase 1: the block reads the run's values and
// columns front to back, 16 bytes a thread on neighbouring addresses
// (the run's first entry rounded down to a 16-byte boundary, hence the 3),
// every load of a thread in flight before the first is used, gathers x through
// the read-only cache and leaves the products in shared memory.  Every lane
// does the same work whatever the row lengths, and no load is strided; the
// streamed entries are marked evict-first so that they do not push x out of
// the caches.  Phase 2: rows are summed out of shared memory, a thread a row
// where the run's rows are short (a 5-point matrix: ~800 rows a run), a lane
// group of 2..32 lanes a row where they are long, chosen per run from its
// mean row length; a group's lanes take the row's entries in turn and meet
// in a shuffle tree of fixed shape.  A run of one row (the only run that may
// exceed CAP - 3 entries) is summed by the whole block: a partial a thread,
// then block_sum.  Empty rows write 0.  VEC = false (a base pointer that is
// not 16-byte aligned) reads the entries 4 bytes a thread instead, still on
// neighbouring addresses.  Several blocks share an SM, so one run's row sums
// overlap the next runs' loads.
// ---------------------------------------------------------------------------
template <int VPT, bool VEC, typename TV>
__global__ void __launch_bounds__(KRYLOV_SPMV_THREADS)
csr_stream_kernel(const int* __restrict__ runs, const int* __restrict__ indptr,
                  const int* __restrict__ indices, const TV* __restrict__ data,
                  const float* __restrict__ x, float* __restrict__ y, int nnz) {
  extern __shared__ __align__(16) float prod[];  // 4 * VPT * KRYLOV_SPMV_THREADS products
  const int tid = threadIdx.x;
  const int r0 = runs[blockIdx.x], r1 = runs[blockIdx.x + 1];
  const int e0 = indptr[r0], e1 = indptr[r1];
  if (r1 - r0 == 1) {  // one row, of any length
    float s = 0.0f;
    for (int e = e0 + tid; e < e1; e += KRYLOV_SPMV_THREADS) {
      s += value_f32(data[e]) * __ldg(x + indices[e]);
    }
    s = block_sum(s);
    if (tid == 0) y[r0] = s;
    return;
  }
  const int base = VEC ? (e0 & ~3) : e0;  // prod[k] holds entry base + k
  if (VEC) {
    int col[VPT][4];
    float val[VPT][4];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a + 4 <= nnz && a < e1) {
        const int4 c = __ldcs(reinterpret_cast<const int4*>(indices + a));
        col[i][0] = c.x; col[i][1] = c.y; col[i][2] = c.z; col[i][3] = c.w;
        load_values4(data + a, val[i]);
      } else {  // past the run, or the array's last, short quad
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = a + k < e1;
          col[i][k] = in ? indices[a + k] : 0;
          val[i][k] = in ? value_f32(data[a + k]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a < e1) {
        float4 p;
        p.x = val[i][0] * __ldg(x + col[i][0]);
        p.y = val[i][1] * __ldg(x + col[i][1]);
        p.z = val[i][2] * __ldg(x + col[i][2]);
        p.w = val[i][3] * __ldg(x + col[i][3]);
        *reinterpret_cast<float4*>(prod + (a - base)) = p;
      }
    }
  } else {
    int col[4 * VPT];
    float val[4 * VPT];
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      col[i] = e < e1 ? indices[e] : 0;
      val[i] = e < e1 ? value_f32(data[e]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      if (e < e1) prod[e - base] = val[i] * __ldg(x + col[i]);
    }
  }
  __syncthreads();
  const int mean = (e1 - e0) / (r1 - r0);
  int G = 1;  // lanes a row
  while (G < 32 && 2 * G * KRYLOV_SPMV_LANE_ENTRIES <= mean) G *= 2;
  const int lane = tid & (G - 1);
  for (int rb = r0; rb < r1; rb += KRYLOV_SPMV_THREADS / G) {  // uniform: the shuffles need every lane
    const int row = rb + tid / G;
    float s = 0.0f;
    if (row < r1) {
      const int end = indptr[row + 1] - base;
      for (int k = indptr[row] - base + lane; k < end; k += G) s += prod[k];
    }
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o, G);
    if (row < r1 && lane == 0) y[row] = s;
  }
}

template <int VPT, typename TV>
static void launch_stream(bool vec, int nruns, const int* runs, const int* indptr,
                          const int* indices, const TV* data, const float* x,
                          float* y, int nnz, cudaStream_t s) {
  const size_t smem = (size_t)4 * VPT * KRYLOV_SPMV_THREADS * sizeof(float);
  if (vec) {
    csr_stream_kernel<VPT, true, TV><<<nruns, KRYLOV_SPMV_THREADS, smem, s>>>(
        runs, indptr, indices, data, x, y, nnz);
  } else {
    csr_stream_kernel<VPT, false, TV><<<nruns, KRYLOV_SPMV_THREADS, smem, s>>>(
        runs, indptr, indices, data, x, y, nnz);
  }
}

template <typename TV>
static int launch_stream_for(int capacity, int nruns, const int* runs, const int* indptr,
                             const int* indices, const void* data, const float* x,
                             float* y, int nnz, cudaStream_t s) {
  const TV* d = static_cast<const TV*>(data);
  // the 16-byte loads need the column array on a 16-byte boundary and the
  // value array on one of four values
  const bool vec = reinterpret_cast<uintptr_t>(indices) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % (4 * sizeof(TV)) == 0;
  switch (capacity) {
    case 1024: launch_stream<1, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 2048: launch_stream<2, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 4096: launch_stream<4, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 8192: launch_stream<8, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11: CSR SpMM, Y = A X, X of shape (m, k) row-major, Y (n, k).
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matmat (_pet_matmat_padded,
// _pet_spmm_kernel).  Bound on this card: memory traffic.  Bytes per call,
// each input read once: 8 per stored entry for f32 values (6 for bf16), 4
// per row for the row pointers, 4 * k per row of X and of Y; on the 5-point
// Poisson CSR of 1024^2 rows that is 33.8 us at k = 8 and 53.8 us at k = 16
// at 3.35 TB/s.  The TPU's PET_SPMM_MAX_COLS = 16 and its
// column-in-lane-major relayout are VMEM artifacts and are not carried over.
//
// Design, against what held the first kernel (a thread or lane group a row,
// one 8-column tile of X a grid row) back:
//  1. One pass over the matrix for every column up to KRYLOV_SPMM_SLAB (32).
//     A block takes one run of whole rows (K10's runs, csr_runs in the
//     wrapper, cut once per matrix on the host) and all of a slab of up to
//     KRYLOV_SPMM_SLAB columns; slabs are the grid's y dimension, so a k
//     above the slab rereads the matrix stream once per slab, and only then.
//  2. X rows read whole, as 16-byte vectors.  Lane c of a row slot holds
//     the sums of the slab's columns 4c .. 4c + 3 (a float4); the slot's Cp
//     lanes (C = ceil(slab / 4) rounded up to a power of two) read one row
//     of X together, neighbouring lanes on neighbouring addresses.  XVEC
//     (k % 4 == 0, X and Y on 16-byte boundaries) loads and stores float4;
//     otherwise the same lanes load and store their columns as 4-byte
//     values.  Each lane has KRYLOV_SPMM_BATCH rows of X in flight before it
//     uses the first.
//  3. The run's column indices and values are read as K10 reads them: front
//     to back, 16 bytes a thread on neighbouring addresses, evict-first
//     (4-byte loads where the arrays lie off a 16-byte boundary), every
//     load of a thread in flight before the first is used, and staged in
//     shared memory as (column, f32 value) pairs beside the run's row
//     pointers, so that no lane waits on device memory for its row's bounds.
//  4. Balance by entries: runs hold at most capacity - 3 entries, so every
//     block has the same work whatever the row lengths.  Within a run, G
//     row slots (a power of two, G * Cp <= 32) share a row, G chosen per run
//     from its mean row length (each slot takes at least
//     KRYLOV_SPMM_LANE_ENTRIES entries before the row gets twice the slots),
//     so long rows are split across lanes and short rows do not idle them.
//     A run of one row (the only run that may exceed capacity - 3 entries)
//     is summed by the whole block straight from device memory.
//
// Measured on an H100 80GB HBM3 at 700 W, device time in a CUDA graph
// beside the first kernel in one call (tools/torch_kernel_sweep.py --only
// k11 --other): the Poisson CSR of 1024^2 rows at k = 8 / 16 / 32 in
// 47.4 / 73.8 / 156.9 us (the first kernel 63.6 / 236.0 / 886.7; bounds
// 33.8 / 53.8 / 93.9); the irregular CSR (2^20 rows, 27 entries a row
// within +-512 columns) in 196.9 / 251.8 / 420.8 us (437.9 / 1212.8 /
// 3713.9; bounds 88.9 / 108.9 / 149.0).  There a run's rows share few rows
// of X, so nearly every stored entry gathers its own: 64 B an entry at
// k = 16, 7.2 TB/s, twice what device memory gives, so from L2, whose rate
// and not the bytes' bound sets the pace.
//
// Tried on the same card and kept out
// (tools/torch_kernel_sweep.py --only k11, device time in a CUDA graph):
// runs of 4096 or 8192 entries (their registers leave 2-4 blocks an SM:
// 1.1-1.8x slower); blocks that stay and walk a stretch of runs, 2 to 16 an
// SM, so that an SM's L1 keeps the X rows of neighbouring runs (no faster
// at any k >= 8, up to 3.5x slower: a block's staging no longer overlaps
// other blocks' sums); more slots a row (KRYLOV_SPMM_LANE_ENTRIES 1 or 2:
// 7 % to 2.5x slower); on the 4-byte path lane c holding columns c,
// c + Cp, ... (4-6 % slower at k = 17); evict-first stores of Y (no
// change); no cap on the registers (54, 4 blocks an SM: up to 20 %
// slower).  Runs of 1024 entries are 20 % faster at k = 32 on the Poisson
// CSR and slower at k <= 16 on the irregular one, so K11 keeps K10's runs.
//
// Order of sums, fixed by the matrix and k alone (tests/test_torch_spmm.py
// models it on the host): per slab, C, Cp and per run G as above.  Slot t of
// a row takes the row's entries t, t + G, t + 2G, ... in order, each into
// its sums by one fused multiply-add starting from 0; the G slot sums meet
// in a shuffle-down tree (slot t += slot t + h, h = G/2, ..., 1).  A run of
// one row: S = 256 / Cp slots, slot t takes entries t, t + S, ... by FMA;
// the 32 / Cp slots of each warp meet in a shuffle-down tree, then the 8
// warp sums in the tree w += w + h, h = 4, 2, 1.  Empty rows write 0.  No
// atomics, so a product repeats bit for bit.
// ---------------------------------------------------------------------------
#define KRYLOV_SPMM_SLAB 32  // columns of X one pass over the matrix serves
#ifndef KRYLOV_SPMM_LANE_ENTRIES
#define KRYLOV_SPMM_LANE_ENTRIES 4
#endif
#ifndef KRYLOV_SPMM_MIN_BLOCKS
#define KRYLOV_SPMM_MIN_BLOCKS 5  // blocks an SM must hold: caps the registers at 51
#endif
#ifndef KRYLOV_SPMM_BATCH
#define KRYLOV_SPMM_BATCH 4  // X rows a lane has in flight
#endif
static_assert(KRYLOV_SPMM_SLAB % 4 == 0 && KRYLOV_SPMM_SLAB <= 128,
              "a slab is whole float4s and at most 32 lanes a row slot");
static_assert(KRYLOV_SPMV_THREADS == 256, "the one-row tree assumes 8 warps");

__device__ __forceinline__ float4 fma4(float v, float4 x, float4 s) {
  return make_float4(fmaf(v, x.x, s.x), fmaf(v, x.y, s.y), fmaf(v, x.z, s.z),
                     fmaf(v, x.w, s.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_down4(float4 v, int o, int width) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, o, width),
                     __shfl_down_sync(0xffffffffu, v.y, o, width),
                     __shfl_down_sync(0xffffffffu, v.z, o, width),
                     __shfl_down_sync(0xffffffffu, v.w, o, width));
}

// The nv (1..4) columns of a row of X at p that a lane holds; XVEC: all
// four as one 16-byte load.
template <bool XVEC>
__device__ __forceinline__ float4 load_x(const float* p, int nv) {
  if (XVEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  r.x = __ldg(p);
  if (nv > 1) r.y = __ldg(p + 1);
  if (nv > 2) r.z = __ldg(p + 2);
  if (nv > 3) r.w = __ldg(p + 3);
  return r;
}

template <bool XVEC>
__device__ __forceinline__ void store_y(float* p, float4 s, int nv) {
  if (XVEC) {
    *reinterpret_cast<float4*>(p) = s;
    return;
  }
  p[0] = s.x;
  if (nv > 1) p[1] = s.y;
  if (nv > 2) p[2] = s.z;
  if (nv > 3) p[3] = s.w;
}

template <int VPT, bool XVEC, typename TV>
__global__ void __launch_bounds__(KRYLOV_SPMV_THREADS, KRYLOV_SPMM_MIN_BLOCKS)
csr_spmm_kernel(const int* __restrict__ runs, const int* __restrict__ indptr,
                const int* __restrict__ indices, const TV* __restrict__ data,
                const float* __restrict__ X, float* __restrict__ Y, int nnz, int k,
                bool svec) {
  // 4 * VPT * KRYLOV_SPMV_THREADS staged (column, value) entries, stage[q]
  // entry base + q, then the run's row pointers less base, srow[i] row r0 + i
  extern __shared__ __align__(16) int2 stage[];
  int* srow = reinterpret_cast<int*>(stage + 4 * VPT * KRYLOV_SPMV_THREADS);
  const int tid = threadIdx.x;
  const int r0 = runs[blockIdx.x], r1 = runs[blockIdx.x + 1];
  const int e0 = indptr[r0], e1 = indptr[r1];
  const int c0 = blockIdx.y * KRYLOV_SPMM_SLAB;
  const int kslab = min(KRYLOV_SPMM_SLAB, k - c0);
  const int C = (kslab + 3) >> 2;  // lanes a row slot needs
  int lg = 0;
  while ((1 << lg) < C) ++lg;
  const int Cp = 1 << lg;  // lanes a row slot
  const int c = tid & (Cp - 1);
  const int nv = max(0, min(4, kslab - 4 * c));  // this lane's columns: 4c .. 4c + nv - 1
  const float* Xc = X + c0 + 4 * c;
  float* Yc = Y + c0 + 4 * c;

  if (r1 - r0 == 1) {  // one row, of any length: the whole block
    const int S = KRYLOV_SPMV_THREADS >> lg;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (nv > 0) {
      for (int e = e0 + (tid >> lg); e < e1; e += S) {
        s = fma4(value_f32(data[e]), load_x<XVEC>(Xc + (size_t)indices[e] * k, nv), s);
      }
    }
    for (int o = 16; o >= Cp; o >>= 1) s = add4(s, shfl_down4(s, o, 32));
    float4* part = reinterpret_cast<float4*>(stage);  // [warp][lane < Cp]
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < Cp) part[warp * Cp + lane] = s;
    __syncthreads();
    if (tid < Cp && nv > 0) {
      float4 w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = part[i * Cp + tid];
#pragma unroll
      for (int h = 4; h > 0; h >>= 1) {
#pragma unroll
        for (int i = 0; i < h; ++i) w[i] = add4(w[i], w[i + h]);
      }
      store_y<XVEC>(Yc + (size_t)r0 * k, w[0], nv);
    }
    return;
  }

  // phase 1: the run's columns, values and row pointers into shared memory
  const int base = svec ? (e0 & ~3) : e0;
  if (svec) {
    int col[VPT][4];
    float val[VPT][4];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a + 4 <= nnz && a < e1) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(indices + a));
        col[i][0] = q.x; col[i][1] = q.y; col[i][2] = q.z; col[i][3] = q.w;
        load_values4(data + a, val[i]);
      } else {  // past the run, or the array's last, short quad
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = a + j < e1;
          col[i][j] = in ? indices[a + j] : 0;
          val[i][j] = in ? value_f32(data[a + j]) : 0.0f;
        }
      }
    }
    for (int i = tid; i <= r1 - r0; i += KRYLOV_SPMV_THREADS) srow[i] = indptr[r0 + i] - base;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a < e1) {
        int4* dst = reinterpret_cast<int4*>(stage + (a - base));
        dst[0] = make_int4(col[i][0], __float_as_int(val[i][0]), col[i][1],
                           __float_as_int(val[i][1]));
        dst[1] = make_int4(col[i][2], __float_as_int(val[i][2]), col[i][3],
                           __float_as_int(val[i][3]));
      }
    }
  } else {
    int col[4 * VPT];
    float val[4 * VPT];
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      col[i] = e < e1 ? indices[e] : 0;
      val[i] = e < e1 ? value_f32(data[e]) : 0.0f;
    }
    for (int i = tid; i <= r1 - r0; i += KRYLOV_SPMV_THREADS) srow[i] = indptr[r0 + i] - base;
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      if (e < e1) stage[e - base] = make_int2(col[i], __float_as_int(val[i]));
    }
  }
  __syncthreads();

  // phase 2: G row slots of Cp lanes a row, rows in waves over the block
  const int mean = (e1 - e0) / (r1 - r0);
  int G = 1;
  while (G * Cp < 32 && 2 * G * KRYLOV_SPMM_LANE_ENTRIES <= mean) G *= 2;
  const int width = G * Cp;  // lanes a row
  const int t = (tid & (width - 1)) >> lg;  // this lane's row slot
  // the loop is uniform over the block: the shuffles need every lane
  for (int rb = 0; rb < r1 - r0; rb += KRYLOV_SPMV_THREADS / width) {
    const int i = rb + tid / width;  // the row r0 + i
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < r1 - r0 && nv > 0) {
      const int end = srow[i + 1];
      for (int q = srow[i] + t; q < end; q += G * KRYLOV_SPMM_BATCH) {
        float v[KRYLOV_SPMM_BATCH];
        float4 xv[KRYLOV_SPMM_BATCH];
#pragma unroll
        for (int u = 0; u < KRYLOV_SPMM_BATCH; ++u) {
          v[u] = 0.0f;
          xv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (q + u * G < end) {
            const int2 cv = stage[q + u * G];
            v[u] = __int_as_float(cv.y);
            xv[u] = load_x<XVEC>(Xc + (size_t)cv.x * k, nv);
          }
        }
#pragma unroll
        for (int u = 0; u < KRYLOV_SPMM_BATCH; ++u) {
          if (q + u * G < end) s = fma4(v[u], xv[u], s);
        }
      }
    }
    for (int o = width >> 1; o >= Cp; o >>= 1) s = add4(s, shfl_down4(s, o, width));
    if (i < r1 - r0 && t == 0 && nv > 0) store_y<XVEC>(Yc + (size_t)(r0 + i) * k, s, nv);
  }
}

template <int VPT, typename TV>
static void launch_spmm(dim3 g, bool svec, bool xvec, const int* runs, const int* indptr,
                        const int* indices, const TV* data, const float* x, float* y,
                        int nnz, int k, cudaStream_t s) {
  // the staged entries, then the run's row pointers
  const size_t smem = (size_t)4 * VPT * KRYLOV_SPMV_THREADS * (sizeof(int2) + sizeof(int)) + 16;
  auto kernel = xvec ? csr_spmm_kernel<VPT, true, TV> : csr_spmm_kernel<VPT, false, TV>;
  if (smem > 48 * 1024) {  // above 48 KB only after an opt-in
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<g, KRYLOV_SPMV_THREADS, smem, s>>>(runs, indptr, indices, data, x, y, nnz, k, svec);
}

template <typename TV>
static int launch_spmm_for(int capacity, int nruns, const int* runs, const int* indptr,
                           const int* indices, const void* data, const float* x, float* y,
                           int nnz, int k, cudaStream_t s) {
  const TV* d = static_cast<const TV*>(data);
  const long long slabs = (k + KRYLOV_SPMM_SLAB - 1) / KRYLOV_SPMM_SLAB;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)nruns, (unsigned)slabs);
  // the stream's 16-byte loads as K10's; X and Y as float4 rows
  const bool svec = reinterpret_cast<uintptr_t>(indices) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(data) % (4 * sizeof(TV)) == 0;
  const bool xvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  switch (capacity) {
    case 1024: launch_spmm<1, TV>(g, svec, xvec, runs, indptr, indices, d, x, y, nnz, k, s); break;
    case 2048: launch_spmm<2, TV>(g, svec, xvec, runs, indptr, indices, d, x, y, nnz, k, s); break;
    case 4096: launch_spmm<4, TV>(g, svec, xvec, runs, indptr, indices, d, x, y, nnz, k, s); break;
    case 8192: launch_spmm<8, TV>(g, svec, xvec, runs, indptr, indices, d, x, y, nnz, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// K10: x of length m, y of length n.  tv: dtype code of the values (f32 or
// bf16).  runs: nruns + 1 first rows of the runs (runs[0] = 0, runs[nruns]
// = n), each run whole rows with at most capacity - 3 stored entries unless
// it is a single row; capacity: 1024, 2048, 4096 or 8192 products of shared
// memory a block.  nnz: the length of indices and data.
int krylov_csr_spmv(int tv, int capacity, int nruns, const int* runs,
                    const int* indptr, const int* indices, const void* data,
                    const float* x, float* y, int nnz, void* stream) {
  if (nruns < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (nruns == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tv == KRYLOV_F32) {
    return launch_stream_for<float>(capacity, nruns, runs, indptr, indices, data, x, y, nnz, s);
  }
  if (tv == KRYLOV_BF16) {
    return launch_stream_for<__nv_bfloat16>(capacity, nruns, runs, indptr, indices, data, x, y,
                                            nnz, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K11: X (m, k) and Y (n, k), row-major, k >= 1; runs, capacity and nnz as
// for K10 (the same partition).
int krylov_csr_spmm(int tv, int capacity, int nruns, const int* runs,
                    const int* indptr, const int* indices, const void* data,
                    const float* x, float* y, int nnz, int k, void* stream) {
  if (nruns < 0 || nnz < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (nruns == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tv == KRYLOV_F32) {
    return launch_spmm_for<float>(capacity, nruns, runs, indptr, indices, data, x, y, nnz, k, s);
  }
  if (tv == KRYLOV_BF16) {
    return launch_spmm_for<__nv_bfloat16>(capacity, nruns, runs, indptr, indices, data, x, y,
                                          nnz, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
