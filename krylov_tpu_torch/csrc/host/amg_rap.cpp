// Smoothed-aggregation Galerkin triple product:  Ac = P^H A P  with
//   P = P_hat - diag(scale) * (A @ P_hat)          (scale == w / diag(A))
// or P = P_hat when scale == nullptr (plain aggregation / the relabel-sum
// A1 = Q^T A Q of the double-pairwise matching).
//
// P_hat is the tentative one-nonzero-per-row prolongator encoded by
// `labels` (labels[i] = coarse column of fine row i), so the whole product
// specializes to three marker-accumulator passes over the fine matrix:
//   1. rows of P      (relabel A's row + the unit entry, scaled)
//   2. T = A P        (row-wise sparse accumulation, marker of size n_agg)
//   3. Ac = P^T T     (counting-sorted P^T, marker accumulation per coarse
//                      row)
// replacing scipy's generic csr_matmat x3 + csc transposes + sorts
// (~1.9 s of a 1M-row Poisson setup; this pass is ~0.3 s).
//
// Accumulation is double throughout (exact for f64 input, >= scipy's f32
// path for f32); callers cast the output data to the level dtype.  The
// numpy/scipy implementation in krylov_tpu/amg.py::_smoothed_prolongator
// is the fallback and ground truth (tests/test_native_ab.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

typedef void* (*alloc_fn)(int64_t nbytes, int32_t which);

namespace {

template <typename I, typename T>
int64_t rap_impl(int64_t n, const I* indptr, const I* indices, const T* data,
                 const int64_t* labels, int64_t n_agg, const double* scale,
                 alloc_fn alloc, int64_t* nnz_out) {
  // ---- phase 1: rows of P ------------------------------------------------
  std::vector<int64_t> p_indptr(n + 1, 0);
  std::vector<int32_t> p_cols;
  std::vector<double> p_vals;
  p_cols.reserve(scale ? 4 * (size_t)n : (size_t)n);
  p_vals.reserve(scale ? 4 * (size_t)n : (size_t)n);
  {
    std::vector<int64_t> mark(n_agg, -1);
    std::vector<double> acc(n_agg, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(64);
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      const int64_t li = labels[i];
      mark[li] = i;
      acc[li] = 1.0;
      touched.push_back((int32_t)li);
      if (scale) {
        const double s = scale[i];
        for (I q = indptr[i]; q < indptr[i + 1]; ++q) {
          const int64_t J = labels[indices[q]];
          const double v = -s * (double)data[q];
          if (mark[J] != i) {
            mark[J] = i;
            acc[J] = v;
            touched.push_back((int32_t)J);
          } else {
            acc[J] += v;
          }
        }
      }
      std::sort(touched.begin(), touched.end());
      for (int32_t J : touched) {
        p_cols.push_back(J);
        p_vals.push_back(acc[J]);
      }
      p_indptr[i + 1] = (int64_t)p_cols.size();
    }
  }

  // ---- phase 2: T = A P --------------------------------------------------
  std::vector<int64_t> t_indptr(n + 1, 0);
  std::vector<int32_t> t_cols;
  std::vector<double> t_vals;
  t_cols.reserve(3 * p_cols.size());
  t_vals.reserve(3 * p_cols.size());
  {
    std::vector<int64_t> mark(n_agg, -1);
    std::vector<double> acc(n_agg, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(256);
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      for (I q = indptr[i]; q < indptr[i + 1]; ++q) {
        const int64_t j = indices[q];
        const double a = (double)data[q];
        for (int64_t pq = p_indptr[j]; pq < p_indptr[j + 1]; ++pq) {
          const int32_t K = p_cols[pq];
          const double v = a * p_vals[pq];
          if (mark[K] != i) {
            mark[K] = i;
            acc[K] = v;
            touched.push_back(K);
          } else {
            acc[K] += v;
          }
        }
      }
      for (int32_t K : touched) {
        t_cols.push_back(K);
        t_vals.push_back(acc[K]);
      }
      t_indptr[i + 1] = (int64_t)t_cols.size();
    }
  }

  // ---- P^T by counting sort over coarse columns --------------------------
  std::vector<int64_t> pt_indptr(n_agg + 1, 0);
  std::vector<int64_t> pt_rows(p_cols.size());
  std::vector<double> pt_vals(p_cols.size());
  {
    for (int32_t J : p_cols) pt_indptr[(size_t)J + 1]++;
    for (int64_t J = 0; J < n_agg; ++J) pt_indptr[J + 1] += pt_indptr[J];
    std::vector<int64_t> cur(pt_indptr.begin(), pt_indptr.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t q = p_indptr[i]; q < p_indptr[i + 1]; ++q) {
        const int64_t pos = cur[p_cols[q]]++;
        pt_rows[pos] = i;
        pt_vals[pos] = p_vals[q];
      }
    }
  }

  // ---- phase 3: Ac = P^T T ----------------------------------------------
  std::vector<int64_t> c_indptr(n_agg + 1, 0);
  std::vector<int32_t> c_cols;
  std::vector<double> c_vals;
  c_cols.reserve(t_cols.size());
  c_vals.reserve(t_cols.size());
  {
    std::vector<int64_t> mark(n_agg, -1);
    std::vector<double> acc(n_agg, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(256);
    for (int64_t I_ = 0; I_ < n_agg; ++I_) {
      touched.clear();
      for (int64_t q = pt_indptr[I_]; q < pt_indptr[I_ + 1]; ++q) {
        const int64_t i = pt_rows[q];
        const double pv = pt_vals[q];
        for (int64_t tq = t_indptr[i]; tq < t_indptr[i + 1]; ++tq) {
          const int32_t K = t_cols[tq];
          const double v = pv * t_vals[tq];
          if (mark[K] != I_) {
            mark[K] = I_;
            acc[K] = v;
            touched.push_back(K);
          } else {
            acc[K] += v;
          }
        }
      }
      std::sort(touched.begin(), touched.end());
      for (int32_t K : touched) {
        c_cols.push_back(K);
        c_vals.push_back(acc[K]);
      }
      c_indptr[I_ + 1] = (int64_t)c_cols.size();
    }
  }

  // ---- copy out ----------------------------------------------------------
  const int64_t nnz = (int64_t)c_cols.size();
  void* o_indptr = alloc((n_agg + 1) * (int64_t)sizeof(int64_t), 0);
  void* o_cols = alloc(nnz * (int64_t)sizeof(int32_t), 1);
  void* o_vals = alloc(nnz * (int64_t)sizeof(double), 2);
  if (!o_indptr || !o_cols || !o_vals) return -1;
  std::memcpy(o_indptr, c_indptr.data(), (n_agg + 1) * sizeof(int64_t));
  std::memcpy(o_cols, c_cols.data(), nnz * sizeof(int32_t));
  std::memcpy(o_vals, c_vals.data(), nnz * sizeof(double));
  *nnz_out = nnz;
  return 0;
}

template <typename I>
int64_t rap_dispatch_data(int64_t n, const I* indptr, const I* indices,
                          const void* data, int32_t data_kind,
                          const int64_t* labels, int64_t n_agg,
                          const double* scale, alloc_fn alloc,
                          int64_t* nnz_out) {
  if (data_kind == 0)
    return rap_impl<I, float>(n, indptr, indices, (const float*)data, labels,
                              n_agg, scale, alloc, nnz_out);
  if (data_kind == 1)
    return rap_impl<I, double>(n, indptr, indices, (const double*)data,
                               labels, n_agg, scale, alloc, nnz_out);
  return -2;
}

}  // namespace

extern "C" int64_t amg_rap(int64_t n, const void* indptr, const void* indices,
                           int32_t idx_kind, const void* data,
                           int32_t data_kind, const int64_t* labels,
                           int64_t n_agg, const double* scale, alloc_fn alloc,
                           int64_t* nnz_out) {
  if (idx_kind == 0)
    return rap_dispatch_data<int32_t>(n, (const int32_t*)indptr,
                                      (const int32_t*)indices, data, data_kind,
                                      labels, n_agg, scale, alloc, nnz_out);
  if (idx_kind == 1)
    return rap_dispatch_data<int64_t>(n, (const int64_t*)indptr,
                                      (const int64_t*)indices, data, data_kind,
                                      labels, n_agg, scale, alloc, nnz_out);
  return -2;
}
