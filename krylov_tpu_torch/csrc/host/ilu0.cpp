// Native host helpers for incomplete-LU setup (loaded via ctypes from
// krylov_tpu/ops/_native.py; the numpy implementations in
// krylov_tpu/ilu.py and ops/triangular.py are the fallback and ground
// truth).  The reference has no native code at all (SURVEY.md 2.2); this
// is setup-side runtime, not TPU compute.
//
// ilu0_factor: in-place IKJ ILU(0) on the exact CSR pattern (sorted
// indices, no pivoting).  O(nnz * row_len) with an O(n) column-position
// scratch map instead of per-entry binary searches — the numpy row loop
// takes ~38 s at 1M rows where this takes ~0.1 s.
//
// tri_levels: dependency-level assignment of a triangular factor (row i
// gets 1 + max level of its strictly-lower/upper neighbors) — the same
// recurrence the Python loop in ops/triangular.py:level_arrays runs.

#include <cstdint>
#include <vector>

extern "C" {

// data is factored in place.  Returns 0 on success.
long long ilu0_factor(long long n, const long long* indptr,
                      const long long* indices, double* data) {
  std::vector<long long> pos(n, -1);   // col -> position in current row
  std::vector<long long> dpos(n, -1);  // diagonal position per row
  for (long long i = 0; i < n; ++i) {
    const long long s = indptr[i], e = indptr[i + 1];
    for (long long t = s; t < e; ++t) {
      pos[indices[t]] = t;
      if (indices[t] == i) dpos[i] = t;
    }
    for (long long t = s; t < e; ++t) {
      const long long k = indices[t];
      if (k >= i) break;
      double ukk = (dpos[k] >= 0) ? data[dpos[k]] : 0.0;
      if (ukk == 0.0) ukk = 1.0;  // breakdown guard (where-guard style)
      const double lik = data[t] / ukk;
      data[t] = lik;
      if (dpos[k] < 0) continue;
      // row i -= lik * upper(row k), restricted to row i's own pattern
      for (long long q = dpos[k] + 1; q < indptr[k + 1]; ++q) {
        const long long p = pos[indices[q]];
        if (p >= 0) data[p] -= lik * data[q];
      }
    }
    for (long long t = s; t < e; ++t) pos[indices[t]] = -1;
  }
  return 0;
}

// Writes per-row dependency levels; returns the level count.
long long tri_levels(long long n, const long long* indptr,
                     const long long* indices, long long lower,
                     long long* level) {
  long long maxl = 0;
  if (lower) {
    for (long long i = 0; i < n; ++i) {
      long long lv = 0;
      for (long long t = indptr[i]; t < indptr[i + 1]; ++t) {
        const long long k = indices[t];
        if (k < i && level[k] + 1 > lv) lv = level[k] + 1;
      }
      level[i] = lv;
      if (lv > maxl) maxl = lv;
    }
  } else {
    for (long long i = n - 1; i >= 0; --i) {
      long long lv = 0;
      for (long long t = indptr[i]; t < indptr[i + 1]; ++t) {
        const long long k = indices[t];
        if (k > i && level[k] + 1 > lv) lv = level[k] + 1;
      }
      level[i] = lv;
      if (lv > maxl) maxl = lv;
    }
  }
  return maxl + 1;
}

}  // extern "C"
