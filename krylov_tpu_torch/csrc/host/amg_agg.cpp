// Native AMG pairwise-matching aggregation: one pass of the
// strongest-neighbor Luby-style matching of krylov_tpu/amg.py
// (_strength_graph + _pairwise_labels), label-identical to the numpy
// path: the strength values, tie-breaking jitter, and the composite
// sort key are computed with the exact same IEEE operation sequence
// (compile with -ffp-contract=off so GCC cannot fuse the final
// multiply-subtract of the key into an FMA), and the stable sort
// reproduces numpy's kind="stable" ordering.  The numpy implementation
// remains the fallback and ground truth (tests assert label equality).
//
// Replaces, per call: A.tocoo() + boolean filters + the 2*nnz-element
// float64 stable argsort + 8 rounds of masked first-per-row scans —
// measured ~12 s of the 1M-row AMG setup, ~0.4 s here.
//
// The reference library has no native code at all (SURVEY.md §2.2) and
// no preconditioners (reference: src/krylov/cg.py:33-36 takes M from
// the user); this is build-side runtime of the TPU framework.
//
// Compiled on demand by krylov_tpu/ops/_native.py with
//   g++ -O3 -ffp-contract=off -shared -fPIC amg_agg.cpp -o _amg_agg.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Filtered strength stream (row-major, column-sorted within rows, the
// canonical-CSR storage order the numpy tocoo path yields).
struct Stream {
  std::vector<int64_t> r, c;
  std::vector<double> key;  // composite (row asc, jittered strength desc)
};

template <typename T, typename I>
void build_stream(int64_t n, const I* indptr, const I* indices,
                  const T* data, double theta, Stream* out) {
  const int64_t nnz = indptr[n];
  // d = |diag|, zeros -> 1, in the matrix dtype (numpy: np.abs + where)
  std::vector<T> d(n, static_cast<T>(1));
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
      if (static_cast<int64_t>(indices[j]) == i) {
        T v = std::abs(data[j]);
        d[i] = (v > static_cast<T>(0)) ? v : static_cast<T>(1);
        break;
      }
    }
  }
  out->r.reserve(nnz);
  out->c.reserve(nnz);
  out->key.reserve(nnz);
  const T theta_t = static_cast<T>(theta);  // numpy weak-scalar promotion
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
      const int64_t cc = static_cast<int64_t>(indices[j]);
      if (cc == i) continue;
      // strength in the matrix dtype, exactly as numpy computes it
      const T s = std::abs(data[j]) / std::sqrt(d[i] * d[cc]);
      if (!(s >= theta_t)) continue;
      const int64_t u = i < cc ? i : cc;
      const int64_t v = i < cc ? cc : i;
      const int64_t ji = (u * 2654435761LL + v * 40503LL) % (1LL << 20);
      const double jit = static_cast<double>(ji) / 1048576.0;
      // s2 = s * (1.0 + 1e-6 * jitter)   (f64, same op order as numpy)
      const double j2 = 1e-6 * jit;
      const double t1 = 1.0 + j2;
      const double s2 = static_cast<double>(s) * t1;
      out->r.push_back(i);
      out->c.push_back(cc);
      out->key.push_back(s2);  // finalized into the composite key below
    }
  }
  // key = r * 2.0 - (s2 / (|max s2| + 1.0)) * 0.5
  double smax = 0.0;
  for (double s2 : out->key) smax = std::max(smax, s2);
  const double den = std::fabs(smax) + 1.0;
  for (size_t e = 0; e < out->key.size(); ++e) {
    const double t1 = out->key[e] / den;
    const double t2 = t1 * 0.5;
    const double rk = static_cast<double>(out->r[e]) * 2.0;
    out->key[e] = rk - t2;
  }
}

// best[i] = target of the first valid entry of row i in (rs, cs) order
// (-1: none).  rs/cs are the key-sorted stream (possibly compacted).
void first_valid_per_row(const std::vector<int64_t>& rs,
                         const std::vector<int64_t>& cs,
                         const std::vector<uint8_t>& row_ok,
                         const std::vector<uint8_t>& col_ok,
                         std::vector<int64_t>* best) {
  std::fill(best->begin(), best->end(), -1);
  const size_t ns = rs.size();
  for (size_t i = 0; i < ns; ++i) {
    const int64_t r = rs[i];
    if ((*best)[r] >= 0) continue;
    if (row_ok[r] && col_ok[cs[i]]) (*best)[r] = cs[i];
  }
}

}  // namespace

extern "C" {

// One pass of strongest-neighbor pairwise matching on canonical CSR
// (sorted column indices, no duplicates).  data_kind: 0 = float32,
// 1 = float64 (complex matrices take the numpy path).  idx_kind:
// 0 = int32, 1 = int64 — scipy's native index dtypes are read directly
// (converting 2*nnz indices to int64 per call cost O(nnz) copies).
// Writes per-row aggregate labels into labels_out and returns n_agg
// (>= 0), or -1 on unsupported input.
int64_t amg_pairwise_labels(int64_t n, const void* indptr,
                            const void* indices, int32_t idx_kind,
                            const void* data, int32_t data_kind,
                            double theta, int64_t rounds,
                            int64_t* labels_out) {
  if (n <= 0) return -1;
  Stream st;
  if (idx_kind == 0 && data_kind == 0)
    build_stream<float, int32_t>(
        n, static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(data), theta, &st);
  else if (idx_kind == 0 && data_kind == 1)
    build_stream<double, int32_t>(
        n, static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const double*>(data), theta, &st);
  else if (idx_kind == 1 && data_kind == 0)
    build_stream<float, int64_t>(
        n, static_cast<const int64_t*>(indptr),
        static_cast<const int64_t*>(indices),
        static_cast<const float*>(data), theta, &st);
  else if (idx_kind == 1 && data_kind == 1)
    build_stream<double, int64_t>(
        n, static_cast<const int64_t*>(indptr),
        static_cast<const int64_t*>(indices),
        static_cast<const double*>(data), theta, &st);
  else
    return -1;

  const int64_t ns = static_cast<int64_t>(st.r.size());
  // Global stable sort by the composite key == concatenation of PER-ROW
  // stable sorts: the stream is built row-major (r non-decreasing) and
  // row r's keys lie in [2r - 0.5, 2r] (t2 in [0, 0.5]), so key ranges
  // of distinct rows are disjoint and increasing — a global comparison
  // sort can never move an entry across a row boundary.  Sorting each
  // row segment independently (typical segment: the handful of strong
  // neighbors of one node) replaces the O(ns log ns) full-stream sort
  // with near-linear work; the (key, index) pair tie-break reproduces
  // numpy's kind="stable" order exactly, as before.
  std::vector<int64_t> rs(ns), cs(ns);  // the key-sorted stream
  {
    std::vector<std::pair<double, int64_t>> kv;
    for (int64_t lo = 0; lo < ns;) {
      const int64_t row = st.r[lo];
      int64_t hi = lo + 1;
      while (hi < ns && st.r[hi] == row) ++hi;
      kv.clear();
      for (int64_t i = lo; i < hi; ++i) kv.emplace_back(st.key[i], i);
      std::sort(kv.begin(), kv.end());
      for (int64_t i = lo; i < hi; ++i) {
        rs[i] = st.r[kv[i - lo].second];
        cs[i] = st.c[kv[i - lo].second];
      }
      lo = hi;
    }
  }

  std::vector<uint8_t> unmatched(n, 1);
  std::vector<int64_t> mate(n, -1), best(n, -1);
  std::vector<uint8_t> matched_col(n, 0);  // ~unmatched view for leftovers
  if (ns > 0) {
    // rounds run on a compacted copy: entries with a matched endpoint
    // can never become valid again in the mutual-matching rounds, so
    // dropping them after each round leaves best[] unchanged
    std::vector<int64_t> wr(rs), wc(cs);
    for (int64_t round = 0; round < rounds; ++round) {
      bool any_un = false;
      for (int64_t i = 0; i < n; ++i)
        if (unmatched[i]) {
          any_un = true;
          break;
        }
      if (!any_un || wr.empty()) break;
      first_valid_per_row(wr, wc, unmatched, unmatched, &best);
      // mutual pairs from the frozen best[] snapshot (numpy semantics)
      int64_t n_pairs = 0;
      for (int64_t i = 0; i < n; ++i) {
        const int64_t b = best[i];
        if (b >= 0 && unmatched[i] && i < b && best[b] == i) {
          mate[i] = b;
          mate[b] = i;
          ++n_pairs;
        }
      }
      if (n_pairs == 0) break;
      for (int64_t i = 0; i < n; ++i)
        if (mate[i] >= 0) unmatched[i] = 0;
      // compact: keep only entries whose BOTH endpoints are unmatched
      size_t w = 0;
      for (size_t i = 0; i < wr.size(); ++i)
        if (unmatched[wr[i]] && unmatched[wc[i]]) {
          wr[w] = wr[i];
          wc[w] = wc[i];
          ++w;
        }
      wr.resize(w);
      wc.resize(w);
    }
  }

  // label matched pairs in ascending lead order
  std::fill(labels_out, labels_out + n, -1);
  int64_t n_pairs = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (mate[i] >= 0 && i < mate[i]) {
      labels_out[i] = n_pairs;
      labels_out[mate[i]] = n_pairs;
      ++n_pairs;
    }
  }
  // leftovers join their strongest already-matched neighbor
  bool any_un = false;
  for (int64_t i = 0; i < n; ++i)
    if (unmatched[i]) {
      any_un = true;
      break;
    }
  if (any_un && ns > 0) {
    for (int64_t i = 0; i < n; ++i) matched_col[i] = unmatched[i] ? 0 : 1;
    first_valid_per_row(rs, cs, unmatched, matched_col, &best);
    for (int64_t i = 0; i < n; ++i)
      if (unmatched[i] && best[i] >= 0) {
        labels_out[i] = labels_out[best[i]];
        unmatched[i] = 0;
      }
  }
  // true isolates become singletons
  int64_t n_agg = n_pairs;
  for (int64_t i = 0; i < n; ++i)
    if (labels_out[i] < 0) labels_out[i] = n_agg++;
  return n_agg;
}

}  // extern "C"
