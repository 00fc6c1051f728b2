// Native host runtime: k-mer seed index + anchor chaining.
//
// The TPU-native analogue of the reference's native aligner cores (bwa /
// LAST / lastz / blasr seeding and chaining, reference
// nanopore/mappers/*): the device kernel handles base-level alignment,
// and this module keeps the host-side seeding stages off the Python
// interpreter.  Exposed through a plain C ABI consumed via ctypes
// (nanopore_tpu_torch.runtime.native_index, which builds it with g++ on
// first use into nanopore_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Index build: sort (kmer, position) pairs of every valid (N-free)
// window.  Returns the number of kept entries; arrays are
// caller-allocated with capacity n (number of windows).
// ---------------------------------------------------------------------
int64_t seedchain_build_index(
    const int8_t* codes, int64_t n, int32_t k,
    int64_t* out_kmers, int32_t* out_positions) {
  if (n < k) return 0;
  int64_t n_windows = n - k + 1;
  std::vector<std::pair<int64_t, int32_t>> entries;
  entries.reserve(n_windows);
  int64_t kmer = 0;
  int64_t mask = (int64_t(1) << (2 * k)) - 1;
  int32_t valid_run = 0;  // count of consecutive non-N codes ending here
  for (int64_t i = 0; i < n; ++i) {
    int8_t c = codes[i];
    if (c >= 4 || c < 0) {
      valid_run = 0;
      kmer = 0;
      continue;
    }
    kmer = ((kmer << 2) | c) & mask;
    ++valid_run;
    if (valid_run >= k) {
      entries.emplace_back(kmer, int32_t(i - k + 1));
    }
  }
  std::sort(entries.begin(), entries.end());
  int64_t kept = int64_t(entries.size());
  for (int64_t i = 0; i < kept; ++i) {
    out_kmers[i] = entries[i].first;
    out_positions[i] = entries[i].second;
  }
  return kept;
}

// Drop over-represented kmers (occurrence > max_occ).  In-place compact;
// returns new length.
int64_t seedchain_mask_repeats(
    int64_t* kmers, int32_t* positions, int64_t n, int64_t max_occ) {
  int64_t out = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && kmers[j] == kmers[i]) ++j;
    if (j - i <= max_occ) {
      for (int64_t t = i; t < j; ++t) {
        kmers[out] = kmers[t];
        positions[out] = positions[t];
        ++out;
      }
    }
    i = j;
  }
  return out;
}

// ---------------------------------------------------------------------
// Lookup: all seed hits of a read against the sorted index.
// Writes up to capacity hits; returns the count (clamped).
// ---------------------------------------------------------------------
int64_t seedchain_lookup(
    const int64_t* sorted_kmers, const int32_t* sorted_positions,
    int64_t index_len, const int8_t* read_codes, int64_t read_len,
    int32_t k, int32_t stride, int64_t capacity,
    int32_t* out_ref_pos, int32_t* out_read_pos) {
  // stride > 1: probe only every stride-th read k-mer (sparse seeding,
  // the long-read mapper trade: ~1/stride the index probes for a small
  // anchor-density loss the chainer absorbs on multi-kb reads)
  if (stride < 1) stride = 1;
  if (read_len < k || index_len == 0) return 0;
  int64_t count = 0;
  int64_t kmer = 0;
  int64_t mask = (int64_t(1) << (2 * k)) - 1;
  int32_t valid_run = 0;
  for (int64_t i = 0; i < read_len; ++i) {
    int8_t c = read_codes[i];
    if (c >= 4 || c < 0) {
      valid_run = 0;
      kmer = 0;
      continue;
    }
    kmer = ((kmer << 2) | c) & mask;
    ++valid_run;
    if (valid_run < k) continue;
    int32_t qpos = int32_t(i - k + 1);
    if (stride > 1 && (qpos % stride) != 0) continue;
    const int64_t* lo = std::lower_bound(
        sorted_kmers, sorted_kmers + index_len, kmer);
    const int64_t* hi = std::upper_bound(
        lo, sorted_kmers + index_len, kmer);
    for (const int64_t* p = lo; p != hi && count < capacity; ++p) {
      int64_t idx = p - sorted_kmers;
      out_ref_pos[count] = sorted_positions[idx];
      out_read_pos[count] = qpos;
      ++count;
    }
    if (count >= capacity) break;
  }
  return count;
}

// ---------------------------------------------------------------------
// Chain DP over anchors sorted by (r_start, q_start): concave gap cost,
// the O(A^2) loop of nanopore_tpu_torch.mapping.chain.chain_anchors.  Outputs
// per-anchor best score and parent (-1 for none).
// ---------------------------------------------------------------------
void seedchain_chain_dp(
    const int32_t* q_start, const int32_t* q_end,
    const int32_t* r_start, const int32_t* r_end,
    const double* lengths, int64_t n_anchors,
    int32_t max_ref_gap, int32_t max_diag_drift,
    double gap_open, double gap_scale,
    double* out_score, int64_t* out_parent) {
  for (int64_t i = 0; i < n_anchors; ++i) {
    out_score[i] = lengths[i];
    out_parent[i] = -1;
  }
  for (int64_t i = 1; i < n_anchors; ++i) {
    double base = lengths[i];
    double best = out_score[i];
    int64_t best_j = -1;
    for (int64_t j = 0; j < i; ++j) {
      int64_t dq = int64_t(q_start[i]) - q_end[j];
      int64_t dr = int64_t(r_start[i]) - r_end[j];
      if (dq <= 0 || dr <= 0 || dr > max_ref_gap) continue;
      int64_t drift = dq > dr ? dq - dr : dr - dq;
      if (drift > max_diag_drift) continue;
      int64_t mindq = dq < dr ? dq : dr;
      double gap = gap_open + gap_scale * double(mindq) + 0.5 * double(drift);
      double cand = out_score[j] + base - gap;
      if (cand > best) {
        best = cand;
        best_j = j;
      }
    }
    if (best_j >= 0) {
      out_score[i] = best;
      out_parent[i] = best_j;
    }
  }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// EM flank corridor: exact forward/backward expected counts over a
// pure-deletion corridor (nanopore_tpu.align.flank).  State order per
// align.model: 0=match, 1=shortDelete, 2=shortInsert, 3=longDelete,
// 4=longInsert; only the two delete states advance inside a flank, so
// the banded lattice's flank reduces to this 2-state inhomogeneous
// chain.  Per-step normalisation: every scale factor cancels in the
// count ratios, so no global Z bookkeeping is needed for the counts.
// Mirrors align.flank._corridor_expectations_np exactly (tested
// against it and against the unbanded oracle at m=0).
// ---------------------------------------------------------------------
int seedchain_flank_corridor(
    const int8_t* x, int64_t F,
    const double* T,      // 5x5 row-major [from*5 + to]
    const double* eg,     // 5x5 [state*5 + base]; base 4 = N column
    const double* entry,  // 5 entry-cell weights
    double* out_trans,    // 5x5, overwritten
    double* out_emis,     // 5x16, overwritten
    double* out_logz) {   // 1, overwritten
  const int D[2] = {1, 3};
  std::fill(out_trans, out_trans + 25, 0.0);
  std::fill(out_emis, out_emis + 80, 0.0);
  double s0 = 0.0;
  for (int s = 0; s < 5; ++s) s0 += entry[s];
  if (F == 0) {
    *out_logz = std::log(std::max(entry[D[0]] + entry[D[1]], 1e-300));
    return 0;
  }
  double e0[5];
  double logz = std::log(std::max(s0, 1e-300));
  for (int s = 0; s < 5; ++s) e0[s] = entry[s] / std::max(s0, 1e-300);
  // 2x2 corridor transitions, 2x5 corridor emissions
  double tDD[2][2], egD[2][5];
  for (int a = 0; a < 2; ++a) {
    for (int b = 0; b < 2; ++b) tDD[a][b] = T[D[a] * 5 + D[b]];
    for (int c = 0; c < 5; ++c) egD[a][c] = eg[D[a] * 5 + c];
  }
  std::vector<double> f(2 * (F + 1));
  {  // k = 1: entry over all 5 states
    int xb = x[0] >= 4 || x[0] < 0 ? 4 : x[0];
    double raw[2];
    for (int d = 0; d < 2; ++d) {
      double acc = 0.0;
      for (int s = 0; s < 5; ++s) acc += e0[s] * T[s * 5 + D[d]];
      raw[d] = acc * egD[d][xb];
    }
    double sk = raw[0] + raw[1];
    if (sk <= 0.0) { *out_logz = -1e300; return 1; }
    f[2] = raw[0] / sk;
    f[3] = raw[1] / sk;
    logz += std::log(sk);
  }
  for (int64_t k = 2; k <= F; ++k) {
    int xb = x[k - 1] >= 4 || x[k - 1] < 0 ? 4 : x[k - 1];
    double raw[2];
    for (int d = 0; d < 2; ++d) {
      raw[d] = (f[2 * (k - 1)] * tDD[0][d] + f[2 * (k - 1) + 1] * tDD[1][d]) *
               egD[d][xb];
    }
    double sk = raw[0] + raw[1];
    if (sk <= 0.0) { *out_logz = -1e300; return 1; }
    f[2 * k] = raw[0] / sk;
    f[2 * k + 1] = raw[1] / sk;
    logz += std::log(sk);
  }
  logz += std::log(std::max(f[2 * F] + f[2 * F + 1], 1e-300));

  double b[2] = {1.0, 1.0};
  for (int64_t k = F; k >= 1; --k) {
    int xraw = x[k - 1];
    int xb = xraw >= 4 || xraw < 0 ? 4 : xraw;
    // occupancy of cell k (consumed x[k-1]); N bases emit nothing
    double occ0 = f[2 * k] * b[0], occ1 = f[2 * k + 1] * b[1];
    double zd = occ0 + occ1;
    if (zd > 0.0 && xraw >= 0 && xraw < 4) {
      double g0 = occ0 / zd / 4.0, g1 = occ1 / zd / 4.0;
      for (int j = 0; j < 4; ++j) {
        out_emis[D[0] * 16 + xraw * 4 + j] += g0;
        out_emis[D[1] * 16 + xraw * 4 + j] += g1;
      }
    }
    if (k == 1) {  // transitions from the 5-state entry cell
      double w[5][2];
      double den = 0.0;
      for (int s = 0; s < 5; ++s)
        for (int d = 0; d < 2; ++d) {
          w[s][d] = e0[s] * T[s * 5 + D[d]] * egD[d][xb] * b[d];
          den += w[s][d];
        }
      if (den > 0.0)
        for (int s = 0; s < 5; ++s)
          for (int d = 0; d < 2; ++d)
            out_trans[s * 5 + D[d]] += w[s][d] / den;
      break;
    }
    double w[2][2];
    double den = 0.0;
    for (int s = 0; s < 2; ++s)
      for (int d = 0; d < 2; ++d) {
        w[s][d] = f[2 * (k - 1) + s] * tDD[s][d] * egD[d][xb] * b[d];
        den += w[s][d];
      }
    if (den > 0.0)
      for (int s = 0; s < 2; ++s)
        for (int d = 0; d < 2; ++d)
          out_trans[D[s] * 5 + D[d]] += w[s][d] / den;
    double braw[2];
    for (int s = 0; s < 2; ++s)
      braw[s] = tDD[s][0] * egD[0][xb] * b[0] + tDD[s][1] * egD[1][xb] * b[1];
    double sb = braw[0] + braw[1];
    if (sb <= 0.0) { *out_logz = -1e300; return 1; }
    b[0] = braw[0] / sb;
    b[1] = braw[1] / sb;
  }
  *out_logz = logz;
  return 0;
}


}  // extern "C"
