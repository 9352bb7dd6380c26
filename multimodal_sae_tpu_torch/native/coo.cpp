// Native host-side COO kernels for the activation cache (a copy of the JAX
// package's native/coo.cpp, built by multimodal_sae_tpu_torch/native/coo.py
// into the port's own build directory).
//
// The cache hot loop on the host is: mask the (B, S, k) top-k activations by
// magnitude (and optionally by a feature filter), emit (row, seq, feature)
// triples with a global row offset, and partition the accumulated stream by
// feature ranges for the split writer (features/cache.py).  numpy needs
// several passes and intermediate index arrays per batch; these single-pass
// C++ kernels keep the host from becoming the bottleneck behind the device.
//
// Build: g++ -O3 -march=native -shared -fPIC coo.cpp -o libcoo.so

#include <cstdint>
#include <cstring>

namespace {

// Shared body for int64/int32 feature-id layouts.  The device top-k returns
// int32 indices; the i32 entry point reads them as they are, with no
// widening pass over the batch on the host.
template <typename IdxT>
int64_t extract_topk_impl(
    const float* vals,
    const IdxT* idx,
    int64_t B, int64_t S, int64_t K,
    float threshold,
    const int64_t* filter, int64_t filter_len,
    int64_t row_offset,
    int64_t* out_locations,
    float* out_activations) {
  int64_t n = 0;
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t s = 0; s < S; ++s) {
      const int64_t base = (b * S + s) * K;
      for (int64_t j = 0; j < K; ++j) {
        const float v = vals[base + j];
        const float av = v < 0 ? -v : v;
        if (av <= threshold) continue;
        const int64_t f = static_cast<int64_t>(idx[base + j]);
        if (filter != nullptr) {
          // binary search in the sorted filter
          int64_t lo = 0, hi = filter_len;
          while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (filter[mid] < f) lo = mid + 1; else hi = mid;
          }
          if (lo >= filter_len || filter[lo] != f) continue;
        }
        out_locations[n * 3 + 0] = b + row_offset;
        out_locations[n * 3 + 1] = s;
        out_locations[n * 3 + 2] = f;
        out_activations[n] = v;
        ++n;
      }
    }
  }
  return n;
}

}  // namespace

extern "C" {

// Extract nonzero (|val| > threshold) triples from a (B, S, k) top-k batch.
// vals: float32[B*S*k], idx: int64[B*S*k] (feature ids, sorted or not)
// filter: optional sorted int64[filter_len] of allowed feature ids (NULL = all)
// out_locations: int64[cap*3], out_activations: float32[cap]
// row_offset is added to the batch-row coordinate.
// Returns the number of triples written (<= B*S*k).
int64_t coo_extract_topk(
    const float* vals,
    const int64_t* idx,
    int64_t B, int64_t S, int64_t K,
    float threshold,
    const int64_t* filter, int64_t filter_len,
    int64_t row_offset,
    int64_t* out_locations,
    float* out_activations) {
  return extract_topk_impl<int64_t>(
      vals, idx, B, S, K, threshold, filter, filter_len, row_offset,
      out_locations, out_activations);
}

// Same, reading the ids as int32 (the device top-k's native index dtype) —
// saves the host-side widening pass entirely.
int64_t coo_extract_topk_i32(
    const float* vals,
    const int32_t* idx,
    int64_t B, int64_t S, int64_t K,
    float threshold,
    const int64_t* filter, int64_t filter_len,
    int64_t row_offset,
    int64_t* out_locations,
    float* out_activations) {
  return extract_topk_impl<int32_t>(
      vals, idx, B, S, K, threshold, filter, filter_len, row_offset,
      out_locations, out_activations);
}

// Partition a COO stream into contiguous per-split segments by feature range.
// boundaries: int64[n_splits+1] ascending; split i covers
// [boundaries[i], boundaries[i+1]) (exclusive upper bound).
int64_t coo_partition_splits(
    const int64_t* locations,  // N x 3
    const float* activations,
    int64_t N,
    const int64_t* boundaries, int64_t n_splits,
    int64_t* out_counts,
    int64_t* out_locations,
    float* out_activations) {
  const int64_t lo_all = boundaries[0];
  const int64_t hi_all = boundaries[n_splits];
  // The linspace partition is uniform whenever width % n_splits == 0 (the
  // flagship 131072/128 = 1024, a power of two): the per-entry split id is
  // then a shift (or a division), not a 2x-per-entry binary search, which
  // would otherwise be the writer thread's largest cost.
  const int64_t stride = n_splits > 0 ? boundaries[1] - boundaries[0] : 0;
  bool uniform = stride > 0;
  for (int64_t i = 0; uniform && i < n_splits; ++i)
    uniform = (boundaries[i + 1] - boundaries[i]) == stride;
  int shift = -1;
  if (uniform && (stride & (stride - 1)) == 0) {
    shift = 0;
    while ((int64_t{1} << shift) != stride) ++shift;
  }
  const auto split_of = [&](int64_t f) -> int64_t {
    if (shift >= 0) return (f - lo_all) >> shift;
    if (uniform) return (f - lo_all) / stride;
    int64_t lo = 0, hi = n_splits;  // greatest i with boundaries[i] <= f
    while (lo + 1 < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (boundaries[mid] <= f) lo = mid; else hi = mid;
    }
    return lo;
  };
  // Pass 1: count per split.
  for (int64_t i = 0; i < n_splits; ++i) out_counts[i] = 0;
  for (int64_t r = 0; r < N; ++r) {
    const int64_t f = locations[r * 3 + 2];
    if (f < lo_all || f >= hi_all) continue;
    ++out_counts[split_of(f)];
  }
  // Prefix offsets.
  int64_t total = 0;
  int64_t* offsets = new int64_t[n_splits];
  for (int64_t i = 0; i < n_splits; ++i) {
    offsets[i] = total;
    total += out_counts[i];
  }
  // Pass 2: scatter.
  for (int64_t r = 0; r < N; ++r) {
    const int64_t f = locations[r * 3 + 2];
    if (f < lo_all || f >= hi_all) continue;
    const int64_t dst = offsets[split_of(f)]++;
    std::memcpy(out_locations + dst * 3, locations + r * 3, 3 * sizeof(int64_t));
    out_activations[dst] = activations[r];
  }
  delete[] offsets;
  return total;
}

}  // extern "C"
