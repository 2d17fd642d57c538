// graphtap_host.cpp — native host-side ingest kernels.
//
// The reference's graph loader is header-only C++ (src/mat/graph.hpp,
// src/ds/compressed_column.hpp): parallel text parsing, triple sorting,
// dedup, per-tile format builds. This library provides the TPU framework's
// host-side equivalents — the pieces NumPy handles poorly — exposed via a
// plain C ABI consumed with ctypes (native/__init__.py):
//
//   gt_parse_text   — parse "<u> <v> [<w>]" edge-list text into u32 arrays
//                     (reference: parread_text, graph.hpp:234-306)
//   gt_sort_edges   — in-place key sort of edges by (key1, key2) pairs
//                     (reference: ColSort + std::sort, matrix.hpp:546)
//   gt_dedup_edges  — remove parallel edges keeping the min weight
//                     (reference: std::unique, matrix.hpp:550-556)
//
// Build: at first use, by graphtap_tpu_torch/native/__init__.py (g++ into
// graphtap_tpu_torch/build/libgraphtap_host_<source hash>.so).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Parse whitespace-separated unsigned integers from text. Returns the
// number of u32 values written to out (capacity out_cap), or -1 on
// malformed input. Newlines and spaces/tabs are interchangeable; the
// caller reshapes into (n/cols, cols).
long long gt_parse_text(const char* buf, long long len,
                        unsigned* out, long long out_cap) {
    long long n = 0;
    long long i = 0;
    while (i < len) {
        // skip whitespace
        while (i < len && (buf[i] == ' ' || buf[i] == '\t' ||
                           buf[i] == '\n' || buf[i] == '\r')) i++;
        if (i >= len) break;
        if (buf[i] < '0' || buf[i] > '9') return -1;
        unsigned long long v = 0;
        while (i < len && buf[i] >= '0' && buf[i] <= '9') {
            v = v * 10u + (unsigned)(buf[i] - '0');
            i++;
        }
        if (n >= out_cap) return -1;
        out[n++] = (unsigned)v;
    }
    return n;
}

// Sort edge indices by (k1, k2): writes the permutation into perm
// (caller applies it with NumPy fancy indexing). Stable.
void gt_sort_edges(const unsigned* k1, const unsigned* k2,
                   long long n, long long* perm) {
    std::iota(perm, perm + n, 0LL);
    std::stable_sort(perm, perm + n, [&](long long a, long long b) {
        if (k1[a] != k1[b]) return k1[a] < k1[b];
        return k2[a] < k2[b];
    });
}

// Dedup consecutive (r, c) duplicates in a sorted edge list, keeping the
// minimum weight. Returns the new count; compacts r/c/w in place.
// w may be null.
long long gt_dedup_edges(unsigned* r, unsigned* c, unsigned* w,
                         long long n) {
    if (n == 0) return 0;
    long long out = 0;
    for (long long i = 1; i < n; i++) {
        if (r[i] == r[out] && c[i] == c[out]) {
            if (w && w[i] < w[out]) w[out] = w[i];
        } else {
            out++;
            r[out] = r[i];
            c[out] = c[i];
            if (w) w[out] = w[i];
        }
    }
    return out + 1;
}

// Bin edges into 2D mesh tiles: computes the destination device of each
// edge for the segment-aligned layout (parallel/layout.py semantics) and
// a stable counting-sort permutation grouping edges by device.
// i = (r/L) % R;  j = (c/L) / R;  dev = i*C + j.
void gt_bin_edges(const unsigned* r, const unsigned* c, long long n,
                  long long L, long long R, long long C,
                  long long* perm, long long* counts) {
    long long D = R * C;
    std::vector<long long> dev(n);
    for (long long e = 0; e < n; e++) {
        long long i = (r[e] / L) % R;
        long long j = (c[e] / L) / R;
        dev[e] = i * C + j;
    }
    std::fill(counts, counts + D, 0LL);
    for (long long e = 0; e < n; e++) counts[dev[e]]++;
    std::vector<long long> cursor(D, 0);
    long long acc = 0;
    for (long long d = 0; d < D; d++) { cursor[d] = acc; acc += counts[d]; }
    for (long long e = 0; e < n; e++) perm[cursor[dev[e]]++] = e;
}

}  // extern "C"
