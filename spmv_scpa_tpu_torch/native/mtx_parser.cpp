// Fast Matrix Market coordinate-entry parser.
//
// Native replacement for the framework's I/O hot loop: the reference
// spends most of its wall-clock in two fscanf passes over the .mtx
// payload (reference: src/csr.c:68-146); our Python fallback bulk-split
// costs ~10 MB/s. This parser streams the payload once with branch-lean
// integer scanning and strtod for values, at several hundred MB/s.
//
// Contract (see spmv_scpa_tpu_torch/io/native.py): Python parses and
// validates the header (banner, comments, size line) and hands us only
// the raw entry payload. Indices are returned 1-based exactly as in
// the file; Python applies the 0-based shift (csr.c:82-83 analog) and
// all semantic expansion (symmetric/pattern).
//
// A copy of the JAX package's native/mtx_parser.cpp (comments aside),
// built on first use by spmv_scpa_tpu_torch/_kernels.py:build_native
// into spmv_scpa_tpu_torch/_build/ and loaded via ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                       *p == '\r' || *p == '\f' || *p == '\v'))
        ++p;
    return p;
}

// Parse a non-negative decimal integer. Returns nullptr on bad input.
inline const char* parse_u64(const char* p, const char* end, int64_t* out) {
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
    }
    *out = v;
    return p;
}

}  // namespace

extern "C" {

// Parse `n_entries` lines of "row col [value]" from buf[0:len).
// ncols_per_line: 2 (pattern) or 3 (real/integer).
// rows/cols receive the 1-based file indices; vals may be null when
// ncols_per_line == 2. Returns the number of entries parsed (==
// n_entries on success; fewer signals malformed/truncated input).
int64_t mtx_parse_entries(const char* buf, int64_t len, int ncols_per_line,
                          int64_t n_entries, int64_t* rows, int64_t* cols,
                          double* vals) {
    const char* p = buf;
    const char* end = buf + len;
    for (int64_t i = 0; i < n_entries; ++i) {
        p = skip_ws(p, end);
        p = parse_u64(p, end, &rows[i]);
        if (!p) return i;
        p = skip_ws(p, end);
        p = parse_u64(p, end, &cols[i]);
        if (!p) return i;
        if (ncols_per_line == 3) {
            p = skip_ws(p, end);
            if (p >= end) return i;
            char* q = nullptr;
            vals[i] = strtod(p, &q);
            if (q == p) return i;
            p = q;
        }
    }
    // Trailing content must be whitespace only (mirror of the Python
    // fallback's trailing-token check).
    p = skip_ws(p, end);
    if (p != end) return -(n_entries + 1);  // sentinel: trailing tokens
    return n_entries;
}

// Count whitespace-separated tokens (used for validation/debug).
int64_t mtx_count_tokens(const char* buf, int64_t len) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t n = 0;
    while (true) {
        p = skip_ws(p, end);
        if (p >= end) break;
        ++n;
        while (p < end && *p != ' ' && *p != '\t' && *p != '\n' &&
               *p != '\r' && *p != '\f' && *p != '\v')
            ++p;
    }
    return n;
}

}  // extern "C"
