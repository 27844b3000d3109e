// Bit-packed GF(2) Gaussian elimination — native host kernel.
//
// The reference delegated ALL GF(2) algebra to the native (C++/Cython)
// `ldpc` package (reference setup.py:30, css.py:2).  In this framework the
// *decode-time* elimination runs on the accelerator (XLA); this translation unit
// is the native engine for the *construction-time* host path (code
// construction, logical-operator computation, rank/nullspace of n ~ 1e4+
// lifted-product codes), where a Python column loop is the bottleneck.
//
// Semantics mirror bp_osd_tpu/gf2.py:_echelon_packed exactly (same pivot
// selection: first row at/below the cursor carrying the column; optional
// full Jordan elimination; optional transform tracking), so outputs are
// bit-identical to the NumPy fallback — tested in tests/test_gf2_native.py.
//
// Build: g++ -O3 -shared -fPIC (driven by bp_osd_tpu/native/build.py).

#include <cstdint>
#include <cstring>

extern "C" {

// In-place row echelon of P [m x W] (64 columns per word, little-endian bit
// order, n logical columns).  T, when non-null, is an [m x Wt] transform
// accumulator (caller initializes to identity).  pivot_cols receives the
// pivot column indices (caller allocates >= min(m, n)).  Returns the rank.
int gf2_row_echelon(uint64_t* P, uint64_t* T, int64_t m, int64_t W,
                    int64_t n, int64_t Wt, int full, int64_t* pivot_cols) {
    int64_t r = 0;
    for (int64_t c = 0; c < n && r < m; ++c) {
        const int64_t w = c >> 6;
        const uint64_t bit = 1ull << (c & 63);

        // find pivot: first row >= r with the bit set
        int64_t p = -1;
        for (int64_t i = r; i < m; ++i) {
            if (P[i * W + w] & bit) { p = i; break; }
        }
        if (p < 0) continue;
        if (p != r) {
            for (int64_t k = 0; k < W; ++k) {
                uint64_t t = P[r * W + k];
                P[r * W + k] = P[p * W + k];
                P[p * W + k] = t;
            }
            if (T) {
                for (int64_t k = 0; k < Wt; ++k) {
                    uint64_t t = T[r * Wt + k];
                    T[r * Wt + k] = T[p * Wt + k];
                    T[p * Wt + k] = t;
                }
            }
        }

        const uint64_t* prow = &P[r * W];
        const uint64_t* trow = T ? &T[r * Wt] : nullptr;
        const int64_t lo = full ? 0 : r + 1;
        for (int64_t i = lo; i < m; ++i) {
            if (i == r) continue;
            if (P[i * W + w] & bit) {
                uint64_t* dst = &P[i * W];
                for (int64_t k = 0; k < W; ++k) dst[k] ^= prow[k];
                if (T) {
                    uint64_t* tdst = &T[i * Wt];
                    for (int64_t k = 0; k < Wt; ++k) tdst[k] ^= trow[k];
                }
            }
        }
        pivot_cols[r] = c;
        ++r;
    }
    return (int)r;
}

// Rank-only fast path (no transform, no pivot bookkeeping beyond count).
int gf2_rank(uint64_t* P, int64_t m, int64_t W, int64_t n) {
    int64_t r = 0;
    for (int64_t c = 0; c < n && r < m; ++c) {
        const int64_t w = c >> 6;
        const uint64_t bit = 1ull << (c & 63);
        int64_t p = -1;
        for (int64_t i = r; i < m; ++i) {
            if (P[i * W + w] & bit) { p = i; break; }
        }
        if (p < 0) continue;
        if (p != r) {
            for (int64_t k = 0; k < W; ++k) {
                uint64_t t = P[r * W + k];
                P[r * W + k] = P[p * W + k];
                P[p * W + k] = t;
            }
        }
        const uint64_t* prow = &P[r * W];
        for (int64_t i = r + 1; i < m; ++i) {
            if (P[i * W + w] & bit) {
                uint64_t* dst = &P[i * W];
                for (int64_t k = 0; k < W; ++k) dst[k] ^= prow[k];
            }
        }
        ++r;
    }
    return (int)r;
}

}  // extern "C"
