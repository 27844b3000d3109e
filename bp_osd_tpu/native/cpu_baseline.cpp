// Serial CPU BP+OSD reference baseline — measured stand-in for `ldpc`.
//
// The reference framework (quantumgizmos/bp_osd) delegates decoding to the
// external `ldpc` C++/Cython package (reference setup.py:30), which cannot
// be pip-installed in this environment (see BASELINE.md).  This translation
// unit is an honest, competently-optimized serial CPU implementation of the
// SAME decode semantics this framework implements on the accelerator:
//
//   * min-sum BP, parallel (flooding) schedule, with a fixed scaling
//     factor or the adaptive alpha_t = 1 - 2^-t when
//     ms_scaling_factor == 0 (reference README.md:184: "variable scaling
//     factor method"),
//   * product-sum ("ps") BP via the tanh rule with forward/backward
//     exclusive products (reference css_decode_sim.py:35),
//   * per-iteration hard decision + syndrome convergence check,
//   * OSD post-processing on BP failure: stable sort of columns by soft
//     reliability, bit-packed Gauss-Jordan elimination in that column
//     order, osd0 read-off, then either the combination-sweep search
//     (osd_cs: all weight-1 patterns over T plus all weight-2 patterns
//     over the first `osd_order` T-positions) or the exhaustive search
//     (osd_e: all 2^order patterns on the first `order` T-positions in
//     counting order) — reference README.md:185-187, arXiv:2005.07016,
//   * received-vector decoding: input is a length-n word, the syndrome is
//     H w mod 2, and the output is the estimated codeword w XOR e_hat
//     (the ldpc ctor's input_vector_type boundary, SURVEY.md 2.2 N1).
//
// One syndrome per decode() call, single thread — exactly the reference's
// execution model (reference css_decode_sim.py:519-520 decodes one
// syndrome at a time).  The measured syndromes/s from this binary replaces
// the round-1 *estimated* baseline in bench.py.
//
// Usage: cpu_baseline <H.txt> <p> <num_decodes> [max_iter] [osd_order]
//   H.txt: first line "m n", then m lines of n 0/1 chars (no spaces).
//   Prints one JSON line {"syndromes_per_sec": ..., ...}.
//
//        cpu_baseline <H.txt> <p> --decode <synd.txt> [max_iter] [osd_order]
//                     [bp_method] [ms_scale] [osd_method] [input_type]
//   synd.txt: one syndrome per line as m 0/1 chars (or one length-n word
//   per line when input_type == received_vector).  bp_method: ms|ps
//   (default ms); ms_scale: float, 0 = adaptive (default 0);
//   osd_method: osd_cs|osd_e|osd0 (default osd_cs); input_type:
//   syndrome|received_vector (default syndrome).  Prints one decoding per
//   line as n 0/1 chars (used by tests/test_cpu_baseline.py for
//   bit-for-bit comparison against the batched JAX decoder).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <string>
#include <algorithm>
#include <chrono>
#include <random>

namespace {

struct Csr {
    int m, n;
    std::vector<int> chk_ptr, chk_var;   // check -> variables
    std::vector<int> var_ptr, var_chk;   // variable -> checks
    std::vector<int> var_edge;           // variable -> flat edge ids (chk-major)
};

struct BpOsd {
    Csr g;
    int max_iter, osd_order;
    bool prod_sum = false;        // ps (tanh rule) instead of min-sum
    float ms_scale = 0.0f;        // 0 => adaptive 1 - 2^-t
    int osd_mode = 0;             // 0 = osd_cs, 1 = osd_e, 2 = osd0
    std::vector<float> llr0;      // [n] channel priors
    std::vector<float> v2c, c2v;  // [E] messages, check-major edge layout
    std::vector<float> total;     // [n] posterior llr
    std::vector<uint8_t> hard;    // [n]
    // OSD workspace
    int W;                                  // packed words per row (64 cols)
    std::vector<uint64_t> hrows;            // [m*W] pristine packed H
    std::vector<uint64_t> work;             // [m*W] elimination scratch
    std::vector<uint8_t> swork;             // [m] reduced syndrome
    std::vector<int> perm, pivot_col, pivot_row, t_cols;
    std::vector<uint8_t> used;
    std::vector<uint64_t> tcols_pack;       // [k*Wr] packed reduced T-columns
    std::vector<uint64_t> spack;            // [Wr] packed reduced syndrome
    std::vector<uint8_t> osd0, osdw;        // [n]

    void init(const Csr& graph, float p, int mi, int order) {
        g = graph;
        max_iter = mi ? mi : g.n;
        osd_order = order;
        llr0.assign(g.n, std::log((1.0f - p) / p));
        int E = (int)g.chk_var.size();
        v2c.resize(E);
        c2v.resize(E);
        total.resize(g.n);
        hard.resize(g.n);
        W = (g.n + 63) / 64;
        hrows.assign((size_t)g.m * W, 0);
        for (int i = 0; i < g.m; ++i)
            for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e) {
                int j = g.chk_var[e];
                hrows[(size_t)i * W + (j >> 6)] |= 1ull << (j & 63);
            }
        work.resize(hrows.size());
        swork.resize(g.m);
        perm.resize(g.n);
        pivot_col.resize(g.m);
        pivot_row.resize(g.m);
        used.resize(g.m);
        osd0.resize(g.n);
        osdw.resize(g.n);
    }

    // returns true if BP converged
    bool bp(const uint8_t* synd) {
        int E = (int)g.chk_var.size();
        for (int i = 0; i < g.m; ++i)
            for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e)
                v2c[e] = llr0[g.chk_var[e]];
        std::vector<float> th, fwd, bwd;  // ps scratch (row-weight sized)
        for (int it = 1; it <= max_iter; ++it) {
            if (!prod_sum) {
                // check update: scaled min-sum; alpha fixed, or the
                // adaptive 1 - 2^-it when ms_scale == 0
                float alpha = ms_scale != 0.0f
                                  ? ms_scale
                                  : 1.0f - std::exp2f(-(float)it);
                for (int i = 0; i < g.m; ++i) {
                    int lo = g.chk_ptr[i], hi = g.chk_ptr[i + 1];
                    // the 1e30f seeds double as the message SATURATION
                    // CAP: exclusive mins never exceed them, so f32
                    // magnitudes cannot overflow at long max_iter.  The
                    // JAX paths apply the identical cap (decoder/bp.py
                    // _check_update_min_sum) — load-bearing for
                    // bit-parity, do not change independently.
                    float min1 = 1e30f, min2 = 1e30f;
                    int amin = lo, negs = 0;
                    for (int e = lo; e < hi; ++e) {
                        float v = v2c[e];
                        negs += v < 0.0f;
                        float a = std::fabs(v);
                        if (a < min1) { min2 = min1; min1 = a; amin = e; }
                        else if (a < min2) { min2 = a; }
                    }
                    float base = (synd[i] ? -alpha : alpha);
                    for (int e = lo; e < hi; ++e) {
                        int sgn = (negs - (v2c[e] < 0.0f)) & 1;
                        float mag = (e == amin) ? min2 : min1;
                        c2v[e] = (sgn ? -base : base) * mag;
                    }
                }
            } else {
                // product-sum (tanh rule) with forward/backward exclusive
                // products — the same association order as the JAX path
                // (decoder/bp.py:_check_update_product_sum)
                for (int i = 0; i < g.m; ++i) {
                    int lo = g.chk_ptr[i], hi = g.chk_ptr[i + 1];
                    int w = hi - lo;
                    th.resize(w); fwd.resize(w); bwd.resize(w);
                    for (int e = 0; e < w; ++e)
                        th[e] = std::tanh(0.5f * v2c[lo + e]);
                    fwd[0] = 1.0f;
                    for (int e = 1; e < w; ++e) fwd[e] = fwd[e - 1] * th[e - 1];
                    bwd[w - 1] = 1.0f;
                    for (int e = w - 2; e >= 0; --e)
                        bwd[e] = bwd[e + 1] * th[e + 1];
                    float syn_sign = synd[i] ? -1.0f : 1.0f;
                    const float clipv = 1.0f - 1e-7f;  // bp.py:_TANH_CLIP
                    for (int e = 0; e < w; ++e) {
                        float ex = syn_sign * fwd[e] * bwd[e];
                        ex = std::fmax(-clipv, std::fmin(clipv, ex));
                        c2v[lo + e] = 2.0f * std::atanh(ex);
                    }
                }
            }
            // variable update + hard decision
            for (int j = 0; j < g.n; ++j) {
                float t = llr0[j];
                for (int e = g.var_ptr[j]; e < g.var_ptr[j + 1]; ++e)
                    t += c2v[g.var_edge[e]];
                total[j] = t;
                hard[j] = t <= 0.0f;
            }
            // convergence: H hard == synd
            bool ok = true;
            for (int i = 0; i < g.m && ok; ++i) {
                int s = 0;
                for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e)
                    s ^= hard[g.chk_var[e]];
                ok = s == synd[i];
            }
            if (ok) return true;
            if (it == max_iter) break;
            // v2c for next iteration
            for (int j = 0; j < g.n; ++j) {
                float t = total[j];
                for (int e = g.var_ptr[j]; e < g.var_ptr[j + 1]; ++e) {
                    int fe = g.var_edge[e];
                    v2c[fe] = t - c2v[fe];
                }
            }
        }
        return false;
    }

    void osd(const uint8_t* synd) {
        int n = g.n, m = g.m;
        // stable reliability sort: most-likely-in-error (lowest llr) first
        for (int j = 0; j < n; ++j) perm[j] = j;
        std::stable_sort(perm.begin(), perm.end(),
                         [&](int a, int b) { return total[a] < total[b]; });
        // Gauss-Jordan in column order; pivot rows stay in place
        std::memcpy(work.data(), hrows.data(), hrows.size() * 8);
        std::memcpy(swork.data(), synd, m);
        std::fill(used.begin(), used.end(), 0);
        int r = 0;
        int k = 0;
        t_cols.clear();
        for (int t = 0; t < n; ++t) {
            int col = perm[t];
            int w = col >> 6;
            uint64_t bit = 1ull << (col & 63);
            int pr = -1;
            for (int i = 0; i < m; ++i)
                if (!used[i] && (work[(size_t)i * W + w] & bit)) { pr = i; break; }
            if (pr < 0) { t_cols.push_back(col); ++k; continue; }
            const uint64_t* prow = &work[(size_t)pr * W];
            uint8_t spiv = swork[pr];
            for (int i = 0; i < m; ++i) {
                if (i == pr) continue;
                if (work[(size_t)i * W + w] & bit) {
                    uint64_t* dst = &work[(size_t)i * W];
                    for (int q = 0; q < W; ++q) dst[q] ^= prow[q];
                    swork[i] ^= spiv;
                }
            }
            used[pr] = 1;
            pivot_col[r] = col;
            pivot_row[r] = pr;
            ++r;
        }
        // osd0: e[pivot_col[i]] = reduced syndrome at pivot row i
        std::fill(osd0.begin(), osd0.end(), 0);
        for (int i = 0; i < r; ++i) osd0[pivot_col[i]] = swork[pivot_row[i]];
        if (osd_mode == 2 || osd_order == 0 || k == 0) { osdw = osd0; return; }

        // pack reduced syndrome and reduced T-columns along the pivot axis
        int Wr = (r + 63) / 64;
        spack.assign(Wr, 0);
        for (int i = 0; i < r; ++i)
            if (swork[pivot_row[i]]) spack[i >> 6] |= 1ull << (i & 63);
        tcols_pack.assign((size_t)k * Wr, 0);
        for (int c = 0; c < k; ++c) {
            int col = t_cols[c], w = col >> 6;
            uint64_t bit = 1ull << (col & 63);
            uint64_t* dst = &tcols_pack[(size_t)c * Wr];
            for (int i = 0; i < r; ++i)
                if (work[(size_t)pivot_row[i] * W + w] & bit)
                    dst[i >> 6] |= 1ull << (i & 63);
        }
        auto popw = [&](const uint64_t* a) {
            int s = 0;
            for (int q = 0; q < Wr; ++q) s += __builtin_popcountll(a[q]);
            return s;
        };
        std::vector<uint64_t> tmp(Wr);
        int lam = std::min(osd_order, k);
        if (osd_mode == 1) {
            // the Python side caps osd_e at order 16 (_MAX_OSD_E_ORDER);
            // mirror the cap here — beyond it `1u << lam` with lam >= 32
            // is undefined behavior (round-4 ADVICE item 2), and the CLI
            // default order (42) is an osd_cs depth, not an osd_e one
            lam = std::min(lam, 16);
            // osd_e: exhaustive over all 2^lam patterns on the first lam
            // T-positions, counting order, FIRST minimum wins ties — the
            // same candidate order as decoder/osd.py:_search_osd_e
            uint32_t best_pat = 0;
            int best_w = popw(spack.data());
            for (uint32_t pat = 1; pat < (1u << lam); ++pat) {
                std::memcpy(tmp.data(), spack.data(), Wr * 8);
                for (int a = 0; a < lam; ++a)
                    if ((pat >> a) & 1) {
                        const uint64_t* cc = &tcols_pack[(size_t)a * Wr];
                        for (int q = 0; q < Wr; ++q) tmp[q] ^= cc[q];
                    }
                int s = __builtin_popcount(pat);
                for (int q = 0; q < Wr; ++q)
                    s += __builtin_popcountll(tmp[q]);
                if (s < best_w) { best_w = s; best_pat = pat; }
            }
            std::fill(osdw.begin(), osdw.end(), 0);
            std::memcpy(tmp.data(), spack.data(), Wr * 8);
            for (int a = 0; a < lam; ++a)
                if ((best_pat >> a) & 1) {
                    osdw[t_cols[a]] = 1;
                    const uint64_t* cc = &tcols_pack[(size_t)a * Wr];
                    for (int q = 0; q < Wr; ++q) tmp[q] ^= cc[q];
                }
            for (int i = 0; i < r; ++i)
                osdw[pivot_col[i]] = (tmp[i >> 6] >> (i & 63)) & 1;
            return;
        }
        // candidate 0: the zero pattern (osd0 itself)
        int best_w = popw(spack.data());
        int best_i = -1, best_j = -1;  // chosen T flips (-1 = none)
        // weight-1 sweep over ALL of T
        for (int c = 0; c < k; ++c) {
            const uint64_t* cc = &tcols_pack[(size_t)c * Wr];
            int s = 1;
            for (int q = 0; q < Wr; ++q)
                s += __builtin_popcountll(spack[q] ^ cc[q]);
            if (s < best_w) { best_w = s; best_i = c; best_j = -1; }
        }
        // weight-2 sweep over the first `osd_order` T-positions
        for (int a = 0; a < lam; ++a) {
            const uint64_t* ca = &tcols_pack[(size_t)a * Wr];
            for (int b = a + 1; b < lam; ++b) {
                const uint64_t* cb = &tcols_pack[(size_t)b * Wr];
                int s = 2;
                for (int q = 0; q < Wr; ++q)
                    s += __builtin_popcountll(spack[q] ^ ca[q] ^ cb[q]);
                if (s < best_w) { best_w = s; best_i = a; best_j = b; }
            }
        }
        // reconstruct the winning candidate
        std::fill(osdw.begin(), osdw.end(), 0);
        std::memcpy(tmp.data(), spack.data(), Wr * 8);
        if (best_i >= 0) {
            osdw[t_cols[best_i]] = 1;
            const uint64_t* cc = &tcols_pack[(size_t)best_i * Wr];
            for (int q = 0; q < Wr; ++q) tmp[q] ^= cc[q];
        }
        if (best_j >= 0) {
            osdw[t_cols[best_j]] = 1;
            const uint64_t* cc = &tcols_pack[(size_t)best_j * Wr];
            for (int q = 0; q < Wr; ++q) tmp[q] ^= cc[q];
        }
        for (int i = 0; i < r; ++i)
            osdw[pivot_col[i]] = (tmp[i >> 6] >> (i & 63)) & 1;
    }

    // full decode; returns checksum of the decoding (prevents dead-code elim)
    uint64_t decode(const uint8_t* synd) {
        bool conv = bp(synd);
        const uint8_t* out;
        if (conv) {
            out = hard.data();
        } else {
            osd(synd);
            out = osdw.data();
        }
        uint64_t cs = 0;
        for (int j = 0; j < g.n; ++j) cs += out[j];
        return cs;
    }
};

}  // namespace

int main(int argc, char** argv) {
    if (argc < 4) {
        std::fprintf(stderr,
                     "usage: %s H.txt p num_decodes [max_iter] [osd_order]\n",
                     argv[0]);
        return 2;
    }
    FILE* f = std::fopen(argv[1], "r");
    if (!f) { std::fprintf(stderr, "cannot open %s\n", argv[1]); return 2; }
    int m, n;
    if (std::fscanf(f, "%d %d", &m, &n) != 2) return 2;
    std::vector<std::string> rows(m);
    {
        char buf[1 << 16];
        for (int i = 0; i < m; ++i) {
            if (std::fscanf(f, "%65535s", buf) != 1) return 2;
            rows[i] = buf;
        }
    }
    std::fclose(f);

    Csr g;
    g.m = m;
    g.n = n;
    g.chk_ptr.assign(m + 1, 0);
    for (int i = 0; i < m; ++i) {
        g.chk_ptr[i] = (int)g.chk_var.size();
        for (int j = 0; j < n; ++j)
            if (rows[i][j] == '1') g.chk_var.push_back(j);
    }
    g.chk_ptr[m] = (int)g.chk_var.size();
    g.var_ptr.assign(n + 1, 0);
    for (int e : g.chk_var) g.var_ptr[e + 1]++;
    for (int j = 0; j < n; ++j) g.var_ptr[j + 1] += g.var_ptr[j];
    g.var_edge.resize(g.chk_var.size());
    {
        std::vector<int> cur(g.var_ptr.begin(), g.var_ptr.end() - 1);
        for (int i = 0; i < m; ++i)
            for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e)
                g.var_edge[cur[g.chk_var[e]]++] = e;
    }

    float p = std::atof(argv[2]);
    int max_iter = argc > 5 ? std::atoi(argv[5]) : 0;
    int osd_order = argc > 6 ? std::atoi(argv[6]) : 42;
    bool decode_mode = std::strcmp(argv[3], "--decode") == 0;
    bool prod_sum = false, received = false;
    float ms_scale = 0.0f;
    int osd_mode = 0;
    if (!decode_mode) {
        max_iter = argc > 4 ? std::atoi(argv[4]) : 0;
        osd_order = argc > 5 ? std::atoi(argv[5]) : 42;
    } else {
        if (argc > 7) prod_sum = std::strcmp(argv[7], "ps") == 0;
        if (argc > 8) ms_scale = (float)std::atof(argv[8]);
        if (argc > 9) {
            if (std::strcmp(argv[9], "osd_e") == 0) osd_mode = 1;
            else if (std::strcmp(argv[9], "osd0") == 0) osd_mode = 2;
        }
        if (argc > 10)
            received = std::strcmp(argv[10], "received_vector") == 0;
    }

    BpOsd dec;
    dec.init(g, p, max_iter, osd_order);
    dec.prod_sum = prod_sum;
    dec.ms_scale = ms_scale;
    dec.osd_mode = osd_mode;

    if (decode_mode) {
        FILE* sf = std::fopen(argv[4], "r");
        if (!sf) { std::fprintf(stderr, "cannot open %s\n", argv[4]); return 2; }
        std::vector<uint8_t> s(m), w(n);
        std::vector<char> out(n + 2);
        char buf[1 << 16];
        while (std::fscanf(sf, "%65535s", buf) == 1) {
            if (received) {
                // input is a length-n word: syndrome = H w mod 2
                for (int j = 0; j < n; ++j) w[j] = buf[j] == '1';
                for (int i = 0; i < m; ++i) {
                    int acc = 0;
                    for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e)
                        acc ^= w[g.chk_var[e]];
                    s[i] = (uint8_t)acc;
                }
            } else {
                for (int i = 0; i < m; ++i) s[i] = buf[i] == '1';
            }
            bool conv = dec.bp(s.data());
            const uint8_t* e;
            if (conv) {
                e = dec.hard.data();
            } else {
                dec.osd(s.data());
                e = dec.osdw.data();
            }
            // received-vector mode returns the estimated CODEWORD w ^ e
            for (int j = 0; j < n; ++j)
                out[j] = (e[j] ^ (received ? w[j] : 0)) ? '1' : '0';
            out[n] = '\n';
            out[n + 1] = 0;
            std::fputs(out.data(), stdout);
        }
        std::fclose(sf);
        return 0;
    }

    long num = std::atol(argv[3]);

    // pre-sample all errors/syndromes so only decode time is measured
    std::mt19937_64 rng(12345);
    std::uniform_real_distribution<float> uni(0.0f, 1.0f);
    std::vector<uint8_t> synds((size_t)num * m);
    std::vector<uint8_t> err(n);
    long bp_conv = 0;
    for (long t = 0; t < num; ++t) {
        for (int j = 0; j < n; ++j) err[j] = uni(rng) < p;
        uint8_t* s = &synds[(size_t)t * m];
        for (int i = 0; i < m; ++i) {
            int acc = 0;
            for (int e = g.chk_ptr[i]; e < g.chk_ptr[i + 1]; ++e)
                acc ^= err[g.chk_var[e]];
            s[i] = (uint8_t)acc;
        }
    }

    uint64_t checksum = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (long t = 0; t < num; ++t)
        checksum += dec.decode(&synds[(size_t)t * m]);
    auto t1 = std::chrono::steady_clock::now();
    double dt = std::chrono::duration<double>(t1 - t0).count();

    std::printf(
        "{\"syndromes_per_sec\": %.1f, \"num_decodes\": %ld, "
        "\"elapsed_s\": %.3f, \"max_iter\": %d, \"osd_order\": %d, "
        "\"checksum\": %llu}\n",
        num / dt, num, dt, dec.max_iter, osd_order,
        (unsigned long long)checksum);
    return 0;
}
