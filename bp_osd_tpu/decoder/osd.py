"""Batched ordered-statistics decoding (OSD) post-processing.

Batched XLA re-design of the reference's native OSD stage (interface at
reference ``README.md:185-187``: ``osd_method`` in {"osd_e", "osd_cs",
"osd0"} with ``osd_order``; outputs ``osd0_decoding``/``osdw_decoding`` at
reference ``css_decode_sim.py:257-295``).

Pipeline per syndrome batch (everything fixed-shape, jit-compiled):

1. Rank qubits by BP soft output (log-prob ratio ascending = most likely in
   error first); stable argsort pins the tie order.
2. Branch-free batched GF(2) Gauss-Jordan elimination over the row-packed
   PCM (uint32 words, 32 columns per lane): visiting columns in reliability
   order, each step swaps a pivot row into place and XORs it into every
   other row carrying that column — all as masked vector ops over
   ``[B, m, W]``.  The number of pivots is the (static) rank of H, so all
   output shapes are static; a ``while_loop`` exits as soon as every sample
   in the batch has found all pivots.
3. OSD-0: read the solution off the reduced syndrome at the pivot columns.
4. OSD-w search over the "bad" set T (non-pivot columns in reliability
   order):
   - ``osd_e``  : all ``2^order`` patterns on the first ``order`` T-bits,
     evaluated as candidate-blocked mod-2 matmuls.
   - ``osd_cs`` : all weight-1 patterns on T plus all weight-2 patterns on
     the first ``order`` T-bits (the combination-sweep of arXiv:2005.07016),
     evaluated with bit-packed XOR + popcount.
   The candidate minimizing total Hamming weight (solution + pattern) wins;
   ties resolve to the earliest candidate in search order.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .tanner import TannerGraph

__all__ = ["OSD_METHODS", "OsdResult", "normalize_osd_method", "osd_decode"]

OSD_METHODS = {
    "osd0": "osd0",
    "osd_0": "osd0",
    "zero": "osd0",
    "osd_e": "osd_e",
    "osde": "osd_e",
    "exhaustive": "osd_e",
    "osd_cs": "osd_cs",
    "osdcs": "osd_cs",
    "combination_sweep": "osd_cs",
}


class OsdConsts(NamedTuple):
    """Host-built candidate-search tables, passed through jit as arguments
    (as the graph is; see the TannerGraph docstring)."""

    patterns: object = None  # osd_e: [C, lam] uint8 bit patterns
    pattern_weights: object = None  # osd_e: [C] int32 popcounts
    pairs: object = None  # osd_cs: [C2, 2] int32 (i < j) index pairs

_MAX_OSD_E_ORDER = 16
_CAND_BLOCK = 256  # candidates per matmul block in the osd_e search


def normalize_osd_method(osd_method) -> str:
    key = str(osd_method).lower()
    if key not in OSD_METHODS:
        raise ValueError(
            f"unknown osd_method {osd_method!r}; choose osd0/osd_e/osd_cs"
        )
    return OSD_METHODS[key]


class OsdResult(NamedTuple):
    osd0: jnp.ndarray  # [B, n] uint8
    osdw: jnp.ndarray  # [B, n] uint8


def build_osd_consts(graph: "TannerGraph", osd_method, osd_order: int) -> OsdConsts:
    """Precompute the candidate tables for a (method, order, graph) config."""
    method = normalize_osd_method(osd_method)
    k = graph.n - graph.rank
    if method == "osd0" or osd_order == 0 or k == 0:
        return OsdConsts()
    if method == "osd_e":
        P, pw = _exhaustive_patterns(min(int(osd_order), k))
        return OsdConsts(patterns=P, pattern_weights=pw)
    lam = min(int(osd_order), k)
    if lam >= 2:
        return OsdConsts(pairs=_pair_indices(lam))
    return OsdConsts()


@lru_cache(maxsize=None)
def _exhaustive_patterns(order: int) -> tuple[np.ndarray, np.ndarray]:
    """All 2^order bit patterns [C, order] in counting order + their weights."""
    C = 1 << order
    i = np.arange(C, dtype=np.uint32)
    bits = ((i[:, None] >> np.arange(order, dtype=np.uint32)[None, :]) & 1).astype(
        np.uint8
    )
    return bits, bits.sum(axis=1).astype(np.int32)


@lru_cache(maxsize=None)
def _pair_indices(lam: int) -> np.ndarray:
    """Lexicographic (i < j) pairs over the first ``lam`` T-positions."""
    idx = [(i, j) for i in range(lam) for j in range(i + 1, lam)]
    return np.asarray(idx, dtype=np.int32).reshape(-1, 2)


def _pack_bits_u32(bits, axis_size):
    """Pack 0/1 int bits along the last axis into uint32 words."""
    pad = (-axis_size) % 32
    if pad:
        widths = [(0, 0)] * (bits.ndim - 1) + [(0, pad)]
        bits = jnp.pad(bits, widths)
    shape = bits.shape[:-1] + ((axis_size + pad) // 32, 32)
    words = bits.reshape(shape).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)


def _popcount_sum(words):
    """Sum of popcounts along the last (word) axis."""
    return jnp.sum(jax.lax.population_count(words), axis=-1).astype(jnp.int32)


def _eliminate(graph: TannerGraph, perm, synd, skip=None):
    """Batched Gauss-Jordan elimination of H in per-sample column order.

    Swap-free formulation: pivot rows stay in place and are tracked in
    ``pivot_rows``, which halves the per-step passes over the packed
    matrix.  Every per-step "gather" is a shift + one-hot masked
    reduction; whether a dynamic gather is cheaper on the GPU is not yet
    measured.

    Args:
      perm:  [B, n] column visiting order (reliability sort).
      synd:  [B, m] syndrome bits (int32).
      skip:  [B] optional bool/int; marked samples start "done" (their
             outputs are undefined and must be masked by the caller).

    Returns:
      h_work:     [B, m, W] fully reduced packed matrix.
      s_work:     [B, m] reduced syndrome bits.
      pivot_ids:  [B, r] original column index of pivot i.
      pivot_rows: [B, r] row holding pivot i.
      pivot_mask: [B, n] True at sorted positions that produced a pivot.
    """
    m, n, W, r = graph.m, graph.n, graph.num_words, graph.rank
    B = perm.shape[0]
    h0 = jnp.broadcast_to(jnp.asarray(graph.H_packed), (B, m, W))
    rowidx = jax.lax.broadcasted_iota(jnp.int32, (1, m), 1)
    wordidx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W), 2)

    def body(state):
        t, h_work, s_work, used, rr, pivot_ids, pivot_rows, pivot_mask = state
        col = jax.lax.dynamic_index_in_dim(perm, t, axis=1, keepdims=False)
        w = (col >> 5).astype(jnp.int32)
        b = (col & 31).astype(jnp.uint32)

        # pivot-column bits: one-hot word select + per-sample shift
        word_sel = (wordidx == w[:, None, None]).astype(jnp.uint32)
        word = jnp.sum(h_work * word_sel, axis=2)  # [B, m]
        colbits = ((word >> b[:, None]) & 1).astype(jnp.int32)

        eligible = (colbits == 1) & ~used
        has = jnp.any(eligible, axis=1) & (rr < r)
        pr = jnp.argmax(eligible, axis=1).astype(jnp.int32)

        # pivot row contents via one-hot masked reduction
        onehot_pr = ((rowidx == pr[:, None]) & has[:, None])
        piv_data = jnp.sum(
            h_work * onehot_pr[:, :, None].astype(jnp.uint32), axis=1
        )  # [B, W]
        s_piv = jnp.sum(s_work * onehot_pr.astype(jnp.int32), axis=1)  # [B]

        # Jordan step: clear the column from every other row
        elim = (colbits == 1) & (rowidx != pr[:, None]) & has[:, None]
        h_work = h_work ^ (elim[:, :, None].astype(jnp.uint32) * piv_data[:, None, :])
        s_work = s_work ^ (elim.astype(jnp.int32) * s_piv[:, None])

        bidx = jnp.arange(B)
        slot = jnp.clip(rr, 0, r - 1)
        pivot_ids = pivot_ids.at[bidx, slot].set(
            jnp.where(has, col, pivot_ids[bidx, slot])
        )
        pivot_rows = pivot_rows.at[bidx, slot].set(
            jnp.where(has, pr, pivot_rows[bidx, slot])
        )
        pivot_mask = pivot_mask.at[:, t].set(has)
        used = used | onehot_pr
        rr = rr + has.astype(jnp.int32)
        return t + 1, h_work, s_work, used, rr, pivot_ids, pivot_rows, pivot_mask

    def cond(state):
        t, _, _, _, rr, _, _, _ = state
        return (t < n) & (jnp.min(rr) < r)

    rr0 = (
        jnp.zeros((B,), jnp.int32)
        if skip is None
        else jnp.asarray(skip).astype(jnp.int32) * r
    )
    init = (
        jnp.int32(0),
        h0,
        synd.astype(jnp.int32),
        jnp.zeros((B, m), bool),
        rr0,
        jnp.zeros((B, r), jnp.int32),
        jnp.zeros((B, r), jnp.int32),
        jnp.zeros((B, n), bool),
    )
    _, h_work, s_work, _, _, pivot_ids, pivot_rows, pivot_mask = (
        jax.lax.while_loop(cond, body, init)
    )
    return h_work, s_work, pivot_ids, pivot_rows, pivot_mask


def _extract_t_columns(graph, h_rows, perm, pivot_mask):
    """Original ids and reduced-column bits of the non-pivot ("bad") set T.

    ``h_rows [B, r, W]`` are the pivot rows of the reduced matrix.  The
    per-column word selection runs as one-hot matmuls over 8-bit chunks of
    each word instead of a minor-axis gather.  Chunks are 8 bits so the
    selection is exact at the default matmul precision, which on the GPU
    is TF32: its 10-bit mantissa holds every value <= 255 exactly, and each
    output sums exactly one nonzero product.  Wider chunks silently lose
    low bits (a real decode-corrupting bug once, caught by
    ``tests/test_cpu_baseline.py``).
    """
    n, r = graph.n, graph.rank
    k = n - r
    B = perm.shape[0]
    W = graph.num_words
    # stable sort moves non-pivot sorted-positions (False=0) to the front,
    # preserving reliability order within T
    tpos = jnp.argsort(pivot_mask.astype(jnp.int32), axis=1, stable=True)[:, :k]
    t_cols = jnp.take_along_axis(perm, tpos, axis=1)  # [B, k]
    w = (t_cols >> 5).astype(jnp.int32)
    b = (t_cols & 31).astype(jnp.uint32)

    wordidx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W), 2)
    onehot_w = (wordidx == w[:, :, None]).astype(jnp.float32)  # [B, k, W]
    words = jnp.zeros((B, r, k), jnp.uint32)
    for shift in (0, 8, 16, 24):
        chunk = ((h_rows >> jnp.uint32(shift)) & jnp.uint32(0xFF)).astype(
            jnp.float32
        )
        # default precision on purpose: exact in TF32 (see docstring)
        sel = jnp.einsum(
            "brw,bkw->brk", chunk, onehot_w,
            preferred_element_type=jnp.float32,
        )
        words = words | (sel.astype(jnp.uint32) << shift)
    t_bits = ((words >> b[:, None, :]) & 1).astype(jnp.int32)  # [B, r, k]
    return t_cols, t_bits


def _scatter_solution(n, pivot_ids, e_pivots, t_cols=None, e_t=None):
    """Assemble an error vector from pivot/T values in original indexing."""
    B = pivot_ids.shape[0]
    bidx = jnp.arange(B)[:, None]
    e = jnp.zeros((B, n), jnp.int32).at[bidx, pivot_ids].set(e_pivots)
    if t_cols is not None:
        e = e.at[bidx, t_cols].set(e_t)
    return e


def _search_osd_e(order, s_rows, t_bits, patterns, pattern_weights):
    """Exhaustive search over 2^order patterns on the first ``order`` T-bits.

    Returns (best_weight_index_pattern [B, k_active], e_pivots [B, r]).
    Candidate parities are evaluated as blocked f32 matmuls: exact because
    sums are bounded by ``order`` << 2^24.
    """
    B, r, k = t_bits.shape
    C, lam = patterns.shape
    t_active = t_bits[:, :, :lam].astype(jnp.float32)  # [B, r, lam]
    s_f = s_rows.astype(jnp.float32)

    Pj = patterns.astype(jnp.float32)
    pwj = jnp.asarray(pattern_weights)

    nblk = -(-C // _CAND_BLOCK)
    pad = nblk * _CAND_BLOCK - C
    P_blocks = jnp.pad(Pj, ((0, pad), (0, 0))).reshape(nblk, _CAND_BLOCK, lam)
    pw_blocks = jnp.pad(pwj, (0, pad), constant_values=10**6).reshape(
        nblk, _CAND_BLOCK
    )

    def block_weights(args):
        Pb, pwb = args
        # [C_b, lam] x [B, r, lam] -> [B, C_b, r] parity; 0/1 operands and
        # sums <= lam are exact at default (TF32) precision
        acc = jnp.einsum(
            "cl,brl->bcr", Pb, t_active, preferred_element_type=jnp.float32
        )
        parity = jnp.mod(acc + s_f[:, None, :], 2.0)
        return jnp.sum(parity, axis=-1).astype(jnp.int32) + pwb[None, :]

    weights = jax.lax.map(block_weights, (P_blocks, pw_blocks))  # [nblk, B, C_b]
    weights = jnp.moveaxis(weights, 0, 1).reshape(B, nblk * _CAND_BLOCK)
    best = jnp.argmin(weights, axis=1)  # first minimum wins ties

    p_best = patterns.astype(jnp.int32)[best]  # [B, lam]
    # 0/1 parity matmul: exact at default (TF32) precision
    e_piv = (
        jnp.einsum(
            "bl,brl->br",
            p_best.astype(jnp.float32),
            t_active,
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        + s_rows
    ) & 1
    pattern = jnp.zeros((B, k), jnp.int32).at[:, :lam].set(p_best)
    return pattern, e_piv


def _search_osd_cs(order, s_rows, t_bits, pairs):
    """Combination-sweep: weight-1 over all of T, weight-2 over first ``order``.

    Bit-packed along the row axis: candidate residuals are XORs of packed
    reduced columns, weights via popcount — integer-exact and 32x denser
    than a dense parity matmul.
    """
    B, r, k = t_bits.shape

    s_pack = _pack_bits_u32(s_rows, r)  # [B, Ws]
    # pack columns: [B, k, r] bits -> [B, k, Ws]
    cols_pack = _pack_bits_u32(jnp.swapaxes(t_bits, 1, 2), r)

    w0 = _popcount_sum(s_pack)  # [B]
    w1 = _popcount_sum(s_pack[:, None, :] ^ cols_pack) + 1  # [B, k]

    if pairs is not None:
        ci = cols_pack[:, pairs[:, 0], :]  # [B, C2, Ws]
        cj = cols_pack[:, pairs[:, 1], :]
        w2 = _popcount_sum(s_pack[:, None, :] ^ ci ^ cj) + 2  # [B, C2]
        weights = jnp.concatenate([w0[:, None], w1, w2], axis=1)
    else:
        weights = jnp.concatenate([w0[:, None], w1], axis=1)

    best = jnp.argmin(weights, axis=1)  # candidate order: zero, w1, w2

    # reconstruct the winning pattern over T
    B_idx = jnp.arange(B)
    in_w1 = (best >= 1) & (best <= k)
    j1 = jnp.clip(best - 1, 0, k - 1)
    pattern = jnp.zeros((B, k), jnp.int32)
    pattern = pattern.at[B_idx, j1].add(in_w1.astype(jnp.int32))
    if pairs is not None:
        in_w2 = best > k
        p2 = jnp.clip(best - 1 - k, 0, pairs.shape[0] - 1)
        i2 = pairs[p2, 0]
        j2 = pairs[p2, 1]
        pattern = pattern.at[B_idx, i2].add(in_w2.astype(jnp.int32))
        pattern = pattern.at[B_idx, j2].add(in_w2.astype(jnp.int32))

    # 0/1 parity matmul (pattern weight <= 2): exact at default precision
    e_piv = (
        jnp.einsum(
            "bk,brk->br",
            pattern.astype(jnp.float32),
            t_bits.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        + s_rows
    ) & 1
    return pattern, e_piv


def osd_decode(
    graph: TannerGraph,
    syndromes,
    llr,
    *,
    osd_method: str = "osd0",
    osd_order: int = 0,
    consts: OsdConsts | None = None,
    skip=None,
) -> OsdResult:
    """Run OSD on a batch given BP soft outputs ``llr`` ([B, n]).

    ``skip`` ([B] bool, optional) marks samples that do not need OSD (BP
    already converged): their elimination is bypassed and their outputs
    are undefined — the caller selects the BP decoding for them anyway.
    The elimination loop exits once every live sample has its pivots.

    ``consts`` are the host-built candidate tables from
    :func:`build_osd_consts`.  When jitting, build them outside and pass
    them *through* the jit boundary as arguments; if omitted they are
    built at trace time.
    """
    method = normalize_osd_method(osd_method)
    if method == "osd_e" and osd_order > _MAX_OSD_E_ORDER:
        raise ValueError(
            f"osd_e order {osd_order} would enumerate 2^{osd_order} patterns; "
            f"max supported is {_MAX_OSD_E_ORDER} (use osd_cs for deep search)"
        )
    if consts is None:
        consts = build_osd_consts(graph, method, osd_order)
    n, r = graph.n, graph.rank

    synd = jnp.asarray(syndromes).astype(jnp.int32)
    llr = jnp.asarray(llr, jnp.float32)
    perm = jnp.argsort(llr, axis=1, stable=True).astype(jnp.int32)  # [B, n]

    h_work, s_work, pivot_ids, pivot_rows, pivot_mask = _eliminate(
        graph, perm, synd, skip=skip
    )
    # pivot i lives in row pivot_rows[:, i]; gather once (O(B*r) scalars)
    s_rows = jnp.take_along_axis(s_work, pivot_rows, axis=1)  # [B, r]

    e0 = _scatter_solution(n, pivot_ids, s_rows)

    no_search = method == "osd0" or osd_order == 0 or n == r
    if no_search:
        e_w = e0
    else:
        h_rows = jnp.take_along_axis(h_work, pivot_rows[:, :, None], axis=1)
        t_cols, t_bits = _extract_t_columns(graph, h_rows, perm, pivot_mask)
        if method == "osd_e":
            pattern, e_piv = _search_osd_e(
                osd_order, s_rows, t_bits,
                jnp.asarray(consts.patterns), jnp.asarray(consts.pattern_weights),
            )
        else:
            pairs = (
                jnp.asarray(consts.pairs) if consts.pairs is not None else None
            )
            pattern, e_piv = _search_osd_cs(osd_order, s_rows, t_bits, pairs)
        e_w = _scatter_solution(n, pivot_ids, e_piv, t_cols, pattern)

    return OsdResult(osd0=e0.astype(jnp.uint8), osdw=e_w.astype(jnp.uint8))
