"""Structure-aware BP for protograph-lifted (block-circulant) codes.

The generic decode path treats the parity-check matrix as unstructured:
it gathers through runtime index arrays or routes through dense one-hot
operators (~0.5 GB at n ~ 10^4).  But a
lifted-product matrix (``codes/lifted_product.py``, the Panteleev-Kalachev
construction behind every n ~ 10^4 qLDPC family) is fully described by a
small protograph of cyclic-shift exponents over ``F2[x]/(x^L - 1)``:

    H[(I, l), (J, l')] = 1  iff  l' = (l + e) mod L for some e in proto[I][J]

so var->edge and edge->var routing are STATIC CYCLIC SHIFTS of length-L
blocks — ``jnp.roll`` with compile-time shifts, which XLA lowers to two
slices and a concatenate.  No gathers, no index arrays, no one-hot
operators.

Layout: every tensor carries the batch on the minor axis and the cyclic
index L on the second-minor axis — ``[.., L, B]`` — so each roll moves
whole contiguous batch rows instead of shifting the minor axis.  The
check-node update therefore reduces over the MAJOR ``wr`` axis with the
same min/sign arithmetic as ``decoder/bp.py:_check_update_min_sum``
(first-minimum tie rule on the slot index), keeping min-sum outputs
bit-identical to the dense path — asserted by ``tests/test_lifted_bp.py``.

Reference scope: the reference repo has no counterpart (its largest
shipped code is the [[900,36,10]] HGP; SURVEY.md section 2.3 names large
lifted-product support as a new-framework responsibility).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .bp import BPResult, adaptive_alpha, normalize_bp_method

__all__ = ["LiftedGraph", "bp_decode_lifted"]

_BIG = 1e30
_TANH_CLIP = 1.0 - 1e-7


class LiftedGraph:
    """Static routing descriptor of a protograph lift.

    ``proto`` is a nested list of exponent tuples (entry (I, J) =
    ``sum_k x^e_k``, empty tuple = zero), exactly as stored by
    ``codes.lifted_product.lifted_hgp`` in ``.hx_proto`` / ``.hz_proto``.
    Everything here is host-side python — the structure enters the jitted
    decode as compile-time constants (static shifts), not arrays.
    """

    def __init__(self, proto, lift: int):
        self.L = int(lift)
        self.mp = len(proto)
        self.np_ = len(proto[0]) if self.mp else 0
        self.m = self.mp * self.L
        self.n = self.np_ * self.L
        # per check block-row: list of (var block J, shift e)
        self.edges = [
            [(J, int(e) % self.L) for J, exps in enumerate(row) for e in exps]
            for row in proto
        ]
        self.wr = max((len(e) for e in self.edges), default=1)
        mask = np.zeros((self.wr, self.mp, 1, 1), np.bool_)
        for I, row in enumerate(self.edges):
            mask[: len(row), I] = True
        self.chk_mask = mask  # [wr, mp, 1, 1]


def bp_decode_lifted(
    graph: LiftedGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
) -> BPResult:
    """Batched BP decode on a lifted graph; jit-compatible, shift-routed.

    Same contract as :func:`decoder.bp.bp_decode`; ``syndromes`` is
    [B, m] with checks ordered (block I, cyclic index l) and variables
    (block J, l) — the natural order of ``protograph_to_binary``.
    """
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n
    L, mp, np_, wr = graph.L, graph.mp, graph.np_, graph.wr
    n = graph.n

    syndromes = jnp.asarray(syndromes)
    if syndromes.ndim == 1:
        syndromes = syndromes[None, :]
    B = syndromes.shape[0]
    synd = syndromes.astype(jnp.int32)
    # [mp, L, B]: batch minor, cyclic index second-minor
    synd_t = jnp.transpose(synd.reshape(B, mp, L), (1, 2, 0))
    syn_sign = (1.0 - 2.0 * synd_t.astype(jnp.float32))[None]  # [1,mp,L,B]
    chk_mask = jnp.asarray(graph.chk_mask)  # [wr, mp, 1, 1]

    llr0 = jnp.broadcast_to(jnp.asarray(llr0, jnp.float32), (B, n))
    llr0_t = jnp.transpose(llr0.reshape(B, np_, L), (1, 2, 0))  # [np_,L,B]

    def var_to_edge(x):  # [np_, L, B] -> [wr, mp, L, B]
        zeros = jnp.zeros((L, B), jnp.float32)
        rows = []
        for s in range(wr):
            row = []
            for I in range(mp):
                if s < len(graph.edges[I]):
                    J, e = graph.edges[I][s]
                    row.append(jnp.roll(x[J], -e, axis=0))
                else:
                    row.append(zeros)
            rows.append(jnp.stack(row, axis=0))  # [mp, L, B]
        return jnp.stack(rows, axis=0)

    def edge_to_var(c2v):  # [wr, mp, L, B] -> [np_, L, B]
        acc = [jnp.zeros((L, B), jnp.float32) for _ in range(np_)]
        for I in range(mp):
            for s, (J, e) in enumerate(graph.edges[I]):
                acc[J] = acc[J] + jnp.roll(c2v[s, I], e, axis=0)
        return jnp.stack(acc, axis=0)

    def syndrome_of(hard_t):  # [np_, L, B] int -> [mp, L, B]
        outs = []
        for I in range(mp):
            p = jnp.zeros((L, B), jnp.int32)
            for (J, e) in graph.edges[I]:
                p = p ^ jnp.roll(hard_t[J], -e, axis=0)
            outs.append(p)
        return jnp.stack(outs, axis=0)

    def check_update_ms(v2c, alpha):
        # axis-0 (slot-major) variant of bp._check_update_min_sum with the
        # identical first-minimum tie rule on the slot index
        neg = ((v2c < 0) & chk_mask).astype(jnp.int32)
        neg_total = jnp.sum(neg, axis=0, keepdims=True)
        excl_sgn = (1 - 2 * ((neg_total - neg) & 1)).astype(jnp.float32)
        mag = jnp.where(chk_mask, jnp.abs(v2c), _BIG)
        min1 = jnp.min(mag, axis=0, keepdims=True)
        amin = jnp.argmin(mag, axis=0, keepdims=True)
        slot = jax.lax.broadcasted_iota(jnp.int32, v2c.shape, 0)
        is_min = slot == amin
        min2 = jnp.min(jnp.where(is_min, _BIG, mag), axis=0, keepdims=True)
        excl_min = jnp.where(is_min, min2, min1)
        # f32 saturation cap, identical across implementations (see
        # decoder/bp.py:_check_update_min_sum)
        excl_min = jnp.minimum(excl_min, _BIG)
        return syn_sign * excl_sgn * alpha * excl_min

    def check_update_ps(v2c):
        t = jnp.tanh(0.5 * v2c)
        t = jnp.where(chk_mask, t, 1.0)
        ones = jnp.ones_like(t[:1])
        fwd = jnp.concatenate([ones, jnp.cumprod(t, axis=0)[:-1]], axis=0)
        rt = jnp.flip(t, axis=0)
        bwd = jnp.flip(
            jnp.concatenate([ones, jnp.cumprod(rt, axis=0)[:-1]], axis=0),
            axis=0,
        )
        excl = jnp.clip(syn_sign * fwd * bwd, -_TANH_CLIP, _TANH_CLIP)
        return 2.0 * jnp.arctanh(excl)

    v2c0 = var_to_edge(llr0_t)
    fixed_alpha = float(ms_scaling_factor)
    adaptive = method == "minimum_sum" and fixed_alpha == 0.0

    def body(state):
        it, v2c, hard_out, llr_out, iters, converged = state
        if method == "minimum_sum":
            alpha = (
                adaptive_alpha(it)
                if adaptive
                else fixed_alpha
            )
            c2v = check_update_ms(v2c, alpha)
        else:
            c2v = check_update_ps(v2c)
        c2v = jnp.where(chk_mask, c2v, 0.0)
        total_t = llr0_t + edge_to_var(c2v)
        v2c_next = var_to_edge(total_t) - c2v
        hard_t = (total_t <= 0).astype(jnp.int32)
        ok = jnp.all(
            (syndrome_of(hard_t) == synd_t).reshape(-1, B), axis=0
        )  # [B]
        live = ~converged  # [B], broadcasts over [np_, L, B]
        hard_out = jnp.where(live, hard_t, hard_out)
        llr_out = jnp.where(live, total_t, llr_out)
        iters = jnp.where(live, it, iters)
        converged = converged | ok
        return it + 1, v2c_next, hard_out, llr_out, iters, converged

    def cond(state):
        it, _, _, _, _, converged = state
        return (it <= max_iter) & ~jnp.all(converged)

    init = (
        jnp.int32(1),
        v2c0,
        jnp.zeros((np_, L, B), jnp.int32),
        llr0_t,
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), bool),
    )
    _, _, hard_out, llr_out, iters, converged = jax.lax.while_loop(
        cond, body, init
    )
    # back to [B, n] row-major once, outside the loop
    hard = jnp.transpose(hard_out, (2, 0, 1)).reshape(B, n)
    llr = jnp.transpose(llr_out, (2, 0, 1)).reshape(B, n)
    return BPResult(
        hard=hard.astype(jnp.uint8),
        llr=llr,
        converged=converged,
        iterations=iters,
    )
