"""Batched belief-propagation syndrome decoding over a Tanner graph.

Batched XLA re-design of the reference's native BP engine (interface contract
at reference ``README.md:184`` and ``css_decode_sim.py:444-463``): instead of
one mutable decoder object processing one syndrome per call, decoding is a
pure function ``(syndromes [B, m], llr0 [B, n]) -> BPResult`` compiled once
and vmapped-by-construction over the batch axis.

Supported schedules (parallel / flooding):

- ``minimum_sum`` with fixed scaling factor, or the *variable* scaling
  method ``alpha_t = 1 - 2**-t`` when ``ms_scaling_factor == 0``
  (reference ``README.md:184``: "If set to zero the variable scaling factor
  method is used").
- ``product_sum`` (tanh rule) with numerically exact exclusive products via
  forward/backward cumulative products.

Per-sample convergence is checked every iteration (hard decision satisfies
the syndrome); outputs freeze at first convergence, matching the native
decoder's early-exit semantics, while the batch keeps iterating inside a
``lax.while_loop`` until every sample converged or ``max_iter`` is reached.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .tanner import TannerGraph

__all__ = ["BPResult", "bp_decode", "llr_from_channel", "MIN_SUM_METHODS", "PROD_SUM_METHODS"]

MIN_SUM_METHODS = frozenset(
    {"minimum_sum", "min_sum", "ms", "minimum_sum_log", "1"}
)
PROD_SUM_METHODS = frozenset(
    {"product_sum", "prod_sum", "ps", "product_sum_log", "0"}
)

_P_CLIP = 1e-30  # channel probabilities clamped away from {0, 1}
_TANH_CLIP = 1.0 - 1e-7  # product-sum atanh domain guard (f32)


def normalize_bp_method(bp_method) -> str:
    key = str(bp_method).lower()
    if key in MIN_SUM_METHODS:
        return "minimum_sum"
    if key in PROD_SUM_METHODS:
        return "product_sum"
    raise ValueError(
        f"unknown bp_method {bp_method!r}; choose minimum_sum/ms or product_sum/ps"
    )


def llr_from_channel(probs) -> jnp.ndarray:
    """Channel error probabilities -> prior log-likelihood ratios.

    ``llr = log((1-p)/p)``; positive means "probably no error".  Probabilities
    are clamped so zero-probability channels (e.g. the pure-Z bias of the
    flagship benchmark, reference ``examples/qldpc_decode_example.py:11``)
    produce large finite priors instead of infinities.
    """
    p = jnp.clip(jnp.asarray(probs, jnp.float32), _P_CLIP, 1.0 - 1e-7)
    return jnp.log1p(-p) - jnp.log(p)


class BPResult(NamedTuple):
    hard: jnp.ndarray  # [B, n] uint8 hard decision at freeze point
    llr: jnp.ndarray  # [B, n] f32 posterior log-prob ratios at freeze point
    converged: jnp.ndarray  # [B] bool
    iterations: jnp.ndarray  # [B] int32 iteration of first convergence (or last)


# finite +inf stand-in (keeps min-sum arithmetic free of inf - inf); python
# float — a module-level jnp scalar would initialize the XLA backend at import time,
# which breaks jax.distributed.initialize() ordering on multi-host
_BIG = 1e30


def adaptive_alpha(it):
    """The variable min-sum scaling factor ``1 - 2^-it``, exactly.

    ``2^-it`` is built from its bit pattern: ``jnp.exp2`` lowers to
    ``exp(x ln 2)``, which is not exact and rounds differently on each
    device.  For ``it > 24`` the result is 1.0 either way.
    """
    exponent = 127 - jnp.minimum(jnp.asarray(it, jnp.int32), 126)
    return 1.0 - jax.lax.bitcast_convert_type(exponent << 23, jnp.float32)


def _check_update_min_sum(v2c, chk_mask, syn_sign, alpha):
    """Scaled min-sum check-node update with self-exclusion via min1/min2.

    Sign products are computed as integer parities of negative-message
    counts and the argmin mask as an iota comparison.
    """
    wr = v2c.shape[-1]
    neg = ((v2c < 0) & chk_mask).astype(jnp.int32)
    neg_total = jnp.sum(neg, axis=-1, keepdims=True)
    excl_sgn = (1 - 2 * ((neg_total - neg) & 1)).astype(jnp.float32)
    mag = jnp.where(chk_mask, jnp.abs(v2c), _BIG)
    min1 = jnp.min(mag, axis=-1, keepdims=True)
    amin = jnp.argmin(mag, axis=-1, keepdims=True)
    slot = jax.lax.broadcasted_iota(jnp.int32, v2c.shape, v2c.ndim - 1)
    is_min = slot == amin
    min2 = jnp.min(jnp.where(is_min, _BIG, mag), axis=-1, keepdims=True)
    excl_min = jnp.where(is_min, min2, min1)
    # Saturate at _BIG: unscaled min-sum magnitudes grow ~x2/iteration and
    # overflow f32 around iteration ~130 (inf - inf -> NaN, destroying the
    # OSD reliability order of exactly the never-converging rows OSD must
    # rescue).  The serial C++ baseline saturates at 1e30 by construction
    # (its min1/min2 seeds, native/cpu_baseline.cpp:130); capping here
    # makes every implementation saturate identically while preserving the
    # relative order of all sub-cap magnitudes.  The reference's double
    # engine doesn't overflow in 400 iterations — see PARITY.md
    # "Message saturation".
    excl_min = jnp.minimum(excl_min, _BIG)
    return syn_sign * excl_sgn * alpha * excl_min


def _check_update_product_sum(v2c, chk_mask, syn_sign):
    """Tanh-rule check-node update with exact exclusive products."""
    t = jnp.tanh(0.5 * v2c)
    t = jnp.where(chk_mask, t, 1.0)
    ones = jnp.ones_like(t[..., :1])
    fwd = jnp.concatenate([ones, jnp.cumprod(t, axis=-1)[..., :-1]], axis=-1)
    rt = jnp.flip(t, axis=-1)
    bwd = jnp.flip(
        jnp.concatenate([ones, jnp.cumprod(rt, axis=-1)[..., :-1]], axis=-1),
        axis=-1,
    )
    excl = jnp.clip(syn_sign * fwd * bwd, -_TANH_CLIP, _TANH_CLIP)
    return 2.0 * jnp.arctanh(excl)


def bp_decode(
    graph: TannerGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
) -> BPResult:
    """Decode a batch of syndromes on ``graph``; fully jit-compatible.

    ``max_iter == 0`` falls back to the block length ``n``, the native
    decoder's convention (reference ``README.md:183`` recommends
    ``max_iter=N``; the sim default is 0 at reference
    ``css_decode_sim.py:72``).
    """
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n

    m, n, wr = graph.m, graph.n, graph.wr
    chk_var = jnp.asarray(graph.chk_var)
    chk_mask = jnp.asarray(graph.chk_mask)
    var_edge = jnp.asarray(graph.var_edge)

    syndromes = jnp.asarray(syndromes)
    if syndromes.ndim == 1:
        syndromes = syndromes[None, :]
    B = syndromes.shape[0]
    synd = syndromes.astype(jnp.int32)
    syn_sign = (1.0 - 2.0 * synd.astype(jnp.float32))[:, :, None]  # [B, m, 1]

    llr0 = jnp.asarray(llr0, jnp.float32)
    llr0 = jnp.broadcast_to(llr0, (B, n))

    fixed_alpha = float(ms_scaling_factor)
    adaptive = method == "minimum_sum" and fixed_alpha == 0.0

    def per_variable_total(c2v):
        """``llr0`` plus each variable's incoming check messages, summed in
        one fixed order, ``((llr0 + c_0) + c_1) + ...`` with checks
        ascending: the serial baseline's order (``native/cpu_baseline.cpp``).
        A matmul or a reduction would leave the order to the backend, and
        BP's dynamics turn a last-bit difference into a different decode
        within a few tens of iterations; the fixed order makes min-sum
        decodes bit-identical on every device, batch size and routing."""
        c2v_flat = jnp.pad(c2v.reshape(B, m * wr), ((0, 0), (0, 1)))
        gathered = c2v_flat[:, var_edge]  # [B, n, wc]; pad slots read 0.0
        total = llr0
        for j in range(graph.wc):
            total = total + gathered[:, :, j]
        return total

    M = graph.edge_var_onehot  # [m*wr, n] one-hot (None for large graphs)

    if M is not None:
        # var->edge selection as a one-hot matmul (each output has exactly
        # one nonzero term, so it is exact).  HIGHEST precision: at the
        # default, a GPU contracts float32 in TF32 and would round every
        # message to a 10-bit mantissa
        def var_to_edge(x):  # [B, n] -> [B, m, wr]
            return jnp.einsum(
                "bn,en->be", x, M, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(B, m, wr)

    else:
        def var_to_edge(x):  # [B, n] -> [B, m, wr]; pad slots read 0
            return jnp.pad(x, ((0, 0), (0, 1)))[:, chk_var]

    def syndrome_of(hard):
        bits = var_to_edge(hard.astype(jnp.float32))
        return jnp.sum(bits, axis=-1).astype(jnp.int32) & 1

    def check_update(v2c, it):
        if method == "minimum_sum":
            alpha = adaptive_alpha(it) if adaptive else fixed_alpha
            return _check_update_min_sum(v2c, chk_mask, syn_sign, alpha)
        return _check_update_product_sum(v2c, chk_mask, syn_sign)

    # The loop carries the CHECK messages of the coming iteration, so each
    # product of the check update reaches memory, rounded, before it is
    # summed.  Computed and summed in one body, a compiler may fuse the
    # last multiply into the first add (an FMA, one rounding fewer) in
    # some programs and not in others, and the decode would depend on
    # fusion decisions.
    def body(state):
        it, c2v, hard_out, llr_out, iters, converged = state
        total = per_variable_total(c2v)
        hard = (total <= 0).astype(jnp.int32)
        ok = jnp.all(syndrome_of(hard) == synd, axis=-1)
        live = ~converged  # not yet converged: keep updating outputs
        hard_out = jnp.where(live[:, None], hard, hard_out)
        llr_out = jnp.where(live[:, None], total, llr_out)
        iters = jnp.where(live, it, iters)
        converged = converged | ok
        c2v_next = check_update(var_to_edge(total) - c2v, it + 1)
        return it + 1, c2v_next, hard_out, llr_out, iters, converged

    def cond(state):
        it, _, _, _, _, converged = state
        return (it <= max_iter) & ~jnp.all(converged)

    init = (
        jnp.int32(1),
        check_update(var_to_edge(llr0), 1),
        jnp.zeros((B, n), jnp.int32),
        llr0,
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), bool),
    )
    _, _, hard_out, llr_out, iters, converged = jax.lax.while_loop(
        cond, body, init
    )
    return BPResult(
        hard=hard_out.astype(jnp.uint8),
        llr=llr_out,
        converged=converged,
        iterations=iters,
    )
