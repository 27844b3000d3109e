"""Edge-sharded BP: partition the Tanner graph's checks across devices.

For codes too large for one card's memory at high batch (n ~ 10^4
lifted-product codes, message state ``[B, E]``), the check axis — and with
it the check-major message state — is sharded over a ``model`` mesh axis.
Each device runs the check update for its own checks with zero
communication; the variable update needs each variable's total over *all*
incident checks, which is one ``psum`` of the partial per-variable sums
``[B, n]`` per iteration (over NVLink between cards).  Convergence is a one-bit ``psum``
per sample.  This is the decoder analogue of tensor parallelism
(SURVEY.md §2.3: a capability the reference lacks entirely — its answer to
big codes was "run fewer syndromes").

Built on ``shard_map`` so the same code runs on a real multi-chip mesh or
the virtual CPU mesh used in tests.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import gf2
from ..decoder.tanner import TannerGraph

__all__ = ["ShardedTannerGraph", "edge_sharded_bp_fn"]


class ShardedTannerGraph:
    """Host-side partition of a PCM's checks into ``n_shards`` row blocks.

    Device d owns checks ``[d*mc, (d+1)*mc)`` (zero-padded rows at the end);
    per-shard index arrays are stacked on a leading shard axis so shard_map
    can split them.
    """

    def __init__(self, H, n_shards: int):
        Hd = gf2.to_dense(H)
        m, n = Hd.shape
        self.m, self.n = m, n
        self.n_shards = n_shards
        mc = -(-m // n_shards)  # checks per shard (padded)
        self.m_chunk = mc

        graphs = []
        wr = 0
        for d in range(n_shards):
            block = Hd[d * mc : (d + 1) * mc]
            if block.shape[0] < mc:
                block = np.vstack(
                    [block, np.zeros((mc - block.shape[0], n), np.uint8)]
                )
            graphs.append(block)
            rows_w = block.sum(axis=1).max() if block.any() else 1
            wr = max(wr, int(rows_w))
        self.wr = max(wr, 1)

        # stacked per-shard layouts [D, mc, wr]
        chk_var = np.full((n_shards, mc, self.wr), n, dtype=np.int32)
        for d, block in enumerate(graphs):
            rows, cols = np.nonzero(block)
            counts = np.bincount(rows, minlength=mc)
            slot = (
                np.concatenate([np.arange(c) for c in counts])
                if rows.size
                else np.zeros(0, int)
            )
            chk_var[d, rows, slot] = cols
        self.chk_var = chk_var
        self.chk_mask = chk_var != n
        self.H = Hd


def edge_sharded_bp_fn(
    sgraph: ShardedTannerGraph,
    mesh: Mesh,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Build a jitted BP decode with checks sharded over ``model_axis`` and
    the batch over ``data_axis``.

    Returns ``decode(syndromes[B, m_pad_total], llr0[B, n]) ->
    (hard [B, n], llr [B, n], converged [B])`` where ``m_pad_total =
    n_shards * m_chunk`` (pad syndromes of the padded checks with zeros).
    """
    from ..decoder.bp import (_check_update_min_sum,
                              _check_update_product_sum, adaptive_alpha,
                              normalize_bp_method)

    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = sgraph.n
    n = sgraph.n
    wr = sgraph.wr
    mc = sgraph.m_chunk
    fixed_alpha = float(ms_scaling_factor)
    adaptive = method == "minimum_sum" and fixed_alpha == 0.0

    def local_decode(chk_var, chk_mask, syndromes, llr0):
        """Runs per (data, model) shard: local checks, local batch."""
        # shard_map passes a leading shard axis of size 1 for the stacked
        # per-shard arrays; drop it
        chk_var = chk_var[0]
        chk_mask = chk_mask[0]
        B = syndromes.shape[0]
        synd = syndromes.astype(jnp.int32)
        syn_sign = (1.0 - 2.0 * synd.astype(jnp.float32))[:, :, None]
        llr0 = llr0.astype(jnp.float32)
        llr0_pad = jnp.pad(llr0, ((0, 0), (0, 1)))

        v2c0 = llr0_pad[:, chk_var]  # [B, mc, wr]

        def edge_to_var_psum(c2v):
            # per-variable partial sums on this shard, then all-reduce
            c2v = jnp.where(chk_mask, c2v, 0.0)
            contrib = jnp.zeros((B, n + 1), c2v.dtype).at[
                jnp.arange(B)[:, None, None], chk_var
            ].add(c2v)
            partial_sums = contrib[:, :n]
            return jax.lax.psum(partial_sums, model_axis)

        def body(state):
            it, v2c, hard_out, llr_out, iters, conv = state
            if method == "minimum_sum":
                alpha = (
                    adaptive_alpha(it)
                    if adaptive
                    else fixed_alpha
                )
                c2v = _check_update_min_sum(v2c, chk_mask, syn_sign, alpha)
            else:
                c2v = _check_update_product_sum(v2c, chk_mask, syn_sign)
            total = llr0 + edge_to_var_psum(c2v)
            total_pad = jnp.pad(total, ((0, 0), (0, 1)))
            v2c_next = total_pad[:, chk_var] - c2v
            hard = (total <= 0).astype(jnp.int32)
            hard_pad = jnp.pad(hard, ((0, 0), (0, 1)))
            bits = jnp.where(chk_mask, hard_pad[:, chk_var], 0)
            synd_hat = jnp.sum(bits, axis=-1) & 1
            ok_local = jnp.all(synd_hat == synd, axis=-1)
            ok = jax.lax.pmin(ok_local.astype(jnp.int32), model_axis) == 1
            live = ~conv
            hard_out = jnp.where(live[:, None], hard, hard_out)
            llr_out = jnp.where(live[:, None], total, llr_out)
            iters = jnp.where(live, it, iters)
            conv = conv | ok
            return it + 1, v2c_next, hard_out, llr_out, iters, conv

        def cond(state):
            it, _, _, _, _, conv = state
            any_live = jax.lax.pmax(
                (~jnp.all(conv)).astype(jnp.int32), model_axis
            )
            return (it <= max_iter) & (any_live == 1)

        init = (
            jnp.int32(1),
            v2c0,
            jnp.zeros((B, n), jnp.int32),
            llr0,
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
        )
        _, _, hard_out, llr_out, iters, conv = jax.lax.while_loop(
            cond, body, init
        )
        return hard_out.astype(jnp.uint8), llr_out, conv

    mapped = shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(
            P(model_axis),  # chk_var stacked [D, mc, wr]
            P(model_axis),
            P(data_axis, model_axis),  # syndromes [B, D*mc]
            P(data_axis),  # llr0 [B, n] replicated over model
        ),
        out_specs=(P(data_axis), P(data_axis), P(data_axis)),
        check_vma=False,
    )

    chk_var = jnp.asarray(sgraph.chk_var)
    chk_mask = jnp.asarray(sgraph.chk_mask)

    @jax.jit
    def decode(syndromes, llr0):
        return mapped(chk_var, chk_mask, syndromes, llr0)

    return decode
