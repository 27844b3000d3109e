"""End-to-end decode for large codes: edge-sharded BP + gather-to-DP OSD.

For n ~ 10^4 lifted-product codes the BP message state is edge-sharded
over the ``model`` mesh axis (``edge_shard.py``); OSD post-processing is
then run data-parallel over ALL devices of the mesh ("gather-to-DP"): the
per-sample posterior LLRs are [B, n] — tiny next to the message state —
so after BP the batch is simply re-sharded over the flattened
(data x model) device set and each device eliminates its own samples.
This is the v1 strategy SURVEY.md §7 anticipates for BASELINE.md row 5;
a column-sharded elimination would only pay off beyond n ~ 10^5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..decoder.osd import build_osd_consts, osd_decode
from ..decoder.tanner import TannerGraph
from .edge_shard import ShardedTannerGraph, edge_sharded_bp_fn

__all__ = ["edge_sharded_bposd_fn", "lifted_sharded_bposd_fn"]


def _build_osd_stage(graph, consts, mesh, *, osd_method, osd_order,
                     data_axis, model_axis):
    """Gather-to-DP OSD: each device of the flattened (data x model) mesh
    eliminates its own batch shard with the single-device ``osd_decode``
    under ``shard_map``, so each device's elimination loop exits on its
    own shard's failures rather than the whole batch's."""
    dp = P((data_axis, model_axis))

    def local(synd, llr, conv):
        out = osd_decode(
            graph, synd, llr, osd_method=osd_method, osd_order=osd_order,
            consts=consts,
            # BP-converged samples keep their BP decoding: start them
            # "done" so the elimination exits as soon as the unconverged
            # tail finds its pivots
            skip=conv,
        )
        return out.osdw

    mapped = shard_map(local, mesh=mesh, in_specs=(dp, dp, dp),
                       out_specs=dp, check_vma=False)
    return jax.jit(mapped)


def edge_sharded_bposd_fn(
    sgraph: ShardedTannerGraph,
    mesh: Mesh,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Build ``decode(syndromes_pad [B, D*mc], llr0 [B, n]) ->
    (osdw [B, n] uint8, converged [B] bool)``.

    ``syndromes_pad`` uses the sharded check layout (zero-pad the trailing
    ``D*mc - m`` rows); the OSD stage consumes the first ``m`` rows.
    ``B`` must be divisible by the total device count for the DP re-shard.
    """
    graph = TannerGraph(sgraph.H)
    consts = build_osd_consts(graph, osd_method, osd_order)
    m = sgraph.m

    bp = edge_sharded_bp_fn(
        sgraph, mesh, bp_method=bp_method, max_iter=max_iter,
        ms_scaling_factor=ms_scaling_factor,
        data_axis=data_axis, model_axis=model_axis,
    )

    # gather-to-DP: batch sharded over EVERY device (both mesh axes)
    osd_stage = _build_osd_stage(
        graph, consts, mesh, osd_method=osd_method, osd_order=osd_order,
        data_axis=data_axis, model_axis=model_axis,
    )

    def decode(syndromes_pad, llr0):
        hard, llr, conv = bp(syndromes_pad, llr0)
        osdw = osd_stage(syndromes_pad[:, :m], llr, conv)
        osdw = jnp.where(conv[:, None], hard.astype(jnp.uint8), osdw)
        return osdw, conv

    return decode


def lifted_sharded_bposd_fn(
    lgraph,
    H,
    mesh: Mesh,
    *,
    n_shards: int,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """End-to-end decode for lifted-product codes: scatter-free
    model-sharded BP (``lifted_shard.py``) + gather-to-DP OSD.

    The structure-aware counterpart of :func:`edge_sharded_bposd_fn` —
    BP routes by static cyclic shifts with a routing-tensor einsum
    instead of ``.at[].add`` scatters, and the OSD stage skip-clusters on
    the BP convergence flags.  Returns ``decode(syndromes_pad
    [B, D*mpc*L], llr0 [B, n]) -> (osdw [B, n] uint8, converged [B])``.

    ``H`` is the binary lift of ``lgraph`` (dense/sparse), needed only by
    the OSD stage's Tanner layout.
    """
    from .lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

    graph = TannerGraph(H)
    consts = build_osd_consts(graph, osd_method, osd_order)
    sg = ShardedLiftedGraph(lgraph, n_shards)

    bp = lifted_sharded_bp_fn(
        sg, mesh, bp_method=bp_method, max_iter=max_iter,
        ms_scaling_factor=ms_scaling_factor,
        data_axis=data_axis, model_axis=model_axis,
    )

    osd_stage = _build_osd_stage(
        graph, consts, mesh, osd_method=osd_method, osd_order=osd_order,
        data_axis=data_axis, model_axis=model_axis,
    )

    m = lgraph.m

    def decode(syndromes_pad, llr0):
        hard, llr, conv, _ = bp(syndromes_pad, llr0)
        osdw = osd_stage(syndromes_pad[:, :m], llr, conv)
        osdw = jnp.where(conv[:, None], hard.astype(jnp.uint8), osdw)
        return osdw, conv

    return decode
