"""Batched BP+OSD decode pipeline: one jit-compatible function.

BP runs straight to ``max_iter`` with per-sample freeze at first
convergence (``bp_decode``); OSD then runs on the BP soft output, and
converged samples keep their BP decoding.  This is the reference's
per-syndrome semantics (``max_iter = 0 -> N``; reference
``examples/qldpc_decode_example.py:19``, ``README.md:183``) on a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .bp import bp_decode
from .osd import OsdConsts, osd_decode
from .tanner import TannerGraph

__all__ = ["BpOsdBatch", "decode_pipeline"]


class BpOsdBatch(NamedTuple):
    osdw: jnp.ndarray  # [B, n] uint8 final decoding (BP if converged)
    osd0: jnp.ndarray  # [B, n] uint8 OSD-0 decoding (BP if converged)
    bp_hard: jnp.ndarray  # [B, n] uint8 BP hard decision at freeze point
    converged: jnp.ndarray  # [B] bool BP convergence
    iterations: jnp.ndarray  # [B] int32
    llr: jnp.ndarray = None  # [B, n] float32 BP soft output (posterior LLRs)


def decode_pipeline(
    graph: TannerGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    consts: OsdConsts | None = None,
) -> BpOsdBatch:
    """Full batched BP+OSD decode; jit-compatible (all shapes static).

    Pass the graph and ``consts`` through any enclosing jit as arguments.
    """
    if max_iter == 0:
        max_iter = graph.n
    n = graph.n
    synd = jnp.asarray(syndromes)
    if synd.ndim == 1:
        synd = synd[None, :]
    B = synd.shape[0]
    llr0 = jnp.broadcast_to(jnp.asarray(llr0, jnp.float32), (B, n))

    bp = bp_decode(
        graph, synd, llr0, bp_method=bp_method, max_iter=int(max_iter),
        ms_scaling_factor=ms_scaling_factor,
    )
    osd = osd_decode(
        graph, synd, bp.llr,
        osd_method=osd_method, osd_order=osd_order, consts=consts,
    )

    keep = bp.converged[:, None]
    osdw = jnp.where(keep, bp.hard, osd.osdw).astype(jnp.uint8)
    osd0 = jnp.where(keep, bp.hard, osd.osd0).astype(jnp.uint8)
    return BpOsdBatch(
        osdw=osdw, osd0=osd0, bp_hard=bp.hard,
        converged=bp.converged, iterations=bp.iterations, llr=bp.llr,
    )
