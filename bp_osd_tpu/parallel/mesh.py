"""Device-mesh scale-out for batched decoding.

The reference has no distributed capability at all — scale-out meant running
independent seeded processes on an HPC cluster (SURVEY.md §2.3; reference
``css_decode_sim.py:51-52`` only mentions "disable tqdm on HPC").  Here
scale-out is first-class:

- **Syndrome-batch data parallelism**: the batch axis of
  ``decode(syndromes[B, m])`` is sharded over a 1D/2D ``jax.sharding.Mesh``
  with ``NamedSharding``; the BP inner loop then runs with *zero* cross-card
  traffic, and only the final statistics reduction crosses NVLink (a psum
  of a few scalars per batch).
- **Multi-host**: the same code path scales across hosts via
  ``jax.distributed.initialize`` — the mesh just gets bigger.

Edge-sharding of very large Tanner graphs (the "tensor parallel" analogue,
for n ~ 10^4 lifted-product codes) rides the same mesh on a second axis.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..decoder.bp import bp_decode, llr_from_channel
from ..decoder.osd import osd_decode
from ..decoder.tanner import TannerGraph

__all__ = ["make_mesh", "sharded_decode_fn", "pad_batch"]


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1D device mesh over the first ``n_devices`` (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} "
                f"available (set --xla_force_host_platform_device_count for "
                f"CPU testing)"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def pad_batch(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple; returns (padded, original_B)."""
    B = arr.shape[0]
    pad = (-B) % multiple
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return arr, B


def sharded_decode_fn(
    graph: TannerGraph,
    mesh: Mesh,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd0",
    osd_order: int = 0,
    axis_name: str = "data",
):
    """Build a jitted decode function with the batch axis sharded over
    ``mesh``.

    Returns ``decode(syndromes[B, m], llr0[B, n]) ->
    (osdw[B, n], osd0[B, n], bp_hard[B, n], converged[B])`` where B must be
    divisible by the mesh size (use :func:`pad_batch`; broadcast a shared
    channel prior to [B, n] at the caller).

    The graph layout and OSD candidate tables travel through jit as
    replicated *arguments* (see TannerGraph docstring).
    """
    from ..decoder.osd import build_osd_consts

    batch_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())
    consts = build_osd_consts(graph, osd_method, osd_order)

    def fn(graph_arg, syndromes, llr0, osd_consts):
        bp = bp_decode(
            graph_arg,
            syndromes,
            llr0,
            bp_method=bp_method,
            max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor,
        )
        osd = osd_decode(
            graph_arg,
            syndromes,
            bp.llr,
            osd_method=osd_method,
            osd_order=osd_order,
            consts=osd_consts,
        )
        keep = bp.converged[:, None]
        osdw = jnp.where(keep, bp.hard, osd.osdw)
        osd0 = jnp.where(keep, bp.hard, osd.osd0)
        return osdw, osd0, bp.hard, bp.converged

    jitted = jax.jit(
        fn,
        in_shardings=(replicated, batch_sharding, batch_sharding, replicated),
        out_shardings=(batch_sharding, batch_sharding, batch_sharding, batch_sharding),
    )

    def decode(syndromes, llr0):
        return jitted(graph, syndromes, llr0, consts)

    return decode
