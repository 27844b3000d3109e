"""Multi-host orchestration.

The reference scaled out by launching independent seeded processes on an
HPC cluster (SURVEY.md §2.3).  The replacement is a single SPMD program
over all hosts: ``initialize()`` wires up ``jax.distributed``, after which
``jax.devices()`` spans every card, a ``Mesh`` built by
``bp_osd_tpu.parallel.make_mesh`` covers them, and the batched decode /
Monte-Carlo harness shard the syndrome batch over NVLink and the network
between hosts with no further code changes.
"""

from __future__ import annotations

import jax

__all__ = ["initialize", "is_multi_host", "host_batch_slice"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize JAX's distributed runtime; True once multi-host is live.

    Under a cluster launcher that JAX recognizes the arguments are
    auto-detected; pass them explicitly for manual setups (the 2-process
    CPU test ``tests/test_distributed.py`` does).  Explicit arguments make
    failures fatal — swallowing them here masked real wiring errors; only
    the argument-free auto-detect path may fall back to single-host.
    """
    # NOTE: do not probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize() refuses to run
    from jax._src import distributed as _internal

    if getattr(_internal.global_state, "client", None) is not None:
        return True  # already initialized
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        if explicit:
            raise
        return False  # single-host environment, nothing to wire up
    return True


def is_multi_host() -> bool:
    return jax.process_count() > 1


def host_batch_slice(total_batch: int) -> tuple[int, int]:
    """(start, size) of this host's slice of a globally sharded batch."""
    per_host = total_batch // jax.process_count()
    start = jax.process_index() * per_host
    return start, per_host
