"""Profiling and timing helpers.

The reference's only observability is wall-clock accounting + a tqdm bar
(reference ``css_decode_sim.py:516-524``); here decode dispatches can be
profiled with the JAX/XLA profiler and inspected in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "Timer", "block"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block.

    View with ``tensorboard --logdir <log_dir>`` (profile plugin) or load
    the ``.trace.json.gz`` into Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def block(tree):
    """Block until every array in a pytree is ready; returns the pytree."""
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
        tree,
    )
    return tree


class Timer:
    """Wall-clock timer that blocks on device work.

    >>> with Timer() as t:
    ...     block(decode(syndromes))
    >>> t.elapsed
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
