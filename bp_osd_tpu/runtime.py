"""What still depends on the device: dispatch sizes and the compile cache.

Decoding takes one path on every platform: plain ``jax.numpy``/``lax``
compiled by XLA.  No kernel is chosen by platform and nothing runs in
Pallas interpret mode.  The only device-dependent settings left are how
many syndromes one dispatch carries, and where compiled programs are kept
between processes.
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "DEFAULT_CACHE_DIR",
    "check_backend",
    "decode_chunk_default",
    "enable_compile_cache",
    "sim_batch_cap",
]

# a fixed path inside the checkout: the cache key includes the directory,
# so a cache that moves between runs never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


# OSD's largest intermediates are [rows, rank, n - rank] float32 T-column
# matrices, several alive at once.  Capping one dispatch's copy at 4 GiB
# keeps the [[10000,420]] lifted product (~100 MB per row) inside one card;
# the [[400,16,6]] flagship (~160 kB per row) is not capped by it.
_OSD_TCOL_BYTES = 4 << 30


def _on_accelerator() -> bool:
    return jax.devices()[0].platform != "cpu"


def _osd_rows(graph) -> int:
    per_row = 4 * graph.rank * max(graph.n - graph.rank, 1)
    return max(1, _OSD_TCOL_BYTES // per_row)


def decode_chunk_default(graph) -> int:
    """Rows per ``BpOsdDecoder.decode_batch`` dispatch when the caller
    gives no ``chunk_size``.

    On an accelerator, 16384: a large dispatch amortizes launch and
    ``while_loop`` overhead.  That value is not yet measured on the H100;
    the benchmark tunes it.  On the CPU, 4096.  Either way no more rows
    than keep the OSD intermediates of ``graph`` near 4 GiB.
    """
    cap = 16384 if _on_accelerator() else 4096
    return min(cap, _osd_rows(graph))


def sim_batch_cap(*graphs) -> int:
    """Upper bound on ``css_decode_sim``'s automatic ``batch_size``.

    16384 on an accelerator (not yet measured on the H100; the benchmark
    tunes it).  CPU dispatches are latency-bound, so 1024 there.  Either
    way no more rows than keep the OSD intermediates near 4 GiB.
    """
    cap = 16384 if _on_accelerator() else 1024
    return min([cap] + [_osd_rows(g) for g in graphs])


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache lives in :data:`DEFAULT_CACHE_DIR`
    (``<checkout>/.jax_cache``), and every compiled program is kept.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return DEFAULT_CACHE_DIR


def check_backend(backend) -> None:
    """Reject the removed ``backend`` option instead of ignoring it.

    ``None``, ``"auto"`` and ``"xla"`` all name the one XLA path.
    ``"pallas"`` selected the Mosaic Pallas kernels, which were removed; a
    caller asking for them gets an error, not another path.
    """
    if backend in (None, "auto", "xla"):
        return
    if backend == "pallas":
        raise ValueError(
            "backend='pallas' selected the Mosaic Pallas kernels, which "
            "were removed; every platform decodes with the XLA path, so "
            "drop the backend argument"
        )
    raise ValueError(f"unknown backend {backend!r}; the only path is 'xla'")
