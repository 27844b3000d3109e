"""Headline benchmark: flagship [[400,16,6]] BP+OSD decode throughput.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}.

Workload = the reference's headline example at its EXACT semantics
(reference ``examples/qldpc_decode_example.py:8-23``): the [[400,16,6]]
MKMN hypergraph-product code at p = 0.05, min-sum BP with the variable
scaling factor (``ms_scaling_factor=0``) run to ``max_iter = 0 -> N = 400``
(reference ``README.md:183``), osd_cs post-processing at order 42.  The
reference decodes one syndrome at a time in Cython; here a large syndrome
batch is decoded per dispatch through ``decoder/pipeline.py``.

The baseline is MEASURED: ``measure_baseline.py`` builds
``bp_osd_tpu/native/cpu_baseline.cpp`` (serial C++ BP+OSD with the reference
decode semantics — the stand-in for the un-installable ``ldpc`` Cython
engine) and times it on this workload, recording the result and its host
in ``BASELINE_MEASURED.json``.  ``vs_baseline`` divides by that figure; if
the file is missing it falls back to the round-1 documented estimate (1e3/s,
which the measurement confirmed to within 8%: 920.8 synd/s).

No roofline share is printed: the H100 peak table keyed by ``device_kind``
comes with the benchmark's rewrite.  Every result names the device it ran
on.
"""

import json
import os
import sys
import time

import numpy as np

_FALLBACK_BASELINE = 1000.0  # round-1 estimate; see docstring


def _baseline_synd_per_sec() -> float:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    try:
        with open(path) as f:
            return float(json.load(f)["syndromes_per_sec"])
    except (OSError, ValueError, KeyError):
        return _FALLBACK_BASELINE


REFERENCE_CPU_SYNDROMES_PER_SEC = _baseline_synd_per_sec()

P = 0.05
MAX_ITER = 400  # reference max_iter=0 -> N
OSD_ORDER = 42
B = int(os.environ.get("BENCH_B", 16384))  # syndromes per dispatch
STEPS = 24  # timed dispatches, distinct batches (cycled)
DISTINCT = 8  # distinct random batches


def main():
    import jax
    import jax.numpy as jnp

    from bp_osd_tpu.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu.decoder import TannerGraph, llr_from_channel
    from bp_osd_tpu.decoder.osd import build_osd_consts
    from bp_osd_tpu.decoder.pipeline import decode_pipeline
    from bp_osd_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    qcode = hgp(mkmn_16_4_6())
    graph = TannerGraph(qcode.hx.toarray())
    H = graph.H
    consts = jax.device_put(build_osd_consts(graph, "osd_cs", OSD_ORDER))
    graph_dev = jax.device_put(graph)

    def decode_step(graph_arg, syndromes, llr0, osd_consts):
        out = decode_pipeline(
            graph_arg, syndromes, llr0,
            bp_method="minimum_sum", max_iter=MAX_ITER,
            ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=OSD_ORDER,
            consts=osd_consts,
        )
        # reduce on-device so the host transfer is O(B), not O(B*n)
        return (jnp.sum(out.osdw, axis=1), jnp.sum(out.converged),
                jnp.sum(out.iterations))

    jitted = jax.jit(decode_step)

    llr0 = jax.device_put(
        np.broadcast_to(
            np.asarray(llr_from_channel(np.full(graph.n, P))), (B, graph.n)
        ).copy()
    )

    def make_batch(seed):
        r = np.random.default_rng(seed)
        errors = (r.random((B, graph.n)) < P).astype(np.uint8)
        return (errors @ H.T % 2).astype(np.uint8)

    batches = [jax.device_put(make_batch(s)) for s in range(DISTINCT)]

    print("bench: compiling...", file=sys.stderr, flush=True)
    w, conv, iters = jitted(graph_dev, batches[0], llr0, consts)
    w.block_until_ready()
    print("bench: compiled, timing...", file=sys.stderr, flush=True)

    # variance pass: each dispatch synced
    times = []
    for s in range(STEPS):
        t0 = time.perf_counter()
        w, conv, iters = jitted(graph_dev, batches[s % DISTINCT], llr0,
                                consts)
        w.block_until_ready()
        times.append(time.perf_counter() - t0)
    step_ms = np.asarray(times) * 1e3

    # headline pass: pipelined dispatches, one host fetch as the barrier
    t0 = time.perf_counter()
    for s in range(STEPS):
        w, conv, iters = jitted(graph_dev, batches[s % DISTINCT], llr0,
                                consts)
    np.asarray(w)
    elapsed = time.perf_counter() - t0

    syndromes_per_sec = STEPS * B / elapsed
    print(
        json.dumps(
            {
                "metric": "syndromes_per_sec_[[400,16,6]]_p0.05_ms0_maxit400_osdcs42",
                "value": round(syndromes_per_sec, 1),
                "unit": "syndromes/s/device",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "vs_baseline": round(
                    syndromes_per_sec / REFERENCE_CPU_SYNDROMES_PER_SEC, 2
                ),
                "baseline_synd_per_sec": REFERENCE_CPU_SYNDROMES_PER_SEC,
                "baseline_source": "BASELINE_MEASURED.json (serial C++ BP+OSD, same semantics)",
                "bp_converged_frac": round(float(conv) / B, 4),
                "bp_mean_iterations": round(float(iters) / B, 2),
                "batch": B,
                "steps": STEPS,
                "step_ms_mean": round(float(step_ms.mean()), 2),
                "step_ms_std": round(float(step_ms.std()), 2),
                "step_ms_min": round(float(step_ms.min()), 2),
                "step_ms_max": round(float(step_ms.max()), 2),
            }
        )
    )


if __name__ == "__main__":
    main()
