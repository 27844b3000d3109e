"""Driver-style bench of the DROP-IN class path (``BpOsdDecoder``).

The decoder is constructed with NO chunk argument at all — the literal
out-of-the-box path a reference user gets — and should land close to
``bench.py``'s headline.

Measurement discipline matches ``bench.py``: syndromes pre-uploaded to
device, distinct run-unique batches, dispatches pipelined with ONE final
sync, and ``outputs="device"`` so no [B, n] arrays cross to the host
inside the timed loop (the weight reduction pulls [B] scalars only).

Prints one JSON line (not the driver headline — recorded in BASELINE.md).
"""

import json
import os
import sys
import time

import numpy as np

P = 0.05
MAX_ITER = 400
OSD_ORDER = 42
B = 16384
STEPS = 24
# every timed dispatch gets a DISTINCT batch with RUN-UNIQUE seeds, so no
# cache of (program, input) -> result anywhere can fake a decode
DISTINCT = 24


def main():
    import jax
    import jax.numpy as jnp

    from bp_osd_tpu import BpOsdDecoder
    from bp_osd_tpu.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    qcode = hgp(mkmn_16_4_6())
    H = np.asarray(qcode.hx.toarray(), np.uint8)

    # NO chunk_size= anywhere below: this measures the out-of-the-box
    # defaults a reference user gets
    dec = BpOsdDecoder(
        H, error_rate=P, max_iter=MAX_ITER, bp_method="ms",
        ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=OSD_ORDER,
    )

    def make_batch(seed):
        r = np.random.default_rng(seed)
        errors = (r.random((B, H.shape[1])) < P).astype(np.uint8)
        return (errors @ H.T % 2).astype(np.uint8)

    nonce = (os.getpid() * 7919 + int(time.time())) % (1 << 20)
    batches = [jax.device_put(make_batch(nonce * 64 + s))
               for s in range(DISTINCT)]
    wsum = jax.jit(lambda x: jnp.sum(x, axis=1))
    # ONE jitted reduction for the final barrier, not a chain of eager ops
    total_fn = jax.jit(
        lambda ws: jnp.sum(jnp.stack(ws).astype(jnp.int32))
    )

    print("bench_api: compiling...", file=sys.stderr, flush=True)
    dec.decode_batch(batches[0], outputs="device")
    w0 = wsum(dec.osdw_decoding_batch)
    int(np.asarray(total_fn([w0] * STEPS)))  # compile barrier program too

    print("bench_api: timing...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    weights = []
    for s in range(STEPS):
        dec.decode_batch(batches[s % DISTINCT], outputs="device")
        weights.append(wsum(dec.osdw_decoding_batch))
    # completion barrier: reduce on device in ONE jitted program and
    # fetch one scalar
    total_weight = int(np.asarray(total_fn(weights)))
    elapsed = time.perf_counter() - t0

    synd_per_sec = STEPS * B / elapsed
    print(json.dumps({
        "metric": "syndromes_per_sec_BpOsdDecoder_decode_batch_flagship",
        "value": round(synd_per_sec, 1),
        "unit": "syndromes/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "batch": B,
        "steps": STEPS,
        "total_weight": total_weight,
        "conv_frac": round(float(jnp.mean(
            dec.converge_batch.astype(jnp.float32))), 4),
    }))


if __name__ == "__main__":
    main()
