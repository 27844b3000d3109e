"""One-device overhead check: model-sharded lifted BP at mesh=1x1 vs the
unsharded shift-routed path (round-3 VERDICT weak item 5 "done" bar: the
sharded program must show no slowdown on one device).

Same [[10000,420]] lifted-product workload as ``bench_large.py``.  The
ratio A/B uses run-unique NEVER-CONVERGING syndromes so it compares
per-iteration cost (r5: batch cycling + the all-converged early exit
made the old measurement a lottery).  Also runs the end-to-end
``lifted_sharded_bposd_fn`` (BP + OSD under shard_map) once as a
compile/validity gate.  Dispatches are pipelined with one final
host-fetch sync.  Prints one JSON line, not a driver headline.
"""

import json
import os
import sys
import time

import numpy as np

PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]
LIFT = 400
P_ERR = 0.005
B = 128
B_OSD = 32
STEPS = int(os.environ.get("BENCH_LS_STEPS", 16))
MAX_ITER = 100


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bp_osd_tpu.codes import lifted_hgp
    from bp_osd_tpu.decoder import llr_from_channel
    from bp_osd_tpu.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu.parallel.lifted_shard import (ShardedLiftedGraph,
                                                  lifted_sharded_bp_fn)
    from bp_osd_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    qcode = lifted_hgp(PROTO, lift=LIFT)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    m, n = H.shape
    lg = LiftedGraph(qcode.hx_proto, LIFT)
    print(f"bench_lifted_shard: [[{n},{qcode.K}]] m={m}", file=sys.stderr,
          flush=True)

    # The ratio must compare PER-ITERATION cost, so the workload is
    # uniform-random syndromes that never converge: at operating p most
    # B=128 batches fully converge within ~30 iterations and the
    # unsharded loop's early exit turns the A/B into a lottery over
    # whether a batch contains a never-converger (observed 9x swings).
    # Batches are DISTINCT and run-unique, so no result cache can fake a
    # decode.
    nonce = (os.getpid() * 7919 + int(time.time())) % (1 << 20)
    rng = np.random.default_rng(nonce)
    batches = []
    for s in range(STEPS):
        batches.append(jax.device_put(
            rng.integers(0, 2, (B, m)).astype(np.uint8)))
    llr0 = jax.device_put(np.broadcast_to(
        np.asarray(llr_from_channel(np.full(n, P_ERR))), (B, n)).copy())

    def time_fn(fn, args_list, label):
        outs = fn(*args_list[0])
        np.asarray(outs[0])
        t0 = time.perf_counter()
        for s in range(STEPS):
            outs = fn(*args_list[(s + 1) % len(args_list)])
        np.asarray(outs[0])  # host fetch as the completion barrier
        dt = time.perf_counter() - t0
        print(f"bench_lifted_shard: {label}: {STEPS * B / dt:.1f} synd/s",
              file=sys.stderr, flush=True)
        return STEPS * B / dt, outs

    unsharded = jax.jit(lambda s, l: bp_decode_lifted(
        lg, s, l, bp_method="minimum_sum", max_iter=MAX_ITER,
        ms_scaling_factor=0.625)[:1])
    rate_u, _ = time_fn(unsharded, [(b, llr0) for b in batches],
                        "unsharded shift-routed")

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    sg = ShardedLiftedGraph(lg, n_shards=1)
    decode = lifted_sharded_bp_fn(sg, mesh, bp_method="minimum_sum",
                                  max_iter=MAX_ITER,
                                  ms_scaling_factor=0.625)
    pad = sg.n_shards * sg.mp_chunk * LIFT - m
    sbatches = [jnp.pad(b, ((0, 0), (0, pad))) for b in batches]
    rate_s, _ = time_fn(lambda s, l: decode(s, l)[:1],
                        [(b, llr0) for b in sbatches], "sharded mesh=1x1")

    # ---- end-to-end sharded BP+OSD on the device ----
    # Use a p where some samples fail BP so the OSD stage does real work.
    # The batch-dense OSD holds ~0.5 GB per sample at this size, so the
    # gate decodes B_OSD samples, not B.
    from bp_osd_tpu.parallel.large_code import lifted_sharded_bposd_fn

    p_osd = 0.028
    rng2 = np.random.default_rng(11)
    errs2 = (rng2.random((B_OSD, n)) < p_osd).astype(np.uint8)
    synd2 = ((errs2 @ H.T) % 2).astype(np.uint8)
    llr0_2 = jax.device_put(np.broadcast_to(
        np.asarray(llr_from_channel(np.full(n, p_osd))), (B_OSD, n)).copy())
    decode_full = lifted_sharded_bposd_fn(
        lg, H, mesh, n_shards=1, max_iter=MAX_ITER,
        ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=15,
    )
    t0 = time.perf_counter()
    osdw, conv = decode_full(jnp.pad(jnp.asarray(synd2), ((0, 0), (0, pad))),
                             llr0_2)
    osdw_h = np.asarray(osdw)
    dt_full = time.perf_counter() - t0
    assert ((osdw_h @ H.T % 2) == synd2).all(), \
        "sharded BP+OSD decodings violate syndromes on hardware"
    nfail = int(B_OSD - np.asarray(conv).sum())
    print(f"bench_lifted_shard: sharded BP+OSD mesh=1x1 at p={p_osd}: "
          f"{nfail}/{B_OSD} BP-fail, all syndromes satisfied "
          f"({dt_full:.1f}s incl. compile)", file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": "lifted_bp_sharded_vs_unsharded_mesh1",
        "value": round(rate_s / rate_u, 3),
        "unit": "sharded/unsharded throughput ratio (>= ~0.9 = no slowdown)",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "unsharded_synd_per_sec": round(rate_u, 1),
        "sharded_synd_per_sec": round(rate_s, 1),
        "batch": B, "max_iter": MAX_ITER, "n": n,
        "sharded_bposd_hardware_gate": {
            "p": p_osd, "bp_fail": nfail,
            "syndromes_satisfied": True,
        },
    }))


if __name__ == "__main__":
    main()
