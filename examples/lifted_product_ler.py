"""OSDW logical-error-rate artifact at lifted-product scale (n = 10^4).

The parallel layer exists for this code class (BASELINE.md row 5's
[[10000,420]] (3,4)-regular lifted product, arXiv:2005.07016's family);
this script produces end-to-end ACCURACY datapoints for it: Z-biased
errors (the flagship artifact's convention), shift-routed lifted BP
(``decoder/lifted_bp.py``) + OSD on the failure tail in buckets of
``OSD_BUCKET``, logical checks against the code's computed lx basis, at
several physical error rates.

Writes ``examples/lifted_product_decode_results.json``.  Run on a GPU from
the repo root: ``python examples/lifted_product_ler.py [runs_per_point]``.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]
LIFT = 400
P_POINTS = (0.005, 0.010, 0.020, 0.030)
B = 512
MAX_ITER = 100
OSD_ORDER = 15
OSD_BUCKET = 8
SEED = 42


def main():
    import jax
    import jax.numpy as jnp

    from bp_osd_tpu.codes import lifted_hgp
    from bp_osd_tpu.decoder import TannerGraph, llr_from_channel, osd_decode
    from bp_osd_tpu.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu.decoder.osd import build_osd_consts
    from bp_osd_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    steps = max(runs // B, 1)

    t0 = time.time()
    qcode = lifted_hgp(PROTO, lift=LIFT)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    m, n = H.shape
    qcode.compute_logicals()
    lx = np.asarray(qcode.lx.toarray(), np.uint8)  # detects Z-type residuals
    K = lx.shape[0]
    print(f"[[{n},{qcode.K}]] m={m} K={K} built+logicals in "
          f"{time.time()-t0:.1f}s", flush=True)

    graph = jax.device_put(TannerGraph(H))
    lgraph = LiftedGraph(qcode.hx_proto, LIFT)
    consts = jax.device_put(build_osd_consts(graph, "osd_cs", OSD_ORDER))
    lx_dev = jax.device_put(lx.astype(np.float32))

    bp_jit = jax.jit(lambda s, l: bp_decode_lifted(
        lgraph, s, l, bp_method="minimum_sum", max_iter=MAX_ITER,
        ms_scaling_factor=0.625))
    osd_jit = jax.jit(lambda g, synd, llr, idx, skip, c: osd_decode(
        g, jnp.take(synd, idx, axis=0), jnp.take(llr, idx, axis=0),
        osd_method="osd_cs", osd_order=OSD_ORDER, consts=c, skip=skip))
    # logical check on device: residual anticommutes with any lx row
    logfail_jit = jax.jit(lambda e, corr: jnp.any(
        jnp.mod(jnp.dot((e ^ corr).astype(jnp.float32), lx_dev.T,
                        preferred_element_type=jnp.float32), 2.0) > 0.5,
        axis=1))
    stack_jit = jax.jit(lambda *xs: jnp.stack(xs))

    results = {}
    for p in P_POINTS:
        llr0 = jax.device_put(np.broadcast_to(
            np.asarray(llr_from_channel(np.full(n, p))), (B, n)).copy())
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        errs, synds = [], []
        for s in range(steps):
            e = (rng.random((B, n)) < p).astype(np.uint8)
            errs.append(jax.device_put(e))
            synds.append(jax.device_put((e @ H.T % 2).astype(np.uint8)))
        outs = [bp_jit(sd, llr0) for sd in synds]  # pipelined
        conv_all = np.asarray(stack_jit(*[o.converged for o in outs]))
        # logical failures of the three decoders, assembled per batch
        fails = {"bp": [], "osd0": [], "osdw": []}
        nosd = 0
        for i in range(steps):
            bp = outs[i]
            conv = conv_all[i]
            bp_fail = logfail_jit(errs[i], bp.hard.astype(jnp.uint8))
            osd0_corr = np.asarray(bp.hard, dtype=np.uint8).copy()
            osdw_corr = osd0_corr.copy()
            failed = np.flatnonzero(~conv)
            nosd += failed.size
            for lo in range(0, failed.size, OSD_BUCKET):
                idx = failed[lo:lo + OSD_BUCKET]
                pad = OSD_BUCKET - idx.size
                take = (np.concatenate([idx, np.zeros(pad, np.int64)])
                        if pad else idx)
                skip = np.zeros(OSD_BUCKET, np.int32)
                skip[idx.size:] = 1
                o = osd_jit(graph, synds[i], bp.llr, jnp.asarray(take),
                            jnp.asarray(skip), consts)
                osd0_corr[idx] = np.asarray(o.osd0)[:idx.size]
                osdw_corr[idx] = np.asarray(o.osdw)[:idx.size]
            fails["bp"].append(np.asarray(bp_fail))
            fails["osd0"].append(np.asarray(
                logfail_jit(errs[i], jnp.asarray(osd0_corr))))
            fails["osdw"].append(np.asarray(
                logfail_jit(errs[i], jnp.asarray(osdw_corr))))
        dt = time.perf_counter() - t0
        N = steps * B
        point = {"runs": N, "bp_converged_frac":
                 round(float(conv_all.mean()), 4),
                 "osd_samples": nosd, "runtime_s": round(dt, 1)}
        for kind in ("bp", "osd0", "osdw"):
            f = np.concatenate(fails[kind]).mean()
            point[f"{kind}_logical_error_rate"] = round(float(f), 5)
            point[f"{kind}_error_bar"] = round(
                float(np.sqrt(max(f * (1 - f), 1e-12) / N)), 5)
        results[str(p)] = point
        print(f"p={p}: {point}", flush=True)

    out = {
        "code": f"[[{n},{qcode.K}]] (3,4)-regular lifted product, lift 400",
        "error_model": "Z-biased iid (flagship artifact convention)",
        "bp_method": "minimum_sum", "ms_scaling_factor": 0.625,
        "max_iter": MAX_ITER, "osd_method": "osd_cs",
        "osd_order": OSD_ORDER, "seed": SEED,
        "points": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lifted_product_decode_results.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
