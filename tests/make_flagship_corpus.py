"""Regenerate tests/data/flagship_corpus.npz (round-over-round drift pin).

The corpus pins the flagship workload's decodings across kernel
generations (round-3 VERDICT weak item 3: OSDW LER drifted 0.117 -> 0.125
across rounds with only a prose tie-flip explanation).  It holds 512
seeded syndromes of the [[400,16,6]] reference workload plus the XLA-path
osdw decodings and their weights, produced ON CPU so the file is
reproducible in CI.  ``tests/test_corpus.py`` re-decodes and asserts
bit-equality on the CPU; ``chip_smoke.py`` and ``tests/test_gpu.py``
re-decode it on the GPU, where it must match bit for bit too.

Run from the repo root: ``JAX_PLATFORMS=cpu python tests/make_flagship_corpus.py``
(only needed when the decode SEMANTICS intentionally change — any
unintentional diff is a regression, that is the point of the file).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

B = 512
P = 0.05
SEED = 20260821
MAX_ITER = 400
OSD_ORDER = 42


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from bp_osd_tpu.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel
    from bp_osd_tpu.decoder.osd import build_osd_consts, osd_decode

    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    graph = TannerGraph(H)
    rng = np.random.default_rng(SEED)
    errors = (rng.random((B, graph.n)) < P).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)

    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(graph.n, P))), (B, graph.n)
    )
    consts = build_osd_consts(graph, "osd_cs", OSD_ORDER)
    bp = bp_decode(graph, synd, llr0, bp_method="minimum_sum",
                   max_iter=MAX_ITER, ms_scaling_factor=0.0)
    osd = osd_decode(graph, synd, bp.llr, osd_method="osd_cs",
                     osd_order=OSD_ORDER, consts=consts)
    osdw = np.where(np.asarray(bp.converged)[:, None], np.asarray(bp.hard),
                    np.asarray(osd.osdw)).astype(np.uint8)
    assert ((osdw @ H.T % 2) == synd).all()

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "flagship_corpus.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out,
        synd_packed=np.packbits(synd, axis=1),
        osdw_packed=np.packbits(osdw, axis=1),
        weights=osdw.sum(axis=1).astype(np.int32),
        converged=np.asarray(bp.converged),
        iterations=np.asarray(bp.iterations).astype(np.int32),
        meta=np.array([B, graph.m, graph.n, MAX_ITER, OSD_ORDER, SEED],
                      np.int64),
    )
    print(f"wrote {out}: {B} samples, "
          f"{int(np.asarray(bp.converged).sum())} BP-converged, "
          f"mean weight {osdw.sum(axis=1).mean():.2f}")


if __name__ == "__main__":
    main()
