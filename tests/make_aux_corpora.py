"""Regenerate tests/data/aux_corpora.npz (round-over-round drift pins).

Extends the flagship corpus (``make_flagship_corpus.py``) to every decode
path that carries a bench number but had no bit-level pin (round-4
VERDICT weak item 6): product-sum BP, fixed min-sum scaling, osd_e, and
the lifted-product BP + OSD route (at CPU-tractable lift; the n = 10^4
semantics are size-independent).  The lifted config was first made with
a per-sample streamed OSD kernel that has since been removed; the XLA OSD
reproduces it bit for bit, so its key keeps the old name.

Each config stores the syndromes and final osdw decodings (bit-packed)
plus convergence/iteration metadata; ``tests/test_corpus.py`` re-decodes
and asserts bit-equality.  Regenerate ONLY on intentional semantic
change, and document it in PARITY.md:

    JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python tests/make_aux_corpora.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

SEED = 20260821

# name -> (family, decode kwargs); family "flagship" = [[400,16,6]] MKMN
# HGP via the generic XLA path, "lifted" = (3,4)-regular lifted product
# via bp_decode_lifted + osd_decode
CONFIGS = {
    "flagship_ps": dict(
        family="flagship", B=192, p=0.05, bp_method="product_sum",
        ms_scaling_factor=1.0, max_iter=400, osd_method="osd_cs",
        osd_order=42),
    "flagship_ms_fixed": dict(
        family="flagship", B=192, p=0.05, bp_method="minimum_sum",
        ms_scaling_factor=0.625, max_iter=400, osd_method="osd_cs",
        osd_order=42),
    "flagship_osd_e": dict(
        family="flagship", B=128, p=0.05, bp_method="minimum_sum",
        ms_scaling_factor=0.0, max_iter=100, osd_method="osd_e",
        osd_order=12),
    "lifted_streamed": dict(
        # p/max_iter chosen so a MAJORITY of samples fail BP — the pin
        # must exercise OSD, not just lifted BP
        family="lifted", B=12, p=0.05, bp_method="minimum_sum",
        ms_scaling_factor=0.625, max_iter=12, osd_method="osd_cs",
        osd_order=15, lift=60),
}

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "data", "aux_corpora.npz")

LIFTED_PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]


def decode_config(name, cfg):
    """Run one config end-to-end on CPU; returns (synd, osdw, conv, iters)."""
    from bp_osd_tpu.decoder import TannerGraph, llr_from_channel
    from bp_osd_tpu.decoder.osd import build_osd_consts, osd_decode

    rng = np.random.default_rng(SEED + sum(name.encode()))
    if cfg["family"] == "flagship":
        from bp_osd_tpu.codes import hgp, mkmn_16_4_6
        from bp_osd_tpu.decoder import bp_decode

        H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
        graph = TannerGraph(H)
        n = graph.n
        errors = (rng.random((cfg["B"], n)) < cfg["p"]).astype(np.uint8)
        synd = (errors @ H.T % 2).astype(np.uint8)
        llr0 = np.broadcast_to(
            np.asarray(llr_from_channel(np.full(n, cfg["p"]))),
            (cfg["B"], n))
        bp = bp_decode(graph, synd, llr0, bp_method=cfg["bp_method"],
                       max_iter=cfg["max_iter"],
                       ms_scaling_factor=cfg["ms_scaling_factor"])
        consts = build_osd_consts(graph, cfg["osd_method"],
                                  cfg["osd_order"])
        osd = osd_decode(graph, synd, bp.llr,
                         osd_method=cfg["osd_method"],
                         osd_order=cfg["osd_order"], consts=consts)
    else:
        from bp_osd_tpu.codes import lifted_hgp
        from bp_osd_tpu.decoder.lifted_bp import LiftedGraph, bp_decode_lifted

        qcode = lifted_hgp(LIFTED_PROTO, lift=cfg["lift"])
        H = np.asarray(qcode.hx.toarray(), np.uint8)
        graph = TannerGraph(H)
        lg = LiftedGraph(qcode.hx_proto, cfg["lift"])
        n = graph.n
        errors = (rng.random((cfg["B"], n)) < cfg["p"]).astype(np.uint8)
        synd = (errors @ H.T % 2).astype(np.uint8)
        llr0 = np.broadcast_to(
            np.asarray(llr_from_channel(np.full(n, cfg["p"]))),
            (cfg["B"], n))
        bp = bp_decode_lifted(lg, synd, llr0, bp_method=cfg["bp_method"],
                              max_iter=cfg["max_iter"],
                              ms_scaling_factor=cfg["ms_scaling_factor"])
        consts = build_osd_consts(graph, cfg["osd_method"],
                                  cfg["osd_order"])
        osd = osd_decode(graph, synd, bp.llr,
                         osd_method=cfg["osd_method"],
                         osd_order=cfg["osd_order"], consts=consts)

    osdw = np.where(np.asarray(bp.converged)[:, None], np.asarray(bp.hard),
                    np.asarray(osd.osdw)).astype(np.uint8)
    assert ((osdw @ H.T % 2) == synd).all(), f"{name}: invalid decodings"
    return (synd, osdw, np.asarray(bp.converged),
            np.asarray(bp.iterations).astype(np.int32))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    blobs = {}
    for name, cfg in CONFIGS.items():
        synd, osdw, conv, iters = decode_config(name, cfg)
        blobs[f"{name}_synd"] = np.packbits(synd, axis=1)
        blobs[f"{name}_osdw"] = np.packbits(osdw, axis=1)
        blobs[f"{name}_conv"] = conv
        blobs[f"{name}_iters"] = iters
        blobs[f"{name}_shape"] = np.array(synd.shape + osdw.shape[-1:],
                                          np.int64)
        print(f"{name}: {synd.shape[0]} samples, {conv.sum()} converged, "
              f"mean weight {osdw.sum(axis=1).mean():.2f}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **blobs)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
