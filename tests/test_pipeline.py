"""decode_pipeline vs its components (semantic equality)."""

import numpy as np

from bp_osd_tpu.codes import hgp, rep_code
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode
from bp_osd_tpu.decoder.pipeline import decode_pipeline


def _workload(B=64, p=0.08, seed=3):
    H = np.asarray(hgp(rep_code(3), rep_code(3)).hx.toarray(), np.uint8)
    graph = TannerGraph(H)
    n = H.shape[1]
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, n)) < p).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(np.asarray(llr_from_channel(np.full(n, p))), (B, n))
    return graph, synd, llr0


def test_pipeline_xla_matches_components():
    graph, synd, llr0 = _workload()
    out = decode_pipeline(
        graph, synd, llr0, bp_method="minimum_sum", max_iter=13,
        ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=4,
    )
    bp = bp_decode(graph, synd, llr0, bp_method="minimum_sum", max_iter=13,
                   ms_scaling_factor=0.0)
    osd = osd_decode(graph, synd, bp.llr, osd_method="osd_cs", osd_order=4)
    expect = np.where(np.asarray(bp.converged)[:, None], np.asarray(bp.hard),
                      np.asarray(osd.osdw))
    np.testing.assert_array_equal(np.asarray(out.osdw), expect)
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(bp.converged))
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(bp.iterations))
