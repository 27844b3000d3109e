"""End-to-end edge-sharded BP + gather-to-DP OSD on a lifted-product code.

Covers the BASELINE.md row-5 decode PATH (correctness on the virtual 2D
mesh at a CPU-tractable size); the n ~ 10^4 throughput number comes from
``bench_large.py`` on the GPU.
"""

import jax
import numpy as np
from jax.sharding import Mesh

from bp_osd_tpu.codes import lifted_hgp
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode
from bp_osd_tpu.parallel.edge_shard import ShardedTannerGraph
from bp_osd_tpu.parallel.large_code import edge_sharded_bposd_fn

PROTO = [[(0,), (1,), (3,)]]  # 1x3 over F2[x]/(x^L - 1)


def test_lifted_product_edge_sharded_bposd_matches_dense():
    qcode = lifted_hgp(PROTO, lift=40)  # [[400, ...]]-scale, CPU tractable
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    m, n = H.shape
    assert qcode.test()

    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("data", "model"))
    sg = ShardedTannerGraph(H, n_shards=2)
    decode = edge_sharded_bposd_fn(
        sg, mesh, bp_method="minimum_sum", max_iter=10,
        ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=3,
    )

    B = 16
    p = 0.04
    rng = np.random.default_rng(5)
    errors = (rng.random((B, n)) < p).astype(np.uint8)
    synds = ((errors @ H.T) % 2).astype(np.uint8)
    pad = sg.n_shards * sg.m_chunk - m
    synds_pad = np.pad(synds, ((0, 0), (0, pad)))
    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(n, p))), (B, n)
    ).copy()

    osdw, conv = decode(synds_pad, llr0)
    osdw, conv = np.asarray(osdw), np.asarray(conv)

    # dense single-device reference
    g = TannerGraph(H)
    ref_bp = bp_decode(g, synds, llr0, bp_method="minimum_sum", max_iter=10,
                       ms_scaling_factor=0.625)
    ref_osd = osd_decode(g, synds, ref_bp.llr, osd_method="osd_cs",
                         osd_order=3)
    expect = np.where(np.asarray(ref_bp.converged)[:, None],
                      np.asarray(ref_bp.hard), np.asarray(ref_osd.osdw))

    assert np.array_equal(conv, np.asarray(ref_bp.converged))
    # all decodings must satisfy their syndromes
    assert (((osdw @ H.T) % 2) == synds).all()
    # converged samples are exact; OSD samples may differ only through
    # float reduction-order ties in the psum'd LLRs — require exactness on
    # the (typical) case where they match and weight-validity otherwise
    exact = (osdw == expect).all(axis=1)
    assert exact.mean() >= 0.9, f"only {exact.sum()}/{B} exact vs dense"
    assert (osdw.sum(axis=1) <= expect.sum(axis=1) + 1).all()
