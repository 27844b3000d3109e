"""Shift-routed lifted-graph BP == generic dense BP, bit for bit."""

import numpy as np
import pytest

from bp_osd_tpu.codes.lifted_product import lifted_hgp, protograph_to_binary
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph, bp_decode_lifted

PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]


@pytest.mark.parametrize("bp_method,msf", [
    ("minimum_sum", 0.625),
    ("minimum_sum", 0.0),
    ("product_sum", 1.0),
])
def test_lifted_bp_matches_dense_on_lifted_hgp(bp_method, msf):
    """The routing is exact, the check update is shared code, so outputs
    must agree bit-for-bit with the dense path on the expanded matrix."""
    L = 8
    qcode = lifted_hgp(PROTO, lift=L)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    g = TannerGraph(H)
    lg = LiftedGraph(qcode.hx_proto, L)
    assert (lg.m, lg.n) == (g.m, g.n)

    B = 12
    rng = np.random.default_rng(23)
    errors = (rng.random((B, g.n)) < 0.03).astype(np.uint8)
    synds = (errors @ H.T) % 2
    llr0 = np.asarray(llr_from_channel(np.full(g.n, 0.03)))

    ref = bp_decode(g, synds, llr0, bp_method=bp_method, max_iter=25,
                    ms_scaling_factor=msf)
    out = bp_decode_lifted(lg, synds, llr0, bp_method=bp_method,
                           max_iter=25, ms_scaling_factor=msf)
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))
    if bp_method == "minimum_sum":
        # routing is exact and min/sign arithmetic reproduces the dense
        # path bit-for-bit
        np.testing.assert_array_equal(np.asarray(out.iterations),
                                      np.asarray(ref.iterations))
        np.testing.assert_array_equal(np.asarray(out.hard),
                                      np.asarray(ref.hard))
        np.testing.assert_allclose(np.asarray(out.llr), np.asarray(ref.llr),
                                   atol=2e-4)
    else:
        # product_sum sums tanh-domain floats in a different order
        # (sequential rolls vs matmul reduction): values agree to float
        # tolerance and all converged rows satisfy their syndromes
        np.testing.assert_allclose(np.asarray(out.llr), np.asarray(ref.llr),
                                   atol=0.25, rtol=5e-3)
        hard = np.asarray(out.hard)
        conv = np.asarray(out.converged)
        assert np.array_equal((hard[conv] @ H.T) % 2, synds[conv])


def test_lifted_bp_multi_exponent_entries():
    """Entries with several shift terms (true circulant sums) route
    correctly too."""
    L = 6
    proto = [[(0, 1), (2,), ()], [(3,), (0, 4), (1,)]]
    H = np.asarray(protograph_to_binary(proto, L).toarray(), np.uint8)
    g = TannerGraph(H)
    lg = LiftedGraph(proto, L)
    B = 8
    rng = np.random.default_rng(3)
    errors = (rng.random((B, g.n)) < 0.1).astype(np.uint8)
    synds = (errors @ H.T) % 2
    llr0 = np.asarray(llr_from_channel(np.full(g.n, 0.1)))

    ref = bp_decode(g, synds, llr0, bp_method="ms", max_iter=15,
                    ms_scaling_factor=0.0)
    out = bp_decode_lifted(lg, synds, llr0, bp_method="ms", max_iter=15,
                           ms_scaling_factor=0.0)
    np.testing.assert_array_equal(np.asarray(out.hard), np.asarray(ref.hard))
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))


def test_decoder_class_lifted_routing_matches_generic():
    """BpOsdDecoder(proto=..., lift=...) decodes identically (min-sum) to
    the generic dense path."""
    from bp_osd_tpu import BpOsdDecoder

    L = 8
    qcode = lifted_hgp(PROTO, lift=L)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    n = H.shape[1]
    rng = np.random.default_rng(41)
    errors = (rng.random((10, n)) < 0.02).astype(np.uint8)
    synds = (errors @ H.T) % 2

    kw = dict(error_rate=0.02, max_iter=30, bp_method="ms",
              ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=4)
    fast = BpOsdDecoder(H, proto=qcode.hx_proto, lift=L, **kw)
    ref = BpOsdDecoder(H, **kw)
    fast.decode_batch(synds)
    ref.decode_batch(synds)
    np.testing.assert_array_equal(fast.converge_batch, ref.converge_batch)
    np.testing.assert_array_equal(fast.bp_decoding_batch,
                                  ref.bp_decoding_batch)
    # every osdw decoding satisfies its syndrome
    assert np.array_equal((fast.osdw_decoding_batch @ H.T) % 2, synds)


def test_lifted_bp_shard_map_batch_dp():
    """Shift-routed BP composes with batch data-parallel shard_map on the
    virtual mesh (rolls are intra-shard; no collectives needed)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    L = 8
    qcode = lifted_hgp(PROTO, lift=L)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    lg = LiftedGraph(qcode.hx_proto, L)
    B = 32
    rng = np.random.default_rng(7)
    errors = (rng.random((B, lg.n)) < 0.02).astype(np.uint8)
    synds = jnp.asarray((errors @ H.T) % 2)
    llr0 = jnp.broadcast_to(
        jnp.asarray(llr_from_channel(np.full(lg.n, 0.02))), (B, lg.n))

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))

    def step(s, l):
        bp = bp_decode_lifted(lg, s, l, bp_method="ms", max_iter=30,
                              ms_scaling_factor=0.625)
        return bp.hard, bp.converged

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    hs, cs = jax.jit(sharded)(synds, llr0)
    hu, cu = step(synds, llr0)
    np.testing.assert_array_equal(np.asarray(hs), np.asarray(hu))
    np.testing.assert_array_equal(np.asarray(cs), np.asarray(cu))
