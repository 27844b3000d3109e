"""Data-parallel sharded decoding over the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from bp_osd_tpu.codes import hgp, mkmn_16_4_6, rep_code
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode
from bp_osd_tpu.parallel import make_mesh, pad_batch, sharded_decode_fn

RNG = np.random.default_rng(3)


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_pad_batch():
    arr = np.ones((13, 4))
    padded, B = pad_batch(arr, 8)
    assert padded.shape == (16, 4)
    assert B == 13
    assert not padded[13:].any()


def test_sharded_decode_matches_single_device():
    surface = hgp(rep_code(3), rep_code(3))
    H = surface.hz.toarray()
    g = TannerGraph(H)
    mesh = make_mesh(8)
    decode = sharded_decode_fn(
        g, mesh, bp_method="ms", max_iter=13, ms_scaling_factor=0.625,
        osd_method="osd_cs", osd_order=4,
    )
    B = 32
    errors = (RNG.random((B, g.n)) < 0.1).astype(np.uint8)
    synds = (errors @ H.T) % 2
    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(g.n, 0.1))), (B, g.n)
    ).copy()

    osdw_sh, osd0_sh, bp_sh, conv_sh = decode(synds, llr0)

    # single-device reference path
    bp = bp_decode(g, synds, llr0, bp_method="ms", max_iter=13,
                   ms_scaling_factor=0.625)
    osd = osd_decode(g, synds, bp.llr, osd_method="osd_cs", osd_order=4)
    keep = np.asarray(bp.converged)[:, None]
    osdw_ref = np.where(keep, np.asarray(bp.hard), np.asarray(osd.osdw))

    assert np.array_equal(np.asarray(osdw_sh), osdw_ref)
    assert np.array_equal(np.asarray(conv_sh), np.asarray(bp.converged))
    # outputs really are sharded over the mesh
    assert len(osdw_sh.sharding.device_set) == 8


def test_sharded_decode_flagship_code_compiles():
    """[[400,16,6]] decode step compiles and runs across the 8-way mesh."""
    qcode = hgp(mkmn_16_4_6())
    g = TannerGraph(qcode.hx.toarray())
    mesh = make_mesh(8)
    decode = sharded_decode_fn(
        g, mesh, bp_method="ms", max_iter=8, ms_scaling_factor=0.0,
        osd_method="osd_cs", osd_order=3,
    )
    B = 16
    errors = (RNG.random((B, g.n)) < 0.05).astype(np.uint8)
    synds = (errors @ g.H.T) % 2
    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(g.n, 0.05))), (B, g.n)
    ).copy()
    osdw, _, _, _ = decode(synds, llr0)
    osdw = np.asarray(osdw)
    assert np.array_equal((osdw @ g.H.T) % 2, synds)


@pytest.mark.parametrize("osd_method,order", [("osd0", 0), ("osd_e", 6),
                                              ("osd_cs", 7)])
def test_sharded_decode_matches_unsharded(osd_method, order):
    """sharded_decode_fn over the 8 virtual devices gives the unsharded
    decode bit for bit, for every OSD method: per-sample arithmetic does
    not depend on how the batch is split."""
    qcode = hgp(rep_code(5), rep_code(5))
    H = qcode.hz.toarray()
    g = TannerGraph(H)
    kw = dict(bp_method="ms", max_iter=25, ms_scaling_factor=0.0)
    decode = sharded_decode_fn(g, make_mesh(8), osd_method=osd_method,
                               osd_order=order, **kw)
    B = 64
    errors = (RNG.random((B, g.n)) < 0.1).astype(np.uint8)
    synds = (errors @ H.T) % 2
    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(g.n, 0.1))), (B, g.n)
    ).copy()
    osdw, osd0, hard, conv = decode(synds, llr0)

    bp = bp_decode(g, synds, llr0, **kw)
    osd = osd_decode(g, synds, bp.llr, osd_method=osd_method,
                     osd_order=order)
    keep = np.asarray(bp.converged)[:, None]
    np.testing.assert_array_equal(np.asarray(conv), np.asarray(bp.converged))
    np.testing.assert_array_equal(np.asarray(hard), np.asarray(bp.hard))
    np.testing.assert_array_equal(
        np.asarray(osdw), np.where(keep, np.asarray(bp.hard),
                                   np.asarray(osd.osdw)))
    np.testing.assert_array_equal(
        np.asarray(osd0), np.where(keep, np.asarray(bp.hard),
                                   np.asarray(osd.osd0)))
    assert (~np.asarray(conv)).any()  # OSD really ran on some rows
