"""Checks that need an NVIDIA GPU; they skip elsewhere.

Run on a GPU host::

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

What the CPU suite cannot see: the card's own arithmetic.  A float32
matmul at default precision runs in TF32 there, and kernels sum in other
orders than the CPU's.  BP sums each variable's messages in one fixed
order and rounds every check message, so the flagship decodes here must
equal the CPU's bit for bit.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")


@pytest.fixture(scope="module")
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")
    return dev


@pytest.fixture(scope="module")
def flagship(gpu):
    from bp_osd_tpu import BpOsdDecoder
    from bp_osd_tpu.codes import hgp, mkmn_16_4_6

    qcode = hgp(mkmn_16_4_6())
    dec = BpOsdDecoder(qcode.hx, error_rate=0.05, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs",
                       osd_order=42)
    return np.asarray(qcode.hx.toarray(), np.uint8), dec


def test_gpu_decodes_cpu_corpus_bit_for_bit(flagship):
    H, dec = flagship
    data = np.load(CORPUS)
    m, n = int(data["meta"][1]), int(data["meta"][2])
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :m]
    osdw = dec.decode_batch(synd)
    np.testing.assert_array_equal(dec.converge_batch, data["converged"])
    np.testing.assert_array_equal(dec.iter_batch, data["iterations"])
    np.testing.assert_array_equal(
        osdw, np.unpackbits(data["osdw_packed"], axis=1)[:, :n])


def test_gpu_osd_matches_cpu_on_identical_llrs(flagship):
    import jax

    from bp_osd_tpu.decoder.osd import osd_decode

    H, dec = flagship
    rng = np.random.default_rng(5)
    synd = ((rng.random((256, H.shape[1])) < 0.05) @ H.T % 2).astype(
        np.uint8)
    llr = np.round(rng.normal(2.0, 2.0, (256, H.shape[1])) * 8) / 8
    fn = jax.jit(lambda g, s, l, c: osd_decode(
        g, s, l, osd_method="osd_cs", osd_order=42, consts=c))
    args = (dec._osd_graph, synd, llr.astype(np.float32), dec._osd_consts)
    on_gpu = fn(*args)
    on_cpu = fn(*jax.device_put(args, jax.devices("cpu")[0]))
    np.testing.assert_array_equal(np.asarray(on_gpu.osd0),
                                  np.asarray(on_cpu.osd0))
    np.testing.assert_array_equal(np.asarray(on_gpu.osdw),
                                  np.asarray(on_cpu.osdw))


@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
def test_gpu_one_hot_routing_matches_gather(flagship, bp_method):
    """At default precision the one-hot matmul would run in TF32 and round
    every message; at HIGHEST it selects exactly, as the gather does."""
    import jax

    from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel

    H, _ = flagship
    onehot, gather = TannerGraph(H), TannerGraph(H)
    gather.edge_var_onehot = None
    rng = np.random.default_rng(6)
    synd = ((rng.random((512, H.shape[1])) < 0.05) @ H.T % 2).astype(
        np.uint8)
    llr0 = llr_from_channel(np.full(H.shape[1], 0.05))
    fn = jax.jit(lambda g, s, l: bp_decode(
        g, s, l, bp_method=bp_method, max_iter=32, ms_scaling_factor=0.0))
    a, b = fn(onehot, synd, llr0), fn(gather, synd, llr0)
    for name in ("converged", "iterations", "hard", "llr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
