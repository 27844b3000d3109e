"""Decoder correctness: Tanner layout, BP convergence, OSD invariants, and
the reference README golden decode (reference ``README.md:190-216``)."""

import numpy as np
import pytest

from bp_osd_tpu import BpDecoder, BpOsdDecoder, bposd_decoder
from bp_osd_tpu.codes import css_code, hamming_code, hgp, rep_code
from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode

RNG = np.random.default_rng(11)


def brute_force_min_weight(H, syndrome):
    """Smallest-weight e with H e = s (mod 2), by exhaustive search."""
    m, n = H.shape
    best = None
    for x in range(1 << n):
        e = np.array([(x >> i) & 1 for i in range(n)], dtype=np.uint8)
        if np.array_equal((H @ e) % 2, syndrome % 2):
            w = int(e.sum())
            if best is None or w < best:
                best = w
    return best


def test_tanner_graph_layout():
    H = hamming_code(3).toarray()
    g = TannerGraph(H)
    assert (g.m, g.n) == (3, 7)
    assert g.num_edges == H.sum()
    assert g.wr == 4 and g.wc == 3
    # chk_var lists exactly the support of each row
    for i in range(g.m):
        vars_i = g.chk_var[i][g.chk_mask[i]]
        assert set(vars_i) == set(np.nonzero(H[i])[0])
    # var_edge points back to edges whose chk_var entry is that variable
    flat_var = g.chk_var.reshape(-1)
    for v in range(g.n):
        edges = g.var_edge[v][g.var_mask[v]]
        assert all(flat_var[e] == v for e in edges)
        assert len(edges) == H[:, v].sum()
    assert g.rank == 3


@pytest.mark.parametrize("bp_method", ["product_sum", "minimum_sum"])
def test_bp_converges_on_single_errors_hamming(bp_method):
    """Weight-1 errors on the Hamming code: flooding BP must converge to
    *some* syndrome-satisfying solution (the loopy graph may legally settle
    on a degenerate higher-weight solution — e.g. the all-ones-column
    syndrome — exactly as the reference's parallel-schedule BP does)."""
    H = hamming_code(3).toarray()
    g = TannerGraph(H)
    errors = np.eye(7, dtype=np.uint8)
    synd = (errors @ H.T) % 2
    llr0 = llr_from_channel(np.full(7, 0.05))
    res = bp_decode(g, synd, llr0, bp_method=bp_method, max_iter=20,
                    ms_scaling_factor=0.625)
    assert np.asarray(res.converged).all()
    hard = np.asarray(res.hard)
    assert np.array_equal((hard @ H.T) % 2, synd)


@pytest.mark.parametrize("bp_method", ["product_sum", "minimum_sum"])
def test_bp_corrects_single_errors_rep_code(bp_method):
    """The repetition-code Tanner graph is a tree: BP is exact, so every
    single-bit interior error must be recovered exactly."""
    H = rep_code(8).toarray()
    g = TannerGraph(H)
    errors = np.eye(8, dtype=np.uint8)
    synd = (errors @ H.T) % 2
    llr0 = llr_from_channel(np.full(8, 0.05))
    res = bp_decode(g, synd, llr0, bp_method=bp_method, max_iter=30,
                    ms_scaling_factor=0.625)
    assert np.asarray(res.converged).all()
    assert np.array_equal(np.asarray(res.hard), errors)


def test_bp_minsum_adaptive_scaling_converges():
    H = rep_code(10).toarray()
    g = TannerGraph(H)
    e = np.zeros(10, np.uint8)
    e[3] = 1
    synd = (H @ e) % 2
    res = bp_decode(g, synd[None], llr_from_channel(np.full(10, 0.1)),
                    bp_method="ms", max_iter=30, ms_scaling_factor=0.0)
    assert np.asarray(res.converged).all()
    assert np.array_equal(np.asarray(res.hard)[0], e)


def test_bp_reports_nonconvergence():
    """A syndrome outside easy reach: rep code with conflicting checks."""
    H = rep_code(4).toarray()
    g = TannerGraph(H)
    synd = np.array([[1, 1, 1]], np.uint8)  # forces weight-2 interior error
    res = bp_decode(g, synd, llr_from_channel(np.full(4, 0.01)),
                    bp_method="ps", max_iter=5)
    # whether or not it converges, outputs must be well-formed
    hard = np.asarray(res.hard)[0]
    assert hard.shape == (4,)
    assert set(np.unique(hard)) <= {0, 1}


@pytest.mark.parametrize("osd_method,order", [("osd0", 0), ("osd_e", 4), ("osd_cs", 4)])
def test_osd_solutions_satisfy_syndrome(osd_method, order):
    """OSD output must satisfy H e = s for every solvable syndrome."""
    H = hgp(rep_code(3), rep_code(3)).hz.toarray()
    g = TannerGraph(H)
    B = 32
    errors = (RNG.random((B, g.n)) < 0.08).astype(np.uint8)
    synd = (errors @ H.T) % 2
    llr = jnp_llr = np.asarray(
        llr_from_channel(np.full(g.n, 0.08))
    ) + RNG.normal(0, 2.0, (B, g.n)).astype(np.float32)  # scrambled reliabilities
    res = osd_decode(g, synd, llr, osd_method=osd_method, osd_order=order)
    for name, sol in [("osd0", res.osd0), ("osdw", res.osdw)]:
        sol = np.asarray(sol)
        assert np.array_equal((sol @ H.T) % 2, synd), f"{name} violates syndrome"


def test_osd_e_full_order_is_maximum_likelihood():
    """With order = |T|, osd_e searches every coset solution -> min weight."""
    H = hamming_code(3).toarray()  # rank 3, n 7 -> |T| = 4
    g = TannerGraph(H)
    B = 8
    synd = RNG.integers(0, 2, (B, 3)).astype(np.uint8)
    llr = RNG.normal(0, 1, (B, 7)).astype(np.float32)
    res = osd_decode(g, synd, llr, osd_method="osd_e", osd_order=4)
    for b in range(B):
        sol = np.asarray(res.osdw)[b]
        assert np.array_equal((H @ sol) % 2, synd[b])
        assert sol.sum() == brute_force_min_weight(H, synd[b])


def test_osd_cs_improves_on_osd0():
    """osd_cs candidates include osd0, so weight can only go down."""
    H = hgp(rep_code(4), rep_code(4)).hx.toarray()
    g = TannerGraph(H)
    B = 64
    errors = (RNG.random((B, g.n)) < 0.1).astype(np.uint8)
    synd = (errors @ H.T) % 2
    llr = RNG.normal(0, 1, (B, g.n)).astype(np.float32)
    res = osd_decode(g, synd, llr, osd_method="osd_cs", osd_order=6)
    w0 = np.asarray(res.osd0).sum(axis=1)
    ww = np.asarray(res.osdw).sum(axis=1)
    assert (ww <= w0).all()
    assert np.array_equal((np.asarray(res.osdw) @ H.T) % 2, synd)


def test_readme_golden_surface_code_decode():
    """Reference README.md:190-216: surface code, error on {5,12}, ms
    scaling 0, osd_cs order 7 -> osdw_decoding flips qubit 8, no logical
    error."""
    surface_code = hgp(rep_code(3), rep_code(3), compute_distance=True)
    bpd = bposd_decoder(
        surface_code.hz,
        error_rate=0.05,
        channel_probs=[None],
        max_iter=surface_code.N,
        bp_method="ms",
        ms_scaling_factor=0,
        osd_method="osd_cs",
        osd_order=7,
    )
    error = np.zeros(surface_code.N).astype(int)
    error[[5, 12]] = 1
    syndrome = surface_code.hz @ error % 2
    bpd.decode(syndrome)
    expected = np.zeros(13, np.uint8)
    expected[8] = 1
    assert np.array_equal(bpd.osdw_decoding, expected)
    residual = (bpd.osdw_decoding + error) % 2
    assert not (surface_code.lz @ residual % 2).any()


def test_decoder_attribute_protocol():
    surface = hgp(rep_code(3), rep_code(3))
    bpd = BpOsdDecoder(
        surface.hz, error_rate=0.05, max_iter=13,
        bp_method="minimum_sum", ms_scaling_factor=0.625,
        osd_method="osd_cs", osd_order=2,
    )
    e = np.zeros(13, np.uint8)
    e[4] = 1
    out = bpd.decode(surface.hz.toarray() @ e % 2)
    for attr in ("bp_decoding", "osd0_decoding", "osdw_decoding",
                 "log_prob_ratios", "converge", "iter"):
        assert hasattr(bpd, attr)
    assert out.shape == (13,)
    assert np.array_equal(bpd.osdw_decoding, out)
    assert bpd.converge in (0, 1)


def test_converged_bp_bypasses_osd():
    """When BP converges, osd0/osdw must equal the BP decoding."""
    H = hamming_code(3).toarray()
    bpd = BpOsdDecoder(H, error_rate=0.05, max_iter=20,
                       bp_method="ps", osd_method="osd_e", osd_order=3)
    e = np.zeros(7, np.uint8)
    e[2] = 1
    bpd.decode(H @ e % 2)
    assert bpd.converge == 1
    assert np.array_equal(bpd.bp_decoding, bpd.osdw_decoding)
    assert np.array_equal(bpd.bp_decoding, bpd.osd0_decoding)
    assert np.array_equal(bpd.bp_decoding, e)


def test_batch_matches_single():
    surface = hgp(rep_code(3), rep_code(3))
    H = surface.hz.toarray()
    bpd = BpOsdDecoder(H, error_rate=0.05, max_iter=13,
                       bp_method="ms", ms_scaling_factor=0.625,
                       osd_method="osd_cs", osd_order=4)
    B = 16
    errors = (RNG.random((B, 13)) < 0.1).astype(np.uint8)
    synds = (errors @ H.T) % 2
    batch_out = bpd.decode_batch(synds).copy()
    for b in range(B):
        single = bpd.decode(synds[b])
        assert np.array_equal(single, batch_out[b])


def test_update_channel_probs():
    H = hamming_code(3).toarray()
    bpd = BpOsdDecoder(H, error_rate=0.05, max_iter=10, osd_method="osd0")
    bpd.update_channel_probs(np.full(7, 0.2))
    assert np.allclose(bpd.channel_probs, 0.2)
    e = np.zeros(7, np.uint8)
    e[0] = 1
    out = bpd.decode(H @ e % 2)
    assert np.array_equal((H @ out) % 2, H @ e % 2)


def test_bp_decoder_standalone():
    H = rep_code(5).toarray()
    bpd = BpDecoder(H, error_rate=0.1, max_iter=20, bp_method="ps")
    e = np.zeros(5, np.uint8)
    e[2] = 1
    out = bpd.decode(H @ e % 2)
    assert np.array_equal(out, e)
    assert bpd.converge == 1


def test_decode_batch_device_outputs():
    """outputs='device' + device-array syndromes must match the host path
    bit-for-bit (the bench_api.py measurement mode)."""
    import jax
    import jax.numpy as jnp

    surface = hgp(rep_code(3), rep_code(3))
    H = surface.hz.toarray()
    dec = BpOsdDecoder(H, error_rate=0.06, max_iter=13, bp_method="ms",
                       ms_scaling_factor=0.625, osd_method="osd_cs",
                       osd_order=4)
    B = 24
    errors = (RNG.random((B, 13)) < 0.1).astype(np.uint8)
    synds = (errors @ H.T) % 2
    host = dec.decode_batch(synds).copy()
    host_conv = dec.converge_batch.copy()
    dev = dec.decode_batch(jnp.asarray(synds.astype(np.uint8)),
                           outputs="device")
    assert isinstance(dev, jax.Array)
    assert isinstance(dec.converge_batch, jax.Array)
    assert np.array_equal(np.asarray(dev), host)
    assert np.array_equal(np.asarray(dec.converge_batch), host_conv)


def test_compact_osd_matches_fused_path():
    """compact_osd=True (OSD only on BP failures) must give the same
    decodings as the fused path."""
    surface = hgp(rep_code(3), rep_code(3))
    H = surface.hz.toarray()
    bpd = BpOsdDecoder(H, error_rate=0.08, max_iter=13, bp_method="ms",
                       ms_scaling_factor=0.625, osd_method="osd_cs",
                       osd_order=4)
    B = 64
    errors = (RNG.random((B, 13)) < 0.12).astype(np.uint8)
    synds = (errors @ H.T) % 2
    fused = bpd.decode_batch(synds).copy()
    fused_conv = bpd.converge_batch.copy()
    compact = bpd.decode_batch(synds, compact_osd=True).copy()
    assert np.array_equal(bpd.converge_batch, fused_conv)
    assert np.array_equal(compact, fused)
    assert np.array_equal((compact @ H.T) % 2, synds)


def test_backend_auto_selection(monkeypatch):
    """There is one decode path; the platform only sets the dispatch
    defaults.  ``backend`` values naming that path still construct, and a
    fake GPU device switches both defaults to the accelerator sizes."""
    import jax

    from bp_osd_tpu import runtime

    H = hgp(rep_code(3), rep_code(3)).hz.toarray()
    kwargs = dict(error_rate=0.05, max_iter=10, osd_method="osd_cs",
                  osd_order=2)
    for backend in ("auto", "xla"):
        assert not hasattr(BpOsdDecoder(H, backend=backend, **kwargs),
                           "backend")
    from bp_osd_tpu.codes import hgp as _hgp, mkmn_16_4_6

    small = TannerGraph(H)
    flagship = TannerGraph(_hgp(mkmn_16_4_6()).hx.toarray())
    big = TannerGraph(H)  # a [[10000,420]]-sized OSD working set, by shape
    big.n, big.rank = 10000, 4790
    assert runtime.decode_chunk_default(small) == 4096  # conftest pins CPU
    assert runtime.sim_batch_cap(small, flagship) == 1024
    assert runtime.decode_chunk_default(big) == 43  # memory-capped

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [FakeGpu()])
    assert runtime.decode_chunk_default(flagship) == 16384
    assert runtime.sim_batch_cap(small, flagship) == 16384
    assert runtime.decode_chunk_default(big) == 43
    assert runtime.sim_batch_cap(small, big) == 43


def test_osd_decode_skip_parity():
    """osd_decode(skip=conv) equals the unskipped decode on live samples."""
    import jax.numpy as jnp

    from bp_osd_tpu.decoder.osd import build_osd_consts

    H = hgp(rep_code(4), rep_code(4)).hz.toarray()
    g = TannerGraph(H)
    consts = build_osd_consts(g, "osd_cs", 4)
    B = 16
    errors = (RNG.random((B, g.n)) < 0.08).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.int32)
    llr = RNG.normal(0, 1, (B, g.n)).astype(np.float32)
    skip = (RNG.random(B) < 0.4)
    live = ~skip
    kw = dict(osd_method="osd_cs", osd_order=4, consts=consts)
    ref = osd_decode(g, synd, llr, **kw)
    out = osd_decode(g, synd, llr, skip=jnp.asarray(skip), **kw)
    assert np.array_equal(np.asarray(ref.osd0)[live], np.asarray(out.osd0)[live])
    assert np.array_equal(np.asarray(ref.osdw)[live], np.asarray(out.osdw)[live])
