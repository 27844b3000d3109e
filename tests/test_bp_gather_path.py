"""BP gather-path vs matmul-path equivalence.

``bp_decode`` selects variable->edge messages with one-hot matmuls when
the graph is small (``TannerGraph.edge_var_onehot``), and with gathers for
large graphs — the path a non-lifted n ~ 10^4 code would take through
``BpDecoder``.  Same graphs, same syndromes, both paths, compared here.
"""

import numpy as np
import pytest

from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel


def _random_graph(seed, m=24, n=60):
    r = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        rows = r.choice(m, size=int(r.integers(2, 5)), replace=False)
        H[rows, j] = 1
    for i in range(m):
        if H[i].sum() == 0:
            H[i, int(r.integers(n))] = 1
    return H


@pytest.mark.parametrize("seed", [11, 22])
@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
def test_gather_path_matches_matmul_path(seed, bp_method):
    H = _random_graph(seed)
    graph = TannerGraph(H)
    assert graph.edge_var_onehot is not None  # small graph: matmul path

    r = np.random.default_rng(seed + 1)
    B = 12
    errors = (r.random((B, graph.n)) < 0.06).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(
        np.asarray(llr_from_channel(np.full(graph.n, 0.06))), (B, graph.n)
    )
    kw = dict(bp_method=bp_method, max_iter=15, ms_scaling_factor=0.625)

    ref = bp_decode(graph, synd, llr0, **kw)

    graph.edge_var_onehot = None  # force the large-graph gather fallback
    out = bp_decode(graph, synd, llr0, **kw)

    assert np.array_equal(np.asarray(out.converged),
                          np.asarray(ref.converged))
    assert np.array_equal(np.asarray(out.iterations),
                          np.asarray(ref.iterations))
    assert np.array_equal(np.asarray(out.hard), np.asarray(ref.hard))
    llr, llr_ref = np.asarray(out.llr), np.asarray(ref.llr)
    confident = np.abs(llr_ref) > 1.0
    assert np.array_equal(np.sign(llr[confident]),
                          np.sign(llr_ref[confident]))
    assert np.allclose(llr, llr_ref, atol=1e-3)


def _code(name):
    from bp_osd_tpu.codes import hamming_code, hgp, mkmn_16_4_6, rep_code

    if name == "hamming":
        return hamming_code(3).toarray()
    if name == "flagship":
        return hgp(mkmn_16_4_6()).hx.toarray()
    d = int(name[-1])
    return hgp(rep_code(d), rep_code(d)).hz.toarray()


@pytest.mark.parametrize("method", ["ms_adaptive", "ms_0.625", "ps"])
@pytest.mark.parametrize("code", ["surface_d3", "surface_d5", "flagship",
                                  "hamming"])
def test_gather_path_matches_matmul_path_on_codes(code, method):
    """The repo's codes and BP methods: the one-hot routing (a float32
    matmul at HIGHEST precision) and the gather routing give the same
    floats.  Each variable's messages are summed in one fixed order on
    both routings (``bp_decode``'s ``per_variable_total``), and selection
    through a one-hot matrix is exact, so equality is bit for bit."""
    H = np.asarray(_code(code), np.uint8)
    graph = TannerGraph(H)
    assert graph.edge_var_onehot is not None
    bp_method, alpha = {"ms_adaptive": ("minimum_sum", 0.0),
                        "ms_0.625": ("minimum_sum", 0.625),
                        "ps": ("product_sum", 1.0)}[method]
    r = np.random.default_rng(sum(map(ord, code + method)))
    B, p = 32, 0.06
    errors = (r.random((B, graph.n)) < p).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    llr0 = np.asarray(llr_from_channel(np.full(graph.n, p)))
    kw = dict(bp_method=bp_method, max_iter=32, ms_scaling_factor=alpha)

    ref = bp_decode(graph, synd, llr0, **kw)
    graph.edge_var_onehot = None
    out = bp_decode(graph, synd, llr0, **kw)

    for name in ("converged", "iterations", "hard", "llr"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
