"""OSD fuzz: the batched XLA OSD against host GF(2) invariants on random
codes.

Random graph shapes, ranks and reliability ties (quantized LLRs) check
the contract of reference ``README.md:185-187`` where single golden
vectors can miss a divergence in pivot selection, candidate order or
tie-breaks:

- osd0 is the unique solution supported on the pivot columns, the first
  ``rank(H)`` linearly independent columns in stable reliability order —
  computed here on the host with ``bp_osd_tpu.gf2``;
- every output satisfies its syndrome;
- osdw is never heavier than osd0 (osd0 is one of its candidates).
"""

import numpy as np
import pytest

from bp_osd_tpu import gf2
from bp_osd_tpu.decoder import TannerGraph
from bp_osd_tpu.decoder.osd import osd_decode


def _random_case(seed):
    r = np.random.default_rng(seed)
    m = int(r.integers(16, 40))
    n = int(r.integers(m + 10, m + 60))
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        rows = r.choice(m, size=int(r.integers(2, 5)), replace=False)
        H[rows, j] = 1
    for i in range(m):
        if H[i].sum() == 0:
            H[i, int(r.integers(n))] = 1
    B = 5
    errors = (r.random((B, n)) < 0.08).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    # quantized llr values force plenty of exact reliability ties,
    # exercising the stable-sort + first-minimum tie-break rules
    llr = np.round(r.normal(1.5, 1.0, size=(B, n)) * 4) / 4
    return H, synd, llr.astype(np.float32)


def _host_osd0(H, synd, llr):
    """osd0 on the host: reduce H in stable reliability order, read the
    solution off the pivot columns."""
    perm = np.argsort(llr, kind="stable")
    re, r, T, pcols = gf2.reduced_row_echelon(H[:, perm])
    s_red = (T.astype(np.int64) @ synd) % 2
    e = np.zeros(H.shape[1], np.uint8)
    e[perm[pcols[:r]]] = s_red[:r]
    return e


@pytest.mark.parametrize("seed", [101, 202, 303])
@pytest.mark.parametrize("order", [0, 4])
def test_osd_matches_host_invariants(seed, order):
    H, synd, llr = _random_case(seed)
    out = osd_decode(TannerGraph(H), synd, llr, osd_method="osd_cs",
                     osd_order=order)
    osd0, osdw = np.asarray(out.osd0), np.asarray(out.osdw)
    for b in range(synd.shape[0]):
        np.testing.assert_array_equal(osd0[b], _host_osd0(H, synd[b], llr[b]))
    np.testing.assert_array_equal(osd0.astype(np.int64) @ H.T % 2, synd)
    np.testing.assert_array_equal(osdw.astype(np.int64) @ H.T % 2, synd)
    assert (osdw.sum(axis=1) <= osd0.sum(axis=1)).all()
    if order == 0:
        np.testing.assert_array_equal(osdw, osd0)
