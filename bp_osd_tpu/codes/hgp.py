"""Hypergraph-product (HGP) quantum LDPC code construction.

Framework counterpart of the reference ``hgp``/``hgp_single`` classes
(reference ``src/bposd/hgp.py:8-94``).  Given classical seed parity-check
matrices ``h1 (m1 x n1)`` and ``h2 (m2 x n2)``::

    hx = [ h1 (x) I_n2  |  I_m1 (x) h2^T ]      (reference hgp.py:48-50)
    hz = [ I_n1 (x) h2  |  h1^T (x) I_m2 ]      (reference hgp.py:52-54)

yielding a CSS code with ``N = n1 n2 + m1 m2`` and
``K = k1 k2 + k1t k2t`` where ``k = n - rank(h)`` and ``kt = m - rank(h)``
(reference ``hgp.py:29-44``).  The code distance is
``min(d1, d1t, d2, d2t)`` over the seed codes and their transposes when the
seeds have full-rank complements (reference ``hgp.py:60-81``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import gf2
from .code_util import compute_exact_code_distance
from .css import css_code

__all__ = ["hgp", "hgp_single"]


def _as_seed(h):
    """Normalize a classical seed PCM to CSR uint8."""
    if not sp.issparse(h):
        h = sp.csr_matrix(np.asarray(h))
    return h.tocsr().astype(np.uint8)


def _seed_distance(h, n_minus_r):
    """Exact distance of a seed code; inf when the kernel is trivial."""
    return compute_exact_code_distance(h) if n_minus_r else np.inf


class hgp(css_code):
    def __init__(self, h1, h2=None, compute_distance: bool = False):
        super().__init__()

        seeds = (_as_seed(h1), _as_seed(h1 if h2 is None else h2))
        self.h1, self.h2 = seeds
        shapes = [h.shape for h in seeds]
        ranks = [gf2.rank(h) for h in seeds]
        (self.m1, self.n1), (self.m2, self.n2) = shapes
        self.r1, self.r2 = ranks

        # kernel dimensions of the seeds and their transposes drive K
        self.k1, self.k2 = (n - r for (_, n), r in zip(shapes, ranks))
        self.k1t, self.k2t = (m - r for (m, _), r in zip(shapes, ranks))
        self.N = self.n1 * self.n2 + self.m1 * self.m2
        self.K = self.k1 * self.k2 + self.k1t * self.k2t

        def eye(k):
            return sp.identity(k, format="csr", dtype=np.uint8)

        def blockrow(a, b):
            """CSR hstack of two Kronecker factors, uint8."""
            return sp.hstack(
                [sp.kron(*a, format="csr"), sp.kron(*b, format="csr")],
                format="csr",
            ).astype(np.uint8)

        h1s, h2s = seeds
        self.hx = blockrow((h1s, eye(self.n2)), (eye(self.m1), h2s.T))
        self.hz = blockrow((eye(self.n1), h2s), (h1s.T, eye(self.m2)))
        # sector blocks of hx/hz, part of the reference attribute surface
        self.hx1 = self.hx[:, : self.n1 * self.n2].tocsr()
        self.hx2 = self.hx[:, self.n1 * self.n2 :].tocsr()
        self.hz1 = self.hz[:, : self.n1 * self.n2].tocsr()
        self.hz2 = self.hz[:, self.n1 * self.n2 :].tocsr()

        self.compute_logicals()
        self.compute_column_row_weights()

        if compute_distance:
            self.d1 = _seed_distance(h1s, self.k1)
            self.d2 = _seed_distance(h2s, self.k2)
            self.d1t = _seed_distance(h1s.T, self.k1t)
            self.d2t = _seed_distance(h2s.T, self.k2t)
            self.D = int(min(self.d1, self.d1t, self.d2, self.d2t))
        else:
            self.D = None

    def print_code_parameters(self):
        if self.D is None:
            print(f"[[{self.N},{self.K},d]]")
        else:
            print(f"[[{self.N},{self.K},{self.D}]]")


class hgp_single(hgp):
    """Symmetric hypergraph product of a single seed code with itself."""

    def __init__(self, h1, compute_distance: bool = False):
        super().__init__(h1, compute_distance=compute_distance)
