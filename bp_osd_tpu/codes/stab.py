"""General (non-CSS) stabilizer codes in binary-symplectic form.

Framework counterpart of the reference ``stab_code`` class (reference
``src/bposd/stab.py:23-165``).  A code on N qubits is given by
``hx``/``hz`` halves of the symplectic check matrix ``[hx | hz]``; logical
operators come from the same kernel-minus-image pivot trick as the CSS case,
applied to the twisted symplectic form ``[hz | hx]`` (reference
``stab.py:47-61``).  Distance is exact brute force over the full coset span
with GF(4) weights (reference ``stab.py:63-98``) — exponential, small codes
only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import gf2

__all__ = ["stab_code", "gf2_to_gf4"]


def gf2_to_gf4(bin_vec: np.ndarray) -> np.ndarray:
    """Map a length-2N binary-symplectic vector to N GF(4) symbols.

    Encoding (reference ``stab.py:7-19``): X-only -> 1, Y (both halves) -> 2,
    Z-only -> 3, identity -> 0.  Vectorized over the qubit axis.
    """
    bin_vec = np.asarray(bin_vec)
    n = bin_vec.shape[-1] // 2
    x = bin_vec[..., :n].astype(np.int64)
    z = bin_vec[..., n:].astype(np.int64)
    # x=1,z=0 -> 1 ; x=1,z=1 -> 2 ; x=0,z=1 -> 3 ; else 0
    return np.where(x & z, 2, np.where(x, 1, np.where(z, 3, 0)))


def _gf4_weight(bin_rows: np.ndarray) -> np.ndarray:
    """Number of non-identity qubit positions of binary-symplectic rows."""
    bin_rows = np.atleast_2d(np.asarray(bin_rows))
    n = bin_rows.shape[1] // 2
    support = (bin_rows[:, :n] | bin_rows[:, n:]) != 0
    return support.sum(axis=1)


def _as_csr(M) -> sp.csr_matrix:
    if sp.issparse(M):
        return M.tocsr().astype(np.uint8)
    return sp.csr_matrix(np.asarray(M), dtype=np.uint8)


class stab_code:
    """A stabilizer code with check matrix ``h = [hx | hz]``.

    ``K = N - rank(h)``; logical representatives are pivot rows of
    ``[h; ker([hz | hx])]`` past ``rank(h)`` — note ``l`` holds 2K rows (an
    X-type and Z-type representative per logical qubit), so ``K = rows(l)/2``
    (reference ``stab.py:61``).
    """

    def __init__(self, hx, hz, name: str | None = None):
        self.name = name if name is not None else "<Unnamed stabilizer code>"
        self.hx = _as_csr(hx)
        self.hz = _as_csr(hz)
        self.init_code()
        self.h = sp.hstack([self.hx, self.hz]).tocsr()
        self.l = sp.hstack([self.lx, self.lz]).tocsr()

    def init_code(self):
        self.h = sp.hstack([self.hx, self.hz]).tocsr()
        self.N = int(self.hx.shape[1])
        self.K = self.N - gf2.rank(self.h)
        self.compute_logical_operators()
        self.D = np.nan

    def compute_logical_operators(self):
        """Logicals = centralizer of the stabilizer modulo the stabilizer.

        The symplectic commutation condition makes the centralizer the kernel
        of the *twisted* matrix ``[hz | hx]``; quotienting by the stabilizer
        row space is the pivot-past-rank selection.
        """
        twisted = sp.hstack([self.hz, self.hx]).tocsr()
        ker = gf2.kernel(twisted)
        rank_h = gf2.rank(self.h)
        stack = sp.vstack([self.h, ker]).tocsr()
        pivots = gf2.pivot_rows(stack)[rank_h:]
        self.l = stack[pivots].tocsr().astype(np.uint8)
        self.lx = self.l[:, : self.N].tocsr()
        self.lz = self.l[:, self.N :].tocsr()
        self.K = int(self.l.shape[0] / 2)

    def compute_code_distance(self, return_logicals: bool = False):
        """Exact distance: min GF(4) weight over all logical coset elements.

        Enumerates ``row_span([stabilizer_basis; l])`` minus the pure
        stabilizer, so cost is ``2^(rank(h) + 2K)`` (reference
        ``stab.py:63-98``; warns for N > 10).
        """
        if self.N > 10:
            print(
                "Warning: computing a code distance of codes with N>10 "
                "will take a long time."
            )

        re, r, _, _ = gf2.row_echelon(self.h)
        stab_basis = re[:r]
        stack = sp.vstack([sp.csr_matrix(stab_basis), self.l])
        span = gf2.row_span(stack).toarray()

        # Logical operators = span elements NOT in the stabilizer span.
        stab_span = {gf2.pack_rows(row.reshape(1, -1))[0].tobytes()
                     for row in gf2.row_span(sp.csr_matrix(stab_basis)).toarray()}
        weights = _gf4_weight(span)
        d_min = self.N
        min_logicals = []
        for row, w in zip(span, weights):
            if gf2.pack_rows(row.reshape(1, -1))[0].tobytes() in stab_span:
                continue
            if w < d_min:
                d_min = int(w)
                min_logicals = [gf2_to_gf4(row)]
            elif w == d_min:
                min_logicals.append(gf2_to_gf4(row))

        self.D = d_min
        if return_logicals:
            return np.array(min_logicals)
        return d_min

    # -- validation ---------------------------------------------------------

    def test(self, show_tests: bool = True) -> bool:
        """Stabilizer-code validity checks (reference ``stab.py:100-161``):

        block dimensions; symplectic self-orthogonality
        ``hx@hz.T + hz@hx.T == 0``; logicals commute with stabilizers;
        logicals pair up with full anticommutation rank.
        """
        valid = True

        def report(ok: bool, label: str) -> bool:
            nonlocal valid
            if ok:
                if show_tests:
                    print(f" -{label}: Pass")
            else:
                valid = False
                print(f" -{label}: Fail")
            return ok

        if show_tests:
            print(f"{self.name}, {self.code_params}")

        dims_ok = (
            self.N == self.hz.shape[1] == self.lz.shape[1] == self.lx.shape[1]
            and self.K == self.lz.shape[0] // 2 == self.lx.shape[0] // 2
        )
        if not dims_ok:
            valid = False
            print(" -Block dimensions incorrect")
        elif show_tests:
            print(" -Block dimensions: Pass")

        def symplectic_zero(a_x, a_z, b_x, b_z) -> bool:
            prod = (a_x @ b_z.T + a_z @ b_x.T).toarray()
            return not np.any(prod % 2)

        report(
            symplectic_zero(self.hx, self.hz, self.hx, self.hz),
            "PCMs commute hx@hz.T + hz@hx.T == 0",
        )
        report(
            symplectic_zero(self.hx, self.hz, self.lx, self.lz),
            "lx and lz in centralizer of stabilizers",
        )

        pairing = gf2.to_dense(
            (self.lx @ self.lz.T + self.lz @ self.lx.T).toarray() % 2
        )
        report(
            gf2.rank(pairing) == self.l.shape[0],
            "lx and lz anticommute",
        )

        if show_tests and valid:
            print(
                f"{self.name} is a valid stabilizer code w/ params"
                f" {self.code_params}"
            )
        return valid

    @property
    def code_params(self) -> str:
        return f"[[{self.N},{self.K},{self.D}]]"
