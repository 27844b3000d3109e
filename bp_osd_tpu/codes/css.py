"""CSS (Calderbank-Shor-Steane) quantum code construction and validation.

Framework counterpart of the reference ``css_code`` class (reference
``src/bposd/css.py:8-191``).  Public surface kept drop-in compatible:
``hx hz lx lz N K D L Q``, ``compute_dimension``, ``compute_logicals``,
``compute_code_distance``, ``to_stab_code``, ``h``/``l`` block properties,
``code_params`` and the five-check ``test()`` validator.  Construction is
host-side NumPy/scipy (offline, tiny); the decoder consumes ``hx``/``hz``
through the Tanner-graph compiler in ``bp_osd_tpu.decoder``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import gf2

__all__ = ["css_code"]


def _as_csr(M) -> sp.csr_matrix:
    if sp.issparse(M):
        return M.tocsr().astype(np.uint8)
    return sp.csr_matrix(np.asarray(M), dtype=np.uint8)


class css_code:
    """A CSS stabilizer code defined by X/Z parity-check matrices.

    The code dimension is ``K = N - rank(hx) - rank(hz)`` (reference
    ``css.py:50``) and the logical operators come from the kernel-minus-image
    pivot construction (reference ``css.py:76-88``): a basis of
    ``ker(hx) \\ im(hz^T)`` is read off the pivot rows of the stacked matrix
    ``[hz; ker(hx)]`` past ``rank(hz)``.
    """

    def __init__(
        self,
        hx=np.array([[]]),
        hz=np.array([[]]),
        code_distance=np.nan,
        name: str = "<Unnamed CSS code>",
    ):
        self.hx = _as_csr(hx)
        self.hz = _as_csr(hz)

        self.lx = sp.csr_matrix((0, 0), dtype=np.uint8)
        self.lz = sp.csr_matrix((0, 0), dtype=np.uint8)

        self.N = np.nan
        self.K = np.nan
        self.D = code_distance
        self.L = np.nan  # max column weight
        self.Q = np.nan  # max row weight

        nx = self.hx.shape[1]
        nz = self.hz.shape[1]
        if nx != nz:
            raise ValueError(
                "hx and hz matrices must have equal numbers of columns!"
            )

        if nx != 0:
            self.compute_dimension()
            self.compute_logicals()
            self.compute_column_row_weights()

        self.name = name

    # -- derived quantities -------------------------------------------------

    def compute_dimension(self) -> int:
        self.N = int(self.hx.shape[1])
        if self.N != self.hz.shape[1]:
            raise ValueError("Code block length (N) inconsistent!")
        self.K = self.N - gf2.rank(self.hx) - gf2.rank(self.hz)
        return self.K

    def compute_column_row_weights(self):
        """L = max qubit (column) weight, Q = max stabilizer (row) weight."""
        h = self.h
        if h.nnz:
            self.L = int(np.max(h.sum(axis=0)))
            self.Q = int(np.max(h.sum(axis=1)))
        return self.L, self.Q

    def compute_logicals(self):
        """Compute lx/lz logical operator bases.

        ``lz in ker(hx)`` but not in ``im(hz^T)`` and vice versa, using the
        pivot-row selection on the stack ``[h_other; ker(h)]``.
        """

        def logical_basis(h_ker_of, h_image_of) -> sp.csr_matrix:
            ker = gf2.nullspace(h_ker_of)
            stack = sp.vstack([_as_csr(h_image_of), ker]).tocsr()
            r_im = gf2.rank(h_image_of)
            pivots = gf2.pivot_rows(stack)[r_im:]
            return stack[pivots].tocsr().astype(np.uint8)

        if isinstance(self.K, float) and np.isnan(self.K):
            self.compute_dimension()
        self.lx = logical_basis(self.hz, self.hx)
        self.lz = logical_basis(self.hx, self.hz)
        return self.lx, self.lz

    def compute_code_distance(self):
        """Exact distance via the symplectic stabilizer form (exponential)."""
        temp = self.to_stab_code()
        self.D = temp.compute_code_distance()
        return self.D

    # -- representation conversions ----------------------------------------

    def to_stab_code(self):
        from .stab import stab_code

        zeros_x = sp.csr_matrix(self.hz.shape, dtype=np.uint8)
        zeros_z = sp.csr_matrix(self.hx.shape, dtype=np.uint8)
        hx = sp.vstack([zeros_x, self.hx])
        hz = sp.vstack([self.hz, zeros_z])
        return stab_code(hx, hz)

    @property
    def h(self) -> sp.csr_matrix:
        """Full symplectic check matrix ``[hx | hz]`` in block form."""
        zeros_x = sp.csr_matrix(self.hz.shape, dtype=np.uint8)
        zeros_z = sp.csr_matrix(self.hx.shape, dtype=np.uint8)
        hx = sp.vstack([zeros_x, self.hx])
        hz = sp.vstack([self.hz, zeros_z])
        return sp.hstack([hx, hz]).tocsr()

    @property
    def l(self) -> sp.csr_matrix:
        """Full symplectic logical matrix ``[lx | lz]`` in block form."""
        zeros_x = sp.csr_matrix(self.lz.shape, dtype=np.uint8)
        zeros_z = sp.csr_matrix(self.lx.shape, dtype=np.uint8)
        lx = sp.vstack([zeros_x, self.lx])
        lz = sp.vstack([self.lz, zeros_z])
        return sp.hstack([lx, lz]).tocsr()

    @property
    def code_params(self) -> str:
        return f"({self.L},{self.Q})-[[{self.N},{self.K},{self.D}]]"

    # -- validation ---------------------------------------------------------

    def test(self, show_tests: bool = True) -> bool:
        """Five-check CSS validity test (reference ``css.py:122-191``):

        block dimensions; hz@hx.T == 0; hx@hz.T == 0; logicals in the
        stabilizer kernels; lx/lz anticommutation of full rank K.
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
            and self.K == self.lz.shape[0] == self.lx.shape[0]
        )
        if not dims_ok:
            valid = False
            print(" -Block dimensions incorrect")
        elif show_tests:
            print(" -Block dimensions: Pass")

        def commutes(a, b) -> bool:
            prod = (a @ b.T).toarray() if sp.issparse(a) else a @ b.T
            return not np.any(np.asarray(prod) % 2)

        report(commutes(self.hz, self.hx), "PCMs commute hz@hx.T==0")
        report(commutes(self.hx, self.hz), "PCMs commute hx@hz.T==0")
        report(
            commutes(self.hz, self.lx) and commutes(self.hx, self.lz),
            "lx \\in ker{hz} AND lz \\in ker{hx}",
        )

        try:
            lx_lz = gf2.to_dense((self.lx @ self.lz.T).toarray() % 2)
            anti_ok = (
                self.lx.shape[0] == self.K and gf2.rank(lx_lz) == self.K
            )
        except Exception:
            anti_ok = False
        report(anti_ok, "lx and lz anticommute")

        if show_tests and valid:
            print(
                f" -{self.name} is a valid CSS code w/ params"
                f" [{self.N},{self.K},{self.D}]"
            )

        return valid

    def canonical_logicals(self):
        """Re-basis the logicals so that ``lx @ lz.T == I (mod 2)``.

        (Exists in older reference API, called at reference
        ``examples/codes/hgp_codes/generate_codes.py:11``.)
        """
        pairing = gf2.to_dense((self.lx @ self.lz.T).toarray() % 2)
        inv = gf2.inverse(pairing)
        new_lx = gf2.to_dense((inv @ self.lx.toarray()) % 2)
        self.lx = sp.csr_matrix(new_lx, dtype=np.uint8)
        return self.lx, self.lz
