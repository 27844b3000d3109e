"""Tanner-graph compiler: host-side layout of a GF(2) PCM for batched decoding.

The reference's native decoder walks CSR adjacency lists one syndrome at a
time (interface at reference ``README.md:190-197``).  Here the graph is
compiled ONCE into fixed-shape, padded index arrays so that a whole syndrome
batch is decoded by dense, jit-compiled gathers/reductions:

- ``chk_var [m, wr]``: variable ids incident to each check, padded with the
  sentinel ``n`` (points at a zero pad column of any per-variable array).
- ``var_edge [n, wc]``: flat edge slots (``check * wr + slot``) incident to
  each variable, padded with sentinel ``m * wr``.
- ``H_packed [m, ceil(n/32)] uint32``: row-packed PCM for the OSD
  elimination kernel.

Check-message updates are reductions along the last axis of ``[B, m, wr]``;
variable updates are gathers of ``[B, m*wr]`` through ``var_edge`` — no
data-dependent shapes anywhere, so XLA compiles one fixed-shape program.
"""

from __future__ import annotations

import jax
import numpy as np

from .. import gf2

__all__ = ["TannerGraph"]


@jax.tree_util.register_pytree_node_class
class TannerGraph:
    """Static decode-time layout of a parity-check matrix.

    Registered as a JAX pytree so a graph can be passed *as an argument*
    through ``jax.jit`` — its index arrays then become program parameters
    rather than HLO-embedded literal constants, which keeps large graphs
    out of the compiled program and lets one compilation serve any graph
    of the same shape.
    """

    def __init__(self, H):
        Hd = gf2.to_dense(H)
        m, n = Hd.shape
        if m == 0 or n == 0:
            raise ValueError("parity check matrix must be non-empty")
        self.H = Hd
        self.m = m
        self.n = n

        rows, cols = np.nonzero(Hd)  # row-major: sorted by (row, col)
        self.num_edges = int(rows.size)

        row_counts = np.bincount(rows, minlength=m)
        col_counts = np.bincount(cols, minlength=n)
        self.wr = int(row_counts.max()) if rows.size else 1
        self.wc = int(col_counts.max()) if cols.size else 1

        # check-major edge slots: edge k of row i sits at flat id i*wr + k
        slot = np.concatenate([np.arange(c) for c in row_counts]) if rows.size else np.zeros(0, int)
        chk_var = np.full((m, self.wr), n, dtype=np.int32)
        chk_var[rows, slot] = cols
        self.chk_var = chk_var
        self.chk_mask = chk_var != n
        edge_flat = rows * self.wr + slot

        # variable-major view: flat edge ids grouped per column, check order
        order = np.lexsort((rows, cols))
        vslot = np.concatenate([np.arange(c) for c in col_counts]) if cols.size else np.zeros(0, int)
        var_edge = np.full((n, self.wc), m * self.wr, dtype=np.int32)
        var_edge[cols[order], vslot] = edge_flat[order]
        self.var_edge = var_edge
        self.var_mask = var_edge != m * self.wr

        # row-packed PCM (uint32 words) for the OSD elimination kernel
        packed64, _ = gf2.pack_rows(Hd)
        W32 = -(-n // 32)
        by = np.ascontiguousarray(packed64).view(np.uint32)
        self.H_packed = np.ascontiguousarray(by[:, :W32])
        self.num_words = W32

        # GF(2) rank is column-permutation invariant, so the OSD elimination
        # always finds exactly `rank` pivots regardless of the per-sample
        # reliability ordering — this is what makes every OSD shape static.
        self.rank = gf2.rank(Hd)

        # one-hot edge<->variable operator [m*wr, n]: turns BP's gathers and
        # segment-sums into matmuls.  Pad slots are all-zero rows, so garbage
        # in pad message slots never propagates.  Only built for graphs small
        # enough that the dense operator is cheap; larger graphs take the
        # gather path.  Which routing is faster on the GPU is not yet
        # measured.
        E_flat = m * self.wr
        if E_flat * n <= 8_000_000:
            M = np.zeros((E_flat, n), dtype=np.float32)
            M[edge_flat, cols] = 1.0
            self.edge_var_onehot = M
        else:
            self.edge_var_onehot = None

    def __repr__(self) -> str:
        return (
            f"TannerGraph(m={self.m}, n={self.n}, edges={self.num_edges}, "
            f"wr={self.wr}, wc={self.wc}, rank={self.rank})"
        )

    # -- pytree protocol ----------------------------------------------------

    _LEAF_FIELDS = (
        "chk_var",
        "chk_mask",
        "var_edge",
        "var_mask",
        "H_packed",
        "edge_var_onehot",
    )
    _AUX_FIELDS = ("m", "n", "wr", "wc", "num_words", "rank", "num_edges")

    def tree_flatten(self):
        leaves = tuple(getattr(self, f) for f in self._LEAF_FIELDS)
        aux = tuple(getattr(self, f) for f in self._AUX_FIELDS)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        for f, v in zip(cls._AUX_FIELDS, aux):
            setattr(obj, f, v)
        for f, v in zip(cls._LEAF_FIELDS, leaves):
            setattr(obj, f, v)
        obj.H = None  # dense host matrix not carried through traces
        return obj
