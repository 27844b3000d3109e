"""Classical binary code generators.

Framework replacement for ``ldpc.codes`` as consumed by the reference
(``rep_code`` at reference ``tests/test_hgp.py:10``, ``hamming_code`` at
reference ``tests/test_css.py:9``).  These are tiny host-side constructors;
they feed the hypergraph-product construction and the test-suite.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["rep_code", "ring_code", "hamming_code", "mkmn_16_4_6", "mkmn_20_5_8", "mkmn_24_6_10"]


def rep_code(distance: int) -> sp.csr_matrix:
    """Parity-check matrix of the length-``distance`` repetition code.

    ``(distance-1) x distance`` chain: row i checks bits i and i+1.
    """
    if distance < 2:
        raise ValueError("repetition code requires distance >= 2")
    m = distance - 1
    rows = np.repeat(np.arange(m), 2)
    cols = np.empty(2 * m, dtype=np.int64)
    cols[0::2] = np.arange(m)
    cols[1::2] = np.arange(m) + 1
    data = np.ones(2 * m, dtype=np.uint8)
    return sp.csr_matrix((data, (rows, cols)), shape=(m, distance), dtype=np.uint8)


def ring_code(distance: int) -> sp.csr_matrix:
    """Closed-loop (cyclic) repetition code: ``distance x distance`` circulant."""
    if distance < 2:
        raise ValueError("ring code requires distance >= 2")
    n = distance
    rows = np.repeat(np.arange(n), 2)
    cols = np.empty(2 * n, dtype=np.int64)
    cols[0::2] = np.arange(n)
    cols[1::2] = (np.arange(n) + 1) % n
    data = np.ones(2 * n, dtype=np.uint8)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, n), dtype=np.uint8)


def hamming_code(rank: int) -> sp.csr_matrix:
    """[2^rank - 1, 2^rank - 1 - rank, 3] Hamming code parity-check matrix.

    Column j is the ``rank``-bit binary expansion of j+1, most significant bit
    in row 0 — the layout whose rank-3 instance appears verbatim in the
    reference README (reference ``README.md:65-74``).
    """
    if rank < 2:
        raise ValueError("hamming code requires rank >= 2")
    n = (1 << rank) - 1
    j = np.arange(1, n + 1)
    i = np.arange(rank).reshape(-1, 1)
    H = ((j >> (rank - 1 - i)) & 1).astype(np.uint8)
    return sp.csr_matrix(H, dtype=np.uint8)


# The (3,4)-regular [16,4,6] MacKay-Neal style seed matrix shipped with the
# reference as ``examples/codes/classical_seed_codes/mkmn_16_4_6.txt`` — the
# seed of the flagship [[400,16,6]] hypergraph-product benchmark code
# (reference ``examples/qldpc_decode_example.py:5``).  Stored as data so the
# benchmark is self-contained.
_MKMN_16_4_6_ROWS = (
    0b0000000000110011,
    0b0001000011000100,
    0b0010000001011000,
    0b1000001100100000,
    0b0000100110000010,
    0b0111000100000000,
    0b1010000010000001,
    0b0001010000101000,
    0b1000100000001100,
    0b0000111000010000,
    0b0100010001000010,
    0b0100001000000101,
)


def mkmn_16_4_6() -> sp.csr_matrix:
    """The 12x16 MKMN seed code of the [[400,16,6]] benchmark HGP code."""
    return _rows_to_csr(_MKMN_16_4_6_ROWS, 16)


# Seeds of the larger benchmark HGP codes the reference ships logicals for
# ([[625,25,8]] and [[900,36,10]]; reference
# ``examples/codes/classical_seed_codes/mkmn_{20_5_8,24_6_10}.txt``).
_MKMN_20_5_8_ROWS = (
    0b10100000000000011000,
    0b10000100000001000010,
    0b00011000001000100000,
    0b00010010000001000100,
    0b01000000101100000000,
    0b00001100010000010000,
    0b00100001001010000000,
    0b00000001000000001110,
    0b00000101000100100000,
    0b00010000110010000000,
    0b01000000000010101000,
    0b10000010100000000001,
    0b01000000000001010001,
    0b00001000000100000101,
    0b00100010010000000010,
)

_MKMN_24_6_10_ROWS = (
    0b000001001100000000000010,
    0b010000001000000011000000,
    0b100010000000000100001000,
    0b100000000010100000000100,
    0b000010010000101000000000,
    0b010000100000000100100000,
    0b000000010000000010000011,
    0b000000000111000000100000,
    0b100001000000010000000001,
    0b011000010000000000010000,
    0b000000000000100001010010,
    0b000000100100000010001000,
    0b001100000000010100000000,
    0b000110000000000000010001,
    0b000000000000010001100100,
    0b001001000010001000000000,
    0b000000101001000000000100,
    0b000100000001001000001000,
)


def mkmn_20_5_8() -> sp.csr_matrix:
    """The 15x20 MKMN seed of the [[625,25,8]] benchmark HGP code."""
    return _rows_to_csr(_MKMN_20_5_8_ROWS, 20)


def mkmn_24_6_10() -> sp.csr_matrix:
    """The 18x24 MKMN seed of the [[900,36,10]] benchmark HGP code."""
    return _rows_to_csr(_MKMN_24_6_10_ROWS, 24)


def _rows_to_csr(rows, width: int) -> sp.csr_matrix:
    H = np.array(
        [[(r >> c) & 1 for c in range(width)] for r in rows], dtype=np.uint8
    )
    return sp.csr_matrix(H, dtype=np.uint8)
