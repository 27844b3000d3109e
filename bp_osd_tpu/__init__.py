"""bp_osd_tpu — a batched BP+OSD quantum LDPC decoding framework for GPUs.

A from-scratch JAX/XLA re-design of the capability surface of
``quantumgizmos/bp_osd``: CSS / stabilizer / hypergraph-product code
construction, GF(2) linear algebra, batched belief-propagation decoding
(product-sum and min-sum), OSD post-processing (osd0 / osd_e / osd_cs) and
a Monte-Carlo logical-error-rate simulation harness — treating syndrome
decoding as a batched sparse message-passing signal chain sharded over a
device mesh rather than a one-syndrome-at-a-time native object.

Drop-in import surface (reference ``src/bposd/__init__.py:1`` re-exports
``bposd_decoder`` from ``ldpc``):

    from bp_osd_tpu import bposd_decoder, BpOsdDecoder
    from bp_osd_tpu.codes import css_code, stab_code, hgp
"""

from . import gf2
from .codes import css_code, gf2_to_gf4, hgp, hgp_single, stab_code
from .decoder import BpDecoder, BpOsdDecoder, bposd_decoder, bp_decoder

__version__ = "0.1.0"

import os as _os


def get_include() -> str:
    """Path of the installed package (reference ``__init__.py:6-8``)."""
    return _os.path.dirname(__file__)


__all__ = [
    "gf2",
    "css_code",
    "stab_code",
    "gf2_to_gf4",
    "hgp",
    "hgp_single",
    "BpOsdDecoder",
    "bposd_decoder",
    "BpDecoder",
    "bp_decoder",
    "get_include",
    "__version__",
]
