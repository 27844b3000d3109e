"""Headline qLDPC decode experiment (counterpart of reference
``examples/qldpc_decode_example.py:5-23``): the [[400,16,6]] symmetric
hypergraph product of the 12x16 MKMN seed code, decoded under a Z-biased
channel at p = 0.05 with adaptive min-sum BP and osd_cs order 42.

The batched harness decodes thousands of syndromes per dispatch; bump
``target_runs``/``batch_size`` to taste.

Run from the repo root with ``python examples/qldpc_decode_example.py``;
the bootstrap below makes the package importable, and the results land in
``qldpc_decode_results.json`` in the working directory.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bp_osd_tpu.codes import hgp, mkmn_16_4_6
from bp_osd_tpu.runtime import enable_compile_cache
from bp_osd_tpu.sim import css_decode_sim

enable_compile_cache()

qcode = hgp(mkmn_16_4_6())  # symmetric hypergraph product of the seed code

osd_options = {
    "error_rate": 0.05,
    "target_runs": 10000,
    "xyz_error_bias": [0, 0, 1],
    "output_file": "qldpc_decode_results.json",
    "bp_method": "ms",
    "ms_scaling_factor": 0,
    "osd_method": "osd_cs",
    "osd_order": 42,
    "channel_update": None,
    "seed": 42,
    "max_iter": 0,
    "batch_size": 2000,
}

sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz, **osd_options)
