"""OSDW logical-error-rate artifacts for the larger reference HGP codes.

The reference ships lx/lz for the [[625,25,8]] and [[900,36,10]]
hypergraph-product codes (reference ``examples/codes/hgp_codes/``; hx/hz
blobs stripped, regenerable from the embedded MKMN seeds — reference
``examples/codes/hgp_codes/generate_codes.py:6-20``).  This script runs
the same Monte-Carlo workload as ``qldpc_decode_example.py`` (p = 0.05,
Z-biased, adaptive min-sum, osd_cs order 42, max_iter = 0 -> N) on both
codes and writes ``hgp_625_decode_results.json`` /
``hgp_900_decode_results.json`` next to the flagship artifact.

Run on a GPU from the repo root:
``python examples/large_hgp_ler.py [runs] [625|900|both]``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bp_osd_tpu.codes import hgp, mkmn_20_5_8, mkmn_24_6_10
    from bp_osd_tpu.runtime import enable_compile_cache
    from bp_osd_tpu.sim import css_decode_sim

    enable_compile_cache()

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    which = sys.argv[2] if len(sys.argv) > 2 else "both"
    here = os.path.dirname(os.path.abspath(__file__))

    codes = [("625", mkmn_20_5_8), ("900", mkmn_24_6_10)]
    if which != "both":
        codes = [c for c in codes if c[0] == which]
    for name, seed_fn in codes:
        qcode = hgp(seed_fn())
        print(f"--- [[{qcode.N},{qcode.K}]] (hgp of mkmn seed {name}) ---",
              flush=True)
        css_decode_sim(
            hx=qcode.hx, hz=qcode.hz,
            error_rate=0.05,
            target_runs=runs,
            xyz_error_bias=[0, 0, 1],
            output_file=os.path.join(here, f"hgp_{name}_decode_results.json"),
            bp_method="ms",
            ms_scaling_factor=0,
            osd_method="osd_cs",
            osd_order=42,
            channel_update=None,
            seed=42,
            max_iter=0,
            batch_size=2000,
        )


if __name__ == "__main__":
    main()
