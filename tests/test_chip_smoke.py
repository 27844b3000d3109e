"""``chip_smoke.py`` off the card: it refuses to run without a GPU, and
its corpus gate accepts agreement and rejects what it must."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from bp_osd_tpu.codes import hgp, rep_code

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_LOG_COMPILES="1")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout  # no result line
    assert "Compiling" not in proc.stderr  # stopped before any work
    assert "needs a GPU" in proc.stderr


def _pair():
    H = np.asarray(hgp(rep_code(3), rep_code(3)).hx.toarray(), np.uint8)
    rng = np.random.default_rng(3)
    osdw = (rng.random((40, H.shape[1])) < 0.1).astype(np.uint8)
    synd = (osdw @ H.T % 2).astype(np.uint8)
    iters = rng.integers(1, 400, 40).astype(np.int32)
    conv = iters < 300
    iters[~conv] = 400
    ref = {"osdw": osdw, "converged": conv, "iterations": iters}
    got = {k: v.copy() for k, v in ref.items()}
    return H, synd, ref, got


@pytest.mark.parametrize("case", ["agree", "shallow_mismatch",
                                  "syndrome_violation"])
def test_parity_gate(case):
    H, synd, ref, got = _pair()
    if case == "agree":
        # a deep row may part ways: still within the gate
        deep = int(np.flatnonzero(ref["iterations"] > 64)[0])
        got["iterations"][deep] += 1
        assert chip_smoke.parity_gate(ref, got, H, synd) == 1 - 1 / 40
        return
    if case == "shallow_mismatch":
        row = int(np.flatnonzero(ref["iterations"] <= 64)[0])
        got["iterations"][row] += 1
        match = "shallow"
    else:
        got["osdw"][5, 0] ^= 1
        match = "syndromes"
    with pytest.raises(chip_smoke.GateError, match=match):
        chip_smoke.parity_gate(ref, got, H, synd)
