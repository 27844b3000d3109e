"""Smoke test on the GPU: the decoder's main path, at full width, checked.

Drives the entry points a user calls — ``BpOsdDecoder`` and
``css_decode_sim`` — on one card at the widths of the reference's headline
workload, and checks what comes out against the repo's own references:

1. flagship: ``BpOsdDecoder`` on the [[400,16,6]] MKMN hypergraph product
   (reference ``examples/qldpc_decode_example.py``), ``decode_batch`` on
   16,384 seeded syndromes, then one ``decode()`` of the README golden;
2. parity: the CPU-made corpus ``tests/data/flagship_corpus.npz`` re-decoded
   on the GPU under the bench gate's shape, OSD on identical LLRs on the
   GPU and the CPU, and one-hot against gather BP routing (no TF32);
3. sim: ``css_decode_sim`` with the committed ``qldpc_decode_results.json``
   config, its OSDW LER within 3 combined standard errors of the file's;
4. large code: ``BpOsdDecoder`` with ``proto``/``lift`` on the [[10000,420]]
   lifted product at p = 0.005, B = 128, then at an OSD-heavy p = 0.028.

``--four`` runs only what exists across cards, on four of them: the
sharded sim against the one-card sim, ``sharded_decode_fn`` against the
unsharded decode, and ``lifted_sharded_bposd_fn`` on a (1, 4) mesh against
the unsharded lifted decode.

Usage, from the repo root::

    python chip_smoke.py          # one card, phases 1-4
    python chip_smoke.py --four   # four cards, the sharded paths only

The last line of standard output is ``{"ok": true, "device": {...}}`` when
every phase passed; the line before it is the card's name and power limit
from ``nvidia-smi``.  Without a GPU, or when a phase fails, the script
exits non-zero and prints no result line.  Everything runs in this one
process, so it holds the card alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 20261016
FLAGSHIP_B = 16384  # the device default decode_batch chunk
SHALLOW_ITERS = 64  # trajectories this short must match bit for bit
MIN_AGREEMENT = 0.9  # fraction of corpus rows decoded identically
# one-hot vs gather routing after 4 BP iterations: both at float32, so they
# differ only in summation order (~1e-7 relative).  TF32 would round each
# routed message to a 10-bit mantissa, ~5e-4 relative.
LLR_RTOL = 1e-5
LER_SIGMAS = 3.0
LIFTED_PROTO = [  # the (3,4)-regular protograph of bench_large.py
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]
LIFT = 400
LARGE_B = 128
LARGE_HEAVY_P = 0.028  # bench_large.py's OSD-heavy point
LARGE_HEAVY_B = 32
MESH_B = 4096
SIM_CONFIG_KEYS = (
    "error_rate", "target_runs", "xyz_error_bias", "bp_method",
    "ms_scaling_factor", "osd_method", "osd_order", "channel_update",
    "seed", "max_iter", "batch_size",
)


class GateError(AssertionError):
    """A check of what the decoder produced failed."""


def parity_gate(ref, got, H, synd, *, shallow_iters=SHALLOW_ITERS,
                min_agreement=MIN_AGREEMENT) -> float:
    """Compare two decodes of the same syndromes; return row agreement.

    ``ref`` and ``got`` map ``osdw`` [B, n], ``converged`` [B] and
    ``iterations`` [B].  BP is a chaotic map: two float32 implementations
    that sum in different orders can part ways on deep trajectories.  So
    the gate pins what is structurally guaranteed: a row that stops within
    ``shallow_iters`` iterations on either side has the same convergence
    and iteration count on both; every ``got`` decoding satisfies its
    syndrome; and at least ``min_agreement`` of the rows agree entirely
    (convergence, iterations and decoding).
    """
    rc, gc = np.asarray(ref["converged"]), np.asarray(got["converged"])
    ri, gi = np.asarray(ref["iterations"]), np.asarray(got["iterations"])
    ro, go = np.asarray(ref["osdw"]), np.asarray(got["osdw"])
    shallow = (ri <= shallow_iters) | (gi <= shallow_iters)
    if not (np.array_equal(rc[shallow], gc[shallow])
            and np.array_equal(ri[shallow], gi[shallow])):
        bad = np.flatnonzero(shallow & ((rc != gc) | (ri != gi)))
        raise GateError(f"shallow-trajectory rows differ: {bad[:8].tolist()}")
    viol = np.flatnonzero((_mod2_mul(go, H) != synd).any(axis=1))
    if viol.size:
        raise GateError(f"decodings violate their syndromes: "
                        f"{viol[:8].tolist()}")
    agree = float(((rc == gc) & (ri == gi) & (ro == go).all(axis=1)).mean())
    if agree < min_agreement:
        raise GateError(f"row agreement {agree:.4f} < {min_agreement}")
    return agree


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _mod2_mul(rows, H):
    """``rows @ H.T mod 2`` through BLAS: float32 sums of 0/1 terms are
    exact below 2^24."""
    prod = np.asarray(rows, np.float32) @ np.asarray(H, np.float32).T
    return (prod % 2).astype(np.uint8)


def _syndromes(H, p, B, seed):
    rng = np.random.default_rng(seed)
    return _mod2_mul(rng.random((B, H.shape[1])) < p, H)


def _check_syndromes(osdw, H, synd, what):
    bad = int((_mod2_mul(osdw, H) != synd).any(axis=1).sum())
    if bad:
        raise GateError(f"{what}: {bad} decodings violate their syndromes")


def _flagship_decoder():
    from bp_osd_tpu import BpOsdDecoder
    from bp_osd_tpu.codes import hgp, mkmn_16_4_6

    qcode = hgp(mkmn_16_4_6())
    dec = BpOsdDecoder(qcode.hx, error_rate=0.05, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs",
                       osd_order=42)
    return qcode, dec


def phase_flagship(ctx):
    from bp_osd_tpu import bposd_decoder
    from bp_osd_tpu.codes import hgp, rep_code

    qcode, dec = _flagship_decoder()
    ctx["flagship"] = (qcode, dec)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    synd = _syndromes(H, 0.05, FLAGSHIP_B, SEED)
    t0 = time.perf_counter()
    osdw = dec.decode_batch(synd)
    t_first = time.perf_counter() - t0
    _check_syndromes(osdw, H, synd, "flagship decode_batch")
    synd2 = _syndromes(H, 0.05, FLAGSHIP_B, SEED + 1)
    t0 = time.perf_counter()
    osdw2 = dec.decode_batch(synd2)
    t_warm = time.perf_counter() - t0
    _check_syndromes(osdw2, H, synd2, "flagship decode_batch (warm)")
    conv = float(np.mean(dec.converge_batch))

    surface = hgp(rep_code(3), rep_code(3))
    bpd = bposd_decoder(surface.hz, error_rate=0.05, channel_probs=[None],
                        max_iter=surface.N, bp_method="ms",
                        ms_scaling_factor=0, osd_method="osd_cs",
                        osd_order=7)
    error = np.zeros(surface.N, dtype=int)
    error[[5, 12]] = 1
    bpd.decode(surface.hz @ error % 2)
    expected = np.zeros(surface.N, np.uint8)
    expected[8] = 1
    if not np.array_equal(bpd.osdw_decoding, expected):
        raise GateError(f"README golden: got {bpd.osdw_decoding.tolist()}")
    return (f"{FLAGSHIP_B} syndromes, all satisfied; BP converged "
            f"{conv:.4f}; first call {t_first:.2f} s (compile included), "
            f"warm call {t_warm:.3f} s = {FLAGSHIP_B / t_warm:.0f} synd/s "
            f"({ctx['card']}, host clock, information only); README "
            f"golden decode() flips qubit 8")


def phase_parity(ctx):
    import jax

    from bp_osd_tpu.decoder import TannerGraph, bp_decode, llr_from_channel
    from bp_osd_tpu.decoder.osd import osd_decode

    qcode, dec = ctx.get("flagship") or _flagship_decoder()
    data = np.load(os.path.join(REPO, "tests", "data", "flagship_corpus.npz"))
    B, m, n, max_iter, osd_order, _ = (int(v) for v in data["meta"])
    if (m, n, max_iter, osd_order) != (dec.m, dec.n, dec.max_iter,
                                       dec.osd_order):
        raise GateError("corpus config does not match the flagship decoder")
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :m]
    ref = {"osdw": np.unpackbits(data["osdw_packed"], axis=1)[:, :n],
           "converged": data["converged"], "iterations": data["iterations"]}
    H = np.asarray(qcode.hx.toarray(), np.uint8)

    dec.decode_batch(synd)
    got = {"osdw": dec.osdw_decoding_batch, "converged": dec.converge_batch,
           "iterations": dec.iter_batch}
    agree = parity_gate(ref, got, H, synd)

    # OSD is integer work after the reliability sort, so identical LLRs
    # must give identical bits on both devices: no tolerance
    llr = np.asarray(dec.log_prob_ratios_batch)
    osd_fn = jax.jit(lambda g, s, l, c: osd_decode(
        g, s, l, osd_method="osd_cs", osd_order=osd_order, consts=c))
    args = (dec._osd_graph, synd, llr, dec._osd_consts)
    gpu = osd_fn(*args)
    cpu = osd_fn(*jax.device_put(args, jax.devices("cpu")[0]))
    for name in ("osd0", "osdw"):
        if not np.array_equal(np.asarray(getattr(gpu, name)),
                              np.asarray(getattr(cpu, name))):
            raise GateError(f"{name} differs between GPU and CPU on "
                            f"identical LLRs")

    graph = TannerGraph(H)
    if graph.edge_var_onehot is None:
        raise GateError("flagship graph lost its one-hot routing operator")
    gather = TannerGraph(H)
    gather.edge_var_onehot = None
    synd_b = _syndromes(H, 0.05, 512, SEED + 2)
    llr0 = llr_from_channel(np.full(n, 0.05))
    bp_fn = jax.jit(lambda g, s, l: bp_decode(
        g, s, l, bp_method="minimum_sum", max_iter=4,
        ms_scaling_factor=0.0))
    a, b = bp_fn(graph, synd_b, llr0), bp_fn(gather, synd_b, llr0)
    for name in ("hard", "converged", "iterations"):
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))):
            raise GateError(f"one-hot vs gather BP: {name} differs")
    la, lb = np.asarray(a.llr), np.asarray(b.llr)
    rel = float(np.max(np.abs(la - lb) / np.maximum(np.abs(lb), 1.0)))
    if rel > LLR_RTOL:
        raise GateError(f"one-hot vs gather BP llr differ by {rel:.2e} "
                        f"relative > {LLR_RTOL} (TF32 routing?)")
    return (f"corpus {B} rows: shallow rows bit-equal, all syndromes "
            f"satisfied, row agreement {agree:.4f}; OSD GPU == CPU on "
            f"identical LLRs; one-hot vs gather BP (B=512, 4 it) llr "
            f"max rel diff {rel:.2e}")


def _committed_sim():
    with open(os.path.join(REPO, "qldpc_decode_results.json")) as f:
        return json.load(f)


def _run_sim(ref, use_mesh, **over):
    from bp_osd_tpu.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu.sim import css_decode_sim

    qcode = hgp(mkmn_16_4_6())
    cfg = {k: ref[k] for k in SIM_CONFIG_KEYS}
    cfg.update(over)
    return css_decode_sim(hx=qcode.hx, hz=qcode.hz, use_mesh=use_mesh,
                          tqdm_disable=1, output_file=None, **cfg)


def phase_sim(ctx):
    ref = _committed_sim()
    t0 = time.perf_counter()
    sim = _run_sim(ref, use_mesh=0)
    dt = time.perf_counter() - t0
    ler, eb = sim.osdw_logical_error_rate, sim.osdw_logical_error_rate_eb
    ler_ref = ref["osdw_logical_error_rate"]
    eb_ref = ref["osdw_logical_error_rate_eb"]
    bound = LER_SIGMAS * float(np.hypot(eb, eb_ref))
    print(f"sim output: {json.dumps(json.loads(sim.output_dict()))}",
          flush=True)
    if sim.run_count != ref["target_runs"]:
        raise GateError(f"sim ran {sim.run_count} of {ref['target_runs']}")
    if abs(ler - ler_ref) > bound:
        raise GateError(f"OSDW LER {ler:.4f} vs committed {ler_ref:.4f}: "
                        f"|diff| > {bound:.4f} ({LER_SIGMAS:g} sigma)")
    return (f"{sim.run_count} runs, OSDW LER {ler:.4f} +- {eb:.4f} vs "
            f"committed {ler_ref:.4f} +- {eb_ref:.4f} (within {bound:.4f}); "
            f"wall {dt:.1f} s incl. compile ({ctx['card']})")


def _lifted_code():
    from bp_osd_tpu.codes import lifted_hgp

    qcode = lifted_hgp(LIFTED_PROTO, lift=LIFT)
    return qcode, np.asarray(qcode.hx.toarray(), np.uint8)


def phase_large(ctx):
    from bp_osd_tpu import BpOsdDecoder

    qcode, H = _lifted_code()
    dec = BpOsdDecoder(qcode.hx, error_rate=0.005, max_iter=100,
                       bp_method="ms", osd_method="osd_cs", osd_order=15,
                       proto=qcode.hx_proto, lift=LIFT)
    synd = _syndromes(H, 0.005, LARGE_B, SEED + 3)
    osdw = dec.decode_batch(synd)
    _check_syndromes(osdw, H, synd, "lifted decode_batch")
    synd2 = _syndromes(H, 0.005, LARGE_B, SEED + 4)
    t0 = time.perf_counter()
    osdw2 = dec.decode_batch(synd2)
    dt = time.perf_counter() - t0
    _check_syndromes(osdw2, H, synd2, "lifted decode_batch (warm)")
    conv = float(np.mean(dec.converge_batch))
    # at p = 0.005 BP usually converges on every row; an OSD-heavy point
    # makes the batch-dense elimination run at n = 10^4
    dec.update_channel_probs(np.full(H.shape[1], LARGE_HEAVY_P))
    synd3 = _syndromes(H, LARGE_HEAVY_P, LARGE_HEAVY_B, SEED + 5)
    t0 = time.perf_counter()
    osdw3 = dec.decode_batch(synd3)
    dt3 = time.perf_counter() - t0
    _check_syndromes(osdw3, H, synd3, "lifted decode_batch (OSD-heavy)")
    n_osd = int(np.sum(~np.asarray(dec.converge_batch)))
    if not n_osd:
        raise GateError("OSD-heavy point: BP converged on every row")
    return (f"[[{H.shape[1]},{qcode.K}]] B={LARGE_B} at p=0.005: all "
            f"syndromes satisfied, BP converged {conv:.4f}, warm call "
            f"{dt:.3f} s; p={LARGE_HEAVY_P} B={LARGE_HEAVY_B}: {n_osd} rows "
            f"through OSD, all satisfied, {dt3:.2f} s incl. compile "
            f"({ctx['card']}, host clock, information only)")


def phase_four_sim(ctx):
    ref = _committed_sim()
    over = dict(target_runs=4 * ref["batch_size"])
    one = _run_sim(ref, use_mesh=0, **over)
    four = _run_sim(ref, use_mesh=1, **over)
    keys = ("run_count", "osdw_success_count", "osd0_success_count",
            "bp_success_count", "bp_converge_count_x",
            "bp_converge_count_z", "min_logical_weight")
    a = {k: int(getattr(one, k)) for k in keys}
    b = {k: int(getattr(four, k)) for k in keys}
    if a != b:
        raise GateError(f"sharded sim counters differ: one card {a}, "
                        f"four cards {b}")
    return f"use_mesh=1 on 4 cards == use_mesh=0 on one card: {b}"


def phase_four_mesh(ctx):
    import jax

    from bp_osd_tpu.decoder import bp_decode, llr_from_channel, osd_decode
    from bp_osd_tpu.parallel import make_mesh, sharded_decode_fn

    qcode, dec = _flagship_decoder()
    graph = dec._osd_graph
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    B = MESH_B
    synd = _syndromes(H, 0.05, B, SEED + 5)
    llr0 = np.broadcast_to(np.asarray(llr_from_channel(np.full(H.shape[1],
                                                                0.05))),
                           (B, H.shape[1])).copy()
    kw = dict(bp_method="ms", max_iter=dec.max_iter, ms_scaling_factor=0.0)
    okw = dict(osd_method="osd_cs", osd_order=42)
    sharded = sharded_decode_fn(graph, make_mesh(4), **kw, **okw)
    osdw, _, _, conv = sharded(synd, llr0)

    def plain(g, s, l, c):
        bp = bp_decode(g, s, l, **kw)
        o = osd_decode(g, s, bp.llr, consts=c, **okw)
        return (jax.numpy.where(bp.converged[:, None], bp.hard, o.osdw),
                bp.converged, bp.iterations)

    r_osdw, r_conv, r_iters = jax.jit(plain)(graph, synd, llr0,
                                             dec._osd_consts)
    if len(osdw.sharding.device_set) != 4:
        raise GateError("sharded decode did not span 4 cards")
    osdw, conv = np.asarray(osdw), np.asarray(conv)
    r_osdw, r_conv = np.asarray(r_osdw), np.asarray(r_conv)
    _check_syndromes(osdw, H, synd, "sharded_decode_fn")
    same = float(((osdw == r_osdw).all(axis=1) & (conv == r_conv)).mean())
    if not np.array_equal(conv, r_conv) or same != 1.0:
        raise GateError(f"sharded vs unsharded: convergence equal "
                        f"{np.array_equal(conv, r_conv)}, row agreement "
                        f"{same:.4f}")
    return f"sharded_decode_fn on 4 cards == unsharded, B={B}"


def phase_four_lifted(ctx):
    import jax
    from jax.sharding import Mesh

    from bp_osd_tpu import BpOsdDecoder
    from bp_osd_tpu.decoder import llr_from_channel
    from bp_osd_tpu.decoder.lifted_bp import LiftedGraph
    from bp_osd_tpu.parallel.large_code import lifted_sharded_bposd_fn

    qcode, H = _lifted_code()
    m, n = H.shape
    lg = LiftedGraph(qcode.hx_proto, LIFT)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4),
                ("data", "model"))
    kw = dict(bp_method="minimum_sum", max_iter=100, ms_scaling_factor=0.625,
              osd_method="osd_cs", osd_order=15)
    decode = lifted_sharded_bposd_fn(lg, H, mesh, n_shards=4, **kw)
    B = LARGE_B
    synd = _syndromes(H, 0.005, B, SEED + 6)
    mpc = -(-lg.mp // 4)
    synd_pad = np.pad(synd, ((0, 0), (0, 4 * mpc * LIFT - m)))
    llr0 = np.broadcast_to(np.asarray(llr_from_channel(np.full(n, 0.005))),
                           (B, n)).copy()
    osdw, conv = decode(synd_pad, llr0)
    osdw, conv = np.asarray(osdw), np.asarray(conv)

    dec = BpOsdDecoder(qcode.hx, error_rate=0.005, proto=qcode.hx_proto,
                       lift=LIFT, **kw)
    ref = dec.decode_batch(synd)
    # the equality standard of tests/test_lifted_shard.py: convergence and
    # converged rows exact; an OSD row may differ only where a psum-order
    # llr delta flips a reliability near-tie, and then with equal weight
    if not np.array_equal(conv, dec.converge_batch):
        raise GateError("sharded lifted BP convergence differs")
    if not np.array_equal(osdw[conv], ref[conv]):
        raise GateError("sharded lifted BP decodings differ")
    _check_syndromes(osdw, H, synd, "lifted_sharded_bposd_fn")
    differ = ~(osdw == ref).all(axis=1)
    if not np.array_equal(osdw[differ].sum(1), ref[differ].sum(1)):
        raise GateError("sharded lifted OSD rows differ in weight")
    return (f"lifted_sharded_bposd_fn on a (1, 4) mesh == unsharded, B={B}, "
            f"{int((~conv).sum())} OSD rows, {int(differ.sum())} of them "
            f"differ with equal weight")


PHASES = [("flagship", phase_flagship), ("parity", phase_parity),
          ("sim", phase_sim), ("large", phase_large)]
FOUR_PHASES = [("four_sim", phase_four_sim), ("four_mesh", phase_four_mesh),
               ("four_lifted", phase_four_lifted)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded paths, on four cards")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from bp_osd_tpu.runtime import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    card = card_line()
    print(f"card: {card}")
    print(f"jax: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    ctx = {"card": card}
    failed = []
    for name, fn in FOUR_PHASES if args.four else PHASES:
        t0 = time.perf_counter()
        try:
            detail = fn(ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAIL after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        stats = dev.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0) / 2**30
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
              f"(peak device memory {peak:.1f} GiB): {detail}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
