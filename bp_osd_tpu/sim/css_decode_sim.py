"""Monte-Carlo BP+OSD decoding simulation for CSS codes.

Batched re-design of the reference harness (reference
``src/bposd/css_decode_sim.py:11-567``).  Same experiment, same config dict,
same JSON output format — but the hot loop is *batched*: instead of one
error/decode per iteration (reference ``css_decode_sim.py:519-520``) the
harness jit-compiles a single function that samples a whole batch of biased
X/Y/Z errors, computes both syndromes, runs the two-stage X<->Z decode with
the Bayes channel update (reference ``css_decode_sim.py:207-248``), checks
logicals and reduces the statistics — one compiled program per batch,
thousands of syndromes per dispatch, shardable over a device mesh.

Config keys match the reference defaults (reference
``css_decode_sim.py:64-91``); the only additions are ``batch_size`` (decode
batch per dispatch) and ``devices`` for data-parallel sharding.
"""

from __future__ import annotations

import datetime
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..codes.css import css_code
from ..decoder.bp import llr_from_channel
from ..decoder.tanner import TannerGraph
from ..runtime import check_backend, sim_batch_cap

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

__all__ = ["css_decode_sim"]

_DEFAULT_INPUT = {
    "error_rate": None,
    "xyz_error_bias": [1, 1, 1],
    "target_runs": 100,
    "seed": 0,
    "bp_method": "minimum_sum",
    "ms_scaling_factor": 0.625,
    "max_iter": 0,
    "osd_method": "osd_cs",
    "osd_order": 2,
    "save_interval": 2,
    "output_file": None,
    "check_code": 1,
    "tqdm_disable": 0,
    "run_sim": 1,
    "channel_update": "x->z",
    "hadamard_rotate": 0,
    "hadamard_rotate_sector1_length": 0,
    "error_bar_precision_cutoff": 1e-3,
    "batch_size": 0,  # 0 -> auto (new: decode batch per dispatch)
    "use_mesh": -1,  # -1 auto: shard batch over all devices when >1 (new)
}

_OUTPUT_VALUES = {
    "K": None,
    "N": None,
    "start_date": None,
    "runtime": 0.0,
    "runtime_readable": None,
    "run_count": 0,
    "bp_converge_count_x": 0,
    "bp_converge_count_z": 0,
    "bp_success_count": 0,
    "bp_logical_error_rate": 0,
    "bp_logical_error_rate_eb": 0,
    "osd0_success_count": 0,
    "osd0_logical_error_rate": 0.0,
    "osd0_logical_error_rate_eb": 0.0,
    "osdw_success_count": 0,
    "osdw_logical_error_rate": 0.0,
    "osdw_logical_error_rate_eb": 0.0,
    "osdw_word_error_rate": 0.0,
    "osdw_word_error_rate_eb": 0.0,
    "min_logical_weight": 1e9,
}

# attributes never serialized (matrices, channel vectors, internals) —
# reference excludes channel_probs_* / hx / hz (css_decode_sim.py:122-132)
_NON_OUTPUT = {
    "channel_probs_x",
    "channel_probs_z",
    "channel_probs_y",
    "hx",
    "hz",
}


class css_decode_sim:
    """Batched Monte-Carlo logical-error-rate experiment for a CSS code.

    Accepts parameters directly or as a dict (reference docstring contract,
    ``css_decode_sim.py:13-61``); a previously saved output dict resumes the
    run (counters restored, seed re-randomized — reference
    ``css_decode_sim.py:134-138``).
    """

    def __init__(self, hx=None, hz=None, **input_dict):
        # the removed backend option: refused if it asks for the removed
        # Pallas kernels, dropped (not serialized) if it names the XLA path
        check_backend(input_dict.pop("backend", None))
        for key, value in input_dict.items():
            self.__dict__[key] = value
        for key, value in _DEFAULT_INPUT.items():
            if key not in input_dict:
                self.__dict__[key] = value
        for key, value in _OUTPUT_VALUES.items():
            if key not in self.__dict__:
                self.__dict__[key] = value

        self.output_keys = [
            key for key in self.__dict__ if key not in _NON_OUTPUT
        ]

        if self.seed == 0 or self.run_count != 0:
            self.seed = int(np.random.randint(low=1, high=2**32 - 1))
        np.random.seed(self.seed)
        print(f"RNG Seed: {self.seed}")

        self.hx = sp.csr_matrix(hx).astype(np.uint8)
        self.hz = sp.csr_matrix(hz).astype(np.uint8)
        self.N = self.hx.shape[1]
        if self.min_logical_weight == 1e9:
            self.min_logical_weight = int(self.N)

        self._construct_code()
        self._error_channel_setup()
        self._decoder_setup()

        if self.run_sim:
            self.run_decode_sim()

    # -- setup --------------------------------------------------------------

    def _construct_code(self):
        print("Constructing CSS code from hx and hz matrices...")
        qcode = css_code(self.hx, self.hz)
        self.lx = qcode.lx
        self.lz = qcode.lz
        self.K = qcode.K
        self.N = qcode.N
        if self.check_code:
            print("Checking the CSS code is valid...")
            if not qcode.test(show_tests=False):
                raise Exception(
                    "Error: invalid CSS code. Check the form of your hx and "
                    "hz matrices!"
                )

    def _error_channel_setup(self):
        """Biased X/Y/Z channel split + optional Hadamard-rotated sectors
        (reference ``css_decode_sim.py:390-434``)."""
        bias = np.array(self.xyz_error_bias, dtype=np.float64)
        if bias[0] == np.inf:
            self.px, self.py, self.pz = float(self.error_rate), 0.0, 0.0
        elif bias[1] == np.inf:
            self.px, self.py, self.pz = 0.0, float(self.error_rate), 0.0
        elif bias[2] == np.inf:
            self.px, self.py, self.pz = 0.0, 0.0, float(self.error_rate)
        else:
            self.px, self.py, self.pz = (
                float(self.error_rate) * bias / np.sum(bias)
            )

        if self.hadamard_rotate == 0:
            self.channel_probs_x = np.full(self.N, self.px)
            self.channel_probs_z = np.full(self.N, self.pz)
            self.channel_probs_y = np.full(self.N, self.py)
        elif self.hadamard_rotate == 1:
            n1 = int(self.hadamard_rotate_sector1_length)
            self.channel_probs_x = np.hstack(
                [np.full(n1, self.px), np.full(self.N - n1, self.pz)]
            )
            self.channel_probs_z = np.hstack(
                [np.full(n1, self.pz), np.full(self.N - n1, self.px)]
            )
            self.channel_probs_y = np.full(self.N, self.py)
        else:
            raise ValueError(
                f"The hadamard rotate attribute should be set to 0 or 1. "
                f"Not '{self.hadamard_rotate}'"
            )

    def _decoder_setup(self):
        """Compile the batched two-stage decode pipeline."""
        self.ms_scaling_factor = float(self.ms_scaling_factor)
        self._graph_z = TannerGraph(self.hx.toarray())  # Z errors vs hx
        self._graph_x = TannerGraph(self.hz.toarray())  # X errors vs hz

        n_dev = len(jax.devices())
        if self.use_mesh == -1:
            self.use_mesh = 1 if n_dev > 1 else 0
        if self.batch_size == 0:
            # auto: fill a useful dispatch without exhausting memory
            self.batch_size = int(min(max(self.target_runs, 1),
                                      sim_batch_cap(self._graph_z,
                                                    self._graph_x)))
        if self.use_mesh and self.batch_size % n_dev:
            # round up so the batch shards evenly over the mesh
            self.batch_size += n_dev - self.batch_size % n_dev
        self._bp_kwargs = dict(
            bp_method=self.bp_method,
            max_iter=int(self.max_iter),
            ms_scaling_factor=self.ms_scaling_factor,
        )
        self._osd_kwargs = dict(
            osd_method=self.osd_method,
            osd_order=int(self.osd_order),
        )

        # all code matrices / channel vectors / graph layouts travel through
        # jit as ARGUMENTS (see TannerGraph docstring)
        from ..decoder.osd import build_osd_consts

        self._sim_consts = {
            "graph_z": self._graph_z,
            "graph_x": self._graph_x,
            "osd_z": build_osd_consts(self._graph_z, self.osd_method, int(self.osd_order)),
            "osd_x": build_osd_consts(self._graph_x, self.osd_method, int(self.osd_order)),
            "hx": np.asarray(self.hx.toarray(), np.float32),
            "hz": np.asarray(self.hz.toarray(), np.float32),
            "lx": np.asarray(self.lx.toarray(), np.float32),
            "lz": np.asarray(self.lz.toarray(), np.float32),
            "pcx": np.asarray(self.channel_probs_x, np.float32),
            "pcy": np.asarray(self.channel_probs_y, np.float32),
            "pcz": np.asarray(self.channel_probs_z, np.float32),
        }
        bp_kwargs, osd_kwargs = self._bp_kwargs, self._osd_kwargs
        channel_update = self.channel_update
        B = int(self.batch_size)
        N = self.N

        def mod2mul(a, M):
            # 0/1 operands, integer sums < 2^24: exact at default (TF32)
            # precision
            prod = jnp.matmul(
                a.astype(jnp.float32), M.T, preferred_element_type=jnp.float32
            )
            return jnp.mod(prod, 2.0).astype(jnp.int32)

        from ..decoder.pipeline import decode_pipeline

        def decode_side(graph, osd_consts, synd, channel_probs):
            """BP+OSD pipeline; returns (BpOsdBatch, osd0, osdw)."""
            llr0 = llr_from_channel(channel_probs)
            out = decode_pipeline(
                graph, synd, llr0, consts=osd_consts,
                **bp_kwargs, **osd_kwargs,
            )
            return out, out.osd0.astype(jnp.int32), out.osdw.astype(jnp.int32)

        def bayes_update(first_decoding, p_first, p_other, p_y):
            """Posterior channel for the second decoder given the first's
            correction (reference ``css_decode_sim.py:207-248``)."""
            decided = first_decoding == 1
            denom_hit = p_first + p_y
            p_hit = jnp.where(denom_hit > 0, p_y / jnp.maximum(denom_hit, 1e-30), 0.0)
            p_miss = p_other / jnp.maximum(1.0 - p_first - p_y, 1e-30)
            return jnp.where(decided, p_hit, p_miss)

        def batch_fn(keys, consts):
            graph_z, graph_x = consts["graph_z"], consts["graph_x"]
            osd_z, osd_x = consts["osd_z"], consts["osd_x"]
            hx_d, hz_d = consts["hx"], consts["hz"]
            lx_d, lz_d = consts["lx"], consts["lz"]
            pcx, pcy, pcz = consts["pcx"], consts["pcy"], consts["pcz"]
            # per-sample keys keep the batch axis shardable over the mesh
            rand = jax.vmap(lambda k: jax.random.uniform(k, (N,)))(keys)
            band_z = rand < pcz
            band_x = (rand >= pcz) & (rand < pcz + pcx)
            band_y = (rand >= pcz + pcx) & (rand < pcz + pcx + pcy)
            error_z = (band_z | band_y).astype(jnp.int32)
            error_x = (band_x | band_y).astype(jnp.int32)

            synd_z = mod2mul(error_z, hx_d)
            synd_x = mod2mul(error_x, hz_d)

            if channel_update is None:
                bp_z, osd0_z, osdw_z = decode_side(graph_z, osd_z, synd_z, pcz + pcy)
                bp_x, osd0_x, osdw_x = decode_side(graph_x, osd_x, synd_x, pcx + pcy)
            elif channel_update == "z->x":
                bp_z, osd0_z, osdw_z = decode_side(graph_z, osd_z, synd_z, pcz + pcy)
                probs_x = bayes_update(osdw_z, pcz, pcx, pcy)
                bp_x, osd0_x, osdw_x = decode_side(graph_x, osd_x, synd_x, probs_x)
            elif channel_update == "x->z":
                bp_x, osd0_x, osdw_x = decode_side(graph_x, osd_x, synd_x, pcx + pcy)
                probs_z = bayes_update(osdw_x, pcx, pcz, pcy)
                bp_z, osd0_z, osdw_z = decode_side(graph_z, osd_z, synd_z, probs_z)
            else:
                raise ValueError(
                    f"channel_update must be None, 'x->z' or 'z->x', "
                    f"got {channel_update!r}"
                )

            def logical_outcome(corr_x, corr_z):
                """(success, min observed logical weight) per sample.

                Reference semantics (``css_decode_sim.py:255-270``): logical
                X-error checked first; only the failing component's weight
                feeds the min_logical_weight tracker.
                """
                residual_x = (error_x + corr_x) % 2
                residual_z = (error_z + corr_z) % 2
                log_x = jnp.any(mod2mul(residual_x, lz_d) == 1, axis=1)
                log_z = jnp.any(mod2mul(residual_z, lx_d) == 1, axis=1)
                success = ~(log_x | log_z)
                wx = jnp.sum(residual_x, axis=1)
                wz = jnp.sum(residual_z, axis=1)
                weight = jnp.where(
                    log_x, wx, jnp.where(log_z, wz, jnp.int32(10**9))
                )
                return success, weight

            osdw_success, osdw_weight = logical_outcome(osdw_x, osdw_z)
            osd0_success, osd0_weight = logical_outcome(osd0_x, osd0_z)
            bp_both = bp_z.converged & bp_x.converged
            bp_log_success, _ = logical_outcome(
                bp_x.bp_hard.astype(jnp.int32), bp_z.bp_hard.astype(jnp.int32)
            )
            bp_success = bp_both & bp_log_success

            # per-sample outcomes: host counts only the first `take` samples
            # of a partial final batch, keeping statistics exact
            return {
                "osdw_success": osdw_success,
                "osd0_success": osd0_success,
                "bp_success": bp_success,
                "bp_converge_x": bp_x.converged,
                "bp_converge_z": bp_z.converged,
                "logical_weight": jnp.minimum(osdw_weight, osd0_weight),
            }

        # multi-host (jax.distributed): per-sample outputs are sharded
        # across processes and cannot be device_get on any one host, so
        # reduce to fully-replicated scalars INSIDE the jit (integer sums
        # are order-exact, so counters match the single-process run
        # bit-for-bit); the final partial batch cannot be trimmed in this
        # mode, so run_count may overshoot target_runs by < batch_size
        self._multi_host = jax.process_count() > 1
        if self._multi_host and self.use_mesh:
            inner_batch_fn = batch_fn

            def batch_fn(keys, consts):  # noqa: F811
                stats = inner_batch_fn(keys, consts)
                return {
                    k: (jnp.min(v) if k == "logical_weight"
                        else jnp.sum(v.astype(jnp.int32)))
                    for k, v in stats.items()
                }

        if self.use_mesh:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel import make_mesh

            self._mesh = make_mesh()
            batch_shard = NamedSharding(self._mesh, P("data"))
            self._batch_shard = batch_shard
            replicated = jax.tree_util.tree_map(
                lambda _: NamedSharding(self._mesh, P()), self._sim_consts
            )
            self._batch_jit = jax.jit(
                batch_fn, in_shardings=(batch_shard, replicated)
            )
        else:
            self._batch_jit = jax.jit(batch_fn)

        def run_batch(key):
            keys = jax.random.split(key, B)
            if self._multi_host and self.use_mesh:
                # build a GLOBAL array from the host-identical key chain
                # (same seed on every process): each process materializes
                # only its addressable shards; a process-local device
                # array cannot be resharded across hosts
                keys_np = np.asarray(keys)
                keys = jax.make_array_from_callback(
                    keys_np.shape, self._batch_shard,
                    lambda idx: keys_np[idx],
                )
            return self._batch_jit(keys, self._sim_consts)

        self._batch_fn = run_batch

    # -- statistics ---------------------------------------------------------

    def _update_error_rates(self):
        """Logical/word error rates with binomial error bars (reference
        ``css_decode_sim.py:250-365``)."""
        n = max(self.run_count, 1)

        def rates(success_count):
            ler = 1 - success_count / n
            eb = np.sqrt((1 - ler) * ler / n)
            wer = 1.0 - (1 - ler) ** (1 / self.K)
            wer_eb = eb * ((1 - eb) ** (1 / self.K - 1)) / self.K
            return ler, eb, wer, wer_eb

        (
            self.osdw_logical_error_rate,
            self.osdw_logical_error_rate_eb,
            self.osdw_word_error_rate,
            self.osdw_word_error_rate_eb,
        ) = rates(self.osdw_success_count)
        (
            self.osd0_logical_error_rate,
            self.osd0_logical_error_rate_eb,
            self.osd0_word_error_rate,
            self.osd0_word_error_rate_eb,
        ) = rates(self.osd0_success_count)
        (
            self.bp_logical_error_rate,
            self.bp_logical_error_rate_eb,
            self.bp_word_error_rate,
            self.bp_word_error_rate_eb,
        ) = rates(self.bp_success_count)

    # -- main loop ----------------------------------------------------------

    def run_decode_sim(self):
        """Main simulation loop: batched dispatches, periodic JSON
        checkpoints, early stop at the error-bar precision cutoff
        (reference ``css_decode_sim.py:500-555``)."""
        self.start_date = datetime.datetime.fromtimestamp(
            time.time()
        ).strftime("%A, %B %d, %Y %H:%M:%S")

        key = jax.random.PRNGKey(self.seed)
        start_time = time.time()
        save_time = start_time

        pbar = None
        if tqdm is not None and not self.tqdm_disable:
            pbar = tqdm(total=self.target_runs, initial=self.run_count, ncols=0)

        while self.run_count < self.target_runs:
            todo = self.target_runs - self.run_count
            key, sub = jax.random.split(key)
            stats = jax.device_get(self._batch_fn(sub))
            if np.ndim(stats["osdw_success"]) == 0:
                # multi-host mode: pre-reduced scalars over the FULL batch
                take = self.batch_size
            else:
                take = min(self.batch_size, todo)
                stats = {k: v[:take] for k, v in stats.items()}
            self.run_count += take
            self.osdw_success_count += int(np.sum(stats["osdw_success"]))
            self.osd0_success_count += int(np.sum(stats["osd0_success"]))
            self.bp_success_count += int(np.sum(stats["bp_success"]))
            self.bp_converge_count_x += int(np.sum(stats["bp_converge_x"]))
            self.bp_converge_count_z += int(np.sum(stats["bp_converge_z"]))
            batch_min_weight = int(np.min(stats["logical_weight"]))
            if batch_min_weight < self.min_logical_weight:
                self.min_logical_weight = batch_min_weight

            self._update_error_rates()

            if pbar is not None:
                pbar.update(take)
                pbar.set_description(
                    f"d_max: {self.min_logical_weight}; "
                    f"OSDW_WER: {self.osdw_word_error_rate * 100:.3g}±"
                    f"{self.osdw_word_error_rate_eb * 100:.2g}%; "
                    f"OSDW: {self.osdw_logical_error_rate * 100:.3g}±"
                    f"{self.osdw_logical_error_rate_eb * 100:.2g}%; "
                    f"OSD0: {self.osd0_logical_error_rate * 100:.3g}±"
                    f"{self.osd0_logical_error_rate_eb * 100:.2g}%;"
                )

            current_time = time.time()
            save_loop = current_time - save_time
            if int(save_loop) > self.save_interval or self.run_count >= self.target_runs:
                save_time = current_time
                self.runtime = save_loop + self.runtime
                self.runtime_readable = time.strftime(
                    "%H:%M:%S", time.gmtime(self.runtime)
                )
                # multi-host: every process holds identical (globally
                # reduced) counters; only process 0 owns the checkpoint
                if self.output_file is not None and jax.process_index() == 0:
                    with open(self.output_file, "w+") as f:
                        print(self.output_dict(), file=f)
                if (
                    self.osdw_logical_error_rate_eb > 0
                    and self.osdw_logical_error_rate_eb
                    / max(self.osdw_logical_error_rate, 1e-100)
                    < self.error_bar_precision_cutoff
                ):
                    print(
                        "\nTarget error bar precision reached. "
                        "Stopping simulation..."
                    )
                    break

        if pbar is not None:
            pbar.close()
        return self.output_dict()

    def output_dict(self):
        """JSON string of all scalar state (reference file format,
        ``css_decode_sim.py:557-567``)."""
        out = {}
        for key, value in self.__dict__.items():
            if key in self.output_keys:
                if isinstance(value, (np.integer,)):
                    value = int(value)
                elif isinstance(value, (np.floating,)):
                    value = float(value)
                out[key] = value
        return json.dumps(out, sort_keys=True, indent=4)
