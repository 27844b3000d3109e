"""The one decode path on every platform, the removed ``backend`` option,
and the compile-cache helper (``bp_osd_tpu.runtime``)."""

import os

import jax
import numpy as np
import pytest

from bp_osd_tpu import BpOsdDecoder, runtime
from bp_osd_tpu.codes import hgp, rep_code
from bp_osd_tpu.sim import css_decode_sim

RNG = np.random.default_rng(41)


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def surface():
    return hgp(rep_code(3), rep_code(3))


def _no_pallas(jaxpr) -> bool:
    return "pallas_call" not in str(jaxpr)


@pytest.mark.parametrize("entry", ["decoder", "sim"])
def test_fake_gpu_takes_xla_path(monkeypatch, surface, entry):
    """With the platform reported as "gpu", the entry points trace the
    plain XLA program (no Pallas call, so nothing in interpret mode) and
    take the accelerator dispatch defaults."""
    H = surface.hz.toarray()
    if entry == "decoder":
        kw = dict(error_rate=0.08, max_iter=13, bp_method="ms",
                  ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=4)
        B = 4100  # one dispatch at the GPU chunk, two at the CPU chunk
        synds = ((RNG.random((B, H.shape[1])) < 0.1) @ H.T % 2).astype(
            np.uint8)
        ref = BpOsdDecoder(H, **kw)
        ref_out = ref.decode_batch(synds).copy()

        monkeypatch.setattr(jax, "devices", lambda *a, **k: [_FakeGpu()])
        dec = BpOsdDecoder(H, **kw)
        chunks = []
        orig = dec._bposd_fn

        def spy(batch):
            chunks.append(batch)
            return orig(batch)

        dec._bposd_fn = spy
        out = dec.decode_batch(synds)
        assert chunks == [B]
        assert np.array_equal(out, ref_out)
        llr0 = dec._llr0()
        jaxpr = jax.make_jaxpr(orig(B))(dec.graph, dec._osd_graph,
                                        synds[:8], llr0, dec._osd_consts)
    else:
        monkeypatch.setattr(jax, "devices", lambda *a, **k: [_FakeGpu()])
        sim = css_decode_sim(
            hx=surface.hx, hz=surface.hz, error_rate=0.05,
            target_runs=20000, osd_method="osd_cs", osd_order=2,
            max_iter=6, tqdm_disable=1, run_sim=0, seed=3,
        )
        assert sim.batch_size == 16384
        assert sim.use_mesh == 0  # one (fake) device
        keys = jax.random.split(jax.random.PRNGKey(0), 8)
        jaxpr = jax.make_jaxpr(sim._batch_jit)(keys, sim._sim_consts)
    assert _no_pallas(jaxpr)


@pytest.mark.parametrize("entry", ["decoder", "sim"])
def test_pallas_backend_rejected(surface, entry):
    """A caller still asking for the removed kernels gets an error, not
    another path."""
    with pytest.raises(ValueError, match="removed"):
        if entry == "decoder":
            BpOsdDecoder(surface.hz, error_rate=0.05, backend="pallas")
        else:
            css_decode_sim(hx=surface.hx, hz=surface.hz, error_rate=0.05,
                           backend="pallas", run_sim=0, tqdm_disable=1)


@pytest.fixture
def restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, restore_cache_config,
                           env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache lives at a fixed path inside the checkout."""
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = runtime.enable_compile_cache()
        checkout = os.path.dirname(os.path.dirname(runtime.__file__))
        assert path == runtime.DEFAULT_CACHE_DIR
        assert path == os.path.join(checkout, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert runtime.enable_compile_cache() == path  # fixed, not per run
