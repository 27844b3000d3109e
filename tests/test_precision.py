"""BP routing matmuls run at float32 HIGHEST precision.

At the default precision a GPU contracts float32 operands in TF32, which
rounds every BP message to a 10-bit mantissa and silently changes decode
semantics.  The CPU computes float32 either way, so results cannot show
this here; the traced programs can.  Every float32 ``dot_general`` in the
BP of ``decoder/bp.py``, ``decoder/layered.py`` and
``parallel/lifted_shard.py`` must ask for HIGHEST on both operands.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from bp_osd_tpu.codes import hgp, lifted_hgp, rep_code
from bp_osd_tpu.decoder import LayeredTannerGraph, TannerGraph, bp_decode
from bp_osd_tpu.decoder import bp_decode_layered, llr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph
from bp_osd_tpu.parallel.lifted_shard import (ShardedLiftedGraph,
                                              lifted_sharded_bp_fn)

HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and all(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _f32_dots(sub)


def _trace(kind, bp_method):
    kw = dict(bp_method=bp_method, max_iter=4, ms_scaling_factor=0.625)
    if kind == "lifted_shard":
        proto = [[(0,), (0,), (0,)], [(0,), (1,), (2,)]]
        qcode = lifted_hgp(proto, lift=8)
        lg = LiftedGraph(qcode.hx_proto, 8)
        sg = ShardedLiftedGraph(lg, n_shards=2)
        mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                    ("data", "model"))
        decode = lifted_sharded_bp_fn(sg, mesh, **kw)
        B = 4
        synd = np.zeros((B, sg.n_shards * sg.mp_chunk * 8), np.uint8)
        llr0 = np.zeros((B, lg.n), np.float32)
        return jax.make_jaxpr(decode)(synd, llr0)
    H = hgp(rep_code(3), rep_code(3)).hz.toarray()
    if kind == "bp":
        graph, fn = TannerGraph(H), bp_decode
        assert graph.edge_var_onehot is not None  # the matmul routing
    else:
        graph, fn = LayeredTannerGraph(H), bp_decode_layered
    synd = np.zeros((4, graph.m), np.uint8)
    llr0 = llr_from_channel(np.full(graph.n, 0.05))
    return jax.make_jaxpr(lambda g, s, l: fn(g, s, l, **kw))(graph, synd,
                                                             llr0)


@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
@pytest.mark.parametrize("kind", ["bp", "layered", "lifted_shard"])
def test_bp_routing_matmuls_are_highest_precision(kind, bp_method):
    dots = list(_f32_dots(_trace(kind, bp_method).jaxpr))
    assert dots, f"{kind}: no float32 routing matmul traced"
    for eqn in dots:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), (
            f"{kind}: float32 dot_general at precision "
            f"{eqn.params['precision']}")


def test_adaptive_alpha_is_exact():
    """The variable scale ``1 - 2^-t`` is built exactly (``jnp.exp2``
    lowers to ``exp(x ln 2)``, which is not), for every iteration count a
    decode can reach, inside and outside jit."""
    from bp_osd_tpu.decoder.bp import adaptive_alpha

    its = np.arange(1, 1001, dtype=np.int32)
    want = (1.0 - np.ldexp(1.0, -np.minimum(its, 126))).astype(np.float32)
    got = np.asarray(jax.jit(jax.vmap(adaptive_alpha))(its))
    np.testing.assert_array_equal(got, want)
    assert float(adaptive_alpha(3)) == 0.875
