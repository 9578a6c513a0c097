"""The port's sharded attention on a model axis wider than the heads:
the tiny granite-8b (4 query heads over 2 KV heads) and starcoder2-7b (3
over 1) on a (1, 4) ("data", "model") mesh, held to the JAX package at
the same mesh.

A projection's flat output is sharded 4 ways on "model"; split into 2 or
3 heads it cannot stay so, and DTensor refuses the reshape
(``sharding.split_last`` lays it out first, as XLA reshards around the
reference's reshape). JAX runs once for the file (one
``run_multidevice`` subprocess, four fake devices), the port once (one
spawn of four gloo ranks, ``torch_dist_util.shard_heads``), from JAX's
init: the forward's logits, the loss and every leaf's gradient, and a
prefill then a decode step against a cache sharded on its sequence.
Bars: the reference's distributed ones (``tests/test_distribution.py``):
2e-4 for logits and the loss, rtol 2e-3 / atol 2e-4 for gradients.
About 40 s on one process.
"""
import numpy as np
import pytest

from conftest import run_multidevice
from torch_dist_util import flatten, run_ranks

ARCHS = ("granite-8b", "starcoder2-7b")
B, S, MAX_LEN, PROMPT = 4, 16, 32, 8

JAX_CODE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_tiny_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.sharding import ShardingRules, tree_shardings
def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, prefix + k + "/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}
B, S, MAX_LEN, PROMPT = (int(a) for a in sys.argv[2:6])
mesh = make_mesh((1, 4), ("data", "model"))
rules = ShardingRules.for_mesh(mesh)
out = {"max_len": np.asarray(MAX_LEN)}
rng = np.random.default_rng(0)
for arch in ("granite-8b", "starcoder2-7b"):
    cfg = get_tiny_config(arch)
    model = build_model(cfg, rules, remat=False)
    params = build_model(cfg, remat=False).init(jax.random.PRNGKey(0))
    out.update(flat(params, arch + "/params/"))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for k, v in (("batch/tokens", tokens), ("batch/labels", labels),
                 ("prompt", prompt), ("next", nxt)):
        out[arch + "/" + k] = v
    with compat.set_mesh(mesh):
        p_sh = tree_shardings(rules, model.param_logical_axes(),
                              jax.eval_shape(model.init, jax.random.PRNGKey(0)))
        sp = jax.device_put(params, p_sh)
        bsh = NamedSharding(mesh, P(rules.batch_axes))
        batch = jax.device_put({"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(labels)}, bsh)
        out[arch + "/logits"] = np.asarray(jax.jit(model.logits)(sp, batch))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(sp, batch)
        out[arch + "/loss"] = np.asarray(loss)
        out.update(flat(grads, arch + "/grads/"))
        cache = model.init_cache(B, MAX_LEN, jnp.float32)
        c_sh = tree_shardings(rules, model.cache_logical_axes(),
                              jax.eval_shape(lambda: cache))
        cache = jax.device_put(cache, c_sh)
        logits, cache = jax.jit(model.prefill)(
            sp, {"tokens": jax.device_put(jnp.asarray(prompt), bsh)}, cache)
        out[arch + "/prefill"] = np.asarray(logits)
        logits, cache = jax.jit(model.decode_step)(
            sp, jax.device_put(jnp.asarray(nxt), bsh), cache)
        out[arch + "/decode"] = np.asarray(logits)
        out[arch + "/cache_k"] = np.asarray(cache["k"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("heads")
    path = d / "jax.npz"
    run_multidevice(f"import sys; sys.argv = ['x', {str(path)!r}, '{B}', "
                    f"'{S}', '{MAX_LEN}', '{PROMPT}']\n" + JAX_CODE,
                    n_devices=4, timeout=900)
    want = dict(np.load(path))
    inp = {k: v.astype(np.int64) if v.dtype == np.int32 else v
           for k, v in want.items() if "/params/" in k or k == "max_len"
           or k.split("/", 1)[-1] in ("batch/tokens", "batch/labels",
                                      "prompt", "next")}
    return want, run_ranks(["shard_heads"], inp)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(results, arch):
    want, ranks = results
    for r in ranks:
        got = r["shard_heads"][arch]
        np.testing.assert_allclose(got["logits"], want[f"{arch}/logits"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["loss"], want[f"{arch}/loss"],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_matches_jax(results, arch):
    want, ranks = results
    for r in ranks:
        got = flatten(r["shard_heads"][arch]["grads"])
        keys = {k[len(arch) + 7:] for k in want
                if k.startswith(f"{arch}/grads/")}
        assert set(got) == keys
        for k, g in got.items():
            np.testing.assert_allclose(g, want[f"{arch}/grads/{k}"],
                                       rtol=2e-3, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(results, arch):
    """The cache is sharded on its sequence over "model" (32 positions on
    4 ranks); each rank writes its own positions in place."""
    want, ranks = results
    for r in ranks:
        got = r["shard_heads"][arch]
        assert got["cache_k_placements"] == ["Replicate", "Shard(2)"]
        for k in ("prefill", "decode", "cache_k"):
            np.testing.assert_allclose(got[k], want[f"{arch}/{k}"],
                                       rtol=2e-4, atol=2e-4, err_msg=k)
