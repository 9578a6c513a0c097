"""Packing and serving of the port's MoE family on the CPU, held to the JAX
package at the tiny qwen3-moe config (8 experts, top-2), with JAX's random
init carried into the port and the same calibration tokens on both sides.

Bars: pack → save → load with stacked (L, E) leaves; prefill logits of a
packed checkpoint within 2e-5 of JAX's (``tests/test_packed_serving.py``);
greedy tokens identical to JAX's static decode and JAX's slot engine; the
paged engine's tokens the slot engine's; the CLIs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.checkpoint import load_packed_checkpoint as jload_packed
from repro.checkpoint import save_packed_checkpoint as jsave_packed
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationRequest as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (load_packed_checkpoint, pack_params,
                                    save_packed_checkpoint)
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model, get_linear
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.quant import QTensor
from repro_torch.serving import Engine, EngineConfig, GenerationRequest

ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny model: more gain it
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4)
    jcal = [{"tokens": jnp.asarray(t)}
            for t, _ in jcalibration_batches(JDataConfig(**dc), 1)]
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 1)]
    return dict(cfg=cfg, model=model, params=params, cal=cal, jmodel=jmodel,
                jparams=jparams, jcal=jcal)


# ---------------------------------------------------------------------------
# packing, checkpoints and serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_ckpt(tiny, tmp_path_factory):
    """JAX compresses (int4 everywhere, group 16, as
    ``tests/test_packed_serving.py``) and saves a packed checkpoint; both
    packages load it."""
    pol = jspecs.Policy({"*": jspecs.QuantSpec(bits=4, group_size=16)})
    jcp, jrep = jcompress_model(tiny["jmodel"], tiny["jparams"],
                                tiny["jcal"], pol)
    path = jsave_packed(str(tmp_path_factory.mktemp("moe_ck")), 0, jcp, jrep)
    jloaded, _, _ = jload_packed(path, tiny["jparams"])
    loaded, _, _ = load_packed_checkpoint(path, tiny["params"], device="cpu")
    return dict(jcp=jcp, jloaded=jloaded, loaded=loaded)


def test_port_pack_save_load_keeps_stacked_expert_leaves(tiny, tmp_path):
    cfg = tiny["cfg"]
    pol = specs.Policy({"*": specs.QuantSpec(bits=4, group_size=16)})
    cp, report = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                                pol)
    packed = pack_params(cp, report)
    path = save_packed_checkpoint(str(tmp_path), 0, cp, report)
    loaded, qts, _ = load_packed_checkpoint(path, tiny["params"],
                                            device="cpu")
    assert len(qts) == 2 * (4 + 3 * cfg.num_experts)
    for name in ("wg", "wu", "wd"):
        a, b = packed["blocks"]["moe"][name], loaded["blocks"]["moe"][name]
        assert isinstance(a, QTensor) and isinstance(b, QTensor)
        assert a.packed.shape[:2] == (cfg.num_layers, cfg.num_experts)
        for f in ("packed", "scale", "zero"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        # every expert's codes dequantize to the weight compression wrote
        assert torch.equal(
            a.map(lambda t: t[1, 3]).dequant(),
            get_linear(cp, ("blocks", "moe", name, 3), 1))
    toks = {"tokens": tiny["cal"][0]["tokens"][:, :8]}
    cache = lambda: tiny["model"].init_cache(4, 10, device="cpu")  # noqa: E731
    want, _ = tiny["model"].prefill(cp, toks, cache())
    got, _ = tiny["model"].prefill(loaded, toks, cache())
    assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_packed_prefill_logits_match_jax(tiny, packed_ckpt):
    jloaded, loaded = packed_ckpt["jloaded"], packed_ckpt["loaded"]
    wu = loaded["blocks"]["moe"]["wu"]
    assert isinstance(wu, QTensor)
    np.testing.assert_array_equal(
        wu.packed.numpy(), np.asarray(jloaded["blocks"]["moe"]["wu"].packed))
    toks = tiny["jcal"][0]["tokens"][:, :8]
    b = toks.shape[0]
    want, _ = jax.jit(tiny["jmodel"].prefill)(
        jloaded, {"tokens": toks}, tiny["jmodel"].init_cache(b, 10,
                                                             jnp.float32))
    got, _ = tiny["model"].prefill(
        loaded, {"tokens": torch.from_numpy(np.array(toks))},
        tiny["model"].init_cache(b, 10, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


TRACE = dict(lens=[5, 13, 8, 21, 3, 16], gens=[6, 3, 9, 4, 8, 5])
ENGINE = dict(num_slots=2, max_len=48, prompt_buckets=(8, 16))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in TRACE["lens"]]


def test_packed_greedy_tokens_match_jax_static_and_engine(tiny, packed_ckpt):
    """The packed model (JAX's checkpoint): the port's static greedy decode
    and its slot engine (INT8 cache off, a prompt of 21 tokens chunked
    through buckets of 8 and 16, slot reuse) give JAX's static tokens and
    JAX's engine tokens, request for request."""
    jloaded, loaded = packed_ckpt["jloaded"], packed_ckpt["loaded"]
    prompts = _prompts(tiny["cfg"].vocab_size)
    jeng = JEngine(tiny["jmodel"], jloaded, JEngineConfig(**ENGINE))
    for i, (p, g) in enumerate(zip(prompts, TRACE["gens"])):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=g))
    jtok = {r.rid: r.tokens for r in jeng.run()}
    eng = Engine(tiny["model"], loaded, EngineConfig(**ENGINE))
    reqs = [GenerationRequest(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, TRACE["gens"]))]
    for r in reqs:
        eng.submit(r)
    got = {r.rid: r for r in eng.run()}
    assert all(r.status == "ok" for r in got.values())
    assert {rid: r.tokens for rid, r in got.items()} == jtok
    assert eng.chunk_dispatches > 0
    for req in reqs[:3]:
        assert serve.static_greedy_reference(tiny["model"], loaded, req, 48) \
            == jserve.static_greedy_reference(tiny["jmodel"], jloaded, req,
                                              48) == jtok[req.rid]


def test_paged_engine_serves_moe(tiny, packed_ckpt):
    """The paged layout needs nothing of its own for an MoE model: its
    tokens are the slot engine's on the same trace."""
    loaded = packed_ckpt["loaded"]
    prompts = _prompts(tiny["cfg"].vocab_size)
    out = {}
    for layout in ("slots", "paged"):
        extra = dict(kv_layout="paged", page_size=8) if layout == "paged" \
            else {}
        eng = Engine(tiny["model"], loaded, EngineConfig(**ENGINE, **extra))
        for i, (p, g) in enumerate(zip(prompts, TRACE["gens"])):
            eng.submit(GenerationRequest(rid=i, prompt=p, max_new_tokens=g))
        out[layout] = {r.rid: r.tokens for r in eng.run()}
    assert out["paged"] == out["slots"]


def test_moe_clis_on_cpu(tmp_path):
    """compress then serve qwen3-moe's tiny config from the CLIs."""
    from repro_torch.launch import compress as compress_cli
    out = str(tmp_path / "ck")
    _, report = compress_cli.main(
        ["--arch", ARCH, "--tiny", "--device", "cpu", "--calib-batches", "1",
         "--seq", "16", "--method", "awp_quant", "--bits", "4",
         "--group-size", "32", "--out", out, "--save-packed"])
    assert len(report.packed_layers()) == 2 * (4 + 3 * 8)
    seqs = serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--ckpt",
                       out, "--packed", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"])
    assert seqs.shape == (2, 4)
    results = serve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                          "--engine", "continuous", "--ckpt", out,
                          "--packed", "--requests", "4", "--slots", "2",
                          "--gen", "4", "--prompt-len", "16", "--buckets",
                          "8,16", "--kv-quant"])
    assert len(results) == 4 and all(r.ok for r in results)
