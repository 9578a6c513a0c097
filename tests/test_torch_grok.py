"""grok-1-314b in the port, held to the JAX package on the CPU at its tiny
preset (4 experts, top-2, silu-gated), with JAX's random init carried
into the port and the same calibration tokens on both sides (one batch of
4 x 24): the configs field for field, compression with both engines,
packing, and the static decode. Its training is in
``tests/test_torch_train_families*.py``.

Bars (``tests/test_torch_moe_compress.py``'s and
``tests/test_torch_moe_serve.py``'s): per-layer loss within 1e-5 of JAX's
batched engine, masks and codes equal on at least 99.9% of entries,
equal iteration counts; prefill logits of JAX's packed checkpoint within
2e-5; greedy tokens equal to JAX's static decode. About 40 s on one
process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.checkpoint import load_packed_checkpoint as jload_packed
from repro.checkpoint import save_packed_checkpoint as jsave_packed
from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (load_packed_checkpoint, pack_params,
                                    save_packed_checkpoint)
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import serve
from repro_torch.models import MoEModel, build_model
from repro_torch.quant import QTensor
from repro_torch.serving import GenerationRequest

ARCH = "grok-1-314b"
# chip_smoke.py's main path at the tiny widths' group: every wo AWP-pruned
# to 50%, every other linear AWP-int4
def POLICY(m):
    return m.Policy({"*.attn.wo": m.PruneSpec(ratio=0.5)},
                    default=m.QuantSpec(bits=4, group_size=32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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
    jcp, jrep = jcompress_model(jmodel, jparams, jcal, POLICY(jspecs),
                                engine="batched")
    return dict(cfg=cfg, model=model, params=params, cal=cal, jmodel=jmodel,
                jparams=jparams, jcal=jcal, jcp=jcp, jrep=jrep)


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_config_matches_jax(which):
    get, jget = ((get_config, jget_config) if which == "full"
                 else (get_tiny_config, jget_tiny))
    ours, theirs = get(ARCH), jget(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert ARCH in list_archs()
    assert isinstance(build_model(ours), MoEModel)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_engines_match_jax(tiny, engine):
    jrep = tiny["jrep"]
    cp, rep = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                             POLICY(specs), engine=engine)
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    assert len(rep) == 2 * (4 + 3 * tiny["cfg"].num_experts)
    for r, jr in zip(rep, jrep):
        assert abs(r.loss_after - jr.loss_after) <= 1e-5, r.qualname
        art, jart = rep.artifacts[r.qualname], jrep.artifacts[r.qualname]
        assert art.result.iters == jart.result.iters, r.qualname
        if jart.result.mask is not None:
            agree = (art.result.mask == np.asarray(jart.result.mask)).mean()
            assert agree >= 0.999, (r.qualname, agree)
        if jart.result.qtensor is not None:
            agree = (art.result.qtensor.codes().numpy()
                     == np.asarray(jart.result.qtensor.codes())).mean()
            assert agree >= 0.999, (r.qualname, agree)


def test_packed_prefill_and_greedy_tokens_match_jax(tiny, tmp_path):
    """JAX's compression saved packed and read by both packages: the
    stacked (L, E) expert leaves, the prefill logits, and the static
    greedy tokens; the port's own packed model decodes the same tokens
    as its dense compressed params."""
    path = jsave_packed(str(tmp_path / "j"), 0, tiny["jcp"], tiny["jrep"])
    jloaded, _, _ = jload_packed(path, tiny["jparams"])
    loaded, _, _ = load_packed_checkpoint(path, tiny["params"], device="cpu")
    for name in ("wg", "wu", "wd"):
        qt = loaded["blocks"]["moe"][name]
        assert isinstance(qt, QTensor)
        assert qt.packed.shape[:2] == (2, tiny["cfg"].num_experts)
        np.testing.assert_array_equal(
            qt.packed.numpy(),
            np.asarray(jloaded["blocks"]["moe"][name].packed))
    toks = tiny["jcal"][0]["tokens"][:, :8]
    b = toks.shape[0]
    want, _ = jax.jit(tiny["jmodel"].prefill)(
        jloaded, {"tokens": toks},
        tiny["jmodel"].init_cache(b, 10, jnp.float32))
    got, _ = tiny["model"].prefill(
        loaded, {"tokens": torch.from_numpy(np.array(toks))},
        tiny["model"].init_cache(b, 10, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    rng = np.random.default_rng(0)
    cp, rep = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                             POLICY(specs))
    mine = pack_params(cp, rep)
    ppath = save_packed_checkpoint(str(tmp_path / "p"), 0, cp, rep)
    reread, _, _ = load_packed_checkpoint(ppath, tiny["params"],
                                          device="cpu")
    for i, (n, g) in enumerate(((5, 6), (13, 4), (21, 5))):
        req = GenerationRequest(
            rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
            max_new_tokens=g)
        jtok = jserve.static_greedy_reference(tiny["jmodel"], jloaded, req, 32)
        assert serve.static_greedy_reference(tiny["model"], loaded, req,
                                             32) == jtok
        dense = serve.static_greedy_reference(tiny["model"], cp, req, 32)
        assert serve.static_greedy_reference(tiny["model"], mine, req,
                                             32) == dense
        assert serve.static_greedy_reference(tiny["model"], reread, req,
                                             32) == dense
