"""The slice end to end against the JAX package on the CPU: calibrate,
compress (sequential engine), pack, save/load packed checkpoints in the
shared format, and greedy-decode, on the tiny llama32 config.

Both packages start from the JAX model's random init (carried across by
``repro_torch.bridge``) and the same Zipf-Markov calibration tokens.
Per-layer losses agree to 1e-5 (the bar of ``docs/performance.md``);
masks and codes agree on at least 99.9% of entries per layer — identity is
expected, the slack is only for last-ulp matmul order at near-ties. Greedy
tokens from a packed checkpoint are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_packed_checkpoint as jload_packed
from repro.checkpoint import save_packed_checkpoint as jsave_packed
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.quant import QTensor as JQTensor
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (latest_path, load_packed_checkpoint,
                                    pack_params, save_packed_checkpoint)
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import compress as compress_cli, serve
from repro_torch.models import build_model
from repro_torch.quant import QTensor

ARCH = "llama32-1b"


def _policy(mod):
    """The slice's policy: prune every wo, quantize the other six linears."""
    return mod.Policy({"*.attn.wo": mod.PruneSpec(ratio=0.5)},
                      default=mod.QuantSpec(bits=4, group_size=128))


class _Req:
    def __init__(self, prompt, n):
        self.prompt, self.max_new_tokens = prompt, n


@pytest.fixture(scope="module")
def compressed():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    jcal = [{"tokens": jnp.asarray(t)}
            for t, _ in jcalibration_batches(JDataConfig(**dc), 2)]
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 2)]
    wo_before = params["blocks"]["attn"]["wo"].clone()
    jout = jcompress_model(jmodel, jparams, jcal, _policy(jspecs),
                           engine="sequential")
    out = compress_model(model, params, cal, _policy(specs),
                         engine="sequential")
    return {"model": model, "jmodel": jmodel, "params": params,
            "wo_before": wo_before, "jout": jout, "out": out}


def test_compress_model_matches_jax(compressed):
    (cp, report), (jcp, jreport) = compressed["out"], compressed["jout"]
    assert [(r.qualname, r.method) for r in report] == \
        [(r.qualname, r.method) for r in jreport]
    assert len(report) == 4 * 7
    for r, jr in zip(report, jreport):
        assert abs(r.loss_after - jr.loss_after) <= 1e-5, r.qualname
        assert abs(r.sparsity - jr.sparsity) <= 1e-3, r.qualname
        art, jart = report.artifacts[r.qualname], jreport.artifacts[r.qualname]
        assert art.result.iters == jart.result.iters, r.qualname
        if jart.result.mask is not None:
            agree = (art.result.mask == np.asarray(jart.result.mask)).mean()
            assert agree >= 0.999, (r.qualname, agree)
        if jart.result.qtensor is not None:
            agree = (art.result.qtensor.codes().numpy()
                     == np.asarray(jart.result.qtensor.codes())).mean()
            assert agree >= 0.999, (r.qualname, agree)
    for key in ("wq", "wo", "wd"):
        group = "attn" if key[1] in "qo" else "mlp"
        np.testing.assert_allclose(cp["blocks"][group][key].numpy(),
                                   np.asarray(jcp["blocks"][group][key]),
                                   rtol=2e-4, atol=2e-4)
    # the caller's params are left as they were
    assert torch.equal(compressed["params"]["blocks"]["attn"]["wo"],
                       compressed["wo_before"])


def test_pack_params_equals_packed_checkpoint(compressed, tmp_path):
    cp, report = compressed["out"]
    packed = pack_params(cp, report)
    # six int4 leaves packed whole; the pruned wo stays dense
    assert isinstance(packed["blocks"]["attn"]["wq"], QTensor)
    assert isinstance(packed["blocks"]["mlp"]["wd"], QTensor)
    assert not isinstance(packed["blocks"]["attn"]["wo"], QTensor)
    assert packed["blocks"]["mlp"]["wu"].packed.shape == (4, 256, 64)
    path = save_packed_checkpoint(str(tmp_path), 0, cp, report)
    loaded, qts, manifest = load_packed_checkpoint(
        path, compressed["params"], device="cpu")
    assert len(qts) == 24 and set(manifest["packed"]) == set(qts)
    for group, key in (("attn", "wk"), ("mlp", "wg")):
        a, b = packed["blocks"][group][key], loaded["blocks"][group][key]
        for f in ("packed", "scale", "zero"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert torch.equal(packed["blocks"]["attn"]["wo"],
                       loaded["blocks"]["attn"]["wo"])
    assert torch.equal(packed["embed"], loaded["embed"])
    # materialize=True expands every packed layer to its dense dequant
    dense, _, _ = load_packed_checkpoint(path, compressed["params"],
                                         materialize=True, device="cpu")
    assert torch.equal(dense["blocks"]["mlp"]["wg"][2],
                       qts["blocks.2.mlp.wg"].dequant().T)
    assert torch.equal(dense["blocks"]["mlp"]["wg"], cp["blocks"]["mlp"]["wg"])


def test_jax_packed_checkpoint_decodes_identically(compressed, tmp_path):
    """JAX compresses and saves; the port loads the checkpoint and its
    greedy tokens are JAX's."""
    model, jmodel = compressed["model"], compressed["jmodel"]
    jcp, jreport = compressed["jout"]
    path = jsave_packed(str(tmp_path), 0, jcp, jreport)
    jparams, _, _ = jload_packed(path, jmodel.init(jax.random.PRNGKey(1)))
    params, _, _ = load_packed_checkpoint(path, compressed["params"],
                                          device="cpu")
    jq = jparams["blocks"]["mlp"]["wd"]
    assert isinstance(jq, JQTensor)
    np.testing.assert_array_equal(params["blocks"]["mlp"]["wd"].packed.numpy(),
                                  np.asarray(jq.packed))
    prompts = calibration_batches(DataConfig(512, 16, 3, seed=7), 1)[0][0]
    for prompt in prompts:
        req = _Req(prompt, 8)
        assert (serve.static_greedy_reference(model, params, req, 24)
                == jserve.static_greedy_reference(jmodel, jparams, req, 24))


def test_port_packed_checkpoint_loads_in_jax(compressed, tmp_path):
    model, jmodel = compressed["model"], compressed["jmodel"]
    cp, report = compressed["out"]
    path = save_packed_checkpoint(str(tmp_path), 3, cp, report)
    jparams, jqts, manifest = jload_packed(path, jmodel.init(
        jax.random.PRNGKey(1)))
    assert manifest["step"] == 3 and len(jqts) == 24
    np.testing.assert_array_equal(
        np.asarray(jparams["blocks"]["attn"]["wq"].packed),
        pack_params(cp, report)["blocks"]["attn"]["wq"].packed.numpy())
    prompt = calibration_batches(DataConfig(512, 16, 1, seed=9), 1)[0][0][0]
    params, _, _ = load_packed_checkpoint(path, compressed["params"],
                                          device="cpu")
    req = _Req(prompt, 8)
    assert (serve.static_greedy_reference(model, params, req, 24)
            == jserve.static_greedy_reference(jmodel, jparams, req, 24))


def test_compress_and_serve_clis_on_cpu(tmp_path):
    policy = ('{"rules": [["*.attn.wo", {"kind": "PruneSpec", "ratio": 0.5}]],'
              ' "default": {"kind": "QuantSpec", "bits": 4}}')
    out = str(tmp_path / "ck")
    _, report = compress_cli.main(["--tiny", "--device", "cpu",
                                   "--calib-batches", "1", "--seq", "16",
                                   "--policy", policy, "--out", out,
                                   "--save-packed"])
    assert len(report.packed_layers()) == 24
    assert latest_path(out).endswith("step_00000000")
    seqs = serve.main(["--tiny", "--device", "cpu", "--ckpt", out, "--packed",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert seqs.shape == (2, 4)
    with pytest.raises(ValueError):
        compress_model(build_model(get_tiny_config(ARCH)), {}, [],
                       specs.QuantSpec(), engine="bogus")
