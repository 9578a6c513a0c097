"""The legacy flat ``CompressionConfig``, ``compress_weight`` and the CLI
flags ``--skip`` (compress) and ``--materialize`` (serve), held to the JAX
package's on the tiny llama32 from JAX's init (a dense checkpoint both
packages restore). About 75 s on one process (two JAX CLI runs and JAX's
compressions).
"""
import ast
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_tiny_config as jget_tiny
from repro.core import calibration as jcalib
from repro.core.compress import CompressionConfig as JConfig
from repro.core.compress import compress_model as jcompress_model
from repro.core.compress import compress_weight as jcompress_weight
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import calibration as calib
from repro_torch.core.compress import (CompressionConfig, as_policy,
                                       compress_model, compress_weight)
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import compress as compress_cli, serve
from repro_torch.models import build_model

ARCH = "llama32-1b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jbuild(jget_tiny(ARCH), remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(get_tiny_config(ARCH)), params


def _cal(n=1, seq=16):
    dc = dict(vocab_size=get_tiny_config(ARCH).vocab_size, seq_len=seq,
              global_batch=8)
    return ([{"tokens": jnp.asarray(t)}
             for t, _ in jcalibration_batches(JDataConfig(**dc), n)],
            [{"tokens": torch.from_numpy(t)}
             for t, _ in calibration_batches(DataConfig(**dc), n)])


CONFIGS = {
    "prune_skip_wo": dict(method="wanda", ratio=0.5, skip=("wo",)),
    "quant_skip_wd_wq": dict(method="awp_quant", bits=4, group_size=32,
                             skip=("wd", "wq")),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compress_model_takes_the_flat_config(tiny, name):
    """compress_model(..., CompressionConfig(...)): the same layers
    compressed (skip substrings match the short layer names only), the
    reference's masks and codes, losses within 1e-5."""
    jmodel, jparams, model, params = tiny
    jcal, cal = _cal()
    kw = CONFIGS[name]
    _, jrep = jcompress_model(jmodel, jparams, jcal, JConfig(**kw))
    _, rep = compress_model(model, params, cal, CompressionConfig(**kw))
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    skipped = kw["skip"]
    assert not any(r.qualname.split(".")[-1] in skipped for r in rep)
    assert len(rep) == 4 * (7 - len(skipped))
    for r, jr in zip(rep, jrep):
        assert abs(r.loss_after - jr.loss_after) <= 1e-5, r.qualname
        art, jart = rep.artifacts[r.qualname], jrep.artifacts[r.qualname]
        if jart.result.mask is not None:
            assert (art.result.mask
                    == np.asarray(jart.result.mask)).mean() >= 0.999
        if jart.result.qtensor is not None:
            assert (art.result.qtensor.codes().numpy()
                    == np.asarray(jart.result.qtensor.codes())).mean() >= 0.999


def test_compress_weight_and_as_policy():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 64)).astype(np.float32)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    jst = jcalib.update(jcalib.init(64), jnp.asarray(x))
    st = calib.update(calib.init(64, device="cpu"), torch.from_numpy(x))
    for kw in (dict(method="awp_prune", ratio=0.5),
               dict(method="rtn", bits=4, group_size=32)):
        want = np.asarray(jcompress_weight(jnp.asarray(w), jst, JConfig(**kw)))
        got = compress_weight(torch.from_numpy(w), st,
                              CompressionConfig(**kw)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    pol = as_policy(CompressionConfig(skip=("o",)))
    assert pol.spec_for("blocks.0.attn.wo", "wo") is None
    assert pol.spec_for("blocks.0.attn.wq", "wq") is not None
    with pytest.raises(TypeError):
        as_policy("awp_prune")


def _jax_cli(module, args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _report_lines(text):
    return [l for l in text.splitlines()
            if l.startswith("[compress]") and ("layers compressed" in l
                                               or "mean loss" in l
                                               or "packed QTensors" in l)]


def test_skip_and_materialize_clis_match_jax(tiny, tmp_path, capsys):
    """--skip wo leaves every wo dense with the JAX CLI's report; the
    packed checkpoint served with --materialize decodes the JAX serve
    CLI's tokens, and the same as served packed."""
    _, jparams, _, _ = tiny
    jsave(str(tmp_path / "init"), 0, {"params": jparams})
    common = ["--tiny", "--arch", ARCH, "--ckpt", str(tmp_path / "init"),
              "--method", "awp_quant", "--bits", "4", "--group-size", "32",
              "--calib-batches", "1", "--seq", "16", "--skip", "wo",
              "--save-packed"]
    jout = _jax_cli("repro.launch.compress",
                    common + ["--out", str(tmp_path / "jck")], tmp_path)
    capsys.readouterr()
    _, report = compress_cli.main(common + ["--device", "cpu", "--out",
                                            str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert _report_lines(out) == _report_lines(jout)
    assert "24 layers compressed" in out
    assert not any(r.qualname.endswith(".wo") for r in report)
    serve_args = ["--tiny", "--arch", ARCH, "--packed", "--batch", "2",
                  "--prompt-len", "8", "--gen", "4"]
    jtext = _jax_cli("repro.launch.serve",
                     serve_args + ["--ckpt", str(tmp_path / "jck"),
                                   "--materialize"], tmp_path)
    want = ast.literal_eval(re.search(r"sample continuation \(req 0\): "
                                      r"(\[.*\])", jtext).group(1))
    for ck in ("jck", "ck"):
        mat = serve.main(serve_args + ["--device", "cpu", "--ckpt",
                                       str(tmp_path / ck), "--materialize"])
        assert "materialized dense" in capsys.readouterr().out
        packed = serve.main(serve_args + ["--device", "cpu", "--ckpt",
                                          str(tmp_path / ck)])
        assert mat[0][:16].tolist() == want
        assert packed.tolist() == mat.tolist()
