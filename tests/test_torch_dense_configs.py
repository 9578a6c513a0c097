"""The last dense configs of the JAX package through the port on the CPU:
starcoder2-7b's and nemotron-4-340b's tiny presets compressed by both of
the port's engines against JAX's batched engine, and the CLIs of all
three (starcoder2-7b, starcoder2-15b, nemotron-4-340b) through compress,
serve and train, as the reference's CLIs run them. Their configs and
batches are held field for field in ``tests/test_torch_frontends.py``.

JAX's random init is carried into the port (``repro_torch.bridge``), and
the calibration batch comes from the reference's ``make_batch``. Bars:
per-layer loss within 1e-5, codes equal on at least 99.9% of entries,
equal iteration counts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.models import build_model as jbuild
from repro.models import make_batch as jmake_batch
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.launch import compress as compress_cli
from repro_torch.launch import serve, train
from repro_torch.models import build_model

DENSE_ARCHS = ["starcoder2-7b", "starcoder2-15b", "nemotron-4-340b"]
# AWP-int4 at the one linear that carries a dense config's own shape:
# starcoder2-7b's wu has d_in 60, which groups of 32 do not divide;
# nemotron's wd reads the squared ReLU
POLICIES = {
    "starcoder2-7b": lambda m: m.Policy(
        {"*.mlp.wu": m.QuantSpec(bits=4, group_size=32)}, default=None),
    "nemotron-4-340b": lambda m: m.Policy(
        {"*.mlp.wd": m.QuantSpec(bits=4, group_size=32)}, default=None),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(POLICIES))
def tiny(request):
    """The arch's tiny model in both packages on JAX's init, one batch of
    2 x 24 tokens from the reference's ``make_batch`` on both sides, and
    JAX's batched compression at the arch's policy."""
    arch = request.param
    cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jcal = [jmake_batch(jcfg, jax.random.PRNGKey(1), 2, 24)]
    _, jrep = jcompress_model(jmodel, jparams, jcal,
                              POLICIES[arch](jspecs), engine="batched")
    return dict(
        arch=arch, cfg=cfg, model=build_model(cfg), jrep=jrep,
        params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu"),
        cal=[{"tokens": torch.from_numpy(np.array(jcal[0]["tokens"],
                                                  dtype=np.int64))}])


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_dense_shapes_compress_like_jax(tiny, engine):
    """starcoder2-7b's odd tiny widths (d_model 60: groups of 32 do not
    divide its wu's d_in) and nemotron's squared-ReLU MLP (its wd's
    statistics) through AWP int4."""
    _, rep = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                            POLICIES[tiny["arch"]](specs), engine=engine)
    jrep = tiny["jrep"]
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    assert len(rep) == tiny["cfg"].num_layers
    for r, jr in zip(rep, jrep):
        assert abs(r.loss_after - jr.loss_after) <= 1e-5, r.qualname
        art, jart = rep.artifacts[r.qualname], jrep.artifacts[r.qualname]
        assert art.result.iters == jart.result.iters, r.qualname
        agree = (art.result.qtensor.codes().numpy()
                 == np.asarray(jart.result.qtensor.codes())).mean()
        assert agree >= 0.999, (r.qualname, agree)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_clis_on_cpu(arch, tmp_path):
    """compress (batched engine, AWP int4) → serve the packed checkpoint
    statically and through the INT8 slot engine → train, as the
    reference's CLIs run these archs."""
    out = str(tmp_path / "ck")
    base = ["--arch", arch, "--tiny", "--device", "cpu"]
    cfg = get_tiny_config(arch)
    _, report = compress_cli.main(
        base + ["--calib-batches", "1", "--seq", "16", "--method",
                "awp_quant", "--group-size", "32", "--ckpt",
                str(tmp_path / "none"), "--out", out, "--save-packed"])
    assert len(report.packed_layers()) == 6 * cfg.num_layers
    seqs = serve.main(base + ["--ckpt", out, "--packed", "--batch", "2",
                              "--prompt-len", "8", "--gen", "4"])
    assert seqs.shape == (2, 4)
    serve.main(base + ["--ckpt", out, "--packed", "--engine", "continuous",
                       "--kv-quant", "--requests", "3", "--slots", "2",
                       "--gen", "3", "--prompt-len", "16", "--buckets",
                       "8,16"])
    train.main(base + ["--steps", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path / "tr")])
