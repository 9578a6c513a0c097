"""The port's batched compression engine against the JAX package's on the
same inputs: tiny llama32 with JAX's random init carried into the port and
the same calibration tokens for both packages, at three policies.

Bars: per-layer losses within 1e-5, masks and codes equal on at least
99.9% of entries and equal iteration counts. Kept apart from
``tests/test_torch_batched.py`` so that the JAX engine's compiles run on
another pytest-xdist worker than the port's own engine cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.models import build_model

ARCH = "llama32-1b"


def _mixed(mod):
    """``chip_smoke.py``'s policy: prune every wo, int4 the other six."""
    return mod.Policy({"*.attn.wo": mod.PruneSpec(ratio=0.5)},
                      default=mod.QuantSpec(bits=4, group_size=128))


def _table1(mod):
    """The Table-1 prune policy on blocks 0 and 1; the rest stays dense."""
    return mod.Policy({"blocks.0.*": mod.PruneSpec(ratio=0.5),
                       "blocks.1.*": mod.PruneSpec(ratio=0.5)}, default=None)


def _joint_nm(mod):
    return mod.Policy({"*.attn.*": mod.JointSpec(ratio=0.5, bits=4,
                                                 group_size=32)},
                      default=mod.PruneSpec(method="awp_prune_nm", nm=(2, 4)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Tiny llama32 with JAX's random init carried into the port, and the
    same calibration tokens for both packages."""
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4)
    jcal = [{"tokens": jnp.asarray(t)}
            for t, _ in jcalibration_batches(JDataConfig(**dc), 2)]
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 2)]
    return dict(model=model, params=params, cal=cal, jmodel=jmodel,
                jparams=jparams, jcal=jcal)


@pytest.mark.parametrize("policy", ["mixed", "table1", "joint_nm"])
def test_batched_engine_matches_jax(tiny, policy):
    build = {"mixed": _mixed, "table1": _table1, "joint_nm": _joint_nm}[policy]
    jcp, jrep = jcompress_model(tiny["jmodel"], tiny["jparams"], tiny["jcal"],
                                build(jspecs), engine="batched")
    cp, rep = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                             build(specs))
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
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
