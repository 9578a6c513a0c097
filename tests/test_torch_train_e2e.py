"""End to end on the port alone, as ``tests/test_system.py`` does it for the
JAX package: the port's trainer trains the tiny llama2-7b preset on the
Zipf-Markov corpus (120 steps, batch 16 × 64, AdamW at lr 1e-3 with 20
warmup steps of a 400-step schedule), and the trained model must meet the
reference's bars (``tests/test_system.py:54-72``): a final loss below 3.5
(the corpus is learnable), held-out perplexity below exp(final loss)·1.6,
and on the port's own compression at ratio 0.6 AWP prune no worse than
Wanda × 1.02, better than magnitude, and not better than the dense model
× 0.98. Torch runs on one intra-op thread.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core.compress import compress_model
from repro_torch.core.specs import PruneSpec
from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
from repro_torch.launch.compress import perplexity
from repro_torch.launch.train import run_steps
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def trained_model():
    cfg = get_tiny_config("llama2-7b")
    model = build_model(cfg, remat=False)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16)
    gen = ZipfMarkov(dc)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                                 total_steps=400))
    step_fn, _ = make_train_step(model, tcfg)
    state = init_train_state(model, 0, device="cpu", tcfg=tcfg)
    state, m = run_steps(step_fn, state, gen, 0, 120, torch.device("cpu"),
                         log_every=40)
    calib = [{"tokens": torch.from_numpy(t)}
             for t, _ in calibration_batches(dc, 2)]
    eval_batches = [tuple(torch.from_numpy(a) for a in gen.batch(1000 + i))
                    for i in range(4)]
    return model, state["params"], calib, eval_batches, float(m["loss"])


def test_e2e_training_learned_structure():
    model, params, _, eval_batches, final_loss = trained_model()
    assert final_loss < 3.5           # Zipf-Markov is learnable
    ppl = perplexity(model, params, eval_batches)
    assert ppl < np.exp(final_loss) * 1.6


def test_e2e_awp_prune_beats_magnitude_and_wanda():
    model, params, calib, eval_batches, _ = trained_model()
    base_ppl = perplexity(model, params, eval_batches)
    ppls, iters = {}, []
    for method in ("magnitude", "wanda", "awp_prune"):
        cp, report = compress_model(model, params, calib,
                                    PruneSpec(method=method, ratio=0.6))
        ppls[method] = perplexity(model, cp, eval_batches)
        if method == "awp_prune":
            iters = [report.artifacts[r.qualname].result.iters
                     for r in report]
    # paper Tables 1-2 ordering on trained-model statistics
    assert ppls["awp_prune"] <= ppls["wanda"] * 1.02
    assert ppls["awp_prune"] < ppls["magnitude"]
    assert ppls["awp_prune"] >= base_ppl * 0.98   # compression can't help
    assert len(iters) == 7 * model.cfg.num_layers
    assert all(1 <= int(n) <= 200 for n in iters)
