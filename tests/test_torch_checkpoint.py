"""Dense checkpoints shared by the two packages, the port's
``CheckpointManager``, and the evaluation path of the CLIs on the CPU:
``repro_torch.launch.compress --ckpt`` restores a JAX-written checkpoint and
prints the perplexity the JAX CLI prints, and ``repro_torch.launch.serve``
serves a port-written dense checkpoint through the slot engine.

Bars: restored leaves equal bit for bit, in both directions; the printed
perplexity before compression equal to the JAX CLI's to its 3 decimals.
"""
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_tiny_config as jget_tiny
from repro.launch import compress as jcompress_cli
from repro.models import build_model as jbuild
from repro_torch.checkpoint import (CheckpointManager, latest_path,
                                    restore_checkpoint, save_checkpoint,
                                    save_packed_checkpoint)
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import compress as compress_cli, serve
from repro_torch.models import build_model

ARCH = "llama2-7b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jbuild(jget_tiny(ARCH), remat=False)
    model = build_model(get_tiny_config(ARCH))
    # a checkpoint that is not the init of seed 0, so a restore shows
    jparams = jmodel.init(jax.random.PRNGKey(7))
    return jmodel, model, jparams


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_same(port_tree, jax_tree):
    a, b = dict(_leaves(port_tree)), dict(_leaves(jax_tree))
    assert a.keys() == b.keys()
    for k in a:
        pa, jb = a[k].numpy(), np.asarray(b[k])
        assert pa.dtype == jb.dtype and pa.shape == jb.shape, k
        assert np.array_equal(pa, jb), k


def test_jax_checkpoint_restores_in_the_port(tiny, tmp_path):
    jmodel, model, jparams = tiny
    jsave(str(tmp_path), 3, {"params": jparams})
    target = {"params": model.init(0, device="cpu")}
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 3
    _assert_same(restored["params"], jparams)
    assert restored["params"]["embed"].device.type == "cpu"


def test_port_checkpoint_restores_in_jax(tiny, tmp_path):
    jmodel, model, _ = tiny
    params = model.init(5, device="cpu")
    save_checkpoint(str(tmp_path), 4, {"params": params})
    target = {"params": jmodel.init(jax.random.PRNGKey(0))}
    restored, step = JCheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 4
    _assert_same(params, restored["params"])


def test_restore_dtype_device_and_refusals(tiny, tmp_path):
    _, model, _ = tiny
    params = model.init(0, device="cpu")
    path = save_checkpoint(str(tmp_path / "dense"), 0, {"params": params})
    half = {"params": {k: (v.to(torch.bfloat16) if k == "final_norm" else v)
                       for k, v in params.items()}}
    out = restore_checkpoint(path, half)
    assert out["params"]["final_norm"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="mesh"):
        restore_checkpoint(path, {"params": params}, shardings={})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {"params": params, "extra": params["embed"]})
    # a packed checkpoint's dense arrays hold zeroed holes: refused
    cal = [{"tokens": torch.from_numpy(t)} for t, _ in calibration_batches(
        DataConfig(vocab_size=512, seq_len=16, global_batch=2), 1)]
    cp, report = compress_model(model, params, cal,
                                specs.QuantSpec(method="rtn", bits=4,
                                                group_size=32))
    ppath = save_packed_checkpoint(str(tmp_path / "packed"), 0, cp, report)
    with pytest.raises(ValueError, match="packed checkpoint"):
        restore_checkpoint(ppath, {"params": params})
    loaded, qts, _ = CheckpointManager(
        str(tmp_path / "packed")).restore_latest_packed(params, device="cpu")
    assert len(qts) == 7 * 4
    assert torch.equal(loaded["embed"], cp["embed"])


def test_manager_rotates_saves_async_and_finds_nothing(tmp_path):
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest({"w": torch.zeros(2)}) == (None, None)
    assert empty.restore_latest_packed({}) == (None, None, None)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_n=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"n": torch.ones(3, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert sorted(os.listdir(mgr.directory)) == ["step_00000002",
                                                 "step_00000003"]
    mgr.save_async(4, tree)
    tree["w"].add_(100.0)             # after the snapshot: not saved
    mgr.wait()
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(mgr.directory)) == ["step_00000003",
                                                 "step_00000004"]
    out, step = mgr.restore_latest({"w": torch.zeros(2, 3),
                                    "b": {"n": torch.zeros(3,
                                                           dtype=torch.int32)}})
    assert step == 4 and out["b"]["n"].dtype == torch.int32
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3))
    assert mgr.latest_path() == latest_path(mgr.directory)


def _ppl_line(text):
    m = re.search(r"\[compress\] perplexity (\S+) -> (\S+)", text)
    assert m, text
    return m.group(1), m.group(2)


def test_compress_cli_restores_a_jax_checkpoint(tiny, tmp_path, capsys,
                                                monkeypatch):
    """The JAX CLI and the port's on one JAX-written checkpoint print the
    same perplexity; the port's dense output then serves through the slot
    engine, held by ``--verify`` to the static path."""
    _, _, jparams = tiny
    ck = str(tmp_path / "train")
    jsave(ck, 9, {"params": jparams})
    # a policy that leaves every layer dense: the restore and the
    # perplexity are what this test holds (the methods have their own)
    flags = ["--arch", ARCH, "--tiny", "--ckpt", ck, "--calib-batches", "1",
             "--seq", "16", "--policy", '{"rules": [], "default": null}']
    monkeypatch.setattr(sys, "argv", ["compress"] + flags
                        + ["--out", str(tmp_path / "jout")])
    jcompress_cli.main()
    jtext = capsys.readouterr().out
    out = str(tmp_path / "out")
    compress_cli.main(flags + ["--device", "cpu", "--out", out])
    text = capsys.readouterr().out
    assert "[compress] loaded checkpoint step 9" in text
    assert "[compress] loaded checkpoint step 9" in jtext
    before, after = _ppl_line(text)
    jbefore, jafter = _ppl_line(jtext)
    assert before == jbefore == after == jafter
    assert latest_path(out).endswith("step_00000000")

    res = serve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                      "--ckpt", out, "--engine", "continuous", "--verify",
                      "--requests", "4", "--slots", "2", "--gen", "4",
                      "--prompt-len", "16", "--buckets", "8,16"])
    text = capsys.readouterr().out
    assert "[serve] loaded checkpoint step 0" in text
    assert "verify vs static path: 4/4 completed requests identical" in text
    assert len(res) == 4
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--packed"])
