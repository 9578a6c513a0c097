"""Guards of the port's boundaries.

- Every module of ``repro_torch`` imports without JAX and without the JAX
  package: a fresh interpreter imports them all and finds neither ``jax``
  nor any ``repro.`` module in ``sys.modules``. ``chip_smoke.py`` imports
  neither either.
- Entry points run on the card unless the caller asks for the CPU: without
  a card and without ``device="cpu"`` they raise, never fall back.
- ``chip_smoke.py`` fails (non-zero, no result line) without a card.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 60
    assert {"repro_torch.core.metrics", "repro_torch.configs.llama2_7b",
            "repro_torch.configs.llama2_13b", "repro_torch.configs.llama31_8b",
            "repro_torch.configs.granite_8b"} | {
        f"repro_torch.core.baselines.{m}" for m in (
            "rtn", "awq", "sequential", "sparsegpt", "gptq")} <= set(mods)
    assert {f"repro_torch.serving.{m}" for m in (
        "engine", "faults", "kv_cache", "paging", "prefix_cache", "sampling",
        "scheduler")} <= set(mods)
    assert {"repro_torch.optim.optimizers", "repro_torch.optim.grad_compress",
            "repro_torch.training.train_loop",
            "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.models.mamba", "repro_torch.models.mamba2",
            "repro_torch.configs.falcon_mamba_7b",
            "repro_torch.configs.zamba2_1p2b"} <= set(mods)
    assert {f"repro_torch.configs.{m}" for m in (
        "musicgen_medium", "internvl2_1b", "starcoder2_7b", "starcoder2_15b",
        "nemotron_4_340b", "grok_1_314b")} <= set(mods)
    assert {"repro_torch.analysis.roofline",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
            "print(len(bad), bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "0 []", out.stdout + out.stderr


MULTI_DEVICE = ("repro_torch.sharding", "repro_torch.core.distributed",
                "repro_torch.launch.mesh", "repro_torch.analysis.roofline",
                "repro_torch.launch.dryrun")


def test_multi_device_modules_import_alone_without_a_group():
    """The multi-device slice's modules and the dry run's are among those
    checked above, and each imports alone without JAX, the JAX package or
    a process group (meshes, fake or not, are made by functions, never at
    import); the tests' rank harness imports neither JAX nor the JAX
    package either."""
    assert set(MULTI_DEVICE) <= set(_port_modules())
    code = ("import sys, torch.distributed as dist\n"
            f"for m in {MULTI_DEVICE!r}: __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
            "print(len(bad), bad, dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "0 [] False", out.stdout + out.stderr
    harness = os.path.join(REPO, "tests", "torch_dist_util.py")
    assert not [m for m in _imports(harness)
                if m == "jax" or m.startswith(("jax.", "repro."))
                or m == "repro"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_and_chip_smoke_name_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card(no_card, tmp_path):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import calibration
    from repro_torch.launch import compress, serve, train
    from repro_torch.models import build_model, make_batch
    from repro_torch.serving import (KVCacheConfig, init_paged_storage,
                                     init_slot_cache)
    from repro_torch.training.train_loop import init_train_state

    cfg = get_tiny_config("llama32-1b")
    model = build_model(cfg)
    calls = [lambda: model.init(0),
             lambda: model.init_cache(1, 8),
             lambda: init_slot_cache(cfg, KVCacheConfig(1, 8)),
             lambda: init_paged_storage(cfg, 4, 8),
             lambda: calibration.init(16),
             lambda: params_from_numpy({"w": [1.0]}),
             lambda: serve.main(["--tiny", "--gen", "2"]),
             lambda: serve.main(["--tiny", "--engine", "continuous",
                                 "--kv-quant", "--gen", "2"]),
             lambda: serve.main(["--tiny", "--engine", "continuous",
                                 "--kv", "paged", "--gen", "2"]),
             lambda: compress.main(["--tiny", "--out", str(tmp_path)]),
             lambda: init_train_state(model, 0),
             lambda: train.main(["--tiny", "--steps", "1", "--ckpt-dir",
                                 str(tmp_path)])]
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        ssm = build_model(get_tiny_config(arch))
        calls += [lambda m=ssm: m.init(0),
                  lambda m=ssm: m.init_cache(1, 8),
                  lambda a=arch: serve.main(["--tiny", "--arch", a, "--gen",
                                             "2"]),
                  lambda a=arch: compress.main(["--tiny", "--arch", a,
                                                "--out", str(tmp_path)])]
    for arch in ("musicgen-medium", "internvl2-1b", "starcoder2-7b",
                 "starcoder2-15b", "nemotron-4-340b"):
        cfg_a = get_tiny_config(arch)
        new = build_model(cfg_a)
        calls += [lambda m=new: m.init(0),
                  lambda m=new: m.init_cache(1, 8),
                  lambda c=cfg_a: make_batch(c, torch.Generator(), 1, 8),
                  lambda a=arch: serve.main(["--tiny", "--arch", a, "--gen",
                                             "2"]),
                  lambda a=arch: compress.main(["--tiny", "--arch", a,
                                                "--out", str(tmp_path)])]
    for arch in ("falcon-mamba-7b", "zamba2-1.2b", "qwen3-moe-235b-a22b",
                 "grok-1-314b"):
        calls += [lambda a=arch: train.main(["--tiny", "--arch", a, "--steps",
                                             "1", "--ckpt-dir",
                                             str(tmp_path)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = model.init(0, device="cpu")          # the CPU when asked
    assert params["embed"].device.type == "cpu"


def test_chip_smoke_fails_without_card(tmp_path):
    lone = tmp_path / "chip_smoke.py"             # alone, outside the repo
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script in (os.path.join(REPO, "chip_smoke.py"), str(lone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
