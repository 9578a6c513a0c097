"""The port's train CLI on a device mesh: ``repro_torch.launch.train
--mesh`` under ``torchrun --standalone`` on four gloo ranks (``--device
cpu``), the params, optimizer state and batch as DTensors, the state
checkpointed whole by rank 0 and resumed onto another mesh shape. About
60 s on one process (two launches of four ranks).
"""
import os
import subprocess
import sys

from conftest import SRC


def _torchrun(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=200)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_train_cli_mesh_and_elastic_resume(tmp_path):
    """The train CLI under torchrun on four gloo ranks: --mesh 2x2 trains
    and checkpoints; the same directory resumes on --mesh 4."""
    common = ["--tiny", "--device", "cpu", "--arch", "granite-8b",
              "--batch", "8", "--seq", "16", "--ckpt-every", "2",
              "--ckpt-dir", str(tmp_path / "ck")]
    out = _torchrun(common + ["--mesh", "2x2", "--steps", "4"], tmp_path)
    assert out.count("step 0:") == 1 and "[train] done" in out
    out = _torchrun(common + ["--mesh", "4", "--steps", "6"], tmp_path)
    assert "[train] resumed from step 4" in out
    assert "step 5:" in out
