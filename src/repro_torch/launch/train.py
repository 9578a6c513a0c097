"""Training launcher: deterministic, resumable (the port of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
      --arch llama2-7b --steps 100 --ckpt-dir /tmp/train_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama32-1b \
      --steps 200 --ckpt-dir /tmp/train_ckpt        # on the card

Atomic rotating checkpoints every ``--ckpt-every`` steps (written on a
worker thread by ``CheckpointManager.save_async``) and deterministic
``batch(step)`` data, so a restart reproduces the exact stream: the newest
checkpoint under ``--ckpt-dir`` is restored (``[train] resumed from step
N``) and training continues from there. The checkpoint is the reference's
train state, ``{"params", "opt", "step"}`` in the npz + ``manifest.json``
format both packages read, so a state written by the JAX CLI continues
here and the reverse. ``--heartbeat FILE`` is rewritten with the step
number after every step (liveness for an external supervisor).

Runs on the card unless ``--device cpu``. ``--mesh`` takes only ``none``:
the multi-device step comes with the multi-device slice. Every family
trains (dense, MoE, SSM, hybrid); the batches are tokens only, as the
reference's CLI feeds them, so the audio and vlm configs raise the
model's ``ValueError`` naming the frames or patches their stub frontend
needs.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.data import DataConfig, ZipfMarkov
from repro_torch.device import resolve_device, to_device
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def train_config(args) -> TrainConfig:
    """The CLI's recipe: warmup a tenth of ``--steps``, cosine to the end."""
    return TrainConfig(optimizer=OptimizerConfig(
        name=args.optimizer, lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps),
        microbatches=args.microbatches)


def device_batch(gen: ZipfMarkov, step: int, dev) -> dict:
    """Step ``step``'s batch on ``dev``, uploaded without a host wait."""
    toks, labels = gen.batch(step)
    return {"tokens": to_device(toks, dev), "labels": to_device(labels, dev)}


def run_steps(step_fn, state, gen, start: int, stop: int, dev, *,
              mgr=None, ckpt_every: int = 0, heartbeat: str = "",
              log_every: int = 10, on_step=None):
    """Steps ``start`` .. ``stop`` − 1 of ``step_fn`` on ``gen``'s batches.
    Saves through ``mgr`` after every ``ckpt_every``-th step and the last;
    prints the loss, lr and tokens/s (two host reads) at every
    ``log_every``-th step and the last, and reads nothing on the host in
    between. ``on_step(i, state, metrics)`` runs after each step. Returns
    the last state and metrics."""
    metrics = {}
    t0 = time.time()
    for i in range(start, stop):
        state, metrics = step_fn(state, device_batch(gen, i, dev))
        if heartbeat:
            with open(heartbeat, "w") as f:
                f.write(str(i))
        if mgr is not None and ckpt_every and (
                (i + 1) % ckpt_every == 0 or i + 1 == stop):
            mgr.save_async(i + 1, state)
        if i % log_every == 0 or i + 1 == stop:
            toks = gen.cfg.global_batch * gen.cfg.seq_len * (i - start + 1)
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"tok/s={toks / (time.time() - t0):.0f}", flush=True)
        if on_step is not None:
            on_step(i, state, metrics)
    return state, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=list_archs())
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    help="only 'none' (one device) until the multi-device "
                         "slice")
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh!r}: the port trains on one "
                         f"device; meshes come with the multi-device slice")
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    dev = resolve_device(args.device)

    model = build_model(cfg, remat=not args.tiny)
    tcfg = train_config(args)
    step_fn, _ = make_train_step(model, tcfg)
    state = init_train_state(model, 0, device=dev, tcfg=tcfg)

    mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
    start = 0
    restored, step = mgr.restore_latest(state)
    if restored is not None:
        state, start = restored, step
        print(f"[train] resumed from step {start}")

    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch))
    state, metrics = run_steps(step_fn, state, gen, start, args.steps, dev,
                               mgr=mgr, ckpt_every=args.ckpt_every,
                               heartbeat=args.heartbeat)
    mgr.wait()
    if metrics:
        print(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return state, metrics


if __name__ == "__main__":
    main()
