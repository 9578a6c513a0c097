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

Runs on the card unless ``--device cpu``. ``--mesh`` shards the train
state over a device mesh of the launch's ranks (run under ``torchrun``):
``single`` is the reference's 16×16 (data × model) mesh, ``multi`` its
2×16×16 (pod × data × model), and a shape such as ``2x2`` or ``4`` any
other (two dims data × model, one dim data). The params, the optimizer
state and the batch become DTensors placed by the models' logical axes
(``repro_torch.sharding``), NCCL on cards and gloo with ``--device cpu``:

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --tiny \
      --device cpu --arch granite-8b --mesh 2x2 --steps 20

Checkpoints of a sharded state are written whole by rank 0 and restore
onto any mesh. Every family
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
from repro_torch.sharding import (NamedSharding, full_tensor, rules_for_cell,
                                  distribute)
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step,
                                             shard_train_state, sharded_step)


def train_config(args) -> TrainConfig:
    """The CLI's recipe: warmup a tenth of ``--steps``, cosine to the end."""
    return TrainConfig(optimizer=OptimizerConfig(
        name=args.optimizer, lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps),
        microbatches=args.microbatches)


def device_batch(gen: ZipfMarkov, step: int, dev, rules=None) -> dict:
    """Step ``step``'s batch on ``dev``, uploaded without a host wait;
    with ``rules`` on a mesh, sharded on the batch axes."""
    toks, labels = gen.batch(step)
    batch = {"tokens": to_device(toks, dev),
             "labels": to_device(labels, dev)}
    if rules is None or rules.mesh is None:
        return batch
    return {k: distribute(v, NamedSharding(
        rules.mesh, rules.spec(("batch", None), v.shape)))
        for k, v in batch.items()}


def make_rules(args, cfg, dev):
    """The sharding rules of ``--mesh`` (no mesh for ``none``)."""
    if args.mesh == "none":
        return rules_for_cell(None, cfg.family, "train")
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         parse_mesh)
    if args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=dev)
    else:
        mesh = make_mesh(*parse_mesh(args.mesh), device=dev)
    return rules_for_cell(mesh, cfg.family, "train")


def is_leader(rules) -> bool:
    """Whether this process prints: always without a mesh, rank 0 on one."""
    if rules is None or rules.mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def run_steps(step_fn, state, gen, start: int, stop: int, dev, *,
              mgr=None, ckpt_every: int = 0, heartbeat: str = "",
              log_every: int = 10, on_step=None, rules=None):
    """Steps ``start`` .. ``stop`` − 1 of ``step_fn`` on ``gen``'s batches.
    Saves through ``mgr`` after every ``ckpt_every``-th step and the last;
    prints the loss, lr and tokens/s (two host reads) at every
    ``log_every``-th step and the last, and reads nothing on the host in
    between; on a mesh only rank 0 prints. ``on_step(i, state, metrics)``
    runs after each step. Returns the last state and metrics."""
    log = is_leader(rules)
    metrics = {}
    t0 = time.time()
    for i in range(start, stop):
        state, metrics = step_fn(state, device_batch(gen, i, dev, rules))
        if heartbeat:
            with open(heartbeat, "w") as f:
                f.write(str(i))
        if mgr is not None and ckpt_every and (
                (i + 1) % ckpt_every == 0 or i + 1 == stop):
            mgr.save_async(i + 1, state)
        if i % log_every == 0 or i + 1 == stop:
            loss, lr = (float(full_tensor(metrics[k])) for k in ("loss", "lr"))
            toks = gen.cfg.global_batch * gen.cfg.seq_len * (i - start + 1)
            if log:
                print(f"step {i}: loss={loss:.4f} lr={lr:.2e} "
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
                    help="none (one device), single (16x16), multi "
                         "(2x16x16) or a shape such as 2x2; under torchrun")
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    dev = resolve_device(args.device)
    rules = make_rules(args, cfg, dev)

    model = build_model(cfg, rules, remat=not args.tiny)
    tcfg = train_config(args)
    step_fn, _ = make_train_step(model, tcfg)
    state = init_train_state(model, 0, device=dev, tcfg=tcfg)
    log = is_leader(rules)
    if rules.mesh is not None:
        state = shard_train_state(state, model, rules, args.optimizer)
        step_fn = sharded_step(step_fn)

    mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
    start = 0
    restored, step = mgr.restore_latest(state)
    if restored is not None:
        state, start = restored, step
        if log:
            print(f"[train] resumed from step {start}")

    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch))
    state, metrics = run_steps(step_fn, state, gen, start, args.steps, dev,
                               mgr=mgr, ckpt_every=args.ckpt_every,
                               heartbeat=args.heartbeat, rules=rules)
    mgr.wait()
    if metrics:
        loss = float(full_tensor(metrics["loss"]))
        if log:
            print(f"[train] done: final loss {loss:.4f}")
    return state, metrics


if __name__ == "__main__":
    main()
