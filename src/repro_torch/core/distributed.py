"""Distributed AWP (the port of ``repro/core/distributed.py``).

Two schedules, each as per-rank code on the rank's shard of the problem
with explicit collectives on the mesh dims' process groups (the
reference's ``shard_map`` bodies):

* :func:`awp_prune_rowsharded` — rows of Θ are independent sub-problems
  (Eq. 4), so d_out is split across the whole mesh and C is replicated:
  the PGD loop runs with **zero collectives**. Each step
  Z = Θ + η(W − Θ)C is K1 (``kernels.impl.awp_pgd_step``), each projection
  K2 (``topk_row``); the rows are all-gathered once at the end.

* :func:`awp_prune_colsharded_fn` — for huge-fan-in layers where a
  replicated C would not fit: C is row-sharded over "model", each rank
  forms its partial (W − Θ)·C_shard, one all-reduce per iteration rebuilds
  the full-width residual product, Θ is all-gathered along d_in and the
  row top-k (K2) runs on the full row before each rank keeps its columns.

:func:`calib_c_distributed` forms C = XᵀX/n from token-sharded
activations with one all-reduce. Every function takes plain tensors that
every rank holds whole (it slices its own shard) or DTensors (each rank
receives only its own shard, ``sharding.local_block``), and returns the
whole result on every rank. Without a mesh each is the single-device
computation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import impl
from repro_torch.sharding import (P, ShardingRules, full_tensor, local_block,
                                  mesh_coord, placements)


def _gather(local: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """The whole tensor from each rank's block, laid out by ``spec``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False).full_tensor()


def awp_prune_rowsharded_fn(k: int, eta, iters: int):
    """The zero-collective PGD loop body (rows independent, C replicated):
    K2 for the projections, K1 for each step."""
    pgd_step, topk = impl("awp_pgd_step"), impl("topk_row")

    def run(w, c):
        theta = topk(w, k)                  # Wanda-init done upstream
        for _ in range(iters):
            z, _ = pgd_step(w, theta, c, eta)
            theta = topk(z, k)
        return theta
    return run


def rowsharded_axes(rules: ShardingRules, d_out: Optional[int] = None):
    """The mesh dims the rows are split over: all of ``rules.rows_axes``,
    with trailing dims dropped until ``d_out`` divides (the graded
    fallback of the reference's ``rowsharded_shardings``: internvl2's 896
    rows on 256 chips)."""
    axes = tuple(rules.rows_axes)
    if d_out is not None:
        while axes and d_out % rules.axis_size(axes) != 0:
            axes = axes[:-1]
    return axes


def awp_prune_rowsharded(w: torch.Tensor, c: torch.Tensor, k: int, eta,
                         iters: int, rules: ShardingRules) -> torch.Tensor:
    """Run the row-sharded loop: each rank its rows, no collective inside
    the loop, one all-gather of Θ at the end."""
    run = awp_prune_rowsharded_fn(k, eta, iters)
    if rules.mesh is None:
        return run(full_tensor(w), full_tensor(c))
    mesh = rules.mesh
    axes = rowsharded_axes(rules, w.shape[0])
    c = local_block(c, mesh, P(None, None))          # C replicated
    if not axes:
        return run(local_block(w, mesh, P(None, None)), c)
    theta_loc = run(local_block(w, mesh, P(axes, None)).contiguous(), c)
    return _gather(theta_loc, mesh, P(axes, None))


def awp_prune_colsharded_fn(k: int, eta, iters: int, rules: ShardingRules):
    """The column-sharded PGD loop. Layout: W and Θ rows over the batch
    axes and d_in over "model"; C's rows (d_in) over "model". Per
    iteration one all-reduce of the (r_loc, d_in) partial product and one
    all-gather of Θ along d_in."""
    mesh = rules.mesh
    assert mesh is not None and rules.tp_axis is not None
    tp = rules.tp_axis
    dp = tuple(rules.batch_axes)
    topk = impl("topk_row")

    def fn(w, c):
        n_tp, my = rules.axis_size(tp), mesh_coord(mesh, (tp,))
        w_loc = local_block(w, mesh, P(dp, tp)).contiguous()
        c_loc = local_block(c, mesh, P(tp, None)).to(torch.float32) \
            .contiguous()
        k_loc = c_loc.shape[0]
        group = mesh.get_group(tp)

        def gather_cols(t):
            parts = [torch.empty_like(t) for _ in range(n_tp)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=1)

        def col_slice(z_full):
            return z_full[:, my * k_loc:(my + 1) * k_loc].contiguous()

        theta_loc = col_slice(topk(gather_cols(w_loc), k))
        for _ in range(iters):
            resid = w_loc - theta_loc                       # (r_loc, k_loc)
            z_resid = resid.to(torch.float32) @ c_loc       # (r_loc, d_in)
            dist.all_reduce(z_resid, group=group)
            z = gather_cols(theta_loc) + eta * z_resid
            theta_loc = col_slice(topk(z, k))
        return _gather(theta_loc, mesh, P(dp, tp))

    return fn


def calib_c_distributed(acts: torch.Tensor,
                        rules: ShardingRules) -> torch.Tensor:
    """C = (1/n)XᵀX with tokens (dim 0) sharded over the batch axes: a
    local XᵀX and one all-reduce per batch axis — the only collective of
    calibration."""
    if rules.mesh is None:
        acts = full_tensor(acts)
        a = acts.reshape(-1, acts.shape[-1]).to(torch.float32)
        return a.T @ a / a.shape[0]
    mesh, dp = rules.mesh, tuple(rules.batch_axes)
    a_loc = local_block(acts, mesh, P(dp, *[None] * (acts.dim() - 1)))
    a = a_loc.reshape(-1, a_loc.shape[-1]).to(torch.float32)
    c_sum = a.T @ a
    n = torch.tensor(float(a.shape[0]), dtype=torch.float32, device=a.device)
    for ax in dp:
        dist.all_reduce(c_sum, group=mesh.get_group(ax))
        dist.all_reduce(n, group=mesh.get_group(ax))
    return c_sum / n


__all__ = ["awp_prune_colsharded_fn", "awp_prune_rowsharded",
           "awp_prune_rowsharded_fn", "calib_c_distributed",
           "rowsharded_axes"]
