"""AdamW with decoupled weight decay, global-norm clipping and the
warmup-cosine schedule — ``repro.optim.adamw`` in PyTorch.

Functional over trees of tensors (dicts, lists, tuples), as the
reference is over pytrees: state in, state out.  The moments are float32
whatever the parameters' dtype, and ``step`` is a 0-d int32 tensor on the
parameters' device, so the schedule and the bias corrections run there
without a host read.  ``global_norm`` is written as the reference writes
it: each leaf's sum of squares, then the sum of the stacked leaf sums.

``apply_updates(..., inplace=True)`` writes the new parameters and
moments into the given tensors leaf by leaf and returns them: the same
arithmetic, without a second copy of the parameters and moments (30 GB at
gemma-2b's 2.51 B float32 parameters); it stands for the reference
launcher's ``donate_argnums``.

On a sharded state (DTensor leaves, the moments placed as their
parameters) the global norm is DTensor's sum over the shards, and the
update, elementwise, runs on each rank's local shards with the schedule's
scalars as plain tensors: the arithmetic of each entry is the unsharded
one, without DTensor's dispatch for each of a leaf's dozen operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: object             # first moment (tree, float32)
    nu: object             # second moment (tree, float32)
    step: torch.Tensor     # 0-d int32


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt(params) -> OptState:
    device = tree_leaves(params)[0].device
    return OptState(mu=tree_map(_zeros_f32, params),
                    nu=tree_map(_zeros_f32, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def warmup_cosine(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an integer tensor): linear warmup,
    then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _local(x):
    """A replicated DTensor scalar's value as a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _upd_shards(upd, p, g, m, v):
    """``upd`` on the local shards of DTensor leaves placed alike (a
    gradient still on other placements is reduced onto its parameter's
    first); results wrapped back on ``p``'s placements (the given DTensors
    themselves where ``upd`` wrote in place)."""
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    if not tuple(p.placements) == tuple(m.placements) == tuple(v.placements):
        raise ValueError("AdamW on a sharded state: the moments must be "
                         "placed as their parameters (state_shardings)")
    leaves = (p, m, v)
    local = [x.to_local() for x in leaves]
    out = upd(local[0], g.to_local(), local[1], local[2])
    return tuple(x if o is lo else DTensor.from_local(
        o, x.device_mesh, x.placements, shape=x.shape, stride=x.stride())
        for o, lo, x in zip(out, local, leaves))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, *,
                  inplace: bool = False):
    """One AdamW step.  Returns (new_params, new_state, {"grad_norm",
    "lr"}).  The gradients are clipped leaf by leaf as the step reaches
    them (the arithmetic of :func:`clip_by_global_norm`)."""
    gn = _local(global_norm(grads))
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, _local(step))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** _local(step).to(torch.float32)
    bc2 = 1 - b2 ** _local(step).to(torch.float32)

    def upd(p, g, m, v):
        if isinstance(p, DTensor):
            return _upd_shards(upd, p, g, m, v)
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if not inplace:
            return p_new, m_new, v_new
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_params, OptState(new_mu, new_nu, step), {"grad_norm": gn,
                                                        "lr": lr}
