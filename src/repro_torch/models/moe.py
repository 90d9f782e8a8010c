"""Mixture-of-Experts feed-forward with capacity-based gather dispatch —
``repro.models.moe`` in PyTorch.

Tokens are reshaped into ``G`` groups; within a group each token's top-k
experts get a slot in a per-(group, expert) capacity buffer, in the
running order of the flattened ``(token, k)`` entries, token-major.  A
slot at or past the capacity is dropped.  Dispatch and combine are
gathers driven by an index map, as in the reference's ``_gather_moe``;
the reference's GShard one-hot einsum (``impl="einsum"``) computes the
same function and is kept there for comparison, so the port accepts the
flag and computes the gather form.

The expert products are plain batched float32 products (the reference
computes them outside any Pallas kernel), over the experts axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act, mlp, mlp_specs
from repro_torch.models.params import spec
from repro_torch.shard.api import constrain
from repro_torch.shard.local import any_dtensor, run_local

__all__ = ["moe_specs", "moe_ffn", "router_aux_loss"]


def moe_specs(d: int, cfg, layers: int):
    p = {"router": spec((layers, d, cfg.n_experts),
                        ("layers", "embed", "experts"), std=d ** -0.5),
         "experts": mlp_specs(d, cfg.moe_d_ff, cfg.act, layers=layers,
                              experts=cfg.n_experts)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(d, cfg.n_shared_experts * cfg.moe_d_ff,
                                cfg.act, layers=layers)
    return p


def _capacity(s_g: int, cfg) -> int:
    c = int(math.ceil(s_g * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)                    # multiple of 8, >= 8


def _top_k(x, k: int):
    """The ``k`` largest of the last axis, largest first, and their
    indices, with ties to the lower index (``jax.lax.top_k``'s order,
    which ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, cfg):
    """logits [.., E] (float32) -> (expert_idx [.., K], gates [.., K])."""
    if cfg.router == "sigmoid":                      # DeepSeek-V3 style
        g, idx = _top_k(torch.sigmoid(logits), cfg.top_k)
        gates = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    else:
        top, idx = _top_k(logits, cfg.top_k)
        gates = torch.softmax(top, dim=-1)
    return idx, gates


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous copy of its
    gradient.  The expert products' outputs are permuted views of a bmm
    over the experts; on a mesh their gradients keep that layout on each
    rank while the DTensor's own strides say contiguous, and the product's
    backward, a view, fails on them.  The copy changes no value."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


def _dense_grad(x):
    """``x`` through :class:`_DenseGrad` when it is a DTensor; a plain
    tensor's gradient is already contiguous and goes on uncopied."""
    return _DenseGrad.apply(x) if any_dtensor(x) else x


def _expert_mlp(pe, xe, act):
    """xe [G, E, C, D] through the per-expert MLP weights [E, D, F]."""
    h = _dense_grad(torch.einsum("gecd,edf->gecf", xe, pe["up"]))
    if "gate" in pe:
        h = h * _act(_dense_grad(torch.einsum("gecd,edf->gecf", xe,
                                              pe["gate"])), act)
    else:
        h = _act(h, act)
    return torch.einsum("gecf,efd->gecd", h, pe["down"])


def moe_ffn(p, x, cfg, *, impl: str = "gather", group_size: int = 2048):
    """MoE FFN.  x [B, S, D]; ``p`` the layer's MoE parameters.  The group
    size halves until it divides the token count.  ``impl`` is the
    reference's dispatch style; both of its forms compute this function,
    and the port always gathers.

    Returns (y [B, S, D], aux: ``router_probs`` [G, S_g, E] and
    ``expert_idx`` [G, S_g, K] for :func:`router_aux_loss`)."""
    del impl
    b, s, d = x.shape
    t = b * s
    s_g = min(group_size, t)
    while t % s_g:
        s_g //= 2
    g = t // s_g
    xt = constrain(x.reshape(g, s_g, d), ("moe_groups", None, None))
    logits = (xt @ p["router"]).to(torch.float32)            # [G, S_g, E]
    expert_idx, gates = _route(logits, cfg)                  # [G, S_g, K]
    y = _gather_moe(p, xt, expert_idx, gates, cfg, _capacity(s_g, cfg))
    y = y.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg.act)
    aux = {"router_probs": torch.softmax(logits, -1),
           "expert_idx": expert_idx}
    return y, aux


def dispatch_slots(expert_idx, n_experts: int, c: int):
    """Each ``(token, k)`` entry's slot in its expert's capacity buffer.

    expert_idx [G, S_g, K].  Returns (flat_e [G, N], pos [G, N], keep
    [G, N]) over N = S_g·K entries in token-major order: ``pos`` is the
    entry's rank among the group's entries routed to the same expert, and
    ``keep`` is ``pos < c``."""
    g = expert_idx.shape[0]
    flat_e = expert_idx.reshape(g, -1)                       # [G, N]
    onehot = F.one_hot(flat_e, n_experts)                    # [G, N, E]
    pos = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    return flat_e, pos, pos < c


# The [G, E, C, D] expert buffers: groups on the data axes, experts on
# the model axis.
_BUFFER_AXES = ("moe_dispatch", "experts_act", None, None)


def _dispatch(xt, expert_idx, gates, e: int, c: int):
    """Each group's expert buffers: (xe [G, E·C, D], each (token, k)
    entry's slot [G, N] and its weight [G, N])."""
    g, s_g, d = xt.shape
    k = expert_idx.shape[-1]
    n = s_g * k
    flat_e, pos, keep = dispatch_slots(expert_idx, e, c)
    # Index map (g, e, c) -> source token row; s_g is the zero row.  The
    # kept entries' slots are distinct and in range, so their writes are
    # deterministic; a dropped entry writes a spare last slot that is cut
    # off (a write of every entry: no shape hangs on the data).
    token = torch.arange(n, device=xt.device) // k
    row = (torch.arange(g, device=xt.device)[:, None] * (e * c)
           + flat_e * c + pos)                               # [G, N]
    row = torch.where(keep, row, g * e * c)
    src = torch.full((g * e * c + 1,), s_g, dtype=torch.int64,
                     device=xt.device)
    src = src.index_put((row.reshape(-1),),
                        token.expand(g, n).reshape(-1))[:-1]
    x_pad = torch.cat([xt, xt.new_zeros((g, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, src.view(g, e * c, 1).expand(g, e * c, d))
    # A dropped entry reads a clamped slot and weighs it by 0.
    slot = flat_e * c + torch.clamp(pos, max=c - 1)
    w = gates.reshape(g, n) * keep
    return xe, slot, w


def _combine(ye, slot, w, k: int):
    """Each (token, k) entry reads its slot of ye [G, E, C, D] and mixes by
    its gate -> [G, S_g, D]."""
    g, e, c, d = ye.shape
    n = slot.shape[1]
    out = torch.gather(ye.reshape(g, e * c, d), 1,
                       slot[..., None].expand(g, n, d))      # [G, N, D]
    return (out * w.to(out.dtype)[..., None]).reshape(g, n // k, k, d).sum(
        dim=2)


def _gather_moe(p, xt, expert_idx, gates, cfg, c):
    """The gather dispatch.  Under a mesh the dispatch and the combine run
    on each rank's groups (``moe_dispatch``); the expert MLP runs on the
    experts' shards (``experts_act``)."""
    g, s_g, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    groups = ("moe_dispatch", None, None)
    if any_dtensor(xt):
        xe, slot, w = run_local(
            "moe_dispatch", lambda *a: _dispatch(*a, e, c),
            [(xt, groups), (expert_idx, groups), (gates, groups)],
            heads=(None,) * 3, outputs=((0, None),) * 3)
    else:
        xe, slot, w = _dispatch(xt, expert_idx, gates, e, c)
    xe = constrain(xe.view(g, e, c, d), _BUFFER_AXES)
    ye = constrain(_expert_mlp(p["experts"], xe, cfg.act), _BUFFER_AXES)
    if any_dtensor(ye):
        return run_local(
            "moe_combine", lambda *a: _combine(*a, k),
            [(ye, ("moe_dispatch", None, None, None)),
             (slot, ("moe_dispatch", None)), (w, ("moe_dispatch", None))],
            heads=(None,) * 3, outputs=((0, None),))
    return _combine(ye, slot, w, k)


def router_aux_loss(aux, n_experts: int):
    """Switch-style load-balance loss: E · Σ_e f_e · P_e."""
    probs = aux["router_probs"]                              # [G, S, E]
    f = F.one_hot(aux["expert_idx"], n_experts).to(
        torch.float32).mean(dim=(0, 1, 2))                   # fraction routed
    pm = probs.mean(dim=(0, 1))
    return n_experts * torch.sum(f * pm)
