"""Train and serve step factories — ``repro.train.step``.

``make_train_step`` builds the reference's training step:

* microbatched gradient accumulation (``flags.microbatches``): the batch
  is cut along its first axis (a VLM's [3, B, S] position ids along B),
  each microbatch's gradients come from ``torch.autograd.grad`` over the
  parameter leaves and are added into float32 sums in microbatch order,
  then divided by the count, as the reference's ``lax.scan`` does;
* optional int8 error-feedback compression (``flags.grad_compress``);
* AdamW with warmup-cosine and the global-norm clip.

The step is functional, state in and state out, like the reference's.
With ``donate=True`` it writes the new parameters and moments into the
state's tensors (the reference launcher's ``donate_argnums=(0,)``), which
spares a copy of them; the numbers are the same.

With a ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_mesh``) and
``rules`` (``shard.make_rules``) the step runs on DTensors: the state as
``state_shardings`` places it (ZeRO: the moments follow the parameters,
the compression residual too), the batch as ``batch_shardings`` places
it, the body under ``shard.activation_ctx`` so that the models'
``constrain`` calls and the kernel ops see the rules.  Each microbatch's
gradients are reduced onto their parameters' placements as they come,
and the metrics come back as plain replicated tensors.  On a mesh whose
axes all have size 1 every spec is replicated and the step computes what
the unsharded one does, bit for bit.

``make_serve_step`` builds the greedy prefill and decode closures, under
the same context when given a mesh.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.compression import compress_with_feedback
from repro_torch.models.params import (spec_leaves, tree_leaves, tree_map,
                                       tree_unflatten, unflatten)
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     init_opt)
from repro_torch.shard.api import activation_ctx, constrain, sharding_for

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "loss_and_grads", "abstract_state", "make_serve_step",
           "state_shardings", "batch_shardings", "distribute", "full",
           "mesh_context"]


class TrainState(NamedTuple):
    params: object
    opt: OptState
    residual: object      # int8-compression error feedback (or () if off)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_state(model, generator: torch.Generator,
                     opt_cfg: AdamWConfig, flags, dtype=torch.float32,
                     device="cuda") -> TrainState:
    """Parameters drawn from ``generator`` on ``device`` (the card unless
    asked), zero moments and, with ``grad_compress``, zero residuals."""
    del opt_cfg
    params = model.init(generator, dtype, device)
    residual = tree_map(_zeros_f32, params) if flags.grad_compress else ()
    return TrainState(params, init_opt(params), residual)


def abstract_state(model, flags, dtype=torch.bfloat16) -> TrainState:
    """The TrainState's shapes and dtypes on the ``meta`` device (no
    storage)."""
    params = model.abstract(dtype)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    opt = OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                   step=torch.empty((), dtype=torch.int32, device="meta"))
    residual = tree_map(f32, params) if flags.grad_compress else ()
    return TrainState(params, opt, residual)


def state_shardings(model, flags, mesh, rules) -> TrainState:
    """The ``NamedSharding`` tree matching a TrainState: each parameter by
    its spec's logical axes; ZeRO: the moments follow the parameters, and
    so does the compression residual (with ``grad_compress``); the step
    counter is replicated."""
    specs = model.specs()
    p_sh = unflatten([(path, sharding_for(s.shape, s.axes, rules, mesh))
                      for path, s in spec_leaves(specs)], specs)
    opt = OptState(mu=p_sh, nu=p_sh, step=sharding_for((), (), rules, mesh))
    return TrainState(p_sh, opt, p_sh if flags.grad_compress else ())


def _batch_axes(x) -> tuple:
    """A batch leaf's logical axes: "batch" first, [3, B, S] position ids
    on B."""
    if x.ndim == 3 and x.shape[0] == 3:
        return (None, "batch", None)
    return ("batch",) + (None,) * (x.ndim - 1)


def batch_shardings(batch: dict, mesh, rules) -> dict:
    """The ``NamedSharding`` of each batch leaf: sharded on its batch
    dim."""
    return {k: sharding_for(x.shape, _batch_axes(x), rules, mesh)
            for k, x in batch.items()}


def distribute(tree, shardings):
    """Each leaf of ``tree`` (the full value, the same on every rank) as
    the DTensor of the matching sharding in ``shardings``."""
    return tree_map(lambda t, sh: sh.distribute(t), tree, shardings)


def full(tree):
    """Each DTensor leaf gathered to its full value (a collective: every
    rank calls it); other leaves as they are."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


@contextlib.contextmanager
def mesh_context(mesh, rules):
    """The steps' context: nothing without a mesh; with one, the
    activation rules, and plain tensors made inside a step (position ids,
    masks, constants) taken as replicated."""
    if mesh is None:
        yield
        return
    with activation_ctx(mesh, rules), implicit_replication():
        yield


def _microbatch(batch: dict, k: int, i: int) -> dict:
    """Microbatch ``i`` of ``k``: the reference's split (a leaf whose
    first axis divides by k and is not 3 is cut along it; [3, B, S]
    position ids along B; anything else goes whole to every microbatch)."""
    out = {}
    for name, x in batch.items():
        if name == "positions" and x.ndim == 3 and x.shape[0] == 3:
            n = x.shape[1] // k
            out[name] = x[:, i * n:(i + 1) * n]
        elif x.ndim >= 1 and x.shape[0] % k == 0 and x.shape[0] != 3:
            n = x.shape[0] // k
            out[name] = x[i * n:(i + 1) * n]
        else:
            out[name] = x
        out[name] = constrain(out[name], _batch_axes(out[name]))
    return out


def _placed_like(g, p):
    """A DTensor gradient reduced onto its parameter's placements (the
    data-parallel sum)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _grads(model, flags, params, batch):
    """(loss, metrics, float32 gradient leaves) of one (micro)batch; on a
    mesh each gradient on its parameter's placements."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch,
                                   flags)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
             else _placed_like(g.to(torch.float32), p)
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def loss_and_grads(model, flags, params, batch):
    """(loss, metrics, grads) of one step's batch with the reference's
    microbatch accumulation: the float32 gradient sums over the
    ``flags.microbatches`` microbatches divided by their count, the loss
    their mean; ``metrics`` are the loss's own (``ce``, ``aux``) with one
    microbatch and empty with several, as in the reference."""
    k = flags.microbatches
    if k <= 1:
        loss, metrics, grads = _grads(model, flags, params, batch)
        return loss, metrics, tree_unflatten(params, grads)
    g_sum = None
    l_sum = 0.0
    for i in range(k):
        loss, _, grads = _grads(model, flags, params,
                                _microbatch(batch, k, i))
        if g_sum is None:
            g_sum = [torch.zeros_like(g) for g in grads]
        for acc, g in zip(g_sum, grads):
            acc.add_(g)
        del grads
        l_sum = l_sum + loss
    for acc in g_sum:
        acc.div_(k)
    return l_sum / k, {}, tree_unflatten(params, g_sum)


def make_train_step(model, flags, opt_cfg: AdamWConfig, mesh=None,
                    rules=None, *, donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics): ``loss``,
    ``grad_norm`` and ``lr`` (with one microbatch also ``ce`` and
    ``aux``), 0-d tensors on the state's device.  With ``mesh`` and
    ``rules`` the state and batch are DTensors (``state_shardings``,
    ``batch_shardings``) and the metrics plain replicated tensors."""

    def train_step(state: TrainState, batch):
        with mesh_context(mesh, rules):
            loss, metrics, grads = loss_and_grads(model, flags, state.params,
                                                  batch)
            residual = state.residual
            if flags.grad_compress:
                grads, residual = compress_with_feedback(grads, residual)
            params, opt, om = apply_updates(state.params, grads, state.opt,
                                            opt_cfg, inplace=donate)
            metrics = full(dict(metrics, loss=loss, **om))
        return TrainState(params, opt, residual), metrics

    return train_step


def _greedy(logits):
    """The argmax token of each row.  On a mesh the vocab is gathered
    first and the argmax taken on each rank's rows: DTensor's own
    distributed argmax fails on a 2-D mesh that holds one row a rank."""
    logits = constrain(logits, ("batch",) + (None,) * (logits.ndim - 1))
    return torch.argmax(logits, dim=-1)


def make_serve_step(model, flags, mesh=None, rules=None):
    """Returns (prefill_fn, decode_fn), both greedy.

    prefill_fn(params, batch, cache_len) -> (next_tokens [B, 1], caches),
    ``batch`` the family's inputs (tokens; a VLM's ``vision_embeds`` and
    ``positions`` with them; an encoder's ``features`` and ``mask``, whose
    prefill gives a token for every position [B, S] and no cache);
    decode_fn(params, caches, tokens [B, 1], pos) -> (next_tokens [B, 1],
    caches) — one new token per sequence against the standing cache.
    With ``mesh`` and ``rules`` both run under the rules on DTensor
    parameters and inputs, and the caches they make are DTensors.
    """

    def prefill(params, batch, cache_len):
        with mesh_context(mesh, rules):
            logits, caches = model.prefill(params, batch, flags, cache_len)
            return _greedy(logits), caches

    def decode(params, caches, tokens, pos):
        with mesh_context(mesh, rules):
            logits, new_caches = model.decode(params, caches, tokens, pos,
                                              flags)
            return _greedy(logits), new_caches

    return prefill, decode
