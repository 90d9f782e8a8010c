"""Rematerialisation (``RuntimeFlags.remat``, ``models.remat``): the
port's loss and every gradient under ``remat="full"`` and ``"dots"`` are
bitwise those of its own ``remat="none"``, and within the training
tolerances of ``jax.value_and_grad`` of the reference's loss under the
same ``remat``; the layers really are recomputed.

gemma-2b-smoke (a layer a unit), gemma2-9b-smoke (Gemma2's local/global
pair a unit, ``alt_window``), zamba2-smoke (each group of Mamba2 blocks
with the shared attention, and each tail block) and xlstm-125m-smoke
(each block): weights drawn with numpy (``convert.numpy_params``), the
batch from ``make_batch`` (B 2, S 40), float32, the loss in 2 chunks.
Against JAX: the loss at rtol 1e-6 and each gradient leaf within 5e-6
(transformer) or 3e-5 (hybrid, ssm) of its largest magnitude, the
tolerances of ``tests/test_torch_train_loss.py`` and
``tests/test_torch_train_ssm.py``.  The recomputation is counted at the
plain forwards of the kernel ops (``flash_attention``'s ``_attend``,
``ssm_scan``'s ``linear_scan_fwd_ref``), which the ops run on the CPU
(through their ``autograd.Function``s under autograd): the count doubles
under checkpointing.  What "dots" saves is counted at the products the
backward runs: those without batch dimensions (``aten.mm``, ``addmm``, or
a ``bmm`` over a batch of one) as often as without remat, the batched
ones (the attention's) again.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssm_scan import ref as scan_ref
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models.params import tree_leaves, tree_unflatten

torch.set_num_threads(1)

ARCHS = ("gemma-2b", "gemma2-9b", "zamba2-7b", "xlstm-125m")
GRAD_REL = {"gemma-2b": 5e-6, "gemma2-9b": 5e-6, "zamba2-7b": 3e-5,
            "xlstm-125m": 3e-5}
LOSS_RTOL = 1e-6


def _flags(remat, cls=RuntimeFlags):
    return cls(attn_impl="naive", loss_chunks=2, compute_dtype="float32",
               remat=remat)


def _inputs(arch):
    model = build_model(get_smoke_config(arch))
    weights = convert.numpy_params(model.specs(), len(arch))
    batch = make_batch(model.cfg, "train", 2, 40, seed=3, step=0)
    return model, weights, batch


def _port(model, weights, batch, remat):
    leaves = [p.requires_grad_(True) for p in
              tree_leaves(convert.tree_from_numpy(weights, "cpu"))]
    loss, _ = model.loss(tree_unflatten(weights, leaves),
                         convert.tree_from_numpy(batch, "cpu"),
                         _flags(remat))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def _counting(monkeypatch):
    """Counts of the plain forwards of the kernel ops: {"flash", "scan"}."""
    counts = {"flash": 0, "scan": 0}
    for mod, name, key in ((flash_ref, "_attend", "flash"),
                           (scan_ref, "linear_scan_fwd_ref", "scan")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_none_and_matches_jax(arch, remat):
    model, weights, batch = _inputs(arch)
    loss0, grads0 = _port(model, weights, batch, "none")
    loss, grads = _port(model, weights, batch, remat)
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert (g is None and g0 is None) or torch.equal(g, g0)
    jm = jax_build(jax_smoke_config(arch))
    jflags = _flags(remat, JaxFlags)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, jflags)[0]))(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL[arch] * float(np.abs(w).max()))


# (arch, the counted op, its forward calls in one loss without remat)
_CALLS = (("gemma-2b", "flash", 2), ("gemma2-9b", "flash", 4),
          ("zamba2-7b", "flash", 2), ("zamba2-7b", "scan", 5),
          ("xlstm-125m", "scan", 2))


@pytest.mark.parametrize("arch,op,once", _CALLS)
def test_the_layers_are_recomputed(arch, op, once, monkeypatch):
    """Without remat each kernel op runs forward once a layer; under
    "full" and "dots" the backward runs it again (the transformer's
    "dots" saves only ``mm``/``addmm`` outputs, and the attention's output
    is none); the prefill never checkpoints."""
    model, weights, batch = _inputs(arch)
    counts = _counting(monkeypatch)
    for remat, factor in (("none", 1), ("full", 2), ("dots", 2)):
        counts[op] = 0
        _port(model, weights, batch, remat)
        assert counts[op] == factor * once, (remat, counts)
    counts[op] = 0
    with torch.no_grad():
        model.prefill(convert.tree_from_numpy(weights, "cpu"),
                      {"tokens": convert.tree_from_numpy(batch, "cpu")
                       ["tokens"]}, _flags("full"), 40)
    assert counts[op] == once


@pytest.mark.parametrize("arch,op,factor", [("gemma-2b", "flash", 1),
                                            ("gemma2-9b", "flash", 1),
                                            ("zamba2-7b", "scan", 2),
                                            ("xlstm-125m", "scan", 2)])
def test_other_values_behave_as_the_reference(arch, op, factor, monkeypatch):
    """A value other than none/dots/full: the reference's transformer
    ``_remat`` leaves the layer as it is; its zamba and xlstm checkpoint on
    any value but "none".  The port does the same, with the loss and
    gradients bitwise those of "none"."""
    model, weights, batch = _inputs(arch)
    counts = _counting(monkeypatch)
    loss0, grads0 = _port(model, weights, batch, "none")
    once = counts[op]
    counts[op] = 0
    loss, grads = _port(model, weights, batch, "offload")
    assert counts[op] == factor * once
    assert torch.equal(loss, loss0)
    assert all((g is None and g0 is None) or torch.equal(g, g0)
               for g, g0 in zip(grads, grads0))


class _Products(TorchDispatchMode):
    """Counts the products dispatched under it: "plain" those without
    batch dimensions, "batched" the rest."""

    PLAIN = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.PLAIN:
            self.counts["plain"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.counts["plain" if args[0].shape[0] == 1 else "batched"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b",
                                  "deepseek-v3-671b"])
def test_dots_saves_the_products_without_batch_dims(arch):
    """The reference's ``dots_with_no_batch_dims_saveable``: under "dots"
    the backward recomputes none of the products without batch dimensions
    (the attention projections, the MLP's, MLA's up-projections), so it
    runs as many as the backward without remat; "full" runs them again.
    The batched ones (the attention's scores and sums, the experts') are
    recomputed under both."""
    model, weights, batch = _inputs(arch)
    counts = {}
    for remat in ("none", "dots", "full"):
        leaves = [p.requires_grad_(True) for p in
                  tree_leaves(convert.tree_from_numpy(weights, "cpu"))]
        loss, _ = model.loss(tree_unflatten(weights, leaves),
                             convert.tree_from_numpy(batch, "cpu"),
                             _flags(remat))
        with _Products() as mode:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        counts[remat] = mode.counts
    assert counts["dots"]["plain"] == counts["none"]["plain"], counts
    assert counts["full"]["plain"] > counts["none"]["plain"], counts
    for remat in ("dots", "full"):
        assert counts[remat]["batched"] > counts["none"]["batched"], counts
