"""The port's training loss and every parameter's gradient against
``jax.value_and_grad`` of ``repro.models.transformer.transformer_loss``.

Four smoke configs: gemma-2b (MQA, tied and scaled embeddings),
gemma2-9b (the attention softcap, alternating windows of 8 under a
24-token batch, the final-logit softcap, post-norms), mixtral-8x22b (the
MoE's router loss in ``aux``, a window of 16) and hubert-xlarge (the
masked-unit CE, non-causal attention).  The weights are drawn with numpy
(``convert.numpy_params``) and go to both packages, as do ``make_batch``'s
arrays (B 2, S 24), in float32 with the loss in 2 chunks (the port's
checkpointed chunks).  The loss, ``ce`` and ``aux`` are held at rtol
1e-6, and each gradient leaf at 5e-6 of its largest magnitude (the two
packages sum in other orders; float32 keeps about 6e-8 a rounding).  On
the CPU the attention's gradient is the plain backward through
``kernels.flash_attention.ops.FlashAttention``.  The hybrid and ssm
families' losses are held in ``tests/test_torch_train_ssm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models.params import tree_leaves, tree_unflatten

torch.set_num_threads(1)

ARCHS = ("gemma-2b", "gemma2-9b", "mixtral-8x22b", "hubert-xlarge")
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=2, compute_dtype="float32")
LOSS_RTOL, GRAD_REL = 1e-6, 5e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg, jm = get_smoke_config(arch), jax_build(jax_smoke_config(arch))
    model = build_model(cfg)
    weights = convert.numpy_params(model.specs(), len(arch))
    batch = make_batch(cfg, "train", 2, 24, seed=3, step=0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, JFLAGS), has_aux=True))(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    leaves = [p.requires_grad_(True) for p in
              tree_leaves(convert.tree_from_numpy(weights, "cpu"))]
    loss, met = model.loss(tree_unflatten(weights, leaves),
                           convert.tree_from_numpy(batch, "cpu"), FLAGS)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert set(met) == set(jmet) == {"ce", "aux"}
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_RTOL)
    if cfg.is_moe:
        assert float(met["aux"].detach()) > 0
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b",
                                  "zamba2-7b", "xlstm-125m"])
def test_cache_axes_abstract_and_axes_match_jax(arch):
    """``Model.cache_axes`` equals the reference's and mirrors
    ``cache_shapes``' tree; ``abstract`` gives each parameter's shape and
    dtype on the meta device; ``axes`` each one's logical axis names."""
    cfg, jm = get_smoke_config(arch), jax_build(jax_smoke_config(arch))
    model = build_model(cfg)
    assert model.cache_axes() == jm.cache_axes()
    abstract = model.abstract(torch.bfloat16)
    jabs = jax.tree.leaves(jm.abstract(jnp.bfloat16))
    assert [tuple(t.shape) for t in tree_leaves(abstract)] == \
        [a.shape for a in jabs]
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(abstract))
    jaxes = jax.tree.leaves(jm.axes(), is_leaf=lambda x: isinstance(x, tuple))
    axes = tree_leaves_axes(model.axes())
    assert axes == jaxes


def tree_leaves_axes(tree):
    """The axis tuples of ``Model.axes()`` in ``jax.tree`` order (a tuple
    of names is a leaf there)."""
    if isinstance(tree, dict):
        return [a for _, v in sorted(tree.items())
                for a in tree_leaves_axes(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in tree_leaves_axes(v)]
    return [tree]
