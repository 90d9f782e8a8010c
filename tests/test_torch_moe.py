"""The port's MoE feed-forward (``repro_torch.models.moe``) against
``repro.models.moe`` on the smoke configs of Mixtral-8x22B (softmax
router over the top 2 of 4 experts) and DeepSeek-V3 (sigmoid router, top
2 of 8, a shared expert).

One layer's weights are drawn with numpy (``convert.numpy_params``) and go
to both packages with the same tokens; the JAX side runs under jit, one
compile a setting.  ``moe_ffn``'s output is held at atol 1e-5 in float32
(the expert products are float32 on both sides), its router statistics
exactly (the expert indices) and at 1e-6 (the probabilities).  With a
small ``capacity_factor`` tokens are dropped: the set of dropped ``(token,
k)`` entries must be the JAX package's.  The reference's GShard einsum
dispatch (``impl="einsum"``) computes the same function as its gather
dispatch, which the port computes for both flags.  Router ties go to the
lower expert index, as ``jax.lax.top_k`` orders them.  Each case prints
the smallest gap between the k-th and the (k+1)-th router score, so that a
routing flip from a rounding difference can be told from a routing bug.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ATOL = 1e-5
ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_moe(cfg, impl, group_size):
    return jax.jit(functools.partial(jmoe.moe_ffn, cfg=cfg, impl=impl,
                                     group_size=group_size))


def _setup(arch, seed, b=2, s=24, **change):
    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **change)
    w = convert.numpy_params(tmoe.moe_specs(cfg.d_model, cfg, 1), seed)
    w = jax.tree.map(lambda a: a[0], w)                 # layer 0
    x = np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, w, x


def _margin(logits, cfg):
    """Smallest gap between the k-th and (k+1)-th score of a token."""
    sc = torch.sigmoid(logits) if cfg.router == "sigmoid" else logits
    top = torch.sort(sc, dim=-1, descending=True).values
    return float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())


def _run(cfg, jcfg, w, x, impl="gather", group_size=2048):
    ty, taux = tmoe.moe_ffn(convert.tree_from_numpy(w, "cpu"),
                            torch.as_tensor(x), cfg, impl=impl,
                            group_size=group_size)
    jy, jaux = _jax_moe(jcfg, impl, group_size)(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x))
    return ty, taux, jy, jaux


def _dropped(expert_idx, cfg, c):
    """The (group, entry) pairs the reference's capacity rule drops, from
    its own formula (``moe.py:101-106``) in numpy."""
    g = expert_idx.shape[0]
    flat = np.asarray(expert_idx).reshape(g, -1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    pos = np.take_along_axis(np.cumsum(onehot, 1) - 1, flat[..., None],
                             2)[..., 0]
    return {tuple(i) for i in np.argwhere(pos >= c)}


@pytest.mark.parametrize("arch,change,impl,group_size", [
    ("mixtral-8x22b", {}, "gather", 2048),
    ("deepseek-v3-671b", {}, "gather", 2048),
    # The JAX GShard einsum dispatch against the port's gather.
    ("mixtral-8x22b", {}, "einsum", 2048),
    ("deepseek-v3-671b", {}, "einsum", 2048),
    # Capacity 8 (the floor) for one group of 96 entries: 24 an expert
    # on average for Mixtral's 4, 12 for DeepSeek's 8; entries are dropped.
    ("mixtral-8x22b", dict(capacity_factor=0.25), "gather", 2048),
    ("deepseek-v3-671b", dict(capacity_factor=0.25), "gather", 2048),
    # 48 tokens in groups of 32 halve to 16: three groups.
    ("mixtral-8x22b", {}, "gather", 32),
])
def test_moe_ffn_matches_jax(arch, change, impl, group_size):
    cfg, jcfg, w, x = _setup(arch, len(arch) + len(change), **change)
    ty, taux, jy, jaux = _run(cfg, jcfg, w, x, impl, group_size)
    t = x.shape[0] * x.shape[1]
    s_g = min(group_size, t)
    while t % s_g:
        s_g //= 2
    logits = (torch.as_tensor(x).reshape(-1, s_g, cfg.d_model)
              @ torch.as_tensor(w["router"]))
    print(f"{arch} {change} {impl}: groups of {s_g}, smallest top-"
          f"{cfg.top_k} margin {_margin(logits, cfg):.3g}")
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_array_equal(taux["expert_idx"].numpy(),
                                  np.asarray(jaux["expert_idx"]))
    _close(taux["router_probs"], jaux["router_probs"], 1e-6)
    _close(ty, jy)
    # The dropped (token, k) entries are the reference's.
    c = tmoe._capacity(s_g, cfg)
    _, pos, keep = tmoe.dispatch_slots(taux["expert_idx"], cfg.n_experts, c)
    got = {tuple(i) for i in torch.nonzero(~keep).tolist()}
    assert got == _dropped(jaux["expert_idx"], cfg, c)
    if change:
        assert got, "the small capacity drops no entry"
    _close(tmoe.router_aux_loss(taux, cfg.n_experts),
           jmoe.router_aux_loss(jaux, cfg.n_experts), 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lower_index(arch):
    """Exact ties in the router's scores: the lower expert index comes
    first, as in ``jax.lax.top_k``, in ``_route`` and through
    ``moe_ffn`` with integer router logits."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    e = cfg.n_experts
    logits = np.zeros((2, 3, e), np.float32)
    logits[0, 0, [1, 3]] = 2.0                  # a tie for the top two
    logits[0, 1, [0, 2, e - 1]] = 1.5           # three tied for two places
    logits[1, 2] = 0.25                         # all tied
    ti, tg = tmoe._route(torch.as_tensor(logits), cfg)
    ji, jg = jmoe._route(jnp.asarray(logits), jcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-7)
    assert ti[0, 0].tolist() == [1, 3] and ti[0, 1].tolist() == [0, 2]
    assert ti[1, 2].tolist() == list(range(cfg.top_k))
    # Through the layer: integer tokens and router weights make the
    # logits exact integers in both packages, with ties at the top-k
    # boundary.
    _, _, w, x = _setup(arch, 7)
    rng = np.random.default_rng(7)
    w = dict(w, router=rng.integers(-2, 3, w["router"].shape).astype(
        np.float32))
    x = rng.integers(-2, 3, x.shape).astype(np.float32)
    ty, taux, jy, jaux = _run(cfg, jcfg, w, x)
    idx = taux["expert_idx"].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jaux["expert_idx"]))
    logits = torch.as_tensor(x).reshape(1, -1, cfg.d_model) @ \
        torch.as_tensor(w["router"])
    assert _margin(logits, cfg) == 0.0          # ties at the boundary
    score = np.take_along_axis(logits.numpy(), idx, -1)
    tied = score[..., 1:] == score[..., :-1]
    assert tied.any() and (idx[..., 1:] > idx[..., :-1])[tied].all()
    _close(ty, jy)
