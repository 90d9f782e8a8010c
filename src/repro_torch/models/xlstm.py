"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) —
``repro.models.xlstm`` in PyTorch.

The mLSTM is a gated linear recurrence — C_t = f_t·C_{t-1} + i_t·k_t v_tᵀ,
h_t = (C_t q_t) / max(|n_t·q_t|, 1) — so its prefill runs the ``ssm_scan``
op (``models.ssm.chunked_linear_scan``: the CUDA kernel for CUDA tensors)
with the normalizer n carried as an extra value column (v gets a ones
column: P = hd + 1).  ``mlstm_decode`` is one recurrent step in plain
PyTorch, as ``mamba2_decode`` is: no TPU kernel covers it.  The sLSTM has
no parallel form; the reference runs it as a ``lax.scan`` over time and
the port as a Python loop of ``_slstm_cell`` (plain PyTorch: no TPU kernel
computes it either), with the paper's exponential-gating stabilizer m.

The reference's simplifications are kept: the forget gate is sigmoid (so
log-decay <= 0), the input gate exponent is clipped at 8, and per-block
RMSNorms replace the original's multi-head GroupNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv1d, mlp, mlp_specs,
                                       project, rmsnorm, rmsnorm_spec, wide)
from repro_torch.models.params import spec
from repro_torch.models.ssm import chunked_linear_scan
from repro_torch.shard.local import elementwise

__all__ = ["mlstm_specs", "mlstm_block", "mlstm_decode", "mlstm_state_shapes",
           "slstm_specs", "slstm_block", "slstm_decode", "slstm_state_shapes"]

_ICLIP = 8.0


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def _mdims(cfg):
    d_in = 2 * cfg.d_model            # proj factor 2 (xLSTM paper)
    hd = d_in // cfg.n_heads
    return d_in, cfg.n_heads, hd


def mlstm_specs(cfg):
    d = cfg.d_model
    d_in, nh, hd = _mdims(cfg)
    return {
        "norm": rmsnorm_spec(d),
        "up": spec((d, 2 * d_in), ("embed", "ffn")),
        "conv": spec((d_in, cfg.ssm_conv or 4), ("ffn", "conv"), std=0.5),
        "wq": spec((d_in, d_in), ("ffn", "ssm_inner")),
        "wk": spec((d_in, d_in), ("ffn", "ssm_inner")),
        "wv": spec((d_in, d_in), ("ffn", "ssm_inner")),
        "wi": spec((d_in, nh), ("ffn", None), std=0.01),
        "wf": spec((d_in, nh), ("ffn", None), std=0.01),
        "bi": spec((nh,), (None,), init="zeros"),
        "bf": spec((nh,), (None,), init="ones"),   # bias toward remembering
        "out_norm": rmsnorm_spec(d_in),
        "down": spec((d_in, d), ("ffn", "embed")),
    }


def _mlstm_gates(p, xc):
    """log forget (<= 0) and clipped-exp input gate.  xc [B,L,d_in] ->
    [B,L,nh] each, float32 (float64 for float64 inputs)."""
    logf = elementwise(F.logsigmoid, wide(xc @ p["wf"]) + p["bf"])
    i = torch.exp(torch.clamp_max(wide(xc @ p["wi"]) + p["bi"], _ICLIP))
    return logf, i


def _mlstm_qkv(p, cfg, xm, xc):
    d_in, nh, hd = _mdims(cfg)
    shp = xm.shape[:-1] + (nh, hd)
    q = (xc @ p["wq"]).reshape(shp)
    k = (xc @ p["wk"]).reshape(shp) * (hd ** -0.5)
    v = (xm @ p["wv"]).reshape(shp)
    return q, k, v


def _normalize(y_aug, hd):
    num, den = y_aug[..., :hd], y_aug[..., hd:]
    return num / torch.clamp_min(torch.abs(den), 1.0)


def _mlstm_in(p, x, cfg, conv_state=None):
    """The block's front: norm, up-projection, conv, q/k/v and gates."""
    h = rmsnorm(p["norm"], x, cfg.norm_eps) @ p["up"]
    xm, z = torch.chunk(h, 2, dim=-1)
    xc, new_conv = causal_conv1d(p["conv"], xm, conv_state)
    xc = F.silu(xc)
    q, k, v = _mlstm_qkv(p, cfg, xm, xc)
    logf, i = _mlstm_gates(p, xc)
    return z, q, k, v, logf, i, new_conv


def _mlstm_out(p, x, cfg, y, z):
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    return x + y @ p["down"]


def mlstm_block(p, x, cfg, state=None, unroll: bool = False):
    """x [B,L,D] -> ([B,L,D], state dict(conv, c)) — the chunk-parallel
    prefill through the ``ssm_scan`` op.  ``unroll`` is the reference's
    and is ignored."""
    del unroll
    b, l, _ = x.shape
    d_in, nh, hd = _mdims(cfg)
    z, q, k, v, logf, i, conv_state = _mlstm_in(
        p, x, cfg, None if state is None else state["conv"])
    ones = v.new_ones(v.shape[:-1] + (1,))           # normalizer column
    v_aug = torch.cat([v, ones], dim=-1)
    s0 = None if state is None else state["c"]
    y_aug, s_fin = chunked_linear_scan(k, v_aug, q, logf, i,
                                       chunk=min(cfg.ssm_chunk or 256, l),
                                       initial_state=s0)
    y = _normalize(y_aug, hd).reshape(b, l, d_in).to(x.dtype)
    return _mlstm_out(p, x, cfg, y, z), {"conv": conv_state, "c": s_fin}


def mlstm_state_shapes(cfg, batch: int):
    d_in, nh, hd = _mdims(cfg)
    return {"conv": (batch, (cfg.ssm_conv or 4) - 1, d_in),
            "c": (batch, nh, hd, hd + 1)}


def mlstm_decode(p, x, cfg, state):
    """One recurrent step in float32.  x [B,1,D]; state dict(conv, c)."""
    b = x.shape[0]
    d_in, nh, hd = _mdims(cfg)
    z, q, k, v, logf, i, conv_state = _mlstm_in(p, x, cfg, state["conv"])
    ones = v.new_ones(v.shape[:-1] + (1,), dtype=torch.float32)
    v_aug = torch.cat([v.to(torch.float32), ones], dim=-1)
    c = state["c"].to(torch.float32)                 # [B,nh,hd,hd+1]
    c = (c * torch.exp(logf[:, 0])[..., None, None]
         + i[:, 0][..., None, None] * k[:, 0].to(torch.float32)[..., None]
         * v_aug[:, 0][..., None, :])
    y_aug = torch.einsum("bhn,bhnp->bhp", q[:, 0].to(torch.float32), c)
    y = _normalize(y_aug, hd).reshape(b, 1, d_in).to(x.dtype)
    return _mlstm_out(p, x, cfg, y, z), {"conv": conv_state,
                                         "c": c.to(state["c"].dtype)}


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def _sdims(cfg):
    hd = cfg.d_model // cfg.n_heads
    return cfg.n_heads, hd


def slstm_specs(cfg):
    d = cfg.d_model
    nh, hd = _sdims(cfg)
    ff = -(-8 * d // 3 // 64) * 64                   # post-MLP, ~8d/3 gated
    return {
        "norm": rmsnorm_spec(d),
        "w_in": spec((d, 4, nh, hd), ("embed", None, "heads", "head_dim")),
        "r": spec((4, nh, hd, hd), (None, "heads", "head_dim", None),
                  std=0.02),
        "b": spec((4, nh, hd), (None, "heads", "head_dim"), init="zeros"),
        "out": spec((d, d), ("embed", "embed")),
        "mlp_norm": rmsnorm_spec(d),
        "mlp": mlp_specs(d, ff, "swiglu"),
    }


def _slstm_cell(p, pre_t, hcnm):
    """One timestep.  pre_t [B,4,nh,hd]; state (h, c, n, m) each [B,nh,hd]
    float32.  On the first step m = -inf: m_new = it is finite and
    exp(ft + m - m_new) = exp(-inf) = 0."""
    h, c, n, m = hcnm
    # h is float32; a bfloat16 r is promoted to it, as jnp.einsum does.
    rec = torch.einsum("bkd,gkde->bgke", h, p["r"].to(h.dtype))  # [B,4,nh,hd]
    zt, it, ft, ot = torch.unbind(wide(pre_t + rec + p["b"]), dim=1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    m_new = torch.maximum(ft + m, it)                # exp-gating stabilizer
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (h_new, c, n, m_new)


def _slstm_out(p, x, cfg, y):
    x = x + y @ p["out"]
    return x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps),
                   "swiglu")


def slstm_block(p, x, cfg, state=None):
    """x [B,L,D] -> ([B,L,D], state (h, c, n, m)) — a Python loop over
    time (the reference's ``lax.scan``)."""
    b, l, d = x.shape
    nh, hd = _sdims(cfg)
    xin = rmsnorm(p["norm"], x, cfg.norm_eps)
    pre = project(xin, p["w_in"], None)              # [B,L,4,nh,hd]
    if state is None:
        dt = torch.promote_types(x.dtype, torch.float32)
        zero = torch.zeros((b, nh, hd), dtype=dt, device=x.device)
        state = (zero, zero, zero, torch.full((b, nh, hd), -torch.inf,
                                              dtype=dt, device=x.device))
    hs = []
    for t in range(l):
        state = _slstm_cell(p, pre[:, t], state)
        hs.append(state[0])
    y = torch.stack(hs, dim=1).reshape(b, l, d).to(x.dtype)
    return _slstm_out(p, x, cfg, y), state


def slstm_state_shapes(cfg, batch: int):
    nh, hd = _sdims(cfg)
    return tuple((batch, nh, hd) for _ in range(4))


def slstm_decode(p, x, cfg, state):
    b, _, d = x.shape
    xin = rmsnorm(p["norm"], x, cfg.norm_eps)
    pre = project(xin, p["w_in"], None)[:, 0]
    state = _slstm_cell(p, pre, state)
    y = state[0].reshape(b, 1, d).to(x.dtype)
    return _slstm_out(p, x, cfg, y), state
