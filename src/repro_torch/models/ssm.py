"""Mamba2 (SSD) blocks and the chunked linear scan — ``repro.models.ssm``
in PyTorch.

``chunked_linear_scan`` is the ``ssm_scan`` op's entry with the final
state: the CUDA kernel (``csrc/ssm_scan.cu``) for CUDA tensors, the plain
version (``kernels/ssm_scan/ref.py``) for CPU tensors; with gradients on,
its backward is ``csrc/ssm_scan_bwd.cu`` on the card.  ``mamba2_decode``
is one recurrent step in plain PyTorch; no TPU kernel covers it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import linear_scan
from repro_torch.models.layers import causal_conv1d, rmsnorm, rmsnorm_spec
from repro_torch.models.params import spec
from repro_torch.shard.api import constrain

__all__ = ["chunked_linear_scan", "mamba2_specs", "mamba2_block",
           "mamba2_decode", "mamba2_state_shapes"]


# The op with the final state: k [B,L,H,N], v [B,L,H,P], q [B,L,H,N],
# log_decay/gate [B,L,H], any L -> (y [B,L,H,P], final_state [B,H,N,P]).
chunked_linear_scan = linear_scan


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh


def mamba2_specs(cfg, layers: int):
    d = cfg.d_model
    d_in, nh = _dims(cfg)
    st = cfg.ssm_state
    ll = ("layers",)
    conv_ch = d_in + 2 * st
    return {
        "in_proj": spec((layers, d, 2 * d_in + 2 * st + nh),
                        ll + ("embed", "ssm_inner")),
        "conv": spec((layers, conv_ch, cfg.ssm_conv),
                     ll + ("ssm_inner", "conv"), std=0.5),
        "a_log": spec((layers, nh), ll + (None,), init="zeros"),
        "d_skip": spec((layers, nh), ll + (None,), init="ones"),
        "dt_bias": spec((layers, nh), ll + (None,), init="zeros"),
        "norm": rmsnorm_spec(d_in, layers),
        "out_proj": spec((layers, d_in, d), ll + ("ssm_inner", "embed")),
    }


def _mamba2_inputs(p, x, cfg, conv_state=None):
    d_in, nh = _dims(cfg)
    st = cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * st, nh], dim=-1)
    xbc, new_conv = causal_conv1d(p["conv"], xbc, conv_state)
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [d_in, st, st], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # [B,L,nh]
    a = -torch.exp(p["a_log"].to(torch.float32))                 # [nh]
    xs = xs.reshape(xs.shape[:2] + (nh, cfg.ssm_head_dim))
    return z, xs, bm, cm, dt, a, new_conv


def mamba2_block(p, x, cfg):
    """Prefill forward.  x [B,L,D] -> ([B,L,D], final state dict).

    B and C go to the scan broadcast over the heads (a head stride of 0),
    and the head-split values as a view of the conv output: the kernel
    reads both through their strides.
    """
    b, l, _ = x.shape
    d_in, nh = _dims(cfg)
    z, xs, bm, cm, dt, a, new_conv = _mamba2_inputs(p, x, cfg)
    log_decay = dt * a[None, None, :]                 # [B,L,nh]
    k = bm[:, :, None, :].expand(b, l, nh, cfg.ssm_state)
    q = cm[:, :, None, :].expand(b, l, nh, cfg.ssm_state)
    y, s_fin = chunked_linear_scan(k, xs, q, log_decay, dt,
                                   chunk=min(cfg.ssm_chunk, l))
    y = y + p["d_skip"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, l, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = constrain(y, ("batch", "act_seq", "act_ffn"))
    return y @ p["out_proj"], {"conv": new_conv, "ssm": s_fin.to(x.dtype)}


def mamba2_state_shapes(cfg, batch: int):
    d_in, nh = _dims(cfg)
    conv_ch = d_in + 2 * cfg.ssm_state
    return {"conv": (batch, cfg.ssm_conv - 1, conv_ch),
            "ssm": (batch, nh, cfg.ssm_state, cfg.ssm_head_dim)}


def mamba2_decode(p, x, cfg, state):
    """Single-token recurrent step.  x [B,1,D]; state dict(conv, ssm)."""
    b = x.shape[0]
    d_in, nh = _dims(cfg)
    z, xs, bm, cm, dt, a, new_conv = _mamba2_inputs(
        p, x, cfg, conv_state=state["conv"])
    dt1 = dt[:, 0]                                    # [B,nh]
    decay = torch.exp(dt1 * a[None, :])               # [B,nh]
    # S <- decay·S + dt·B x^T ;  y = C·S  (state [B,nh,N,P])
    s = state["ssm"].to(torch.float32)
    outer = torch.einsum("bn,bhp->bhnp", bm[:, 0].to(torch.float32),
                         xs[:, 0].to(torch.float32)) * dt1[:, :, None, None]
    s = s * decay[..., None, None] + outer
    y = torch.einsum("bn,bhnp->bhp", cm[:, 0].to(torch.float32), s)
    y = y + p["d_skip"][None, :, None] * xs[:, 0].to(torch.float32)
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], {"conv": new_conv,
                               "ssm": s.to(state["ssm"].dtype)}
