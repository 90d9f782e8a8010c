"""Plain PyTorch version of the chunked SSD scan — same contract as the
CUDA kernel in ``csrc/ssm_scan.cu``.

The PyTorch form of ``repro.models.ssm.chunked_linear_scan`` (the
reference's ``ssm_scan_ref``): the tail padded to a whole chunk with gate
0 and log-decay 0 (the state is untouched), the intra-chunk quadratic form
in the inputs' dtype with the decay-and-gate weights in float32, the
chunk summaries in float32 and a sequential loop over chunks for the
carried state.  It serves the CPU path and the tests; on the card it is
the kernel's yardstick (``chip_smoke.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear_scan_bwd_ref", "linear_scan_fwd_ref", "linear_scan_ref",
           "ssm_scan_ref", "three_phase_scan_ref"]


def linear_scan_ref(k, v, q, log_decay, gate, *, chunk: int,
                    initial_state=None):
    """Gated linear recurrence ``S_t = exp(ld_t)·S_{t-1} + g_t·k_t v_tᵀ``,
    ``y_t = q_t · S_t``, chunk-parallel.

    k, q [B, L, H, N]; v [B, L, H, P]; log_decay, gate [B, L, H];
    initial_state [B, H, N, P] or None (zeros).  Returns (y [B, L, H, P],
    final_state [B, H, N, P]) in float32 (float64 for float64 inputs).
    """
    return linear_scan_fwd_ref(k, v, q, log_decay, gate, chunk=chunk,
                               initial_state=initial_state)[:2]


def linear_scan_fwd_ref(k, v, q, log_decay, gate, *, chunk: int,
                        initial_state=None):
    """:func:`linear_scan_ref` with the state entering each chunk:
    (y, final_state, states [B, H, C, N, P]), states[:, :, c] = S_{c-1}
    (the initial state, or zeros, for c = 0), C = ceil(L / chunk).  The
    backward reads the states (:func:`linear_scan_bwd_ref`)."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    # float32 for float32 and bf16 inputs, as the reference computes; a
    # float64 call stays float64 throughout (the card's exact yardstick).
    acc = torch.promote_types(k.dtype, torch.float32)
    pad = (-l) % chunk
    if pad:                        # tail-pad: gate 0, decay 1 (state-neutral)
        k, v, q = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v, q))
        log_decay, gate = (F.pad(x, (0, 0, 0, pad))
                           for x in (log_decay, gate))
    nc = (l + pad) // chunk
    r = lambda x: x.reshape((b, nc, chunk) + tuple(x.shape[2:]))
    kc, vc, qc = r(k), r(v), r(q)
    ld = r(log_decay).to(acc)                        # [B,C,Q,H]
    g = r(gate).to(acc)

    # ---- intra-chunk (quadratic within the chunk) --------------------- #
    cum_t = torch.cumsum(ld.permute(0, 1, 3, 2), dim=-1)     # [B,C,H,Q]
    seg = cum_t[..., :, None] - cum_t[..., None, :]          # [B,C,H,Q,Q]
    ii = torch.arange(chunk, device=k.device)
    lower = ii[:, None] >= ii[None, :]
    decay_m = torch.exp(torch.where(lower, seg, float("-inf")))
    att = torch.einsum("bcihn,bcjhn->bchij", qc, kc)
    att = att * decay_m * g.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att.to(vc.dtype), vc)

    # ---- chunk summaries + sequential inter-chunk scan ----------------- #
    cum = torch.cumsum(ld, dim=2)                    # [B,C,Q,H]
    total = cum[:, :, -1, :]                         # [B,C,H]
    # state contribution of chunk c: sum_j exp(total - cum_j) g_j k_j v_j^T
    w_in = torch.exp(total[:, :, None, :] - cum) * g            # [B,C,Q,H]
    s_chunk = torch.einsum("bcqhn,bcqhp->bchnp",
                           w_in[..., None] * kc.to(acc), vc.to(acc))
    s = (torch.zeros((b, h, n, p), dtype=acc, device=k.device)
         if initial_state is None else initial_state.to(acc))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[..., None, None] + s_chunk[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)            # [B,C,H,N,P]

    # y_inter_i = exp(cum_i) * q_i · S_{prev chunk}
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", qc.to(acc),
                           s_prevs) * torch.exp(cum)[..., None]
    y = (y_intra.to(acc) + y_inter).reshape(b, nc * chunk, h, p)
    return y[:, :l], s, s_prevs.transpose(1, 2)


def ssm_scan_ref(k, v, q, log_decay, gate, *, chunk: int = 256):
    """y only, as ``repro.kernels.ssm_scan.ref.ssm_scan_ref``."""
    return linear_scan_ref(k, v, q, log_decay, gate, chunk=chunk)[0]


def three_phase_scan_ref(k, v, q, log_decay, gate, *, chunk: int,
                         initial_state=None):
    """The CUDA kernel's three phases in float64, unpadded (the last chunk
    ends at L): per chunk the state increment dS_c = sum_j exp(total -
    cum_j) g_j k_j v_jᵀ; the states passed in chunk order, S_c =
    exp(total_c)·S_{c-1} + dS_c; then each chunk's y_i = sum_{j<=i}
    (q_i·k_j) exp(cum_i - cum_j) g_j v_j + exp(cum_i)·(q_i S_{c-1}).
    Same arguments and outputs as :func:`linear_scan_ref`, in float64."""
    f = lambda x: x.to(torch.float64)
    k, v, q, ld, g = map(f, (k, v, q, log_decay, gate))
    b, l, h, n = k.shape
    p = v.shape[-1]
    bounds = [(c0, min(c0 + chunk, l)) for c0 in range(0, l, chunk)]
    cums, d_states = [], []
    for c0, c1 in bounds:                              # 1. chunk states
        cum = torch.cumsum(ld[:, c0:c1], dim=1)        # [B,Lc,H]
        w = torch.exp(cum[:, -1:] - cum) * g[:, c0:c1]
        d_states.append(torch.einsum("blhn,blhp->bhnp",
                                     k[:, c0:c1] * w[..., None], v[:, c0:c1]))
        cums.append(cum)
    s = (torch.zeros((b, h, n, p), dtype=torch.float64, device=k.device)
         if initial_state is None else f(initial_state))
    s_prev = []
    for cum, ds in zip(cums, d_states):                # 2. state passing
        s_prev.append(s)
        s = torch.exp(cum[:, -1])[..., None, None] * s + ds
    y = torch.empty((b, l, h, p), dtype=torch.float64, device=k.device)
    for (c0, c1), cum, sp in zip(bounds, cums, s_prev):   # 3. chunk scan
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # [B,i,j,H]
        lower = torch.ones(c1 - c0, c1 - c0, dtype=torch.bool,
                           device=k.device).tril()[None, :, :, None]
        decay = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)),
                            0.0) * g[:, None, c0:c1]
        att = torch.einsum("bihn,bjhn->bijh", q[:, c0:c1], k[:, c0:c1])
        y[:, c0:c1] = (torch.einsum("bijh,bjhp->bihp", att * decay,
                                    v[:, c0:c1])
                       + torch.exp(cum)[..., None]
                       * torch.einsum("bihn,bhnp->bihp", q[:, c0:c1], sp))
    return y, s


def linear_scan_bwd_ref(k, v, q, log_decay, gate, dy, d_final=None, *,
                        chunk: int, initial_state=None, states=None,
                        final_state=None):
    """The scan's backward in the CUDA kernel's form
    (``csrc/ssm_scan_bwd.cu``): given dy [B, L, H, P] and the final
    state's gradient ``d_final`` [B, H, N, P] (None: zero, as in
    training), returns (dk, dv, dq, d_log_decay, d_gate, d_initial_state)
    in float32 (float64 for float64 inputs); d_initial_state is the
    gradient at a zero initial state when ``initial_state`` is None.

    ``states`` [B, H, C, N, P] and ``final_state`` are the forward's
    (:func:`linear_scan_fwd_ref`, or the kernel's scratch); None
    recomputes them here.  With cum the within-chunk cumsum of log_decay,
    total its last value and G_c the gradient of the state leaving chunk
    c (G_{C-1} = d_final):

    (i)   ΔG_c = Σ_i exp(cum_i) q_i dy_iᵀ;
    (ii)  G_{c-1} = exp(total_c) G_c + ΔG_c, from the last chunk back;
          d_initial_state = G_{-1};
    (iii) dq_i = Σ_{j<=i} (dy_i·v_j) exp(cum_i - cum_j) g_j k_j
                 + exp(cum_i) S_{c-1} dy_i,
          dk̃_j = Σ_{i>=j} (dy_i·v_j) exp(cum_i - cum_j) q_i
                 + exp(total - cum_j) G_c v_j,
          dṽ_j = Σ_{i>=j} (q_i·k_j) exp(cum_i - cum_j) dy_i
                 + exp(total - cum_j) G_cᵀ k_j,
          dk = g dk̃, dv = g dṽ, d_gate_j = k_j·dk̃_j (never a division
          by g: padded and zero-gate rows have g = 0);
    (iv)  d cum_m = q_m·dq_m - k_m·dk_m, plus <S_final, d_final> at the
          last position; d_log_decay_t = Σ_{m>=t} d cum_m, summed within
          each chunk from its end and carried across chunks from the last.
    """
    b, l, h, n = k.shape
    p = v.shape[-1]
    acc = torch.promote_types(k.dtype, torch.float32)
    if states is None or (d_final is not None and final_state is None):
        _, final_state, states = linear_scan_fwd_ref(
            k, v, q, log_decay, gate, chunk=chunk,
            initial_state=initial_state)
    pad = (-l) % chunk
    if pad:                        # the padded rows have gate 0 and ld 0
        k, v, q, dy = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v, q, dy))
        log_decay, gate = (F.pad(x, (0, 0, 0, pad))
                           for x in (log_decay, gate))
    nc = (l + pad) // chunk
    r = lambda x: x.reshape((b, nc, chunk) + tuple(x.shape[2:])).to(acc)
    kc, vc, qc, dyc = r(k), r(v), r(q), r(dy)
    ld, g = r(log_decay), r(gate)                    # [B,C,Q,H]
    sp = states.to(acc).transpose(1, 2)              # [B,C,H,N,P]
    cum = torch.cumsum(ld, dim=2)
    total = cum[:, :, -1, :]                         # [B,C,H]
    e_out = torch.exp(cum)                           # exp(cum_i)
    e_in = torch.exp(total[:, :, None, :] - cum)     # exp(total - cum_j)

    # (i) and (ii): the states' gradients, from the last chunk back.
    d_g = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", e_out, qc, dyc)
    gs = torch.empty_like(sp)
    gc = (torch.zeros((b, h, n, p), dtype=acc, device=k.device)
          if d_final is None else d_final.to(acc))
    for c in reversed(range(nc)):
        gs[:, c] = gc
        gc = gc * torch.exp(total[:, c])[..., None, None] + d_g[:, c]
    d_init = gc

    # (iii) each chunk's gradients, the decay matrix W_ij for i >= j.
    seg = (cum.permute(0, 1, 3, 2)[..., :, None]
           - cum.permute(0, 1, 3, 2)[..., None, :])  # [B,C,H,i,j]
    ii = torch.arange(chunk, device=k.device)
    lower = ii[:, None] >= ii[None, :]
    w = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)), 0.0)
    gj = g.permute(0, 1, 3, 2)[:, :, :, None, :]     # [B,C,H,1,j]
    a_s = torch.einsum("bcihp,bcjhp->bchij", dyc, vc) * w
    b_s = torch.einsum("bcihn,bcjhn->bchij", qc, kc) * w
    dq = (torch.einsum("bchij,bcjhn->bcihn", a_s * gj, kc)
          + e_out[..., None] * torch.einsum("bcihp,bchnp->bcihn", dyc, sp))
    dkt = (torch.einsum("bchij,bcihn->bcjhn", a_s, qc)
           + e_in[..., None] * torch.einsum("bchnp,bcjhp->bcjhn", gs, vc))
    dvt = (torch.einsum("bchij,bcihp->bcjhp", b_s, dyc)
           + e_in[..., None] * torch.einsum("bchnp,bcjhn->bcjhp", gs, kc))
    dk, dv = g[..., None] * dkt, g[..., None] * dvt
    dg = (kc * dkt).sum(-1)                          # [B,C,Q,H]

    # (iv) d log_decay: the reverse cumsum of d cum, chunk by chunk.
    dcum = (qc * dq).sum(-1) - (kc * dk).sum(-1)     # [B,C,Q,H]
    if d_final is not None:
        last = (l - 1) // chunk, (l - 1) % chunk
        dcum[:, last[0], last[1]] += (final_state.to(acc)
                                      * d_final.to(acc)).sum((-2, -1))
    local = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    carry = torch.zeros_like(local[:, 0, 0])         # [B,H]
    dld = torch.empty_like(local)
    for c in reversed(range(nc)):
        dld[:, c] = local[:, c] + carry[:, None]
        carry = carry + local[:, c, 0]
    f = lambda x: x.reshape((b, nc * chunk) + tuple(x.shape[3:]))[:, :l]
    return f(dk), f(dv), f(dq), f(dld), f(dg), d_init
