"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version — the port of ``repro.kernels``.

  select_step      — fused selector step: forest descent -> EI_c/Gamma ->
                     quantized argmax (the selector's hot path)
  tree_predict     — bagged-forest mu/sigma over the points
  gh_ei            — fused constrained EI + budget flag + Gauss-Hermite nodes
  flash_attention  — train/prefill attention (causal/window/softcap, GQA),
                     differentiable: its backward is a kernel too
  decode_attention — single-token attention over a ring KV cache
  ssm_scan         — chunked SSD / gated linear recurrence (Mamba2,
                     mLSTM), differentiable: its backward is a kernel too
  masked_argmax    — masked, quantized argmax (the determinism gate's
                     kernel fixture)

Each op sends CPU tensors to its plain version and CUDA tensors to its
kernel (``kernels.dispatch``); the kernels are built from ``csrc/*.cu`` at
first use (``kernels.build``).
"""

# The core package first: its lookahead imports select_step's op, which
# must not meet this package half initialised.
import repro_torch.core  # noqa: F401
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.dispatch import resolve_mode
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.gh_ei.ops import gh_ei
from repro_torch.kernels.masked_argmax.ops import masked_argmax
from repro_torch.kernels.select_step.ops import select_step
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.tree_predict.ops import tree_predict

__all__ = ["flash_attention", "decode_attention", "ssm_scan",
           "tree_predict", "gh_ei", "select_step", "masked_argmax",
           "resolve_mode"]
