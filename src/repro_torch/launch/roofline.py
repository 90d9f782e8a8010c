"""Roofline terms of a dry-run step — ``repro.launch.roofline`` for the
H100.

Three terms, all in *seconds per step per device* (the dry run counts
each device's own work: its local shards' operations and bytes, and the
collectives it takes part in):

  compute    = flops / peak rate of the step's compute dtype
  memory     = bytes / HBM bandwidth
  collective = wire bytes / link bandwidth

``HW`` holds the published figures of an NVIDIA H100 80GB HBM3 (SXM) at
700 W, stated as analytic, never measured here: 989 TFLOP/s bf16 and 67
TFLOP/s float32 dense (the port trains in float32 without TF32, so a
float32 step takes the float32 rate: the bf16 peak would understate its
compute term 15x), 3.35 TB/s HBM, 450 GB/s NVLink each way.

Wire bytes follow the reference's ring cost model (each collective's
local result bytes R over a group of n): all-gather (n-1)/n x R;
all-reduce 2(n-1)/n x R; reduce-scatter (n-1) x R (its result is the
already-scattered shard); all-to-all (n-1)/n x R; permute R (a
broadcast too: each device forwards R once down a chain).  The
reference parses them out of the compiled HLO text; the port has no HLO,
so :func:`record_collectives` records them as the step issues them: a
``TorchDispatchMode`` that sees every ``c10d_functional`` collective and
DTensor's all-to-all (DTensor's redistributions and the step's own) with
its local shapes.
It models one link speed for every group: a mesh whose groups cross
hosts (a NIC, not NVLink) is not modelled.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW", "CollectiveStats", "record_collectives", "roofline_terms",
           "model_flops", "wire_bytes"]

HW = {
    "name": "NVIDIA H100 80GB HBM3 (SXM), 700 W: published figures",
    "peak_flops": {"bfloat16": 989e12, "float32": 67e12},  # dense, /device
    "hbm_bw": 3.35e12,          # B/s
    "link_bw": 450e9,           # B/s each way (NVLink)
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes_per_device: float

    def to_json(self):
        return {"counts": self.counts, "result_bytes": self.result_bytes,
                "wire_bytes_per_device": self.wire_bytes_per_device}


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes a device sends for one collective of ``kind`` whose local
    result holds ``result_bytes``, over a group of ``n`` (the ring
    model)."""
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / max(n, 1)
    return float(result_bytes)         # collective-permute, broadcast


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


# (namespace, op) -> the ring model's kind: the functional collectives,
# and DTensor's all-to-all between two shardings (its own op on a mesh of
# cards).
_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("_c10d_functional", "broadcast"): "broadcast",
    ("_c10d_functional", "broadcast_"): "broadcast",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for i in x for t in _tensors(i)]
    return []


class record_collectives(TorchDispatchMode):
    """Records every ``c10d_functional`` collective the code under it
    issues: its kind, its local result bytes and its group's size, with
    the wire bytes of the ring model.  ``stats()`` gives the
    :class:`CollectiveStats`.  The recorded calls are in ``calls``:
    (kind, result bytes, group size)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor dispatches the op itself, with this mode still on
            # the stack: the collectives of its redistributions come here.
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get((func.namespace, func._opname))
        if kind is not None:
            named = {a.name: v for a, v in zip(func._schema.arguments, args)}
            named.update(kwargs or {})
            n = (named["group_size"] if "group_size" in named
                 else _group_size(named["group_name"]))
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(out))
            self.calls.append((kind, nbytes, int(n)))
        return out

    def stats(self) -> CollectiveStats:
        counts, rbytes, wire = {}, {}, 0.0
        for kind, b, n in self.calls:
            counts[kind] = counts.get(kind, 0) + 1
            rbytes[kind] = rbytes.get(kind, 0) + b
            wire += wire_bytes(kind, b, n)
        return CollectiveStats(counts, rbytes, wire)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, dtype: str = "float32",
                   hw=HW) -> dict:
    """The three terms at the peak rate of ``dtype`` (the step's compute
    dtype), the bound and the step's least time."""
    t_c = flops_per_dev / hw["peak_flops"][dtype]
    t_m = bytes_per_dev / hw["hbm_bw"]
    t_x = wire_bytes_per_dev / hw["link_bw"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    total = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "bound": dom[1], "step_s": total,
        "roofline_fraction": (t_c / total) if total > 0 else 0.0,
    }


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """6·N_active·D (train) or 2·N_active·D (forward-only), global."""
    n = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
