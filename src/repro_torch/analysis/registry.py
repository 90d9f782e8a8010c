"""Registry of audited entry points of the port.

The torch counterpart of ``repro.analysis.registry``: each
:class:`ProgramSpec` lazily builds ``(fn, example_args, rules)`` for one
port program that has a reference counterpart, on a given device:

* the selector, native and padded by a ``GeometryBucket``, per policy,
  fused (``fused_selector="auto"``: the select_step kernel on the card,
  its plain version on the CPU) and unfused (``"ref"``), with timeout
  censoring, and with the frozen refit;
* the batched harness's episode programs: a lockstep step (timeout off and
  on) and a lane-compacting segment step (single-job native queue, and a
  geometry-bucketed queue), each with the selection fused.  Where the
  reference's episode is one ``lax.while_loop``, the port's is a host loop
  whose one host read a step is the loop condition
  (``optimizer._read_step``); the audited program is the device side of a
  step: ``_lockstep_body``, and ``_segment_start`` (with the evict flag)
  then ``_segment_body``;
* each kernel op, through its plain version (``force="ref"``) and through
  its dispatch (``force="auto"``: the kernel on the card).

The sharded segment joins with the service (ROADMAP A9).  Geometries are
the reference's smallest ones, chosen so the padded
width ``m = 32`` is unique among the dimension sizes the programs run
(R3 identifies the M axis by its size).  Inputs are zeros, as the
reference's example arguments; a trace runs the program for real, so the
kernel programs take small seeded inputs instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.rules import default_rules
from repro_torch.analysis.trace_audit import Finding, audit

__all__ = ["ProgramSpec", "registered_programs", "audit_program",
           "audit_all"]


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One audited entry point; ``build(device) -> (fn, args, rules)``."""

    name: str
    build: Callable[[torch.device], tuple[Callable, tuple, list]]
    description: str = ""


_POLICIES = ("bo", "la0", "lynceus")


def _native_space():
    from repro_torch.core.space import DiscreteSpace
    return DiscreteSpace.from_grid({"a": [0.0, 1.0, 2.0, 3.0, 4.0],
                                    "b": [0.0, 1.0, 2.0]})


def _bucket():
    from repro_torch.core.space import GeometryBucket
    return GeometryBucket(m=32, f=4, t=7)


def _settings(policy: str, fused: bool, **kw):
    from repro_torch.core import lookahead
    base = dict(policy=policy, la=1 if policy == "lynceus" else 0,
                k_gh=2, n_trees=3, depth=3,
                fused_selector="auto" if fused else "ref")
    base.update(kw)
    return lookahead.Settings(**base)


def _selector_native(policy: str, timeout: bool, fused: bool):
    def build(device):
        from repro_torch.core import lookahead
        space = _native_space()
        s = _settings(policy, fused, timeout=timeout)
        pts, left, thr, u = lookahead.space_arrays(
            space, np.ones(space.n_points), device)
        m = space.n_points
        z = lambda dt, *shape: torch.zeros(shape, dtype=dt, device=device)
        args = [z(torch.int64, 2), z(torch.float32, m), z(torch.bool, m),
                torch.tensor(3.0, device=device), pts, left, thr, u,
                torch.tensor(1.0, device=device)]
        if timeout:
            args.append(z(torch.bool, m))

        def fn(*a):
            return lookahead._select_next_impl(*a[:9], s, *a[9:])
        return fn, tuple(args), default_rules()
    return build


def _selector_padded(policy: str, *, fused: bool, refit: str = "exact",
                     timeout: bool = False):
    def build(device):
        from repro_torch.core import lookahead
        space = _native_space()
        bucket = _bucket()
        s = _settings(policy, fused, refit=refit, timeout=timeout)
        ps = space.pad_to(bucket)
        pts, left, thr, u = lookahead.space_arrays(
            ps, np.ones(space.n_points), device)
        valid = lookahead.space_valid(ps, device)
        r = 2
        z = lambda dt, *shape: torch.zeros(shape, dtype=dt, device=device)
        args = [z(torch.int64, r, 2), z(torch.float32, r, bucket.m),
                z(torch.bool, r, bucket.m),
                torch.ones(r, dtype=torch.float32, device=device),
                pts, left, thr, u, torch.tensor(1.0, device=device)]
        cens = [z(torch.bool, r, bucket.m)] if timeout else []
        example = tuple(args) + tuple(cens) + (valid,)

        def fn(*a):
            c = a[9] if timeout else None
            return lookahead.select_next_batched(*a[:9], s, c, a[-1])
        # obs_mask (2), cens and valid are False on padding.
        mask_nums = [2, len(example) - 1] + ([len(args)] if timeout else [])
        return fn, example, default_rules(m=bucket.m,
                                          mask_argnums=tuple(mask_nums))
    return build


def _episode_lockstep(timeout: bool):
    def build(device):
        from repro_torch.core import lookahead, optimizer
        space = _native_space()
        s = _settings("lynceus", True, timeout=timeout)
        pts, left, thr, u = lookahead.space_arrays(
            space, np.ones(space.n_points), device)
        m, r = space.n_points, 2
        z = lambda dt, *shape: torch.zeros(shape, dtype=dt, device=device)
        ones = torch.ones(m, device=device)
        st = {"key": z(torch.int64, r, 2), "y": z(torch.float32, r, m),
              "mask": z(torch.bool, r, m),
              "beta": torch.ones(r, device=device),
              "explored": torch.full((r, m), -1, dtype=torch.int32,
                                     device=device),
              "n_exp": z(torch.int32, r),
              "active": torch.ones(r, dtype=torch.bool, device=device)}
        if timeout:
            st.update(cens=z(torch.bool, r, m), cexpl=z(torch.bool, r, m),
                      bexpl=z(torch.float32, r, m))
        rows = (pts, left, thr, u, torch.tensor(1.0, device=device), None)

        def fn(st_):
            return optimizer._lockstep_body(st_, ones, ones, rows, s)
        return fn, (st,), default_rules()
    return build


def _segment(bucketed: bool):
    def build(device):
        from repro_torch.core import lookahead, optimizer, trees
        space = _native_space()
        s = _settings("lynceus", True)
        l_dim, c_dim = 2, 3
        valid = job_ids = None
        if bucketed:
            ps = space.pad_to(_bucket())
            m = ps.n_points
            as_t = lambda a: torch.as_tensor(np.asarray(a), device=device)
            pts, thr = as_t(ps.points)[None], as_t(ps.thresholds)[None]
            left = trees.make_left_table(ps.points, ps.thresholds,
                                         device=device)[None]
            valid = as_t(ps.valid)[None]
            u = torch.ones((1, m), device=device)
            t_max = torch.ones(1, device=device)
            cost = torch.ones((1, m), device=device)
            job_ids = torch.zeros(l_dim + c_dim, dtype=torch.int64,
                                  device=device)
        else:
            m = space.n_points
            pts, left, thr, u = lookahead.space_arrays(
                space, np.ones(m), device)
            t_max = torch.tensor(1.0, device=device)
            cost = torch.ones(m, device=device)
        carry = optimizer._fresh_slot_carry(l_dim, m, s, device)
        queue = {"keys": torch.zeros((c_dim, 2), dtype=torch.int64,
                                     device=device),
                 "y": torch.zeros((c_dim, m), device=device),
                 "mask": torch.zeros((c_dim, m), dtype=torch.bool,
                                     device=device),
                 "beta": torch.ones(c_dim, device=device),
                 "explored": torch.full((c_dim, m), -1, dtype=torch.int32,
                                        device=device),
                 "n_exp": torch.zeros(c_dim, dtype=torch.int32,
                                      device=device)}
        # The evict flag is part of the audited program: the boundary
        # banking of flagged seats must add no reduction.
        evict = torch.zeros(l_dim, dtype=torch.bool, device=device)
        n_out = l_dim + c_dim

        def fn(carry_, queue_, qtail, evict_, *valid_):
            rows = optimizer._job_rows(job_ids, pts, left, thr, u, t_max,
                                       valid_[0] if valid_ else None)
            st = optimizer._segment_start(carry_, evict_, n_out, s)
            return optimizer._segment_body(
                st, queue_, qtail, optimizer._job_groups([0] * l_dim, rows),
                job_ids, cost, None, u, s, n_out)
        example = (carry, queue, c_dim, evict) + ((valid,) if bucketed
                                                  else ())
        if not bucketed:
            return fn, example, default_rules()
        # The observation masks and the validity rows are False on padding.
        masks = {id(carry["mask"]), id(queue["mask"]), id(valid)}
        leaves, _ = tree_flatten(example)
        return fn, example, default_rules(
            m=m, mask_argnums=tuple(i for i, leaf in enumerate(leaves)
                                    if id(leaf) in masks))
    return build


def _kernel_args(name: str, device):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=g).to(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    if name == "flash_attention":
        q = rnd(1, 2, 16, 8)
        return (q, q, q), {}
    if name == "decode_attention":
        k = rnd(1, 2, 64, 8)
        return (rnd(1, 2, 8), k, k, torch.tensor(10, device=device)), {}
    if name == "tree_predict":
        return (rnd(16, 4), torch.zeros(3, 2, 2, dtype=torch.int32,
                                        device=device),
                torch.zeros(3, 2, 2, device=device),
                torch.zeros(3, 4, device=device)), {}
    if name == "gh_ei":
        m = torch.ones(16, device=device)
        return (m, m, m, f32(1.0), f32(1.0), f32(3.0), f32([-1.0, 1.0])), {}
    if name == "select_step":
        s_dim, b, d, w, m, f = 6, 3, 2, 2, 16, 4
        return (torch.zeros(s_dim, b, d, w, dtype=torch.int32,
                            device=device),
                torch.full((s_dim, b, d, w), float("inf"), device=device),
                torch.zeros(s_dim, b, 2 ** d, device=device),
                torch.zeros(s_dim, m, device=device),
                torch.zeros(s_dim, m, dtype=torch.bool, device=device),
                torch.ones(s_dim, device=device),
                torch.full((s_dim,), float("inf"), device=device),
                torch.zeros(m, f, device=device),
                torch.ones(m, device=device), f32(1.0), f32(0.01), None,
                None, torch.ones(m, dtype=torch.bool, device=device)), {
                    "emit_full": True}
    if name == "ssm_scan":
        k = rnd(1, 8, 2, 4)
        return (k, rnd(1, 8, 2, 4), rnd(1, 8, 2, 4),
                -torch.rand((1, 8, 2), generator=g).to(device),
                torch.rand((1, 8, 2), generator=g).to(device)), {"chunk": 4}
    if name == "masked_argmax":
        return (rnd(16), torch.arange(16, device=device) < 12), {}
    raise KeyError(name)


_KERNELS = ("flash_attention", "decode_attention", "tree_predict", "gh_ei",
            "select_step", "ssm_scan", "masked_argmax")


def _kernel(name: str, mode: str):
    def build(device):
        import repro_torch.kernels as kernels
        op = getattr(kernels, name)
        args, kw = _kernel_args(name, device)
        fn = lambda *a: op(*a, force=mode, **kw)
        return fn, args, default_rules()
    return build


def registered_programs() -> list[ProgramSpec]:
    """All audited entry points, cheapest geometry each."""
    specs: list[ProgramSpec] = []
    for pol in _POLICIES:
        for fused, tag in ((False, ""), (True, "/fused")):
            specs.append(ProgramSpec(
                f"selector/{pol}/native{tag}",
                _selector_native(pol, timeout=False, fused=fused),
                f"sequential selector, policy={pol}"))
            specs.append(ProgramSpec(
                f"selector/{pol}/padded{tag}",
                _selector_padded(pol, fused=fused),
                f"geometry-bucket padded batched selector, policy={pol}"))
    for fused, tag in ((False, ""), (True, "/fused")):
        specs.append(ProgramSpec(
            f"selector/lynceus/native/timeout{tag}",
            _selector_native("lynceus", timeout=True, fused=fused),
            "timeout-censoring selector (censored fit + billed tau cap)"))
        specs.append(ProgramSpec(
            f"selector/lynceus/padded/timeout{tag}",
            _selector_padded("lynceus", fused=fused, timeout=True),
            "padded timeout-censoring selector"))
    specs.append(ProgramSpec(
        "selector/lynceus/padded/frozen",
        _selector_padded("lynceus", fused=False, refit="frozen"),
        "padded selector with frozen-structure incremental refit"))
    for timeout, tag in ((False, ""), (True, "/timeout")):
        specs.append(ProgramSpec(
            f"episode/lockstep{tag}", _episode_lockstep(timeout),
            "lockstep batched episode step"
            + (" with timeout-censored exploration" if timeout else "")))
    specs.append(ProgramSpec(
        "episode/segment", _segment(bucketed=False),
        "lane-compacting segment step, single-job native queue"))
    specs.append(ProgramSpec(
        "episode/segment/bucketed", _segment(bucketed=True),
        "lane-compacting segment step, geometry-bucketed mixed queue"))
    for k in _KERNELS:
        specs.append(ProgramSpec(f"kernel/{k}/ref", _kernel(k, "ref"),
                                 f"{k} plain PyTorch version"))
        specs.append(ProgramSpec(f"kernel/{k}/kernel", _kernel(k, "auto"),
                                 f"{k} through its dispatch (the CUDA "
                                 "kernel on the card)"))
    return specs


def audit_program(spec: ProgramSpec, device="cpu") -> list[Finding]:
    fn, example_args, rules = spec.build(torch.device(device))
    return audit(fn, example_args, rules, program=spec.name)


def audit_all(device="cpu", progress: Callable[[str], None] | None = None
              ) -> list[Finding]:
    """Audit every registered program on ``device``."""
    findings: list[Finding] = []
    for spec in registered_programs():
        if progress is not None:
            progress(spec.name)
        findings.extend(audit_program(spec, device))
    return findings
