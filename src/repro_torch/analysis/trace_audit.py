"""Layer 1 of the port's determinism auditor: trace-level contract checking.

The torch counterpart of ``repro.analysis.jaxpr_audit``.  Where the JAX
package traces a program with ``jax.make_jaxpr`` and walks the jaxpr, the
port runs the program once, on the caller's device, under a
``TorchDispatchMode`` and walks the aten operations it records, in the
order they ran, propagating value-level *labels* that the rules in
``analysis/rules.py`` consume.  The walker is rule-agnostic: it computes
the labels; the rules are sink checks over (operation, labels).

Label semantics (as in the reference)
-------------------------------------
The padded selector programs right-pad the candidate axis M; the contract
is that padding lanes never influence a decision.  Each tensor carries a
polarity:

* ``MASK``     — boolean, False on padding lanes (the ``valid`` mask, the
  observation/censor rows, any AND-chain containing one of them);
* ``ANTIMASK`` — boolean, True on padding lanes (``~mask``);
* ``CLEAN``    — data whose padding entries are neutral (constants, and
  ``where(mask, x, neutral)`` / ``mask * x``);
* ``DIRTY``    — no guarantee (the default for program inputs).

and three flags: ``quant`` (the value went through the port's
``quantize_scores`` pattern: ``view(int32)`` -> int64 bit operations
(``& 0xFFFFFFFF``, ``+ half``, ``& mask``) -> ``view(float32)``; it passes
through ``where``, so ``where(isnan(x), x, q)`` and a validity select keep
it), ``selidx`` (an index from an argmax over masked or quantized scores,
so ``iota == selidx`` is a MASK) and ``iota`` (an ``arange``).

How the port's program differs from a jaxpr, and what the walker does
--------------------------------------------------------------------
* Labels are keyed to tensor identity: the walker keeps every tensor it
  has seen alive for the length of the trace, so an ``id`` names one
  tensor.  A view takes its base's label (the shape-only operations pass
  labels through); an in-place operation relabels the tensor it writes.
  A tensor the trace never produced is a program input (labelled by the
  rules' ``mask_argnums``/``clean_argnums``, else DIRTY) or a constant the
  program closed over (CLEAN, as a jaxpr's constvars are).
* Loops are Python loops: each iteration's operations are recorded as
  they run, so no fixpoint is needed.
* A hand-written kernel's launch is opaque to the mode, which records
  only the wrapper's ``torch.empty``.  Each op therefore declares, after
  the launch, the plain version the kernel is held equal to
  (``kernels.dispatch.declare_kernel``); the walker runs that plain version
  on the same inputs, under the mode, and gives the kernel's outputs the
  labels the plain version's outputs get.  This is the counterpart of the
  reference's ``pallas_call`` ref-label seeding, and it is why an audit
  on the card (kernels) and on the CPU (plain versions) finds the same.
* The port's PRNG is int64 tensor arithmetic, not one primitive: the
  walker hooks ``prng.split`` and reports each call's count as an
  operation ``prng.split`` (rule R2 reads it).
* The port computes in float64 on purpose inside two single-rounding
  helpers, ``acquisition.sqrt_rn`` and ``acquisition.fma``: each takes
  float32 operands, computes exactly (or with a tie correction) in
  float64 and rounds once to float32.  The walker marks operations that
  run inside them (``Op.rounding_helper``), and R4 lets exactly those
  produce float64.
* Host round trips are ``aten._local_scalar_dense`` (``.item()``,
  ``float(t)``, indexing with a 0-d tensor) and device-to-host copies.

The reference's ``program_signature`` (a jaxpr's canonical text) becomes
:func:`signature`: the ordered aten operations a run of the program
records, each with its overload, its operands' dtypes and shapes and its
non-tensor arguments, tensors renamed ``v0, v1, ...`` in the order they
first appear (program inputs first).  Devices are left out: placement is
not part of the program; so is ``lift_fresh``, a host constant entering
the program, which a module-level cache (the Gauss-Hermite nodes) makes
only on the first run.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Iterable
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import acquisition, prng

__all__ = ["Finding", "Labels", "Op", "Rule", "audit", "signature",
           "REDUCTIONS", "is_binary_max", "DIRTY", "MASK", "ANTIMASK",
           "CLEAN"]


# --------------------------------------------------------------------------- #
# Findings and labels
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation located in a traced program."""

    rule: str                   # rule id, e.g. "R1"
    op: str                     # offending operation, e.g. "argmax"
    message: str                # human-readable explanation
    path: tuple[str, ...] = ()  # the Python functions the op ran in
    program: str = ""           # registry program name

    def __str__(self):
        where = "/".join(self.path) or "<top>"
        prog = f"{self.program}: " if self.program else ""
        return f"[{self.rule}] {prog}{where}: {self.op}: {self.message}"

    def key(self) -> tuple[str, str, str]:
        """What two devices' audits of one program must agree on: the
        path differs by the kernel replays (``kernel:<op>``)."""
        return self.rule, self.op, self.message


DIRTY, MASK, ANTIMASK, CLEAN = "dirty", "mask", "antimask", "clean"
_CLEANISH = (MASK, CLEAN)


@dataclasses.dataclass(frozen=True)
class Labels:
    """Abstract value attached to each tensor."""

    pol: str = DIRTY
    quant: bool = False
    selidx: bool = False
    iota: bool = False

    @property
    def cleanish(self) -> bool:
        return self.pol in _CLEANISH


_DIRTY = Labels()
_CLEAN = Labels(pol=CLEAN)


@dataclasses.dataclass
class Op:
    """One recorded operation: the aten overload packet's name (``argmax``,
    ``sum``, ...), the overload, its arguments and its output tensors.
    ``rounding_helper`` names the single-rounding helper it ran in (None
    outside them)."""

    name: str
    overload: str
    args: tuple
    kwargs: dict
    outputs: list
    rounding_helper: str | None = None

    def tensor_args(self) -> list[torch.Tensor]:
        flat, _ = tree_flatten((self.args, self.kwargs))
        return [a for a in flat if isinstance(a, torch.Tensor)]


class Rule:
    """Base class of the trace rules (``analysis/rules.py``).

    ``mask_argnums`` / ``clean_argnums`` seed the polarity labels at the
    program's flat argument positions (``torch.utils._pytree`` order);
    ``check`` is called on every recorded operation with the labels of its
    inputs (``get``) and returns findings."""

    id = "R?"
    mask_argnums: tuple[int, ...] = ()
    clean_argnums: tuple[int, ...] = ()

    def check(self, op: Op, get: Callable[[Any], Labels]
              ) -> Iterable[Finding]:
        return ()


# --------------------------------------------------------------------------- #
# Operation classes (aten overload packet names)
# --------------------------------------------------------------------------- #
_VIEW = {"view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
         "expand_as", "unsqueeze", "squeeze", "alias", "detach", "clone",
         "contiguous", "_to_copy", "to", "lift_fresh_copy", "repeat",
         "broadcast_to"}
_SHAPE = {"permute", "transpose", "t", "slice", "select", "flip",
          "as_strided", "unbind", "split", "split_with_sizes", "chunk",
          "narrow", "diagonal", "movedim", "unfold", "roll"}
_GATHER = {"index", "gather", "index_select", "take", "take_along_dim"}
# Reductions whose folded axes are ``dim`` (args[1] or the keyword), all
# axes when it is None or empty.
REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                        "any", "all", "argmax", "argmin", "std", "var",
                        "std_mean", "var_mean", "logsumexp", "nansum",
                        "aminmax", "count_nonzero"})
_DOT = {"mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv", "addbmm",
        "matmul", "vdot", "linear"}
_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}
_FACTORY = {"empty", "empty_like", "empty_strided", "zeros", "zeros_like",
            "ones", "ones_like", "full", "full_like", "new_zeros",
            "new_ones", "new_full", "new_empty", "scalar_tensor",
            "lift_fresh", "eye"}
_ROUNDING_HELPERS = {acquisition.sqrt_rn.__code__: "sqrt_rn",
                     acquisition.fma.__code__: "fma"}
_MASK32 = 0xFFFFFFFF


def _dims(t: torch.Tensor) -> int:
    return t.dim() if isinstance(t, torch.Tensor) else 0


def _is_int(v, value=None) -> bool:
    """``v`` is a Python int constant (equal to ``value`` if given)."""
    return (isinstance(v, int) and not isinstance(v, bool)
            and (value is None or v == value))


def is_binary_max(op: "Op") -> bool:
    """``max.other``/``min.other``: elementwise, not a reduction."""
    return op.name in ("max", "min") and op.overload == "other"


# --------------------------------------------------------------------------- #
# The walker
# --------------------------------------------------------------------------- #
class _Tracer(TorchDispatchMode):
    def __init__(self, rules: list[Rule], inputs: dict[int, Labels]):
        super().__init__()
        self.rules = rules
        self.labels: dict[int, Labels] = dict(inputs)
        self.producers: dict[int, tuple[Op, list]] = {}
        self.keep: list = []                    # ids stay unique
        self.findings: list[Finding] = []
        self.context: list[str] = []            # kernel replays in flight
        self.entry = None                       # the frame of audit()

    # -- labels ------------------------------------------------------------- #
    def get(self, v) -> Labels:
        if not isinstance(v, torch.Tensor):
            return _CLEAN                       # a Python number: literal
        return self.labels.get(id(v), _CLEAN)

    def _set(self, t: torch.Tensor, lab: Labels, op: Op, ins) -> None:
        self.keep.append(t)
        self.labels[id(t)] = lab
        self.producers[id(t)] = (op, ins)

    # -- recording ---------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        name = func._overloadpacket.__name__
        op = Op(name.rstrip("_") if name.endswith("_") and
                not name.startswith("_") else name,
                func._overloadname, tuple(args), dict(kwargs), outs)
        if any(o.dtype in (torch.float64, torch.complex128) for o in outs):
            op.rounding_helper = _rounding_helper()
        ins = op.tensor_args()
        self.keep.extend(ins)
        self._check(op)
        labs = self._transfer(op)
        for o, lab in zip(outs, labs):
            self._set(o, lab, op, ins)
        if (name == "view" and func._overloadname == "dtype"
                and outs and outs[0].dtype == torch.float32
                and self._closes_quantize(ins[0])):
            self.labels[id(outs[0])] = dataclasses.replace(
                self.labels[id(outs[0])], quant=True)
        return out

    def _check(self, op: Op) -> None:
        for rule in self.rules:
            found = list(rule.check(op, self.get))
            if found:
                path = self._path()
                self.findings.extend(dataclasses.replace(f, path=path)
                                     for f in found)

    def record(self, op: Op) -> None:
        """An operation the mode cannot see (``prng.split``): rules only."""
        self._check(op)

    def _path(self) -> tuple[str, ...]:
        names = []
        f = sys._getframe(1)
        while f is not None and f is not self.entry:
            if not _internal(f.f_code.co_filename):
                names.append(f.f_code.co_qualname)
            f = f.f_back
        return tuple(self.context) + tuple(reversed(names))

    # -- kernel replays ----------------------------------------------------- #
    def kernel_launched(self, op: str, outputs, plain) -> None:
        """``kernels.dispatch.declare_kernel``: run the plain version the
        kernel is held equal to, under the mode, and give the kernel's
        outputs its outputs' labels."""
        self.context.append(f"kernel:{op}")
        try:
            ref = plain()
        finally:
            self.context.pop()
        got, _ = tree_flatten(outputs)
        want, _ = tree_flatten(ref)
        for g, w in zip(got, want):
            if isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor):
                self.keep.append(g)
                self.labels[id(g)] = self.get(w)

    # -- the quantize pattern ----------------------------------------------- #
    def _closes_quantize(self, t: torch.Tensor) -> bool:
        """Is ``t`` (int32, about to be viewed as float32) the end of the
        quantize bit pattern?  Walk its producers back to a float32 ->
        int32 view; the first arithmetic after it must be an addition of a
        constant followed by an AND with a constant mask (``& 0xFFFFFFFF``
        re-masks and ``to`` copies are skipped)."""
        seq = []
        for _ in range(16):
            prod = self.producers.get(id(t))
            if prod is None:
                return False
            op, ins = prod
            if op.name == "view" and op.overload == "dtype":
                if ins and ins[0].dtype == torch.float32:
                    break
                return False
            seq.append(op)
            ints = [a for a in ins if not a.is_floating_point()]
            if not ints:
                return False
            t = ints[0]
        else:
            return False
        seq.reverse()
        arith = [op for op in seq if op.name not in ("_to_copy", "detach")
                 and not (op.name == "bitwise_and"
                          and _is_int(op.args[1], _MASK32))]
        return (len(arith) >= 2 and arith[0].name == "add"
                and _is_int(arith[0].args[1])
                and arith[1].name == "bitwise_and"
                and _is_int(arith[1].args[1]))

    # -- label transfer ----------------------------------------------------- #
    def _transfer(self, op: Op) -> list[Labels]:
        name, n_out = op.name, len(op.outputs)
        args = op.args
        ins = [self.get(a) for a in args if isinstance(a, torch.Tensor)]
        arrays = [self.get(a) for a in op.tensor_args() if _dims(a) > 0]
        first = self.get(args[0]) if args else _CLEAN

        if name == "arange":
            return [Labels(pol=CLEAN, iota=True)]
        if name in _FACTORY:
            return [_CLEAN] * n_out
        if name in _VIEW:
            return [first] * n_out
        if name in _SHAPE or (name == "view" and op.overload == "dtype"):
            return [dataclasses.replace(first, iota=False)] * n_out
        if name in _GATHER:
            return [dataclasses.replace(first, iota=False)] * n_out
        if name == "copy":
            return [dataclasses.replace(self.get(args[1]), iota=False)]
        if name in ("bitwise_not", "logical_not"):
            flip = {MASK: ANTIMASK, ANTIMASK: MASK}.get(first.pol, first.pol)
            return [Labels(pol=flip)]
        if name in ("bitwise_and", "logical_and"):
            labs = [self.get(a) for a in args[:2]]
            pols = [lab.pol for lab in labs]
            quant = any(lab.quant for lab in labs)
            if MASK in pols:
                return [Labels(pol=MASK)]
            if all(p == ANTIMASK for p in pols):
                return [Labels(pol=ANTIMASK)]
            if all(lab.cleanish for lab in labs):
                return [Labels(pol=CLEAN, quant=quant)]
            return [Labels(quant=quant)]
        if name in ("bitwise_or", "logical_or"):
            pols = [self.get(a).pol for a in args[:2]]
            if ANTIMASK in pols:
                return [Labels(pol=ANTIMASK)]
            if all(p == MASK for p in pols):
                return [Labels(pol=MASK)]
            return [_DIRTY]
        if name == "mul":
            # Only a factor that is zero/False at padding cleans a product:
            # a mask, or a CLEAN array.  A CLEAN scalar broadcasts one value
            # onto the padding lanes and cleans nothing.
            for a in args[:2]:
                lab = self.get(a)
                if lab.pol == MASK or (lab.pol == CLEAN and _dims(a) > 0):
                    return [_CLEAN]
            return [_DIRTY]
        if name == "where" and len(args) == 3:
            pred = self.get(args[0])
            # torch.where(c, x, y): a padding lane (c False) takes y.
            cases = [self.get(args[2]), self.get(args[1])]
            return [self._select(pred, cases)]
        if name == "masked_fill":
            pred = self.get(args[1])
            return [self._select(pred, [first, self.get(args[2])])]
        if name in _CMP:
            if name == "eq" and len(args) >= 2:
                a, b = self.get(args[0]), self.get(args[1])
                if (a.iota and b.selidx) or (b.iota and a.selidx):
                    return [Labels(pol=MASK)]
            return [_DIRTY]
        if name in ("argmax", "argmin"):
            return [Labels(pol=DIRTY, selidx=first.quant or first.cleanish)]
        if (name in REDUCTIONS and not is_binary_max(op)) or name in _DOT:
            return [_DIRTY] * n_out
        if name in ("cat", "stack"):
            labs = [self.get(a) for a in args[0]]
            pol = CLEAN if all(lab.cleanish for lab in labs) else DIRTY
            if labs and all(lab.pol == MASK for lab in labs):
                pol = MASK
            return [Labels(pol=pol, quant=all(lab.quant for lab in labs))]
        if name in ("maximum", "minimum", "clamp", "clamp_min",
                    "clamp_max") or is_binary_max(op):
            tens = [a for a in args if isinstance(a, torch.Tensor)]
            selidx = any(self.get(a).selidx for a in tens) and all(
                self.get(a).selidx or _dims(a) == 0 for a in tens)
            pol = CLEAN if all(lab.cleanish for lab in ins) else DIRTY
            return [Labels(pol=pol, selidx=selidx)]
        # elementwise-ish default: clean iff every array input is clean
        if arrays and all(lab.cleanish for lab in arrays):
            return [_CLEAN] * n_out
        return [_DIRTY] * n_out

    @staticmethod
    def _select(pred: Labels, cases: list[Labels]) -> Labels:
        """``cases[0]`` where the predicate is False, ``cases[1]`` where it
        is True (the reference's ``select_n`` order)."""
        if pred.pol == MASK:
            ok = cases[0].cleanish
        elif pred.pol == ANTIMASK:
            ok = cases[-1].cleanish
        else:
            ok = all(c.cleanish for c in cases)
        pol = CLEAN if ok else DIRTY
        if pol == CLEAN and all(c.pol == MASK for c in cases):
            pol = MASK
        return Labels(pol=pol, quant=any(c.quant for c in cases))


_SELF = __file__
_TORCH_DIR = torch.__file__.rsplit("/", 1)[0]


def _internal(filename: str) -> bool:
    return (filename == _SELF or filename.startswith(_TORCH_DIR)
            or filename.endswith("kernels/dispatch.py")
            or filename.endswith("/contextlib.py"))


def _rounding_helper() -> str | None:
    f = sys._getframe(2)
    while f is not None:
        hit = _ROUNDING_HELPERS.get(f.f_code)
        if hit is not None:
            return hit
        f = f.f_back
    return None


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #
def audit(fn, example_args: tuple, rules: list[Rule], *,
          example_kwargs: dict | None = None,
          program: str = "") -> list[Finding]:
    """Run ``fn`` on the example arguments under the tracer and return the
    rules' findings.

    The program runs for real, on whatever device its arguments lie on.
    ``mask_argnums``/``clean_argnums`` index the flat argument list as
    ``torch.utils._pytree.tree_flatten(example_args)`` orders it."""
    leaves, _ = tree_flatten(tuple(example_args))
    seeds: dict[int, Labels] = {}
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            seeds[id(leaf)] = _DIRTY
    for rule in rules:
        for i in rule.mask_argnums:
            seeds[id(leaves[i])] = Labels(pol=MASK)
        for i in rule.clean_argnums:
            seeds[id(leaves[i])] = Labels(pol=CLEAN)
    tracer = _Tracer(list(rules), seeds)
    tracer.entry = sys._getframe()
    tracer.keep.extend(leaves)
    real_split = prng.split

    def split(key, num: int = 2):
        tracer.record(Op("prng.split", "", (key, num), {}, []))
        return real_split(key, num)

    with mock.patch.object(prng, "split", split), tracer:
        fn(*example_args, **(example_kwargs or {}))
    if program:
        return [dataclasses.replace(f, program=program)
                for f in tracer.findings]
    return tracer.findings



# --------------------------------------------------------------------------- #
# Canonical program signatures
# --------------------------------------------------------------------------- #
# Keyword arguments that say where or how a result is allocated, not what
# it computes.
_PLACEMENT_KWARGS = frozenset({"device", "pin_memory", "non_blocking"})


class _Signer(TorchDispatchMode):
    """Records each aten operation a program runs as one canonical line."""

    def __init__(self, leaves):
        super().__init__()
        self.names: dict[int, str] = {}
        self.keep: list = []                    # ids stay unique
        self.lines: list[str] = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                self._tensor(leaf)

    def _tensor(self, t: torch.Tensor) -> str:
        name = self.names.get(id(t))
        if name is None:
            name = self.names[id(t)] = f"v{len(self.names)}"
            self.keep.append(t)
        dt = str(t.dtype).removeprefix("torch.")
        return f"{name}:{dt}{list(t.shape)}"

    def _arg(self, a) -> str:
        if isinstance(a, torch.Tensor):
            return self._tensor(a)
        if isinstance(a, (list, tuple)):
            return "[" + ",".join(self._arg(x) for x in a) + "]"
        if isinstance(a, torch.dtype):
            return str(a).removeprefix("torch.")
        if isinstance(a, torch.device):
            return "device"
        return repr(a)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket.__name__ == "lift_fresh":
            # A host constant entering the program (a jaxpr's constvar): it
            # shows only where it is first made, not where a cached copy is
            # reused, so the line would differ between runs.
            return out
        ins = [self._arg(a) for a in args] + [
            f"{k}={self._arg(v)}" for k, v in sorted(kwargs.items())
            if k not in _PLACEMENT_KWARGS]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.lines.append(
            f"{func._overloadpacket.__name__}.{func._overloadname}("
            + ",".join(ins) + ")->(" + ",".join(self._arg(o) for o in outs)
            + ")")
        return out

    def kernel_launched(self, op: str, outputs, plain) -> None:
        """A hand-written kernel's launch (``kernels.dispatch.
        declare_kernel``): one line naming the op and its outputs."""
        got, _ = tree_flatten(outputs)
        self.lines.append(f"kernel.{op}()->(" + ",".join(
            self._arg(g) for g in got if isinstance(g, torch.Tensor)) + ")")


def signature(fn, *example_args, **example_kwargs) -> str:
    """Run ``fn`` on the example arguments and return its canonical program
    signature: one line for the inputs, then one per aten operation in the
    order they ran (see the module docstring).  Two runs of one program on
    the same inputs give the same text; two programs that run different
    operations, or the same operations on other dtypes or shapes, differ.
    """
    leaves, _ = tree_flatten((tuple(example_args), dict(example_kwargs)))
    signer = _Signer(leaves)
    head = "in(" + ",".join(signer._arg(leaf) for leaf in leaves
                            if isinstance(leaf, torch.Tensor)) + ")"
    with signer:
        fn(*example_args, **example_kwargs)
    return "\n".join([head] + signer.lines)
