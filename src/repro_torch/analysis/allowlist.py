"""Justified suppressions for the port's AST determinism lint.

The policy of ``repro.analysis.allowlist``: every entry matches a specific
offending source line by substring, carries a written justification for
why the contract does not apply there, and stays live (the lint reports
entries that match nothing, so a suppression cannot outlive its code).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Allow", "ALLOWLIST"]


@dataclasses.dataclass(frozen=True)
class Allow:
    file: str    # path suffix, e.g. "core/trees.py"
    rule: str    # lint rule id
    match: str   # substring of the offending (stripped) source line
    why: str     # required justification


# Sums of integer-valued float32 (0/1 masks, Poisson(1) bootstrap counts and
# their products with 0/1 one-hots): every partial sum is an integer far
# below 2**24, so it is exact, and any summation order gives the same bits.
_COUNTS = ("an exact count: the summands are integer-valued float32 "
           "(0/1 masks or Poisson(1) bootstrap counts times 0/1 one-hots), "
           "every partial sum is an integer below 2**24, so every "
           "summation order gives the same bits on every device")

ALLOWLIST = [
    Allow(file="core/lookahead.py", rule="unpinned-reduction",
          match="n = torch.clamp_min(obs.sum(dim=-1), 1.0)",
          why="_sigma_floor's observation count: " + _COUNTS),
    Allow(file="core/lookahead.py", rule="unpinned-reduction",
          match="sw = (boot_w[:, :, None] * same_leaf.to(torch.float32))",
          why="the frozen refit's leaf weight: " + _COUNTS),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="cnt = (_knuth_cumprod(u) > _KNUTH_L).sum(dim=-2)",
          why="Knuth's Poisson sampler counts booleans in int64: exact"),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="sw0 = w.sum(dim=1)",
          why="the root node's bootstrap weight: " + _COUNTS),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="sw_n = (onehot * w[:, :, None]).sum(dim=1)",
          why="each node's bootstrap weight: " + _COUNTS),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="sl_w = torch.matmul((onehot * w[:, :, None])",
          why="the split search's left-branch weights (a product with the "
              "0/1 left table): " + _COUNTS),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="sw2 = (oh2 * w[:, :, None]).sum(dim=1)",
          why="each child's bootstrap weight: " + _COUNTS),
    Allow(file="core/trees.py", rule="unpinned-reduction",
          match="dead = w.sum(dim=2, keepdim=True)",
          why="a tree's total bootstrap weight: " + _COUNTS),
    # The §4.4 extension loops (the reference's four entries).  They are
    # sequential host loops with no batched or device-side twin whose
    # selections or bills must match theirs; they reproduce the reference's
    # own host arithmetic, which these four lines are.
    Allow(file="core/extensions.py", rule="raw-argmax",
          match="int(score.argmax())",
          why="the extension loops' host numpy argmax, first index on ties, "
              "as the reference takes it: the loops have no batched or "
              "device twin whose picks must match, and one host argmax has "
              "no second compilation whose rounding could differ"),
    Allow(file="core/extensions.py", rule="float-accum",
          match="beta -= billed",
          why="the multi-constraint loop's budget in Python floats, as the "
              "reference keeps it (its float64 job costs and bills): no "
              "device-side float32 replay of this loop exists to match"),
    Allow(file="core/extensions.py", rule="float-accum",
          match="beta -= cost[i] + fee",
          why="the setup-cost loop's budget in Python floats, as the "
              "reference keeps it: the same reasoning as the "
              "multi-constraint loop's budget"),
    Allow(file="core/extensions.py", rule="float-accum",
          match="setup_spent += fee",
          why="a reported total of the setup fees, never compared with "
              "device arithmetic nor fed back into a decision"),
]
