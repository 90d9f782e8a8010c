"""The port's AST determinism lint (``repro_torch.analysis.ast_lint``).

Three parts: the four rules it shares with the JAX package's lint give the
same (rule, line) findings as ``repro.analysis.ast_lint`` on the snippets
of ``tests/test_ast_lint.py``, translated to torch (``jax.random.split``
-> ``prng.split``, ``jnp.argmax`` -> ``torch.argmax``); each torch rule
fires on a seeded snippet and stays quiet on its clean twin; and
``src/repro_torch`` lints clean with a live allowlist.  Snippets are laid
out under tmp_path as ``src/repro[_torch]/<scope>/`` so the per-rule scopes
are exercised too.
"""

import pathlib
import textwrap

import pytest

from repro.analysis.ast_lint import lint_file as jax_lint_file
from repro_torch.analysis.allowlist import ALLOWLIST, Allow
from repro_torch.analysis.ast_lint import lint_file, lint_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _lint(tmp_path, package, relpath, code, linter):
    path = tmp_path / "src" / package / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return [(f.rule, f.line) for f in linter(path, tmp_path)]


def _port(tmp_path, relpath, code):
    return _lint(tmp_path, "repro_torch", relpath, code, lint_file)


# (scope path, the reference snippet, its torch translation, the findings
# the reference test expects)
SHARED = {
    "raw_argmax_in_core": ("core/c.py", """
        import jax.numpy as jnp

        def pick(score):
            return jnp.argmax(score)
    """, """
        import torch

        def pick(score):
            return torch.argmax(score)
    """, [("raw-argmax", 5)]),
    "raw_argmax_out_of_scope": ("train/t.py", """
        import jax.numpy as jnp

        def pick(score):
            return jnp.argmax(score)
    """, """
        import torch

        def pick(score):
            return torch.argmax(score)
    """, []),
    "raw_argmax_resolves_quantized_assignment": ("core/c.py", """
        import jax.numpy as jnp
        from repro.core.acquisition import quantize_scores

        def pick(ei):
            score = quantize_scores(ei)
            return jnp.argmax(score)
    """, """
        import torch
        from repro_torch.core.acquisition import quantize_scores

        def pick(ei):
            score = quantize_scores(ei)
            return torch.argmax(score)
    """, []),
    "raw_argmax_method_call_on_score_like_name": ("core/c.py", """
        def pick(score, cost):
            a = int(score.argmax())      # score-like: flagged
            b = int(cost.argmin())       # exact-table lookup: not a score
            return a, b
    """, """
        def pick(score, cost):
            a = int(score.argmax())      # score-like: flagged
            b = int(cost.argmin())       # exact-table lookup: not a score
            return a, b
    """, [("raw-argmax", 3)]),
    "nonliteral_split_in_core": ("core/c.py", """
        import jax

        def keys(key, m):
            return jax.random.split(key, m)
    """, """
        from repro_torch.core import prng

        def keys(key, m):
            return prng.split(key, m)
    """, [("nonliteral-split", 5)]),
    "nonliteral_split_in_service": ("service/s.py", """
        import jax

        def keys(key, m):
            return jax.random.split(key, m)
    """, """
        from repro_torch.core import prng

        def keys(key, m):
            return prng.split(key, m)
    """, [("nonliteral-split", 5)]),
    "literal_split": ("core/c2.py", """
        import jax

        def keys(key):
            return jax.random.split(key, 3)
    """, """
        from repro_torch.core import prng

        def keys(key):
            return prng.split(key, 3)
    """, []),
    "float_accum_fires_on_python_float_state": ("core/c.py", """
        def run(budget: float, costs):
            beta = budget
            for c in costs:
                beta -= c
            return beta
    """, """
        def run(budget: float, costs):
            beta = budget
            for c in costs:
                beta -= c
            return beta
    """, [("float-accum", 5)]),
    "float_accum_quiet_on_np_float32_state": ("core/c.py", """
        import numpy as np

        def run(budget: float, costs):
            beta = np.float32(budget)
            for c in costs:
                beta -= c
            return beta
    """, """
        import numpy as np

        def run(budget: float, costs):
            beta = np.float32(budget)
            for c in costs:
                beta -= c
            return beta
    """, []),
    "hash_derivation_fires_everywhere": ("models/m.py", """
        def tag(path):
            return abs(hash(path)) % (2**31)
    """, """
        def tag(path):
            return abs(hash(path)) % (2**31)
    """, [("hash-derivation", 3)]),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rules_match_the_reference_lint(tmp_path, case):
    scope, jax_code, torch_code, expected = SHARED[case]
    want = _lint(tmp_path, "repro", scope, jax_code, jax_lint_file)
    got = _port(tmp_path, scope, torch_code)
    assert want == expected
    assert got == want


# (scope path, seeded snippet, its clean twin, the rule)
TORCH_RULES = {
    "sum": ("core/trees.py", """
        def f(x):
            return x.sum(dim=1)
    """, """
        def xla_sum(x):
            return x.sum(dim=1)
    """, "unpinned-reduction"),
    "torch_mean": ("core/lookahead.py", """
        import torch

        def f(x):
            return torch.mean(x)
    """, """
        import numpy as np

        def f(x):
            return np.mean(x)
    """, "unpinned-reduction"),
    "std": ("core/acquisition.py", """
        def f(x):
            return x.std(dim=0)
    """, """
        def gh_expect(x):
            return x.std(dim=0)
    """, "unpinned-reduction"),
    "matmul_operator": ("kernels/select_step/ref.py", """
        def f(a, b):
            return a @ b
    """, """
        def _xla_dot(a, b):
            return a @ b
    """, "unpinned-reduction"),
    "torch_matmul": ("core/acquisition.py", """
        import torch

        def f(a, b):
            return torch.matmul(a, b)
    """, """
        import torch

        def f(a, b):
            return torch.minimum(a, b)
    """, "unpinned-reduction"),
    "tf32_flag": ("device.py", """
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
    """, """
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
    """, "tf32"),
    "tf32_precision": ("models/m.py", """
        import torch

        torch.set_float32_matmul_precision("high")
    """, """
        import torch

        torch.set_float32_matmul_precision("highest")
    """, "tf32"),
    "triton_launch": ("kernels/k.py", """
        import triton

        def run(kernel, x):
            kernel[(1,)](x, BLOCK=128)
    """, """
        import triton

        def run(kernel, x):
            kernel[(1,)](x, BLOCK=128, enable_fp_fusion=False)
    """, "triton-fp-fusion"),
}


@pytest.mark.parametrize("case", sorted(TORCH_RULES))
def test_torch_rule_fires_and_its_twin_is_quiet(tmp_path, case):
    scope, seeded, clean, rule = TORCH_RULES[case]
    assert [r for r, _ in _port(tmp_path, scope, seeded)] == [rule]
    assert _port(tmp_path, scope, clean) == []


def test_unpinned_reduction_is_scoped_to_decision_modules(tmp_path):
    assert _port(tmp_path, "models/m.py", """
        def f(x):
            return x.sum() + x.mean()
    """) == []


def test_repo_lints_clean_with_live_allowlist():
    findings, suppressed, stale = lint_tree(ROOT)
    assert findings == [], [str(f) for f in findings]
    assert stale == [], [f"{a.file}:{a.rule}:{a.match}" for a in stale]
    assert suppressed, "allowlist suppressed nothing — entries went stale?"


def test_allowlist_suppresses_and_reports_stale(tmp_path):
    path = tmp_path / "src" / "repro_torch" / "core" / "c.py"
    path.parent.mkdir(parents=True)
    path.write_text("def tag(p):\n    return hash(p)\n")
    live = Allow(file="core/c.py", rule="hash-derivation",
                 match="hash(p)", why="test")
    stale_entry = Allow(file="core/zzz.py", rule="raw-argmax",
                        match="nope", why="test")
    findings, suppressed, stale = lint_tree(
        tmp_path, allowlist=[live, stale_entry])
    assert findings == []
    assert len(suppressed) == 1 and suppressed[0].rule == "hash-derivation"
    assert stale == [stale_entry]


def test_allowlist_entries_all_carry_justifications():
    for a in ALLOWLIST:
        assert a.why and len(a.why) > 20, (
            f"{a.file}:{a.rule} needs a real justification")
