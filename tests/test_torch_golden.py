"""The golden Outcomes that ``chip_smoke.py`` holds the card against.

``src/repro_torch/testdata/golden_outcomes.json`` holds the pinned Outcome
fields of the JAX package's sequential oracle (CPU) on ``synthetic_job(0)``
at lookahead 2, timeout off and on.  The card cannot run the JAX package,
so the smoke run compares its outcomes with this file; the tests here keep
the file from going stale (regenerated from JAX, it must be equal) and
check that the port's CPU path reproduces it.

Regenerate with ``PYTHONPATH=src python tests/test_torch_golden.py``.
"""

import json
import pathlib

import torch

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_outcomes.json")
JOB_SEED, N_RUNS, BUDGET_B = 0, 4, 6.0
CASES = [dict(policy="lynceus", la=2, k_gh=3, n_trees=4, depth=3,
              timeout=timeout) for timeout in (False, True)]


def golden_payload() -> dict:
    from repro.core import Settings, run_many
    from repro.jobs.synthetic import synthetic_job
    from repro.obs.forensics import outcome_to_dict
    job = synthetic_job(JOB_SEED)
    cases = []
    for c in CASES:
        outs = run_many(job, Settings(**c), n_runs=N_RUNS, budget_b=BUDGET_B)
        cases.append({"settings": c,
                      "outcomes": [outcome_to_dict(o) for o in outs]})
    payload = {"job_seed": JOB_SEED, "n_runs": N_RUNS, "budget_b": BUDGET_B,
               "source": "repro.core.optimizer.run_many on the CPU",
               "cases": cases}
    return json.loads(json.dumps(payload))


def test_golden_file_equals_fresh_jax_outcomes():
    assert json.loads(GOLDEN.read_text()) == golden_payload()


def test_port_cpu_reproduces_golden_file():
    from repro_torch.core import Settings, run_many
    from repro_torch.jobs.synthetic import synthetic_job
    from repro_torch.obs.forensics import outcome_to_dict
    golden = json.loads(GOLDEN.read_text())
    job = synthetic_job(golden["job_seed"])
    for case in golden["cases"]:
        outs = run_many(job, Settings(**case["settings"]),
                        n_runs=golden["n_runs"], budget_b=golden["budget_b"],
                        device="cpu")
        got = json.loads(json.dumps([outcome_to_dict(o) for o in outs]))
        assert got == case["outcomes"], case["settings"]


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden_payload(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
