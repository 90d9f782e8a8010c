"""The port's mock launch-config tuner against ``repro.launch.autotune``.

``tune("mixtral-8x22b", "train_4k", "single", budget=1000, slo=1.5,
mock=True, la=2)``: the bootstrap and some 45 depth-2 selections over the
180-point launch space (the reference test's budget of 400 runs the
bootstrap only), on the CPU, bitwise against the JAX tuner and the golden
file's entry, file written included.  One JAX run and one port run, each
some 7-20 s.
"""

import functools
import json

import torch

from repro_torch.launch import autotune as tat
from test_torch_golden_extensions import golden_case, jax_autotune

torch.set_num_threads(1)

ARGS = ("mixtral-8x22b", "train_4k", "single")
KW = dict(budget=1000.0, slo=1.5, mock=True, la=2, log=lambda *a: None)
FILE = "mixtral-8x22b__train_4k__single.json"


@functools.lru_cache(maxsize=None)
def _runs(tmp):
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    want = jax_autotune().tune(*ARGS, out_dir=str(jax_dir), **KW)
    got = tat.tune(*ARGS, out_dir=str(port_dir), device="cpu", **KW)
    return (json.loads(json.dumps(want, default=str)),
            json.loads(json.dumps(got, default=str)),
            (jax_dir / FILE).read_text(), (port_dir / FILE).read_text())


def test_tune_at_budget_1000_matches_jax(tmp_path_factory):
    want, got, _, _ = _runs(tmp_path_factory.getbasetemp())
    assert got == want
    # the selection loop ran: beyond the bootstrap's 6 probes
    assert len(got["explored"]) > 6 and got["censored"]


def test_tune_writes_the_reference_file(tmp_path_factory):
    _, _, want, got = _runs(tmp_path_factory.getbasetemp())
    assert got == want


def test_golden_tune_entry_equals_fresh_jax_output(tmp_path_factory):
    want, _, _, _ = _runs(tmp_path_factory.getbasetemp())
    assert golden_case("tune/mixtral-8x22b")["out"] == want
