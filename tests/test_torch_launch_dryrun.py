"""The dry-run launcher (``repro_torch.launch.{specs,roofline,dryrun}``),
the kernels' meta branch and the tuner's real evaluator.

``specs`` and ``model_flops`` against the JAX package's for every arch
and shape; ``roofline_terms`` on the reference test's unit numbers;
``record_collectives`` on four hand-issued functional collectives with
the wire bytes of ``tests/test_dryrun_subprocess.py``'s parser test; one
cell (xlstm-125m decode_32k) on both production meshes and the hubert
skip through the command, as the reference's test runs its own; the
per-device count on a smoke config: a fake (4, 1) mesh gives exactly a
quarter of the (1, 1) mesh's flops (a mode above DTensor would count the
global op on both); the meta branch of each model kernel op raises on
what its kernel raises on, reports the kernel's work, and leaves a CPU
tensor's dispatch as it was; ``tune(mock=False)`` on a cheap cell, each
probe's step time the dry run's ``roofline.step_s`` for its point.

A fake world takes the process's process group, so every check that
needs one runs in a subprocess (``_PROBE``), which prints one JSON line.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import roofline as jrl
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels.dispatch import resolve_mode
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.kernels.ssm_scan.ops import linear_scan
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))
DTYPES = {jnp.int32: torch.int32, jnp.bool_: torch.bool,
          jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _jdtype(d):
    return next(v for k, v in DTYPES.items() if jnp.dtype(k) == d)


# --------------------------------------------------------------------------- #
# specs, model_flops, roofline_terms: against the JAX package
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jm = build_model(cfg), jax_build(jcfg)
    assert specs.runnable_cells([arch]) == jspecs.runnable_cells([arch])
    for shape in specs.SHAPES:
        assert specs.SHAPES[shape] == jspecs.SHAPES[shape]
        assert specs.skip_reason(arch, shape) == \
            jspecs.skip_reason(arch, shape)
        kind = specs.SHAPES[shape]["kind"]
        for fn, jfn in ((specs.train_input_specs, jspecs.train_input_specs),
                        (specs.prefill_input_specs,
                         jspecs.prefill_input_specs)):
            got, want = fn(cfg, shape), jfn(jcfg, shape)
            assert list(got) == list(want)
            for k in got:
                assert tuple(got[k].shape) == want[k].shape, (shape, k)
                assert got[k].dtype == _jdtype(want[k].dtype)
                assert got[k].device.type == "meta"
        if kind != "decode" or not specs.cell_is_runnable(arch, shape):
            continue
        caches, tokens, pos = specs.decode_input_specs(model, shape,
                                                       torch.float32)
        jc, jt, jpos = jspecs.decode_input_specs(jm, shape, jnp.float32)
        import jax
        assert [tuple(t.shape) for t in tree_leaves(caches)] == \
            [c.shape for c in jax.tree.leaves(jc)]
        assert all(t.dtype == torch.float32 for t in tree_leaves(caches))
        assert tuple(tokens.shape) == jt.shape and \
            tokens.dtype == torch.int32
        # the port's decode takes its position as a host int: the last slot
        assert jpos.shape == () and pos == specs.SHAPES[shape]["seq"] - 1


def test_model_flops_match_jax():
    for arch in ARCHS:
        for n, kind in ((1 << 20, "train"), (4096, "prefill"),
                        (128, "decode")):
            assert rl.model_flops(get_config(arch), n, kind) == \
                jrl.model_flops(jax_config(arch), n, kind)


def test_roofline_terms_units():
    """The reference test's unit numbers through both packages' formulas
    (the reference's peaks as the port's ``hw``), and the H100's peaks
    by dtype: each term 1 s at its own rate."""
    tpu = {"peak_flops": {"bfloat16": 197e12}, "hbm_bw": 819e9,
           "link_bw": 50e9}
    got = rl.roofline_terms(197e12, 819e9, 50e9, "bfloat16", tpu)
    assert got == jrl.roofline_terms(197e12, 819e9, 50e9)
    for dtype, peak in (("float32", 67e12), ("bfloat16", 989e12)):
        t = rl.roofline_terms(peak, 3.35e12, 450e9, dtype)
        for key in ("compute_s", "memory_s", "collective_s", "step_s"):
            assert t[key] == pytest.approx(1.0)
    t = rl.roofline_terms(67e12 * 2, 3.35e12, 450e9, "float32")
    assert t["bound"] == "compute" and t["roofline_fraction"] == 1.0


# --------------------------------------------------------------------------- #
# The kernels' meta branch: the kernel's checks, its work, no values
# --------------------------------------------------------------------------- #
def _m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


class _Costs(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def kernel_cost(self, op, ops, nbytes):
        self.calls.append((op, ops, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _prepare_on_meta(monkeypatch):
    """The kernels' ``prepare``s with the device rule lifted, so their
    checks run on meta tensors (their launch arguments never build)."""
    from repro_torch.kernels import capi
    monkeypatch.setattr(capi, "require_cuda", lambda op, t: t.device)


# (op, call of the op's entry, call of the kernel's prepare): bad inputs
_BAD = [
    ("head dim 300", lambda: flash_attention(_m(1, 2, 8, 300),
                                             _m(1, 2, 8, 300),
                                             _m(1, 2, 8, 300)),
     lambda: fa.prepare(_m(1, 2, 8, 300), _m(1, 2, 8, 300),
                        _m(1, 2, 8, 300))),
    ("3 heads over 2", lambda: flash_attention(_m(1, 3, 8, 32),
                                               _m(1, 2, 8, 32),
                                               _m(1, 2, 8, 32)),
     lambda: fa.prepare(_m(1, 3, 8, 32), _m(1, 2, 8, 32), _m(1, 2, 8, 32))),
    ("window 0", lambda: flash_attention(_m(1, 2, 8, 32), _m(1, 2, 8, 32),
                                         _m(1, 2, 8, 32), window=0),
     lambda: fa.prepare(_m(1, 2, 8, 32), _m(1, 2, 8, 32), _m(1, 2, 8, 32),
                        window=0)),
    ("mixed dtypes", lambda: flash_attention(
        _m(1, 2, 8, 32), _m(1, 2, 8, 32, dtype=torch.bfloat16),
        _m(1, 2, 8, 32)),
     lambda: fa.prepare(_m(1, 2, 8, 32),
                        _m(1, 2, 8, 32, dtype=torch.bfloat16),
                        _m(1, 2, 8, 32))),
    ("decode group width", lambda: decode_attention(
        _m(1, 64, 256), _m(1, 1, 16, 256), _m(1, 1, 16, 256), 3),
     lambda: __import__("repro_torch.kernels.decode_attention.kernel",
                        fromlist=["prepare"]).prepare(
        _m(1, 64, 256), _m(1, 1, 16, 256), _m(1, 1, 16, 256), 3)),
    ("scan chunk 0", lambda: linear_scan(
        _m(1, 8, 2, 4), _m(1, 8, 2, 5), _m(1, 8, 2, 4), _m(1, 8, 2),
        _m(1, 8, 2), chunk=0),
     lambda: sk.prepare(_m(1, 8, 2, 4), _m(1, 8, 2, 5), _m(1, 8, 2, 4),
                        _m(1, 8, 2), _m(1, 8, 2), chunk=0)),
    ("scan gate dtype", lambda: linear_scan(
        _m(1, 8, 2, 4), _m(1, 8, 2, 5), _m(1, 8, 2, 4), _m(1, 8, 2),
        _m(1, 8, 2, dtype=torch.bfloat16), chunk=4),
     lambda: sk.prepare(_m(1, 8, 2, 4), _m(1, 8, 2, 5), _m(1, 8, 2, 4),
                        _m(1, 8, 2), _m(1, 8, 2, dtype=torch.bfloat16),
                        chunk=4)),
]


@pytest.mark.parametrize("case,meta,kernel", _BAD, ids=[c[0] for c in _BAD])
def test_meta_branch_raises_as_the_kernel(case, meta, kernel, monkeypatch):
    with pytest.raises(Exception) as got:
        meta()
    _prepare_on_meta(monkeypatch)
    with pytest.raises(Exception) as want:
        kernel()
    assert type(got.value) is type(want.value), case
    assert str(got.value) == str(want.value), case


def test_meta_branch_refuses_a_bf16_gradient_and_reports_the_work():
    with pytest.raises(TypeError, match="float32"):
        flash_attention(_m(1, 2, 8, 32, dtype=torch.bfloat16, grad=True),
                        _m(1, 2, 8, 32, dtype=torch.bfloat16),
                        _m(1, 2, 8, 32, dtype=torch.bfloat16))
    q, k, v = _m(2, 4, 64, 32, grad=True), _m(2, 1, 64, 32), \
        _m(2, 1, 64, 32)
    scan = [_m(2, 40, 3, 16, grad=True), _m(2, 40, 3, 17), _m(2, 40, 3, 16),
            _m(2, 40, 3), _m(2, 40, 3)]
    with _Costs() as costs:
        o = flash_attention(q, k, v, causal=True, window=16)
        y, s = linear_scan(*scan, chunk=16)
        (o.sum() + y.sum() + s.sum()).backward()
        with torch.no_grad():
            d = decode_attention(_m(2, 4, 32), _m(2, 1, 100, 32),
                                 _m(2, 1, 100, 32), 50, window=20)
    assert o.device.type == y.device.type == d.device.type == "meta"
    assert q.grad.shape == q.shape and scan[0].grad.shape == scan[0].shape
    assert [c[0] for c in costs.calls] == [
        "flash_attention", "ssm_scan", "ssm_scan_bwd",
        "flash_attention_bwd", "decode_attention"]
    pairs = fa.live_pairs(64, 64, True, 16)
    assert pairs == sum(min(i + 1, 16) for i in range(64))
    assert costs.calls[0][1:] == (4 * 32 * 2 * 4 * pairs,
                                  2 * 2 * 4 * 64 * 32 * 4
                                  + 2 * 2 * 64 * 32 * 4 + 4 * 2 * 4 * 64)
    assert costs.calls[3][1] == 10 * 32 * 2 * 4 * pairs
    assert costs.calls[1][1:] == sk.cost(*scan, chunk=16)
    assert costs.calls[4][1] == 4 * 32 * 4 * 2 * 20      # 20 live slots
    with pytest.raises(ValueError, match="Python int"):
        decode_attention(_m(2, 4, 32), _m(2, 1, 100, 32), _m(2, 1, 100, 32),
                         _m(dtype=torch.int32))
    with pytest.raises(ValueError, match="meta for the ops"):
        resolve_mode("auto", torch.device("meta"), op="gh_ei")


def test_cpu_dispatch_is_unchanged():
    """A CPU tensor still takes the plain version, bit for bit, and
    reports no kernel work."""
    assert resolve_mode("auto", torch.device("cpu"), op="flash_attention") \
        == "ref"
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 16, 8), generator=g) for _ in range(3))
    with _Costs() as costs:
        got = flash_attention(q, k, v)
    assert torch.equal(got, fa_ref.attention_ref(q, k, v))
    assert costs.calls == []


# --------------------------------------------------------------------------- #
# Fake worlds, in a subprocess
# --------------------------------------------------------------------------- #
_PROBE = r"""
import json, sys, logging
import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.distributed.device_mesh import init_device_mesh
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
from repro_torch.launch import autotune as tat
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.shard import make_rules
out = {}

# four functional collectives: the parser test's shapes and group sizes
dryrun.fake_world(512)
g16 = init_device_mesh("cuda", (32, 16), mesh_dim_names=("a", "b"))
g4 = init_device_mesh("cuda", (128, 4), mesh_dim_names=("a", "b"))
g256 = init_device_mesh("cuda", (2, 256), mesh_dim_names=("a", "b"))
meta = lambda *s, dt: torch.empty(s, dtype=dt, device="meta")
with rl.record_collectives() as rec:
    fc.all_gather_tensor(meta(1, 1024, dt=torch.bfloat16), 0, (g16, 1))
    fc.all_reduce(meta(4096, dt=torch.float32), "sum", (g4, 1))
    fc.reduce_scatter_tensor(meta(2048, 128, dt=torch.bfloat16), "sum", 0,
                             (g256, 1))
    fc.broadcast(meta(64, dt=torch.bfloat16), 0, (g256, 1))
out["collectives"] = rec.stats().to_json()
out["calls"] = rec.calls

# per-device flops of a smoke train step on (1, 1) and (4, 1)
model = build_model(get_smoke_config("gemma-2b"))
flags = dryrun.default_flags("train", {})
for shape in ((1, 1), (4, 1)):
    dryrun.fake_world(shape[0] * shape[1])
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    c = dryrun.count(*dryrun.placed_step(model, "train", 8, 64, flags, mesh,
                                         make_rules()))
    out[f"flops_{shape[0]}x{shape[1]}"] = c["flops"]
    out[f"kernels_{shape[0]}x{shape[1]}"] = c["kernels"]

# the real evaluator under tune(mock=False), in process on the fake world
probes = []
real = tat.real_evaluator
def recording(*a, **kw):
    ev = real(*a, **kw)
    def evaluate(i):
        step_s, cost = ev(i)
        probes.append((int(i), step_s))
        return step_s, cost
    return evaluate
tat.real_evaluator = recording
res = tat.tune("gemma-2b", "decode_32k", "single", budget=0.1, slo=1.0,
               mock=False, out_dir=None, log=lambda *a: None, device="cpu")
space = tat.build_space(False)
want = {}
for i, _ in probes:
    if i not in want:
        flags_i, rules_i = tat.decode_point(space, i, False)
        want[i] = dryrun.analyze(*dryrun.lower_cell(
            "gemma-2b", "decode_32k", False, flags_i, rules_i))[
            "roofline"]["step_s"]
out["probes"] = probes
out["want"] = {str(i): s for i, s in want.items()}
out["recommended"] = int(res["recommended"])
out["explored"] = [int(i) for i in res["explored"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    r = subprocess.run([sys.executable, "-c", _PROBE], env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_record_collectives_wire_bytes(probe):
    """The parser test's collectives (all-gather bf16[16, 1024] over 16,
    all-reduce f32[4096] over 4, reduce-scatter bf16[8, 128] over 256, and
    a bf16[64] broadcast at the permute's cost) and its wire bytes."""
    st = probe["collectives"]
    assert st["counts"] == {"all-gather": 1, "all-reduce": 1,
                            "reduce-scatter": 1, "broadcast": 1}
    ag, ar, rs, cp = 16 * 1024 * 2, 4096 * 4, 8 * 128 * 2, 64 * 2
    assert st["result_bytes"] == {"all-gather": ag, "all-reduce": ar,
                                  "reduce-scatter": rs, "broadcast": cp}
    expect = (ag * 15 / 16) + (2 * ar * 3 / 4) + (rs * 255) + cp
    assert st["wire_bytes_per_device"] == pytest.approx(expect)
    assert [c[2] for c in probe["calls"]] == [16, 4, 256, 256]


def test_per_device_flops_are_local(probe):
    """A (4, 1) mesh's device does exactly a quarter of a (1, 1) mesh's
    products: the counter sits below DTensor, at the local shards."""
    one, four = probe["flops_1x1"], probe["flops_4x1"]
    assert one > 0 and four * 4 == one
    for op, k in probe["kernels_1x1"].items():
        assert probe["kernels_4x1"][op]["calls"] == k["calls"]
        assert probe["kernels_4x1"][op]["flops"] * 4 == k["flops"]


def test_real_evaluator_probes_are_the_dry_runs_step_times(probe):
    assert probe["probes"], "the tuner probed nothing"
    assert [i for i, _ in probe["probes"]] == probe["explored"]
    for i, step_s in probe["probes"]:
        assert step_s == probe["want"][str(i)] and step_s > 0
    assert probe["recommended"] in probe["explored"]


def _dryrun(tmp_path, arch, shape, mesh):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmp_path)],
        env=ENV, capture_output=True, text=True, timeout=600)


def test_dryrun_cell_single_and_multi(tmp_path):
    r = _dryrun(tmp_path, "xlstm-125m", "decode_32k", "both")
    assert r.returncode == 0, r.stderr[-2000:]
    for mesh in ("single", "multi"):
        d = json.loads((tmp_path / f"xlstm-125m__decode_32k__{mesh}.json"
                        ).read_text())
        assert "error" not in d, d.get("error")
        assert d["chips"] == (256 if mesh == "single" else 512)
        assert d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
        assert d["roofline"]["bound"] in ("compute", "memory", "collective")
        assert d["argument_size_in_bytes"] > 0
        assert np.isfinite(d["mfu_upper_bound"])


def test_skip_cells_are_documented(tmp_path):
    r = _dryrun(tmp_path, "hubert-xlarge", "decode_32k", "single")
    assert r.returncode == 0
    d = json.loads((tmp_path / "hubert-xlarge__decode_32k__single.json"
                    ).read_text())
    assert "skipped" in d and "encoder-only" in d["skipped"]
