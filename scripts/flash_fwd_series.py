"""Time and check the float32 flash-attention forward on the card.

    python3 scripts/flash_fwd_series.py [--old FILE.cu] [--flex]
                                        [--only SUBSTRING,...]

For every shape of ``SHAPES`` (the zoo's serving calls, phase ops'
float32 cases of ``chip_smoke.py``, gemma-2b's training shape, and edge
cases of the tiling) it prints one ``[series]`` line and writes them all
to ``chiprun_out/flash_fwd_series.json``:

- ``ms``: the kernel of this tree (``csrc/flash_attention.cu``) with
  ``kernel.fwd_plan``'s tiling, CUDA events around back-to-back launches;
- with ``--old``: another tree's ``flash_attention.cu``, whose float32
  entry takes no plan (the CUDA-core kernel this one replaced), built with
  the same flags, timed in turns old, new, new, old (``old_ms``);
- ``library_ms``: SDPA's float32 call where there is no softcap or window
  and S = T or no causal mask; with ``--flex`` a compiled
  ``flex_attention`` at the zoo's other shapes;
- ``bound_ms`` (4·D·H·B·pairs at float32's 67 TFLOP/s, or the bytes at
  3.35 TB/s) and ``bound_split_tf32_ms`` (three products each at TF32's
  495 TFLOP/s);
- ``max_abs_err`` of o against ``ref.attention_ref`` and ``lse_err`` of
  the lse against ``ref.attention_fwd_ref``'s, each held at 2e-5 +
  2e-5·|want| elementwise (phase ops' tolerance), and the old kernel's
  (``old_err``); ``bitwise``: two runs give the same bits.

It first builds the kernels and prints ``-Xptxas -v``'s lines for the
forward; an instantiation of ``flash_tf32_kernel`` that spills is timed
all the same and fails the run at its end.  Exits 1 if a check fails, 2
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

TOL = (2e-5, 2e-5)
G2 = 256 ** -0.5
# (label, B, H, KH, S, T, D, causal, window, softcap, scale; None: D^-0.5)
SHAPES = (
    ("zamba2-7b site: B 4, H 32, S 1000, D 112, causal", 4, 32, 32, 1000,
     1000, 112, True, None, None, None),
    ("gemma2-9b serving layer 0: B 2, H 16, KH 8, S 4608, D 256, window "
     "4096, softcap 50", 2, 16, 8, 4608, 4608, 256, True, 4096, 50.0, G2),
    ("gemma2-9b serving layer 1: global, softcap 50", 2, 16, 8, 4608, 4608,
     256, True, None, 50.0, G2),
    ("mixtral-8x22b layer 0: B 2, H 48, KH 8, S 4608, D 128, window 4096",
     2, 48, 8, 4608, 4608, 128, True, 4096, None, None),
    ("deepseek-v3 MLA layer 0: B 2, H 128, S 2048, D 192", 2, 128, 128,
     2048, 2048, 192, True, None, None, None),
    ("qwen2-vl-2b: B 4, H 12, KH 2, S 1280, D 128", 4, 12, 2, 1280, 1280,
     128, True, None, None, None),
    ("hubert-xlarge: B 4, H 16, S 1000, D 80, non-causal", 4, 16, 16, 1000,
     1000, 80, False, None, None, None),
    ("ops gemma2-9b local: B 1, S 8192, window 4096, softcap 50", 1, 16, 8,
     8192, 8192, 256, True, 4096, 50.0, G2),
    ("ops gemma2-9b global: softcap 50", 1, 16, 8, 8192, 8192, 256, True,
     None, 50.0, G2),
    ("ops gemma2-9b causal", 1, 16, 8, 8192, 8192, 256, True, None, None,
     G2),
    ("ops gemma2-9b non-causal", 1, 16, 8, 8192, 8192, 256, False, None,
     None, G2),
    ("ops deepseek-v3 MLA: B 1, v zero-padded", 1, 128, 128, 2048, 2048,
     192, True, None, None, None),
    ("ops hubert-xlarge: B 1", 1, 16, 16, 1000, 1000, 80, False, None, None,
     None),
    ("ops D 192, GQA 4, S = T = 777, window 300", 1, 8, 2, 777, 777, 192,
     True, 300, None, None),
    ("gemma-2b training: B 1, H 8, KH 1, S 2048, D 256, causal", 1, 8, 1,
     2048, 2048, 256, True, None, None, None),
    ("edge: S = T = 1000, D 256, window 300, softcap 50", 1, 16, 8, 1000,
     1000, 256, True, 300, 50.0, G2),
    ("edge: cross S 200, T 1000, D 256, non-causal", 1, 16, 8, 200, 1000,
     256, False, None, None, None),
    ("edge: D 100, S = T = 500, causal, softcap 30", 1, 4, 2, 500, 500, 100,
     True, None, 30.0, None),
    ("edge: MQA, D 128, S = T = 777, window 200", 1, 8, 1, 777, 777, 128,
     True, 200, None, None),
    ("edge: D 64, S = T = 333, window 100", 1, 4, 4, 333, 333, 64, True,
     100, None, None),
    ("edge: D 36, S 70, T 90, non-causal", 2, 2, 1, 70, 90, 36, False,
     None, None, None),
    ("edge: D 4, S 130, T 130, causal", 1, 3, 3, 130, 130, 4, True, None,
     None, None),
)


def _build_old(path: pathlib.Path):
    """The float32 entry of another tree's flash_attention.cu, built with
    this tree's flags (its argument list takes no plan)."""
    from repro_torch.kernels import build, capi
    out = ROOT / "build" / "series" / "flash_attention_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.argtypes = ([capi.P] * 5 + [capi.I] * 7
                   + [capi.F, capi.I, capi.I, capi.I, capi.F, capi.P])
    fn.restype = capi.I
    return fn


def _check(got, want):
    import torch
    a, b = got.double(), want.double()
    diff = (a - b).abs()
    err = diff.nan_to_num(nan=float("inf")).max().item()
    bad = int((~(diff <= TOL[0] + TOL[1] * b.abs())).sum())
    del a, b, diff
    torch.cuda.empty_cache()
    return err, bad


def run_case(case, old_fn, flex, device):
    import torch
    from repro_torch.kernels import capi
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

    label, b, h, kh, s, t, d, causal, window, softcap, scale = case
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    gen = torch.Generator(device=device).manual_seed(s + t + d + h)
    q = torch.randn((b, h, s, d), generator=gen, device=device)
    k = torch.randn((b, kh, t, d), generator=gen, device=device)
    v = torch.randn((b, kh, t, d), generator=gen, device=device)
    if "zero-padded" in label:
        v[..., 128:] = 0
    plan = fa.fwd_plan(b, h, kh, s, t, d, causal, window)
    want_o, want_lse = attention_fwd_ref(q, k, v, **kw)
    failures = []
    row = dict(case=label, B=b, H=h, KH=kh, S=s, T=t, D=d, causal=causal,
               window=window, softcap=softcap, plan=plan._asdict())

    prep, (o, lse), keep = fa.prepare(q, k, v, want_lse=True, **kw)
    fa.launch(prep)
    _, (o2, lse2), keep2 = fa.prepare(q, k, v, want_lse=True, **kw)
    fa.launch(_)
    torch.cuda.synchronize()
    row["bitwise"] = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
    row["max_abs_err"], bad = _check(o, want_o)
    row["lse_err"], bad_lse = _check(lse, want_lse)
    if bad or bad_lse:
        failures.append(f"{label}: {bad} outputs, {bad_lse} lse outside "
                        f"{TOL}")
    if not row["bitwise"]:
        failures.append(f"{label}: two runs differ")
    del o2, lse2, keep2, lse
    serve, serve_o, serve_keep = fa.prepare(q, k, v, **kw)   # no lse
    n = 3 if s * t * h * b > 4e8 else 20
    ms = lambda args: cs._launch_ms(lambda: fa.launch(args), n=n, warmup=2)
    if old_fn is not None:
        old_o = torch.empty_like(q)
        old_args = (serve[0], serve[1], serve[2], old_o.data_ptr(), None,
                    *serve[5:17], serve[-1])
        capi.raise_on_error("old", old_fn(*old_args))
        torch.cuda.synchronize()
        row["old_err"], bad_old = _check(old_o, want_o)
        if bad_old:
            failures.append(f"{label}: the old kernel, {bad_old} outputs "
                            f"outside {TOL}")
        old = lambda: cs._launch_ms(lambda: old_fn(*old_args), n=n,
                                    warmup=2)
        t_old = [old()]
        t_new = [ms(serve), ms(serve)]
        t_old.append(old())
        row["old_ms"] = sum(t_old) / 2
        row["ms"] = sum(t_new) / 2
        row["old_runs_ms"], row["runs_ms"] = t_old, t_new
        del old_o
    else:
        row["ms"] = ms(serve)
    del want_o, want_lse
    torch.cuda.empty_cache()
    lib = None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if softcap is None and window is None and (s == t or not causal):
        lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale,
                           enable_gqa=kh != h)
        row["library"] = "sdpa"
    elif flex and not label.startswith(("edge", "ops D 192")):
        # The zoo's shapes only: each shape is a graph of its own, and
        # the yardstick's compile raises past dynamo's recompile limit.
        lib = cs._flex_attention(q, k, v, **kw)
        row["library"] = "flex_attention (compiled)"
    row["library_ms"] = (None if lib is None
                         else cs._launch_ms(lib, n=n, warmup=2))
    ops, nbytes = fa.cost(q, k, v, causal=causal, window=window)
    byte_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    row["bound_ms"] = max(ops / cs.FP32_OPS_PER_S * 1e3, byte_ms)
    row["bound_split_tf32_ms"] = max(3 * ops / cs.TF32_OPS_PER_S * 1e3,
                                     byte_ms)
    row["ops"], row["bytes"] = ops, nbytes
    del prep, keep, serve, serve_o, serve_keep, q, k, v
    torch.cuda.empty_cache()
    return row, failures


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", default=None,
                        help="another tree's csrc/flash_attention.cu, "
                             "timed beside this one")
    parser.add_argument("--flex", action="store_true",
                        help="a compiled flex_attention as the library call "
                             "where SDPA cannot take the mask")
    parser.add_argument("--only", default=None,
                        help="run the shapes whose label holds one of "
                             "these comma-separated substrings")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_fwd_series: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import set_cuda_determinism
    from repro_torch.kernels import build
    set_cuda_determinism()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all(("flash_attention",))
    print(f"[series] build_s={time.perf_counter() - t0:.1f}", flush=True)
    for ln in logs["flash_attention"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"[build] {ln.strip()}", flush=True)
    spilled = {fn: n for fn, n in cs._spills(logs).items()
               if n and "flash_tf32_kernel" in fn}
    print(f"[series] spilled={json.dumps(spilled)}", flush=True)
    old_fn = _build_old(pathlib.Path(args.old)) if args.old else None
    rows, failures = [], []
    for case in SHAPES:
        if args.only and not any(x in case[0]
                                 for x in args.only.split(",")):
            continue
        row, bad = run_case(case, old_fn, args.flex, device)
        rows.append(row)
        failures += bad
        cs._line("series", **{k: (json.dumps(v) if isinstance(v, dict)
                                  else cs._fmt(k, v))
                              for k, v in row.items()})
    out = ROOT / "chiprun_out" / "flash_fwd_series.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    failures += [f"{fn} spills {n} bytes" for fn, n in spilled.items()]
    for f in failures:
        print(f"[series] FAIL {f}", flush=True)
    print(f"[series] cases={len(rows)} failures={len(failures)} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
