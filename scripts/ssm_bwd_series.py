"""Time and check the ssm_scan backward kernel on the card.

    python3 scripts/ssm_bwd_series.py [--old FILE.cu] [--only SUBSTRING,...]

For every shape of ``SHAPES`` (the three ``chip_smoke.SSM_BWD_CASES``:
zamba2-7b's layer, xlstm-125m's mLSTM and an edge case; the mLSTM form at
N 192, P 193; zamba2-7b's widths at chunks 64 and 128) it prints one
``[series]`` line and writes them all to
``chiprun_out/ssm_bwd_series.json``:

- ``ms``: the backward of this tree (``csrc/ssm_scan_bwd.cu``) with
  ``kernel.plan_bwd``'s tiling, host-launched calls between CUDA events,
  and ``kernel_ms``, each of its kernels launched alone
  (``kernel.BWD_PHASES``);
- with ``--old``: another tree's ``ssm_scan_bwd.cu``, whose C entry takes
  no plan and no dq workspace (the CUDA-core design this one replaced),
  built with the same flags and timed on the same inputs in turns old,
  new, new, old (``old_ms``, and its kernels' ``old_kernel_ms``);
- ``plan``: ``kernel.plan_bwd``'s fields;
- ``bound_ms`` (the smaller of the chunked form's and the recurrence's
  float32 operations at 67 TFLOP/s, or the bytes at 3.35 TB/s) and
  ``bound_split_tf32_ms`` (three TF32 products of the chunked form's
  count at 495 TFLOP/s), as ``kernel.work_bwd`` counts them;
  ``useful_tflops``: the chunked form's float32 operations over ``ms``;
- ``errs``: each gradient's largest error against the plain backward
  evaluated in float64, held within ``chip_smoke.BWD_TOL`` times its
  largest magnitude (``old_errs`` the old kernel's); ``bitwise``: two
  runs give the same bits.

It first builds the kernel and prints ``-Xptxas -v``'s lines for it; a
kernel of the backward listed in ``chip_smoke.NO_SPILL`` that spills is
timed all the same and fails the run at its end.  Exits 1 if a check
fails, 2 without a card.
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

ZAMBA = cs.SSM_BWD_CASES[0]
MLSTM = cs.SSM_BWD_CASES[1]
# chip_smoke.SSM_BWD_CASES' form: (label, B, L, H, N, P, chunk, k/q
# broadcast, initial state, dS_final, zero gates).
SHAPES = cs.SSM_BWD_CASES + (
    ("mLSTM form at N 192, P 193: B 4, L 2048, H 4", *MLSTM[1:4], 192, 193,
     *MLSTM[6:]),
    ("zamba2-7b widths at chunk 64", *ZAMBA[1:6], 64, *ZAMBA[7:]),
    ("zamba2-7b widths at chunk 128", *ZAMBA[1:6], 128, *ZAMBA[7:]),
)
NAMES = ("dk", "dv", "dq", "d_log_decay", "d_gate", "d_initial_state")
# The old entry's kernels, as bits of its ``phases``.
OLD_PHASES = {"cum": 1, "dstate": 2, "state_pass": 4, "dq": 8, "dkdv": 16,
              "dlog": 32}


def _build_old(path: pathlib.Path):
    """The C entry of another tree's ssm_scan_bwd.cu, built with this
    tree's flags (20 pointers, the strides, eight ints and the stream)."""
    from repro_torch.kernels import build, capi
    out = ROOT / "build" / "series" / "ssm_scan_bwd_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(out)).ssm_scan_bwd_launch
    fn.argtypes = ([capi.P] * 20 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [capi.I] * 8 + [capi.P])
    fn.restype = capi.I
    return fn, res.stdout + res.stderr


def _old_args(prep, b, l, h, n, p, chunk, chunks):
    """The old entry's arguments on the new call's inputs and outputs:
    its own scratch (ΔG/G, the cumsum, exp(total) and the dot products'
    slots of 64-column tiles), the new workspace and plan dropped."""
    import torch
    dev = torch.device("cuda")
    pad = -(-chunk // 64) * 64
    gs = torch.empty((b, h, chunks, n, p), device=dev)
    cum = torch.empty((b, h, chunks, pad), dtype=torch.int64, device=dev)
    etot = torch.empty((b, h, chunks), device=dev)
    parts = torch.empty((2, -(-n // 64), b, h, l), device=dev)
    args = (*prep[:15], gs.data_ptr(), cum.data_ptr(), etot.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), prep[21], *prep[23:31])
    return args, (gs, cum, etot, parts)


def _errs(got, want, tol):
    errs, tols = {}, {}
    for name, a, w in zip(NAMES, got, want):
        errs[name] = (a.double() - w).abs().nan_to_num(
            nan=float("inf")).max().item()
        tols[name] = tol * w.abs().max().item()
    return errs, tols


def run_case(i, case, old_fn, device):
    import torch
    from repro_torch.kernels import capi
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import linear_scan_bwd_ref

    label = case[0]
    args, kw, dy, dfin = cs._ssm_bwd_inputs(device, i, case)
    b, l, h, n = args[0].shape
    p = args[1].shape[-1]
    plan = sk.plan_bwd(b, l, h, n, p, kw["chunk"])
    _, s_fin, states = sk.ssm_scan_cuda(*args, want_states=True, **kw)
    bkw = dict(kw, states=states, final_state=s_fin)
    prep, got, keep = sk.prepare_bwd(*args, dy, dfin, **bkw)
    sk.launch_bwd(prep)
    prep2, again, keep2 = sk.prepare_bwd(*args, dy, dfin, **bkw)
    sk.launch_bwd(prep2)
    torch.cuda.synchronize()
    row = dict(case=label, B=b, L=l, H=h, N=n, P=p, chunk=kw["chunk"],
               plan=plan._asdict())
    row["bitwise"] = all(torch.equal(x, y) for x, y in zip(got, again))
    del prep2, again, keep2
    f64 = lambda t: None if t is None else t.double()
    want = linear_scan_bwd_ref(*map(f64, args), f64(dy), f64(dfin),
                               chunk=kw["chunk"],
                               initial_state=f64(kw["initial_state"]))
    m = 6 if kw["initial_state"] is not None else 5
    row["errs"], row["tols"] = _errs(got[:m], want[:m], cs.BWD_TOL)
    failures = []
    bad = {k: e for k, e in row["errs"].items() if not e <= row["tols"][k]}
    if bad:
        failures.append(f"{label}: errors {bad} over {row['tols']}")
    if not row["bitwise"]:
        failures.append(f"{label}: two runs differ")
    timed = lambda fn: cs._launch_ms(fn, n=5, warmup=1)
    new = lambda: sk.launch_bwd(prep)
    if old_fn is not None:
        old_out = [torch.empty_like(t) for t in got]
        oargs = list(prep)
        for j, t in zip((9, 10, 11, 12, 13, 14), (0, 2, 1, 3, 4, 5)):
            oargs[j] = old_out[t].data_ptr()
        old_args, old_keep = _old_args(oargs, b, l, h, n, p, kw["chunk"],
                                       plan.chunks)
        call = lambda bits=63: capi.raise_on_error(
            "old", old_fn(*old_args[:-1], bits, old_args[-1]))
        call()
        torch.cuda.synchronize()
        row["old_errs"], _ = _errs(old_out[:m], want[:m], cs.BWD_TOL)
        t_old = [timed(call)]
        t_new = [timed(new), timed(new)]
        t_old.append(timed(call))
        row["old_ms"], row["ms"] = sum(t_old) / 2, sum(t_new) / 2
        row["old_runs_ms"], row["runs_ms"] = t_old, t_new
        row["speedup"] = row["old_ms"] / row["ms"]
        row["old_kernel_ms"] = {k: timed(lambda bit=bit: call(bit))
                                for k, bit in OLD_PHASES.items()}
        del old_out, old_keep
    else:
        row["ms"] = timed(new)
    row["kernel_ms"] = {k: timed(lambda bit=bit: sk.launch_bwd(prep, bit))
                        for k, bit in sk.BWD_PHASES.items()}
    del want
    nbytes, recurrence, chunked = sk.work_bwd(
        *args, dy, dfin, chunk=kw["chunk"],
        initial_state=kw.get("initial_state"), states=states)
    bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    row["bound_ms"] = max(min(recurrence, chunked) / cs.FP32_OPS_PER_S
                          * 1e3, bytes_ms)
    row["bound_split_tf32_ms"] = max(3 * chunked / cs.TF32_OPS_PER_S * 1e3,
                                     bytes_ms)
    row["useful_tflops"] = chunked / row["ms"] * 1e-9
    row["ops_chunked"], row["bytes"] = chunked, nbytes
    del prep, keep, got, states, s_fin, args, dy, dfin
    torch.cuda.empty_cache()
    return row, failures


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", default=None,
                        help="another tree's csrc/ssm_scan_bwd.cu, timed "
                             "beside this one")
    parser.add_argument("--only", default=None,
                        help="run the shapes whose label holds one of "
                             "these comma-separated substrings")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_bwd_series: no CUDA device", file=sys.stderr)
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
    logs = build.build_all(("ssm_scan", "ssm_scan_bwd"))
    print(f"[series] build_s={time.perf_counter() - t0:.1f}", flush=True)
    for ln in logs["ssm_scan_bwd"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"[build] {ln.strip()}", flush=True)
    spilled = {fn: k for fn, k in cs._spills(logs).items()
               if k and any(name in fn for name in cs.NO_SPILL
                            if name.startswith("ssm_bwd_"))}
    print(f"[series] spilled={json.dumps(spilled)}", flush=True)
    old_fn = None
    if args.old:
        old_fn, old_log = _build_old(pathlib.Path(args.old))
        for ln in old_log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build old] {ln.strip()}", flush=True)
    rows, failures = [], []
    for i, case in enumerate(SHAPES):
        if args.only and not any(x in case[0]
                                 for x in args.only.split(",")):
            continue
        row, bad = run_case(i % len(cs.SSM_BWD_CASES), case, old_fn, device)
        rows.append(row)
        failures += bad
        cs._line("series", **{k: (json.dumps(v) if isinstance(v, dict)
                                  else cs._fmt(k, v))
                              for k, v in row.items()})
    out = ROOT / "chiprun_out" / "ssm_bwd_series.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    failures += [f"{fn} spills {k} bytes" for fn, k in spilled.items()]
    for f in failures:
        print(f"[series] FAIL {f}", flush=True)
    print(f"[series] cases={len(rows)} failures={len(failures)} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
