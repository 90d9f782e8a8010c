"""Serving launcher: batched prefill + greedy decode against ring KV caches
— ``repro.launch.serve`` on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --batch 4 --prompt-len 1000 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \\
      --smoke --device cpu --prompt-len 40 --gen 8

Runs on the card unless ``--device cpu`` is given.  Parameters are drawn
on the device from a seeded ``torch.Generator`` (float32, as the reference
serves).  The kernels are built before the timed run.  Prints the
reference's JSON keys, plus the device and the time of the (first)
prefill.  The whole batch of the arch's family goes to the prefill (a
VLM's vision prefix and M-RoPE ids with its tokens); an encoder-only arch
(HuBERT) has no decode step and is refused, as the reference refuses it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.train.step import make_serve_step

__all__ = ["generate", "main"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, flags, batch, prompt_len: int, gen: int,
             cache_len: int):
    """Greedy generation.  Returns (tokens [B, gen], decode tokens/s,
    prefill seconds).  The decode rate counts the ``gen - 1`` decode steps
    after the prefill, as the reference does; both times end in a device
    synchronize."""
    prefill, decode = make_serve_step(model, flags)
    device = batch["tokens"].device
    _sync(device)
    t0 = time.perf_counter()
    next_tok, caches = prefill(params, batch, cache_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    outs = [next_tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        next_tok, caches = decode(params, caches, outs[-1], prompt_len + i)
        outs.append(next_tok)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = torch.cat(outs, dim=1)
    return toks, toks.shape[0] * (gen - 1) / max(dt, 1e-9), prefill_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all()     # nvcc once, outside the timed prefill
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.float32, dev)
    batch = make_batch(cfg, "serve", args.batch, args.prompt_len, seed=0,
                       step=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
             if k != "targets"}
    cache_len = args.prompt_len + args.gen
    toks, tps, prefill_s = generate(model, params, flags, batch,
                                    args.prompt_len, args.gen, cache_len)
    print(json.dumps({"arch": cfg.name, "batch": args.batch,
                      "generated": int(toks.shape[1]),
                      "tokens_per_s": round(float(tps), 1),
                      "sample": toks[0, :10].tolist(),
                      "prefill_s": round(prefill_s, 4),
                      "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}))


if __name__ == "__main__":
    main()
