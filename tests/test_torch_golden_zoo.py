"""The golden logits of the model zoo that ``chip_smoke.py`` holds the card
against: every arch but zamba2-7b (``test_torch_zamba_golden.py``).

``src/repro_torch/testdata/golden_zoo.json`` holds, for each arch's smoke
config, the JAX package's prefill logits and four teacher-forced decode
logits (B = 2, a prompt of 40 tokens: past gemma2-9b-smoke's window of 8
and mixtral-smoke's of 16, and two chunks of 16 and a ragged tail of 8 for
xlstm-125m-smoke's scan), computed on the CPU from weights drawn with
numpy (``repro_torch.convert.numpy_params``, seed 0) and batches from
``make_batch(seed=0)``: Qwen2-VL's with its vision prefix and M-RoPE ids,
HuBERT's frames and mask, whose entry holds the encoder's prefill logits
of every frame alone (and its mask in place of tokens).  The card cannot run the JAX package, so the smoke
run serves the same weights through the kernels and compares its logits
with this file at 2e-4 (the repo's decode-versus-forward tolerance,
``tests/test_models_smoke.py:97``).  The tests here keep the file fresh
(regenerated from JAX, equal within 1e-6) and check that the port's CPU
path reproduces it within 2e-4.

Regenerate with ``PYTHONPATH=src JAX_PLATFORMS=cpu python
tests/test_torch_golden_zoo.py``.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for the logits runner)

torch.set_num_threads(1)

GOLDEN = chip_smoke.GOLDEN_ZOO
ARCHS = ("xlstm-125m", "gemma2-9b", "gemma-2b", "deepseek-7b",
         "granite-3-2b", "mixtral-8x22b", "deepseek-v3-671b", "qwen2-vl-2b",
         "hubert-xlarge")
PARAM_SEED, BATCH, PROMPT, STEPS = 0, 2, 40, 4


def _inputs(arch):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch)
    weights = convert.numpy_params(build_model(cfg).specs(), PARAM_SEED)
    batch = make_batch(cfg, "serve", BATCH, PROMPT + STEPS, seed=0, step=0)
    return cfg, weights, batch


def _key(batch):
    """The inputs an entry keeps: the tokens, or an encoder's mask."""
    return "tokens" if "tokens" in batch else "mask"


def _jax_logits(arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import RuntimeFlags, build_model
    _, weights, batch = _inputs(arch)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, weights)
    prefill = jax.jit(model.prefill, static_argnums=(2, 3))
    decode = jax.jit(model.decode, static_argnums=(4,))
    logits, caches = prefill(
        params, jax.tree.map(jnp.asarray,
                             chip_smoke.prompt_batch(batch, PROMPT)),
        flags, PROMPT + STEPS)
    if cfg.is_encoder:
        return batch, [np.asarray(logits)]
    out = [np.asarray(logits[:, 0])]
    tokens = batch["tokens"]
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = decode(
            params, caches, jnp.asarray(tokens[:, pos:pos + 1]),
            jnp.int32(pos), flags)
        out.append(np.asarray(logits[:, 0]))
    return batch, out


def golden_payload() -> dict:
    archs = {}
    for arch in ARCHS:
        batch, out = _jax_logits(arch)
        key = _key(batch)
        archs[arch] = {key: batch[key].astype(int).tolist(), "logits": [
            np.vectorize(lambda x: float(f"{x:.9g}"), otypes=[object])(
                step).tolist() for step in out]}
    return {"archs": archs, "config": "smoke", "param_seed": PARAM_SEED,
            "batch": BATCH, "prompt_len": PROMPT, "steps": STEPS,
            "data_seed": 0,
            "source": "repro.models prefill + teacher-forced decode of each "
                      "arch's smoke config on the CPU, float32, under jit "
                      "(an encoder: its prefill's logits of every frame)"}


def port_logits(cfg, weights, batch):
    """The port's prefill and teacher-forced decode logits [STEPS + 1, B,
    V] (an encoder's [1, B, PROMPT, V]) on the CPU, as ``chip_smoke.py``
    computes them on the card."""
    return chip_smoke.golden_logits(cfg, weights, batch, PROMPT, STEPS,
                                    "cpu").numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_equals_fresh_jax_logits(arch):
    golden = json.loads(GOLDEN.read_text())
    assert tuple(golden["archs"]) == ARCHS
    assert (golden["param_seed"], golden["batch"], golden["prompt_len"],
            golden["steps"]) == (PARAM_SEED, BATCH, PROMPT, STEPS)
    batch, out = _jax_logits(arch)
    key = _key(batch)
    assert golden["archs"][arch][key] == batch[key].astype(int).tolist()
    np.testing.assert_allclose(np.asarray(golden["archs"][arch]["logits"]),
                               np.asarray(out), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cpu_reproduces_golden_file(arch):
    golden = json.loads(GOLDEN.read_text())["archs"][arch]
    cfg, weights, batch = _inputs(arch)
    key = _key(batch)
    np.testing.assert_array_equal(batch[key], np.asarray(golden[key]))
    # What the card's check feeds the model: the same inputs.
    card = chip_smoke.golden_batch(cfg, golden,
                                   json.loads(GOLDEN.read_text()))
    for k, v in card.items():
        np.testing.assert_array_equal(v, batch[k])
    got = port_logits(cfg, weights, batch)
    want = np.asarray(golden["logits"], np.float32)
    assert got.shape == want.shape == (
        (1, BATCH, PROMPT, cfg.vocab) if cfg.is_encoder
        else (STEPS + 1, BATCH, cfg.vocab))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden_payload()) + "\n")
    print(f"wrote {GOLDEN}")
