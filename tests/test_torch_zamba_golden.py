"""The golden Zamba2 logits that ``chip_smoke.py`` holds the card against.

``src/repro_torch/testdata/golden_zamba.json`` holds the JAX package's
``zamba_prefill`` logits and six teacher-forced ``zamba_decode`` logits on
zamba2-smoke (B = 2, a prompt of 40 tokens: two chunks of 16 and a padded
tail of 8), computed on the CPU from weights drawn with numpy
(``repro_torch.convert.numpy_params``, seed 0) and prompts from
``make_batch(seed=0)``.  The card cannot run the JAX package, so the smoke
run serves the same weights through the kernels and compares its logits
with this file at 2e-4 (the repo's decode-versus-forward tolerance,
``tests/test_models_smoke.py:97``).  The tests here keep the file fresh
(regenerated from JAX, equal within 1e-6) and check that the port's CPU
path reproduces it within 2e-4.

Regenerate with ``PYTHONPATH=src python tests/test_torch_zamba_golden.py``.
"""

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for the logits runner)

torch.set_num_threads(1)

GOLDEN = chip_smoke.GOLDEN_ZAMBA
ARCH, PARAM_SEED, BATCH, PROMPT, STEPS = "zamba2-7b", 0, 2, 40, 6


def _inputs():
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    cfg = get_smoke_config(ARCH)
    weights = convert.numpy_params(build_model(cfg).specs(), PARAM_SEED)
    tokens = make_batch(cfg, "serve", BATCH, PROMPT + STEPS, seed=0,
                        step=0)["tokens"]
    return cfg, weights, tokens


def golden_payload() -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import RuntimeFlags, build_model
    _, weights, tokens = _inputs()
    model = build_model(get_smoke_config(ARCH))
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, weights)
    logits, caches = model.prefill(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])}, flags,
        PROMPT + STEPS)
    out = [np.asarray(logits[:, 0])]
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = model.decode(
            params, caches, jnp.asarray(tokens[:, pos:pos + 1]),
            jnp.int32(pos), flags)
        out.append(np.asarray(logits[:, 0]))
    return {"arch": ARCH, "config": "smoke", "param_seed": PARAM_SEED,
            "batch": BATCH, "prompt_len": PROMPT, "steps": STEPS,
            "data_seed": 0, "tokens": tokens.tolist(),
            "source": "repro.models zamba_prefill + teacher-forced "
                      "zamba_decode on the CPU, float32",
            "logits": [[[float(f"{x:.9g}") for x in row] for row in step]
                       for step in out]}


def port_logits(cfg, weights, tokens):
    """The port's prefill and teacher-forced decode logits [STEPS + 1, B,
    V] on the CPU, as ``chip_smoke.py`` computes them on the card."""
    return chip_smoke.golden_logits(cfg, weights, {"tokens": tokens},
                                    PROMPT, STEPS, "cpu").numpy()


def test_golden_file_equals_fresh_jax_logits():
    golden = json.loads(GOLDEN.read_text())
    fresh = golden_payload()
    assert {k: v for k, v in golden.items() if k != "logits"} == \
        {k: v for k, v in fresh.items() if k != "logits"}
    np.testing.assert_allclose(np.asarray(golden["logits"]),
                               np.asarray(fresh["logits"]), atol=1e-6,
                               rtol=0)


def test_port_cpu_reproduces_golden_file():
    golden = json.loads(GOLDEN.read_text())
    cfg, weights, tokens = _inputs()
    np.testing.assert_array_equal(tokens, np.asarray(golden["tokens"]))
    got = port_logits(cfg, weights, tokens)
    want = np.asarray(golden["logits"], np.float32)
    assert got.shape == want.shape == (STEPS + 1, BATCH, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden_payload()) + "\n")
    print(f"wrote {GOLDEN}")
