"""Where the port runs: the card by default, the CPU only when asked.

Without a card the entry points raise (naming ``device="cpu"``) instead of
running on the CPU unasked; ``fused_selector="kernel"`` and the kernel
wrapper refuse CPU tensors; the dispatch follows the tensor's device.
Whether a card is present is decided inside each test, never at import.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (Settings, make_batch_selector, make_selector,
                              optimize, run_many)
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.kernels.dispatch import resolve_mode

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

SMALL = Settings(la=1, k_gh=2, n_trees=3, depth=3)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["optimize", "run_many", "make_selector",
                                   "make_batch_selector"])
def test_entry_points_default_to_the_card_and_raise_without_one(no_card,
                                                                entry):
    job = synthetic_job(0)
    calls = {
        "optimize": lambda **kw: optimize(job, SMALL, **kw),
        "run_many": lambda **kw: run_many(job, SMALL, n_runs=1, **kw),
        "make_selector": lambda **kw: make_selector(
            job.space, job.unit_price, job.t_max, SMALL, **kw),
        "make_batch_selector": lambda **kw: make_batch_selector(
            job.space, job.unit_price, job.t_max, SMALL, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_dispatch_follows_the_tensor_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_mode("auto", cpu) == "ref"
    assert resolve_mode("auto", cuda) == "kernel"
    assert resolve_mode("kernel", cuda) == "kernel"
    assert resolve_mode("ref", cuda) == "ref"
    assert resolve_mode("ref", cpu) == "ref"
    with pytest.raises(ValueError, match="CPU"):
        resolve_mode("kernel", cpu)
    with pytest.raises(ValueError):
        resolve_mode("pallas", cpu)


def test_kernel_selector_on_cpu_raises():
    job = synthetic_job(0)
    s = Settings(la=1, k_gh=2, n_trees=3, depth=3, fused_selector="kernel")
    sel = make_selector(job.space, job.unit_price, job.t_max, s,
                        device="cpu")
    m = job.space.n_points
    y = np.zeros(m, np.float32)
    mask = np.zeros(m, bool)
    y[:4] = job.cost[:4]
    mask[:4] = True
    with pytest.raises(ValueError, match="CUDA"):
        sel(prng.PRNGKey(0), y, mask, np.float32(job.budget(3)))


def test_fused_selector_setting_is_validated():
    job = synthetic_job(0)
    for bad in (Settings(fused_selector="pallas"),
                Settings(fused_selector="kernel", refit="frozen")):
        with pytest.raises(ValueError):
            make_selector(job.space, job.unit_price, job.t_max, bad,
                          device="cpu")
