"""Synthetic regeneration of the paper's three evaluation datasets.

The paper's EC2 traces were announced but never publicly released, so we
regenerate statistically matched tables (DESIGN.md §8):

* ``tensorflow_jobs`` — 3 jobs (CNN / RNN / Multilayer analogues), the exact
  5-dim × 384-point space of Tables 1–2, parameter-server execution model
  with a 10-minute timeout.  Calibration targets from Fig. 1a: cost spread
  ≈ 3 orders of magnitude; ~1.5–5 % of configs within 2× of the optimum;
  T_max feasible for ≈ half the space; hyper-parameter × cluster
  interactions strong enough that disjoint optimization fails (Fig. 1b).
* ``scout_jobs`` — 18 Hadoop/Spark analogues on the 69-point, 3-dim space.
* ``cherrypick_jobs`` — 5 analogues on 47–72-point, 3-dim spaces.

All generators are deterministic in ``seed``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.space import DiscreteSpace
from repro_torch.jobs.tables import JobTable

__all__ = ["synthetic_job", "tensorflow_jobs", "scout_jobs",
           "cherrypick_jobs", "all_jobs"]


def synthetic_job(seed: int = 0, *, n_a: int = 6, n_b: int = 4,
                  name: str = "synthetic") -> JobTable:
    """Small deterministic 2-dim job for smoke tests and harness benchmarks.

    Runtime/price are uniform draws with T_max at the median runtime, so
    about half the space is feasible — the same regime as the real datasets
    but tiny enough that a full ≥100-run sweep finishes in seconds.
    """
    rng = np.random.default_rng(seed)
    space = DiscreteSpace.from_grid({"a": list(range(n_a)),
                                     "b": list(range(n_b))})
    runtime = rng.uniform(0.1, 2.0, space.n_points)
    price = rng.uniform(0.5, 2.0, space.n_points)
    return JobTable(name, space, runtime, price,
                    t_max=float(np.median(runtime)))

# --------------------------------------------------------------------------- #
# TensorFlow jobs (paper §5.1.1)
# --------------------------------------------------------------------------- #
_TIMEOUT_H = 10.0 / 60.0                       # 10-minute hard timeout
_VM_TYPES = {                                  # type -> (vcpus, $/h, ram GB)
    "t2.small": (1, 0.023, 2),
    "t2.medium": (2, 0.0464, 4),
    "t2.xlarge": (4, 0.1856, 16),
    "t2.2xlarge": (8, 0.3712, 32),
}
_CLUSTER_VCPUS = [8, 16, 32, 48, 64, 80, 96, 112]   # Table 2 rows share these


def _tf_space() -> DiscreteSpace:
    return DiscreteSpace.from_grid({
        "learning_rate": [1e-5, 1e-4, 1e-3],
        "batch_size": [16, 256],
        "sync": [0, 1],                        # 0 = async, 1 = sync
        "vm_type": [0, 1, 2, 3],               # index into _VM_TYPES
        "cluster_vcpus": _CLUSTER_VCPUS,
    })


# Per-job "physics": (work/sample ms·vcpu, model MB, best lr idx, divergence
# risk at lr=1e-3, async staleness, sync straggler, base samples to converge).
_TF_JOB_PHYSICS = {
    "tf-cnn": dict(work=0.5, model_mb=45.0, lr_best=1, diverge=0.8,
                   stale=0.012, straggle=0.05, samples=3.2e5),
    "tf-rnn": dict(work=0.9, model_mb=25.0, lr_best=1, diverge=0.35,
                   stale=0.02, straggle=0.04, samples=2.6e5),
    "tf-multilayer": dict(work=0.3, model_mb=12.0, lr_best=2, diverge=0.1,
                          stale=0.008, straggle=0.06, samples=4.0e5),
}


def tensorflow_jobs(seed: int = 0) -> list[JobTable]:
    space = _tf_space()
    raw = space.points_raw
    jobs = []
    for j, (name, ph) in enumerate(_TF_JOB_PHYSICS.items()):
        rng = np.random.default_rng(seed * 1000 + j)
        lr_i = np.searchsorted([1e-5, 1e-4, 1e-3], raw[:, 0])
        bs = raw[:, 1]
        sync = raw[:, 2]
        vm = raw[:, 3].astype(int)
        vcpus_tot = raw[:, 4]
        vcpus_per = np.array([_VM_TYPES[k][0] for k in _VM_TYPES])[vm]
        price_per = np.array([_VM_TYPES[k][1] for k in _VM_TYPES])[vm]
        n_vms = vcpus_tot / vcpus_per

        # --- statistical efficiency: samples needed to hit 0.85 accuracy ---
        # The optimal learning rate SHIFTS with the effective batch (linear
        # scaling rule): sync training on a big cluster wants the next lr up.
        # This is the hyper-param x cloud interaction that defeats disjoint
        # optimization (Fig 1b).
        eff_batch = bs * np.where(sync == 1, n_vms, 1.0)
        lr_best_eff = np.minimum(
            ph["lr_best"] + ((sync == 1) & (eff_batch >= 2048)), 2)
        lr_pen = np.ones(raw.shape[0])
        lr_pen = np.where(lr_i < lr_best_eff,
                          14.0 ** (lr_best_eff - lr_i), lr_pen)  # too small
        # too large: fraction of runs effectively diverge (hit the timeout)
        diverge = (lr_i > lr_best_eff) & (
            rng.random(raw.shape[0]) < ph["diverge"])
        lr_pen = np.where((lr_i > lr_best_eff) & ~diverge, 0.8, lr_pen)
        big_batch_pen = np.where(bs == 256, 1.35, 1.0)  # fewer, noisier updates
        sync_pen = np.where(sync == 1, (eff_batch / 256.0) ** 0.25, 1.0)
        sync_pen = np.where((sync == 1) & (lr_i < lr_best_eff),
                            sync_pen * 1.6, sync_pen)
        # async: gradient staleness grows with worker count.
        async_pen = np.where(sync == 0, 1.0 + ph["stale"] * n_vms, 1.0)
        samples = ph["samples"] * lr_pen * big_batch_pen * sync_pen * async_pen

        # --- systems efficiency: time per sample -------------------------- #
        compute_h = samples * ph["work"] / 1000.0 / 3600.0 / vcpus_tot
        # parameter-server network bottleneck: per-step model push/pull.
        steps = samples / (bs * n_vms)
        ps_bw_mbs = 2400.0                      # sharded-PS effective MB/s
        comm_h = steps * (ph["model_mb"] * n_vms / ps_bw_mbs) / 3600.0
        comm_h *= np.where(sync == 1, 1.0 + ph["straggle"] * np.log2(n_vms), 0.85)
        small_ram_pen = np.where((vm == 0) & (bs == 256), 1.5, 1.0)  # 2 GB VMs swap
        runtime = (compute_h + comm_h) * small_ram_pen
        runtime *= np.exp(rng.normal(0.0, 0.08, raw.shape[0]))  # measurement noise
        runtime = np.where(diverge, _TIMEOUT_H, np.minimum(runtime, _TIMEOUT_H))

        unit_price = (n_vms + 1) * price_per    # +1 VM for the parameter server
        # T_max satisfied by ~half the configs (paper §5.2); if the median
        # sits on the timeout mass, fall back to just under the timeout.
        t_max = float(np.quantile(runtime, 0.5))
        if t_max >= _TIMEOUT_H * 0.999:
            t_max = _TIMEOUT_H * 0.999
        jobs.append(JobTable(name, space, runtime, unit_price, t_max))
    return jobs


# --------------------------------------------------------------------------- #
# Scout jobs (18 Hadoop/Spark analogues, 69-point space — paper §5.1.2)
# --------------------------------------------------------------------------- #
_SCOUT_PRICE = {  # (family, size) -> $/h
    ("c4", "large"): 0.100, ("c4", "xlarge"): 0.199, ("c4", "2xlarge"): 0.398,
    ("m4", "large"): 0.100, ("m4", "xlarge"): 0.200, ("m4", "2xlarge"): 0.400,
    ("r4", "large"): 0.133, ("r4", "xlarge"): 0.266, ("r4", "2xlarge"): 0.532,
}
_SIZES = ["large", "xlarge", "2xlarge"]
_FAMILIES3 = ["c4", "m4", "r4"]
_SCOUT_N = [4, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48]

_SCOUT_NAMES = [
    "hibench-wordcount", "hibench-sort", "hibench-terasort", "hibench-kmeans",
    "hibench-bayes", "hibench-pagerank", "hibench-nutchindex", "hibench-scan",
    "hibench-join", "hibench-aggregate", "spark-wordcount", "spark-sort",
    "spark-kmeans", "spark-pagerank", "spark-bayes", "spark-als",
    "spark-regression", "spark-terasort",
]


def _scout_space() -> DiscreteSpace:
    def valid(cfg):
        if cfg["size"] == 1 and cfg["n"] > 24:        # xlarge capped at 24
            return False
        if cfg["size"] == 2 and cfg["n"] > 12:        # 2xlarge capped at 12
            return False
        if cfg["size"] == 0 and cfg["n"] == 48:       # trim 72 -> 69 (paper)
            return False
        return True

    return DiscreteSpace.from_grid({
        "family": [0, 1, 2], "size": [0, 1, 2], "n": _SCOUT_N}, valid=valid)


def _cluster_table(name, space, rng, families, prices, *, serial, work,
                   shuffle, alpha, cpu_sens, mem_sens) -> JobTable:
    raw = space.points_raw
    fam = raw[:, 0].astype(int)
    size = raw[:, 1].astype(int)
    n = raw[:, 2]
    size_speed = 2.0 ** size                       # vcpus double per size step
    # family affinity: cpu-bound jobs like c4, memory-bound like r3/r4,
    # storage-heavy like i2 (split sensitivity).
    aff_by_name = {"c4": 1.0 + 0.5 * cpu_sens, "m4": 1.0,
                   "r4": 1.0 + 0.5 * mem_sens, "r3": 1.0 + 0.5 * mem_sens,
                   "i2": 1.0 + 0.25 * (cpu_sens + mem_sens)}
    fam_aff = np.array([aff_by_name[families[f]] for f in fam])
    cap = n * size_speed * fam_aff
    runtime = serial + work / cap + shuffle * (n ** alpha) / size_speed
    runtime *= np.exp(rng.normal(0.0, 0.07, raw.shape[0]))
    price = np.array([prices[(families[f], _SIZES[s])]
                      for f, s in zip(fam, size)])
    unit_price = n * price
    t_max = float(np.quantile(runtime, 0.5))
    return JobTable(name, space, runtime, unit_price, t_max)


def scout_jobs(seed: int = 0) -> list[JobTable]:
    space = _scout_space()
    jobs = []
    for j, name in enumerate(_SCOUT_NAMES):
        rng = np.random.default_rng(seed * 2000 + 77 + j)
        jobs.append(_cluster_table(
            name, space, rng, _FAMILIES3, _SCOUT_PRICE,
            serial=float(rng.uniform(0.02, 0.12)),
            work=float(rng.uniform(2.0, 14.0)),
            shuffle=float(rng.uniform(0.0005, 0.004)),
            alpha=float(rng.uniform(0.8, 1.3)),
            cpu_sens=float(rng.uniform(-1.0, 1.0)),
            mem_sens=float(rng.uniform(-1.0, 1.0)),
        ))
    return jobs


# --------------------------------------------------------------------------- #
# CherryPick jobs (5 analogues, 47–72-point spaces — paper §5.1.2)
# --------------------------------------------------------------------------- #
_CP_PRICE = {
    ("c4", "large"): 0.100, ("c4", "xlarge"): 0.199, ("c4", "2xlarge"): 0.398,
    ("m4", "large"): 0.100, ("m4", "xlarge"): 0.200, ("m4", "2xlarge"): 0.400,
    ("r3", "large"): 0.166, ("r3", "xlarge"): 0.333, ("r3", "2xlarge"): 0.665,
    ("i2", "large"): 0.153, ("i2", "xlarge"): 0.305, ("i2", "2xlarge"): 0.610,
}
_FAMILIES4 = ["c4", "m4", "r3", "i2"]
_CP_N = [32, 48, 64, 80, 96, 112]
_CP_NAMES = ["tpch", "tpcds", "terasort", "spark-kmeans", "spark-regression"]


def cherrypick_jobs(seed: int = 0) -> list[JobTable]:
    jobs = []
    for j, name in enumerate(_CP_NAMES):
        rng = np.random.default_rng(seed * 3000 + 555 + j)
        # Per-job validity subset sized in [47, 72] (paper: 47–72 points).
        target = int(rng.integers(47, 73))
        full = [(f, s, n) for f in range(4) for s in range(3) for n in _CP_N]
        keep_idx = rng.choice(len(full), size=target, replace=False)
        keep = {full[i] for i in keep_idx}

        def valid(cfg, keep=keep):
            return (int(cfg["family"]), int(cfg["size"]), int(cfg["n"])) in keep

        space = DiscreteSpace.from_grid(
            {"family": [0, 1, 2, 3], "size": [0, 1, 2], "n": _CP_N},
            valid=valid)
        jobs.append(_cluster_table(
            name, space, rng, _FAMILIES4, _CP_PRICE,
            serial=float(rng.uniform(0.05, 0.2)),
            work=float(rng.uniform(20.0, 90.0)),
            shuffle=float(rng.uniform(0.0003, 0.002)),
            alpha=float(rng.uniform(0.9, 1.4)),
            cpu_sens=float(rng.uniform(-1.0, 1.0)),
            mem_sens=float(rng.uniform(-1.0, 1.0)),
        ))
    return jobs


def all_jobs(seed: int = 0) -> list[JobTable]:
    return tensorflow_jobs(seed) + scout_jobs(seed) + cherrypick_jobs(seed)
