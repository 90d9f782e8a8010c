"""Job cost tables: the simulation substrate of the paper's evaluation.

The paper evaluates via *simulation*: every job was profiled once on every
configuration, producing a table ⟨config → (runtime, unit price)⟩; optimizers
then "run" a config by looking up its measured cost (§5.2).  ``JobTable``
is that object, plus the derived quantities the optimizers need.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.space import DiscreteSpace

__all__ = ["DeviceTables", "HostTables", "JobTable"]


class DeviceTables(NamedTuple):
    """Per-config job tables as device tensors (float32 — the precision the
    whole simulation runs in, host and device alike)."""

    cost: torch.Tensor        # [M] f32 — C(x) = T(x)·U(x)
    unit_price: torch.Tensor  # [M] f32
    runtime: torch.Tensor     # [M] f32
    feasible: torch.Tensor    # [M] bool — T(x) <= t_max


class HostTables(NamedTuple):
    """The same float32 columns as :class:`DeviceTables`, host-resident.

    Alg. 1's budget accounting — and the timeout billing ``min(t, τ)·U`` —
    performs its IEEE float32 arithmetic on the host from one casting of
    the tables."""

    cost: np.ndarray        # [M] f32
    unit_price: np.ndarray  # [M] f32
    runtime: np.ndarray     # [M] f32


@dataclasses.dataclass(frozen=True)
class JobTable:
    """A fully profiled job.

    Attributes:
      name: job identifier (e.g. ``tf-cnn``).
      space: the discrete configuration space (M points).
      runtime: ``[M]`` measured job runtime in hours.
      unit_price: ``[M]`` $/hour of the rented cluster while the job runs.
      t_max: the runtime constraint (hours).
    """

    name: str
    space: DiscreteSpace
    runtime: np.ndarray
    unit_price: np.ndarray
    t_max: float

    @property
    def cost(self) -> np.ndarray:
        """C(x) = T(x) · U(x) — the optimization objective ($)."""
        return self.runtime * self.unit_price

    @property
    def feasible(self) -> np.ndarray:
        return self.runtime <= self.t_max

    @property
    def optimum_cost(self) -> float:
        c = self.cost[self.feasible]
        if c.size == 0:
            raise ValueError(f"job {self.name} has no feasible config")
        return float(c.min())

    @property
    def optimum_index(self) -> int:
        c = np.where(self.feasible, self.cost, np.inf)
        return int(c.argmin())

    @property
    def mean_cost(self) -> float:
        """m̃ — average cost of running the job on any config (budget unit)."""
        return float(self.cost.mean())

    def bootstrap_size(self) -> int:
        """N = max(3% of |space|, n_dims) — paper §5.2 default."""
        return max(int(np.ceil(0.03 * self.space.n_points)), self.space.n_dims)

    def budget(self, b: float) -> float:
        """B = N · m̃ · b (paper §5.2)."""
        return self.bootstrap_size() * self.mean_cost * b

    def device_view(self, m_pad: int | None = None,
                    device="cuda") -> DeviceTables:
        """The tables as tensors on ``device``, moved once and cached.

        ``m_pad`` right-pads every column to a geometry bucket's point
        width (cached per width and device): cost/runtime pad with ``+inf``
        (a padding lane can never be selected — billing it infinite money
        makes any mask regression explode loudly instead of plausibly),
        unit_price with 1.0 (finite: it enters elementwise EI math before
        masking), feasible with False.
        """
        cached = getattr(self, "_device_views", None)
        if cached is None:
            cached = {}
            object.__setattr__(self, "_device_views", cached)
        device = torch.device(device)
        view = cached.get((m_pad, device))
        if view is None:
            m = self.space.n_points
            if m_pad is not None and m_pad < m:
                raise ValueError(f"m_pad={m_pad} < native space size {m}")
            ext = 0 if m_pad is None else m_pad - m
            pad = lambda a, v: torch.as_tensor(
                np.pad(a.astype(np.float32), (0, ext),
                       constant_values=np.float32(v)), device=device)
            view = DeviceTables(
                cost=pad(self.cost, np.inf),
                unit_price=pad(self.unit_price, 1.0),
                runtime=pad(self.runtime, np.inf),
                feasible=torch.as_tensor(np.pad(self.feasible, (0, ext)),
                                         device=device))
            cached[(m_pad, device)] = view
        return view

    def host_view(self) -> HostTables:
        """Float32 table columns for host-side Alg. 1 accounting (cached)."""
        cached = getattr(self, "_host_view", None)
        if cached is None:
            cached = HostTables(cost=self.cost.astype(np.float32),
                                unit_price=self.unit_price.astype(np.float32),
                                runtime=self.runtime.astype(np.float32))
            object.__setattr__(self, "_host_view", cached)
        return cached

    # ------------------------------------------------------------------ #
    def cno(self, index: int) -> float:
        """Cost-normalized-to-optimal of a recommended config."""
        return float(self.cost[index] / self.optimum_cost)

    def summary(self) -> dict:
        c = self.cost
        near2 = float((np.where(self.feasible, c, np.inf)
                       <= 2.0 * self.optimum_cost).sum())
        return {
            "name": self.name,
            "n_configs": int(c.size),
            "n_dims": self.space.n_dims,
            "feasible_frac": float(self.feasible.mean()),
            "cost_spread_orders": float(np.log10(c.max() / c.min())),
            "within_2x_of_opt": near2,
            "within_2x_frac": near2 / c.size,
            "optimum_cost": self.optimum_cost,
        }

    # ------------------------------------------------------------------ #
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.write_text(json.dumps({
            "name": self.name,
            "names": list(self.space.names),
            "points_raw": self.space.points_raw.tolist(),
            "runtime": self.runtime.tolist(),
            "unit_price": self.unit_price.tolist(),
            "t_max": self.t_max,
        }))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "JobTable":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(
            name=d["name"],
            space=DiscreteSpace.from_points(d["names"],
                                            np.asarray(d["points_raw"])),
            runtime=np.asarray(d["runtime"]),
            unit_price=np.asarray(d["unit_price"]),
            t_max=float(d["t_max"]),
        )
