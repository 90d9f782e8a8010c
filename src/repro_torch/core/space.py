"""Discrete configuration spaces for Lynceus.

A configuration space is a finite set of points over F mixed-type dimensions
(VM type, cluster size, hyper-parameters, ...).  Lynceus only ever evaluates
members of this set, so we materialize the whole grid as an ``[M, F]`` float
matrix (categoricals are ordinal-encoded; trees are invariant to monotone
encodings).  Features are normalized to [0, 1] per dimension so that the
tree-split threshold grids are shared, fixed-shape arrays — the property that
lets the whole fit/predict path run batched over every speculative
lookahead state.

Pure numpy: a copy of ``repro.core.space``, kept here so that the port never
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np

__all__ = ["DiscreteSpace", "GeometryBucket", "PaddedSpace",
           "latin_hypercube_indices", "next_pow2"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class DiscreteSpace:
    """A finite configuration space.

    Attributes:
      names: per-dimension feature names, length F.
      points_raw: ``[M, F]`` raw (un-normalized) feature values.
      points: ``[M, F]`` features normalized to [0, 1] per dimension.
      thresholds: ``[F, T]`` normalized candidate split thresholds (midpoints
        of consecutive unique values), right-padded with ``+inf`` so every
        feature column has the same static width T.
    """

    names: tuple[str, ...]
    points_raw: np.ndarray
    points: np.ndarray
    thresholds: np.ndarray

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_dims(self) -> int:
        return int(self.points.shape[1])

    # ------------------------------------------------------------------ #
    @classmethod
    def from_points(cls, names: Sequence[str], points_raw: np.ndarray,
                    max_thresholds: int | None = None) -> "DiscreteSpace":
        points_raw = np.asarray(points_raw, dtype=np.float64)
        if points_raw.ndim != 2:
            raise ValueError(f"points must be [M, F], got {points_raw.shape}")
        m, f = points_raw.shape
        if len(names) != f:
            raise ValueError("len(names) != n_dims")
        # Per-dim [0, 1] normalization (constant dims map to 0.5).
        lo = points_raw.min(axis=0)
        hi = points_raw.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        points = (points_raw - lo) / span
        points = np.where(hi > lo, points, 0.5)

        # Candidate thresholds: midpoints between consecutive unique values.
        per_dim: list[np.ndarray] = []
        for d in range(f):
            uniq = np.unique(points[:, d])
            mids = (uniq[1:] + uniq[:-1]) / 2.0 if uniq.size > 1 else np.zeros((0,))
            per_dim.append(mids)
        width = max(1, max(t.size for t in per_dim))
        if max_thresholds is not None and width > max_thresholds:
            # Subsample evenly to bound the static threshold width.
            per_dim = [
                t if t.size <= max_thresholds
                else t[np.linspace(0, t.size - 1, max_thresholds).round().astype(int)]
                for t in per_dim
            ]
            width = max_thresholds
        thr = np.full((f, width), np.inf)
        for d, t in enumerate(per_dim):
            thr[d, : t.size] = t
        return cls(tuple(names), points_raw,
                   points.astype(np.float32), thr.astype(np.float32))

    @classmethod
    def from_grid(cls, dims: Mapping[str, Sequence[float]],
                  valid=None, max_thresholds: int | None = None) -> "DiscreteSpace":
        """Cartesian product of per-dimension value lists.

        Args:
          dims: ordered mapping name -> values.
          valid: optional predicate ``f(dict[name, value]) -> bool`` used to
            drop invalid combinations (e.g. Scout's per-size cluster caps).
        """
        names = tuple(dims.keys())
        combos = []
        for vals in itertools.product(*dims.values()):
            if valid is None or valid(dict(zip(names, vals))):
                combos.append(vals)
        return cls.from_points(names, np.array(combos, dtype=np.float64),
                               max_thresholds=max_thresholds)

    # ------------------------------------------------------------------ #
    def row_of(self, raw_values: Sequence[float]) -> int:
        """Index of an exact raw-value point (raises if absent)."""
        hit = np.where((self.points_raw == np.asarray(raw_values)).all(axis=1))[0]
        if hit.size == 0:
            raise KeyError(f"point {raw_values} not in space")
        return int(hit[0])

    @property
    def geometry(self) -> tuple[int, int, int]:
        """The static selector-program shape [M, F, T] of this space."""
        return (self.n_points, self.n_dims, int(self.thresholds.shape[1]))

    def pad_to(self, bucket: "GeometryBucket") -> "PaddedSpace":
        """Right-pad this space to fixed bucket widths (see GeometryBucket).

        Padding values are inert by construction: padded point rows sit at
        0.5 in every dimension (any finite value works — a validity mask
        excludes them from every selector decision), padded feature columns
        are the constant 0.5 (a constant dimension can never split), and
        padded threshold slots are ``+inf`` (the same all-routes-left
        convention the native threshold grid already uses for its ragged
        tail).  The padded tensors keep the native values bit-for-bit in
        their leading slices, which — together with the padding-invariant
        bootstrap (``trees.bootstrap_weights``) — is what lets a padded
        selector replay the native selector's decisions exactly.
        """
        m, f, t = self.geometry
        if bucket.m < m or bucket.f < f or bucket.t < t:
            raise ValueError(
                f"bucket {bucket.shape} cannot hold space geometry "
                f"[{m}, {f}, {t}]; every bucket width must be >= the "
                "native width")
        points = np.full((bucket.m, bucket.f), 0.5, np.float32)
        points[:m, :f] = self.points
        thresholds = np.full((bucket.f, bucket.t), np.inf, np.float32)
        thresholds[:f, :t] = self.thresholds
        valid = np.zeros(bucket.m, bool)
        valid[:m] = True
        return PaddedSpace(native=self, bucket=bucket, points=points,
                           thresholds=thresholds, valid=valid)


@dataclasses.dataclass(frozen=True)
class GeometryBucket:
    """Fixed selector-program widths shared by a family of spaces.

    One selector program is compiled per bucket (shape [m, f, t]) and
    reused for every member space padded into it — that is what lets a
    work queue mix jobs whose native geometries differ, and what collapses
    selector compile count from O(#geometries) to O(#buckets) on mixed
    fleets.  ``for_spaces`` picks the canonical bucket of a job set: the
    next power of two of the largest M (so nearby fleet compositions land
    in the same bucket and reuse its compiled program) and the exact F/T
    caps (tree-split work scales with F·T, so those are not rounded up).
    """

    m: int   # point rows (space size M)
    f: int   # feature dimensions F
    t: int   # threshold columns T

    def __post_init__(self):
        # Coerce here — the single entry point for every bucket source
        # (tuples from ServiceConfig / run_queue_batched / --bucket) — so
        # a float width fails eagerly instead of deep inside pad_to.
        for name in ("m", "f", "t"):
            w = getattr(self, name)
            if int(w) != w:
                raise ValueError(f"bucket widths must be integers, got "
                                 f"{name}={w!r}")
            object.__setattr__(self, name, int(w))
        if self.m < 1 or self.f < 1 or self.t < 1:
            raise ValueError(f"bucket widths must be >= 1, got {self.shape}")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.m, self.f, self.t)

    @classmethod
    def for_spaces(cls, spaces: Sequence["DiscreteSpace"],
                   m_pow2: bool = True) -> "GeometryBucket":
        """The canonical bucket covering ``spaces`` (see class docstring)."""
        if not spaces:
            raise ValueError("need at least one space to size a bucket")
        m = max(s.n_points for s in spaces)
        return cls(m=next_pow2(m) if m_pow2 else m,
                   f=max(s.n_dims for s in spaces),
                   t=max(int(s.thresholds.shape[1]) for s in spaces))


@dataclasses.dataclass(frozen=True)
class PaddedSpace:
    """A :class:`DiscreteSpace` right-padded to a :class:`GeometryBucket`.

    Duck-types the selector-facing half of ``DiscreteSpace`` (``points``,
    ``thresholds``, ``n_points``, ``n_dims``) at the *bucket* widths, and
    additionally carries ``valid`` — the [bucket.m] point-validity mask the
    selector threads through every decision so a padding lane can never be
    explored, become incumbent, or pass the budget filter.  ``native``
    keeps the unpadded space for host-side bookkeeping (bootstraps, table
    lookups, outcome reconstruction all stay in native indices: padding
    never renumbers a config).
    """

    native: DiscreteSpace
    bucket: GeometryBucket
    points: np.ndarray      # [bucket.m, bucket.f] f32
    thresholds: np.ndarray  # [bucket.f, bucket.t] f32
    valid: np.ndarray       # [bucket.m] bool — True on native rows

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_dims(self) -> int:
        return int(self.points.shape[1])

    @property
    def geometry(self) -> tuple[int, int, int]:
        return self.bucket.shape


def latin_hypercube_indices(space: DiscreteSpace, n: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Latin-Hypercube bootstrap sample of ``n`` distinct config indices.

    Classic LHS over the unit cube [McKay et al. 1979], snapped to the nearest
    grid point per dimension, then greedily de-duplicated with uniform random
    replacements — the standard discrete-space adaptation (paper §4.3 fn. 3).
    """
    m, f = space.points.shape
    n = min(n, m)
    # Stratified samples per dimension, independently permuted (LHS).
    u = (rng.permuted(np.tile(np.arange(n), (f, 1)), axis=1).T + rng.random((n, f))) / n
    # Snap each LHS point to the nearest grid point (L2 in normalized coords).
    d2 = ((u[:, None, :] - space.points[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(axis=1)
    # De-duplicate: replace collisions with uniform draws from the unused set.
    chosen: list[int] = []
    used = np.zeros(m, dtype=bool)
    for i in idx:
        if not used[i]:
            chosen.append(int(i))
            used[i] = True
    while len(chosen) < n:
        free = np.where(~used)[0]
        pick = int(rng.choice(free))
        chosen.append(pick)
        used[pick] = True
    return np.array(chosen, dtype=np.int32)
