"""CNO / NEX aggregation across simulation runs (paper §5.2 'Metrics')."""

from __future__ import annotations

import numpy as np

__all__ = ["cno_stats", "cdf", "nex_stats"]


def cno_stats(outcomes) -> dict:
    """Average / p50 / p90 / p95 CNO + optimum hit-rate over runs."""
    c = np.array([o.cno for o in outcomes], dtype=np.float64)
    return {
        "mean": float(c.mean()),
        "p50": float(np.percentile(c, 50)),
        "p90": float(np.percentile(c, 90)),
        "p95": float(np.percentile(c, 95)),
        "std": float(c.std()),
        "hit_rate": float(np.mean([o.found_optimum for o in outcomes])),
        "n": int(c.size),
    }


def nex_stats(outcomes) -> dict:
    n = np.array([o.nex for o in outcomes], dtype=np.float64)
    return {"mean": float(n.mean()), "p50": float(np.percentile(n, 50)),
            "p90": float(np.percentile(n, 90)), "std": float(n.std())}


def cdf(values) -> tuple[np.ndarray, np.ndarray]:
    """Empirical CDF (x sorted, y in (0, 1])."""
    x = np.sort(np.asarray(values, dtype=np.float64))
    y = np.arange(1, x.size + 1) / x.size
    return x, y
