"""Lynceus core in PyTorch: budget-aware, long-sighted Bayesian optimization.

The port of ``repro.core``'s sequential decision loop.  Layout:

* ``prng``        — threefry-2x32, bit-compatible with ``jax.random``
* ``space``       — discrete configuration spaces, LHS bootstrap, buckets
* ``trees``       — fixed-shape bagged regression trees, batched over states
* ``acquisition`` — EI / constrained EI / budget filter / Gauss-Hermite
* ``lookahead``   — NextConfig/ExplorePaths (Algs. 1-2), one launch of the
                    selector-step kernel per lookahead level on the card
* ``optimizer``   — the optimization loop + BO / LA0 / RND: the sequential
                    oracle (``run_many``, ``run_queue``) and the batched,
                    lane-compacting harness (``run_many_batched``,
                    ``run_queue_batched``) with the same Outcomes
* ``metrics``     — CNO / NEX aggregation
"""

from repro_torch.core.space import (DiscreteSpace, GeometryBucket,
                                    PaddedSpace, latin_hypercube_indices)
from repro_torch.core.lookahead import (Settings, select_next,
                                        select_next_batched, make_selector,
                                        make_batch_selector,
                                        selector_cache_size)
from repro_torch.core.optimizer import (Outcome, RunRequest,
                                       episode_cache_size, optimize,
                                       run_many, run_many_batched, run_queue,
                                       run_queue_batched)
from repro_torch.core import acquisition, metrics, trees

__all__ = [
    "DiscreteSpace", "GeometryBucket", "PaddedSpace",
    "latin_hypercube_indices", "Settings", "select_next",
    "select_next_batched", "make_selector", "make_batch_selector",
    "selector_cache_size", "Outcome", "RunRequest", "episode_cache_size",
    "optimize", "run_many", "run_many_batched", "run_queue",
    "run_queue_batched", "acquisition", "metrics", "trees",
]
