"""A gloo world of spawned ranks for the port's sharded tests.

``spawn_world(worker, n, out_dir, *args)`` starts ``n`` processes, each
joining one gloo process group through a ``FileStore`` in ``out_dir`` and
calling ``worker(rank, out_dir, *args)``.  The worker must be a
module-level function of a module that imports neither jax nor the JAX
package (the spawned ranks import it to find the worker); each rank
records the jax modules it holds, and :func:`jax_free` checks them.
Rank 0 writes what the parent compares (``torch.save`` into ``out_dir``).
"""

import logging
import pathlib
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_world", "jax_free", "single_rank_mesh"]


def _entry(rank, worker, n, out, args):
    torch.set_num_threads(1)
    # DTensor warns of each two-step redistribution over a 2-D mesh.
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    store = dist.FileStore(str(pathlib.Path(out) / "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
    try:
        worker(rank, out, *args)
        held = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        (pathlib.Path(out) / f"modules_{rank}.txt").write_text(
            "\n".join(held))
    finally:
        dist.destroy_process_group()


def spawn_world(worker, n, out_dir, *args, join=True):
    """Run the world; with ``join=False`` return its context at once (call
    ``join()`` until it returns True)."""
    return mp.spawn(_entry, args=(worker, n, str(out_dir), args), nprocs=n,
                    join=join)


def jax_free(out_dir, n) -> bool:
    """Whether no rank of the world held a jax or ``repro`` module."""
    return all(not (pathlib.Path(out_dir) / f"modules_{r}.txt"
                    ).read_text().strip() for r in range(n))


def single_rank_mesh():
    """A (1, 1) ("data", "model") mesh of this rank alone, inside a larger
    world (every rank calls this: each makes the world's one-rank
    groups in the same order)."""
    from torch.distributed.device_mesh import DeviceMesh
    groups = [dist.new_group([r]) for r in range(dist.get_world_size())]
    mine = groups[dist.get_rank()]
    return DeviceMesh.from_group([mine, mine], "cpu",
                                 mesh=torch.tensor([[dist.get_rank()]]),
                                 mesh_dim_names=("data", "model"))
