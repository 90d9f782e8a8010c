"""Checkpointing — ``repro.checkpoint.manager`` for trees of tensors.

The reference's layout: ``<dir>/step_<n:08d>/`` holds one
``leaf_<i:05d>.npy`` per leaf, in ``jax.tree`` order (dict keys sorted),
and a ``manifest.json`` (step, leaf count, each leaf's path in
``jax.tree_util.keystr`` form, a description of the tree).  Writes go to
``step_<n>.tmp``, which is fsynced and only then renamed, so a crash in a
write never corrupts the latest checkpoint; ``keep`` bounds how many
stay.  ``save`` copies the state to the host at once and, when
``async_write``, writes it on a background thread (one writer in flight).
``restore`` reads the leaves into the structure and dtypes of ``like`` and
puts them on a given device (by default each leaf on its ``like`` leaf's
device).  A bfloat16 leaf is stored as float32 (numpy has no bfloat16)
and cast back on restore, as every leaf is cast to its ``like`` leaf's
dtype.

Sharded state (DTensor leaves): ``save`` gathers each leaf's full value
(``full_tensor``, a collective every rank takes part in) before the
writer thread starts, so no collective runs on that thread, and only
rank 0 writes.  ``restore(..., shardings)`` places each leaf on the
matching ``shard.NamedSharding``: every rank reads the files and keeps
its own slice.  The checkpoint does not record the mesh it was written
under, so a run saved under one mesh restores under another (the
reference's elastic restart).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

__all__ = ["CheckpointManager"]


def _names(tree, prefix: str = "") -> list[str]:
    """Each leaf's path in ``jax.tree_util.keystr`` form (``['key']`` for
    a dict key, ``[i]`` for a sequence item, ``.field`` for a named
    tuple's field), in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [n for k, v in sorted(tree.items())
                for n in _names(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f, v in zip(tree._fields, tree)
                for n in _names(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _names(v, f"{prefix}[{i}]")]
    return [prefix]


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(v)}"
                               for k, v in sorted(tree.items())) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return (f"{type(tree).__name__}({inner})" if hasattr(tree, "_fields")
                else f"[{inner}]" if isinstance(tree, list)
                else f"({inner})")
    return "*"


def _to_host(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, state) -> None:
        """Snapshot to the host (sharded leaves gathered whole), then
        (optionally) write in a background thread; under a process group
        only rank 0 writes."""
        host = tree_map(_to_host, state)
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        if self._pending is not None:
            self._pending.join()                     # one writer in flight
        if self.async_write:
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._pending.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        names = _names(host)
        for i, leaf in enumerate(tree_leaves(host)):
            np.save(tmp / f"leaf_{i:05d}.npy", np.asarray(leaf))
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "n_leaves": len(names), "names": names,
             "treedef": _describe(host)}))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None, *, device=None):
        """The checkpoint of ``step`` in the structure of ``like``, each
        leaf cast to its ``like`` leaf's dtype and put on ``device`` (by
        default the ``like`` leaf's device); with ``shardings`` (a
        matching tree of ``shard.NamedSharding``) each leaf becomes the
        DTensor of its sharding, this rank keeping its slice."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = [np.load(d / f"leaf_{i:05d}.npy")
                  for i in range(manifest["n_leaves"])]
        like_leaves = tree_leaves(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, target "
                             f"{len(like_leaves)}")

        shards = (tree_leaves(shardings) if shardings is not None
                  else [None] * len(leaves))

        def place(a, ref, sh):
            if not isinstance(ref, torch.Tensor):
                return a
            dev = ref.device if device is None else torch.device(device)
            if sh is not None:
                return sh.from_host(a, dev).to(ref.dtype)
            return torch.as_tensor(a, device=dev).to(ref.dtype)

        return tree_unflatten(like, [place(a, r, sh) for a, r, sh in
                                     zip(leaves, like_leaves, shards)])

    def restore_latest(self, like, shardings=None, *, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, shardings, device=device)
