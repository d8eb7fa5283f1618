"""Batches under a mesh, and background batch synthesis.

Port of ``repro.data.pipeline``, with the batch helpers the optimiser
uses (``batch_size``, ``map_batch``).  The reference places a host batch on
the mesh's data axes (``jax.device_put`` with a ``NamedSharding``) and
lets the jitted step read the global array.  Under the port's explicit
SPMD every rank draws the same global batch from the same seed, and
``shard_batch`` keeps this rank's share of it: rows ``[i n, (i+1) n)`` of
every batch-leading tensor (``Lattice`` fields included), with ``i`` the
rank's place on the data axes and ``n = B / data_extent``.  The split
follows ``launch.sharding.lattice_pspec``: all or nothing, so a batch
that does not divide the data extent is kept whole on every rank (and
must then not be summed over the ranks).

``Prefetcher`` overlaps host-side batch synthesis with device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch

from repro_torch.launch.sharding import lattice_pspec
from repro_torch.losses.lattice import Lattice


def batch_size(batch) -> int:
    """Leading dim of the first tensor leaf (keys sorted, as JAX's tree
    order), Lattice fields included."""
    for leaf in _leaves(batch):
        if leaf.dim() >= 1:
            return leaf.shape[0]
    raise ValueError("batch has no tensor with a leading dimension")


def _leaves(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, Lattice):
        for f in batch:
            if f is not None:
                yield f
    elif isinstance(batch, dict):
        for k in sorted(batch):
            yield from _leaves(batch[k])


def map_batch(fn, batch, B: int):
    """Apply ``fn`` to every tensor of ``batch`` (dicts and ``Lattice``
    tuples) whose leading dim is B; everything else passes untouched."""
    if isinstance(batch, torch.Tensor):
        return fn(batch) if batch.dim() >= 1 and batch.shape[0] == B \
            else batch
    if isinstance(batch, Lattice):
        return Lattice(*(None if f is None else map_batch(fn, f, B)
                         for f in batch))
    if isinstance(batch, dict):
        return {k: map_batch(fn, v, B) for k, v in batch.items()}
    return batch


def batch_splits(batch, mesh) -> bool:
    """Whether ``shard_batch`` splits ``batch`` (its leading dim divides
    the mesh's data extent)."""
    return lattice_pspec(mesh, (batch_size(batch),))[0] is not None


def shard_batch(batch, mesh):
    """This rank's even share of every batch-leading tensor of ``batch``
    (dicts and ``Lattice`` tuples); other tensors, and a batch that does
    not split evenly, pass whole."""
    if not batch_splits(batch, mesh):
        return batch
    B = batch_size(batch)
    n = B // mesh.data_extent
    lo = mesh.data_index * n
    return map_batch(lambda x: x[lo:lo + n], batch, B)


class Prefetcher:
    """Depth-k background prefetch of host-side batch synthesis: one
    worker thread runs ``make_batch(seed)`` for seed = 0, 1, ... ahead of
    the consumer, with at most ``depth`` batches outstanding."""

    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 num_batches: Optional[int] = None):
        self.make_batch = make_batch
        self.num_batches = num_batches
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        seed = 0
        while not self._stop.is_set():
            if self.num_batches is not None and seed >= self.num_batches:
                self._q.put(None)
                return
            self._q.put(self.make_batch(seed))
            seed += 1

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()
