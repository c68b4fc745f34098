"""Sharded dataset pipeline for the training paths (port of
nemo_tpu/data/sharded.py; VIBE's trainer reads it).

Fixed-schema npz shards + an index, and a shuffled host-side prefetch
iterator, so the card never waits on IO. No framework dependency: shards
are plain npz, written by either package and read by the other.

  * batches have a static shape (the short last batch is dropped);
  * shuffling is two-level (shard order, then an in-shard permutation)
    from one seeded ``np.random.RandomState``, so both packages yield the
    same batches in the same order;
  * one background thread and a bounded queue prefetch the batches;
  * ``as_sharded_arrays`` gives a data-parallel rank its rows of each batch
    on its device (parallel.make_mesh).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

INDEX_NAME = "index.json"


def write_shards(arrays: Dict[str, np.ndarray], out_dir: str,
                 shard_size: int = 8192) -> int:
    """Split a dict of equal-leading-dim arrays into npz shards + index.

    Returns the number of shards written. Layout:
      out_dir/shard-00000.npz ... (each holds rows [i*S, min((i+1)S, N)))
      out_dir/index.json          {num_rows, shard_size, shards, keys, shapes}
    """
    keys = sorted(arrays)
    n = arrays[keys[0]].shape[0]
    for k in keys:
        if arrays[k].shape[0] != n:
            raise ValueError(f"leading dim mismatch for {k!r}: "
                             f"{arrays[k].shape[0]} != {n}")
    os.makedirs(out_dir, exist_ok=True)
    num_shards = max(1, -(-n // shard_size))
    for i in range(num_shards):
        lo, hi = i * shard_size, min((i + 1) * shard_size, n)
        np.savez(osp.join(out_dir, f"shard-{i:05d}.npz"),
                 **{k: arrays[k][lo:hi] for k in keys})
    index = {
        "num_rows": int(n),
        "shard_size": int(shard_size),
        "shards": [f"shard-{i:05d}.npz" for i in range(num_shards)],
        "keys": keys,
        "shapes": {k: list(arrays[k].shape[1:]) for k in keys},
        "dtypes": {k: str(arrays[k].dtype) for k in keys},
    }
    with open(osp.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f, indent=1)
    return num_shards


class ShardedDataset:
    """Lazy view over a shard directory written by write_shards."""

    def __init__(self, root: str):
        self.root = root
        with open(osp.join(root, INDEX_NAME)) as f:
            self.index = json.load(f)

    def __len__(self) -> int:
        return self.index["num_rows"]

    @property
    def keys(self) -> Sequence[str]:
        return self.index["keys"]

    @property
    def num_shards(self) -> int:
        return len(self.index["shards"])

    def load_shard(self, i: int) -> Dict[str, np.ndarray]:
        with np.load(osp.join(self.root, self.index["shards"][i])) as z:
            return {k: z[k] for k in self.keys}


def batch_iterator(ds: ShardedDataset, batch_size: int, seed: int = 0,
                   epochs: Optional[int] = None, shuffle: bool = True,
                   prefetch: int = 2
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled fixed-shape batches with background prefetch.

    Two-level shuffle per epoch: shard visit order, then a permutation
    within each shard; rows left over at a shard boundary carry into the
    next batch, and the final short batch of an epoch is dropped (static
    shapes). With epochs=None iterates forever.
    """
    stop = object()
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))

    def producer():
        rng = np.random.RandomState(seed)
        epoch = 0
        try:
            while epochs is None or epoch < epochs:
                order = (rng.permutation(ds.num_shards) if shuffle
                         else np.arange(ds.num_shards))
                carry: Optional[Dict[str, np.ndarray]] = None
                for si in order:
                    shard = ds.load_shard(int(si))
                    n = shard[ds.keys[0]].shape[0]
                    perm = rng.permutation(n) if shuffle else np.arange(n)
                    shard = {k: v[perm] for k, v in shard.items()}
                    if carry is not None:
                        shard = {k: np.concatenate([carry[k], shard[k]])
                                 for k in ds.keys}
                        carry = None
                    n = shard[ds.keys[0]].shape[0]
                    nb = n // batch_size
                    for b in range(nb):
                        lo = b * batch_size
                        q.put({k: v[lo:lo + batch_size]
                               for k, v in shard.items()})
                    if n % batch_size:
                        carry = {k: v[nb * batch_size:]
                                 for k, v in shard.items()}
                epoch += 1
        finally:
            q.put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def as_sharded_arrays(batches: Iterator[Dict[str, np.ndarray]], mesh,
                      axis_name: str = "dp"):
    """This rank's rows of each batch (leading axis split over the mesh's
    ranks; the batch size must divide by its size), as tensors on the
    mesh's device."""
    from ..parallel.mesh import shard_batch
    for batch in batches:
        keys = list(batch)
        yield dict(zip(keys, shard_batch(mesh, *(batch[k] for k in keys),
                                         axis_name=axis_name)))
