"""Batched, prefetching host pipeline for event sequence clips.

Counterpart of ``bmcnet_esr_tpu/data/pipeline.py``, kept step for step so
that both packages yield the same batches from the same seed:

* items are raw padded event windows; the train step rasterizes them on the
  device (``ops/batch.py::counts_from_batch``);
* worker *threads* each own private h5 handles; batches are assigned round
  robin, so the order is deterministic with any number of workers, and batch
  ``b`` of epoch ``e`` draws its clip seeds from ``default_rng((seed, e, b))``;
* sharding partitions the clip index space by ``(shard_index, shard_count)``
  with wrap-around padding to equal shards (``DistributedSampler``'s rule);
* ``rows=(r, n)`` keeps rows ``[r*b/n, (r+1)*b/n)`` of every batch and
  reads only their clips, the clip seeds still drawn for the whole batch,
  so the ``n`` row sets of one batch, concatenated, are the batch a
  ``rows=(0, 1)`` loader yields (a data-parallel rank's share of its node's
  batch, ``parallel/mesh.py``);
* ``pad_last`` wrap-pads the final short batch and marks the padding in a
  ``clip_mask``, which follows the rows; ``compact`` ships ``{inp,gt}_{xy,p}`` (int16 / int8, no
  timestamps) instead of ``{inp,gt}_events``;
* a worker's exception reaches the consumer and is raised there (never a
  short epoch), and the workers are stopped and joined at exit.
"""

from __future__ import annotations

import atexit
import copy
import logging
import queue
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from bmcnet_esr_torch.data.h5dataset import DatasetConfig, EventSequenceDataset
from bmcnet_esr_torch.ops.batch import compact_events


def load_datalist(path: str) -> List[str]:
    """Read a datalist txt (one h5 path per line; reference datalist/*.txt)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def concatenate_datasets(
    paths: Sequence[str], config: DatasetConfig
) -> List[EventSequenceDataset]:
    return [EventSequenceDataset(p, config) for p in paths]


class SequenceLoader:
    """Iterates batches of ``[B, L, ...]`` numpy clips with thread prefetch."""

    def __init__(
        self,
        paths: Sequence[str],
        config: DatasetConfig,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = False,
        compact: bool = False,
        num_workers: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        rows: Tuple[int, int] = (0, 1),
    ):
        self.config = config
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last and not drop_last
        self.compact = compact
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.row_index, self.row_count = rows
        if not 0 <= self.row_index < self.row_count:
            raise ValueError(f"rows={rows}: need 0 <= index < count")
        self.epoch = 0

        self.datasets = concatenate_datasets(paths, config)
        first = self.datasets[0].dataset
        self.inp_resolution = first.layout.inp_resolution
        self.gt_resolution = first.layout.gt_resolution
        self.scale = config.scale
        self.seqn = config.sequence.seqn
        for ds in self.datasets[1:]:
            if ds.dataset.layout.inp_resolution != self.inp_resolution:
                raise ValueError("all datasets in one loader must share a resolution")

        # global (dataset_id, clip_id) index space
        self._index: List = []
        for d, ds in enumerate(self.datasets):
            self._index.extend((d, i) for i in range(len(ds)))

    def __len__(self) -> int:
        # arithmetic: the shuffle cannot change the count, and the shards
        # are padded to equal lengths
        n = len(self._index)
        if self.shard_count > 1:
            n = -(-n // self.shard_count)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _shard_indices(self, epoch: int):
        idx = list(self._index)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.shard_count > 1:
            total = -(-len(idx) // self.shard_count) * self.shard_count
            reps = -(-total // len(idx))
            idx = (idx * reps)[:total]
        return idx[self.shard_index :: self.shard_count]

    def _make_batches(self, epoch: int) -> List[List]:
        shard = self._shard_indices(epoch)
        batches = [
            shard[i : i + self.batch_size] for i in range(0, len(shard), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = [b for b in batches if b]
        if self.pad_last and batches and len(batches[-1]) < self.batch_size:
            last = list(batches[-1])
            real = len(last)
            reps = -(-self.batch_size // len(shard)) + 1
            last = (last + list(shard) * reps)[: self.batch_size]
            batches[-1] = [(d, i, k < real) for k, (d, i) in enumerate(last)]
        short = sorted({len(b) for b in batches if len(b) % self.row_count})
        if short:
            raise ValueError(f"batches of {short} clips do not split over {self.row_count} "
                             "rows: set drop_last or pad_last")
        return batches

    @staticmethod
    def _collate(items_per_clip: List[List[Dict]]) -> Dict[str, np.ndarray]:
        """clips (B) of windows (L) of dicts -> dict of [B, L, ...] arrays."""
        return {
            key: np.stack([np.stack([np.asarray(w[key]) for w in clip]) for clip in items_per_clip])
            for key in items_per_clip[0][0]
        }

    def _load_batch(self, datasets, batch, rng) -> Dict[str, np.ndarray]:
        clips, mask = [], []
        m = len(batch) // self.row_count
        mine = range(self.row_index * m, (self.row_index + 1) * m)
        for k, entry in enumerate(batch):
            d, i, real = entry if len(entry) == 3 else (*entry, True)
            clip_seed = int(rng.integers(0, 2**31))  # drawn for every row: the seeds stay put
            if k not in mine:
                continue
            clips.append(datasets[d].get_clip(i, seed=clip_seed))
            mask.append(1.0 if real else 0.0)
        out = self._collate(clips)
        if self.compact:
            for prefix in ("inp", "gt"):
                key = f"{prefix}_events"
                if key in out:
                    out[f"{prefix}_xy"], out[f"{prefix}_p"] = compact_events(out.pop(key))
        if self.pad_last:
            # in every batch, so that every batch has the same keys
            out["clip_mask"] = np.asarray(mask, np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1
        batches = self._make_batches(epoch)
        if not batches:
            return iter(())

        n_workers = min(self.num_workers, len(batches))
        queues = [queue.Queue(maxsize=self.prefetch) for _ in range(n_workers)]
        stop = threading.Event()

        def put_or_stop(q, item) -> bool:
            """Blocking put that gives up when the consumer abandoned the
            iterator (a producer must not pin its h5 handles forever)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid: int):
            # private h5 handles per worker thread: shallow copies of the
            # datasets without the shared (not thread-safe) file objects
            local = []
            for ds in self.datasets:
                c = copy.copy(ds)
                c.dataset = copy.copy(ds.dataset)
                c.dataset._file = None
                local.append(c)
            try:
                for b, batch in enumerate(batches):
                    if b % n_workers != wid:
                        continue
                    if stop.is_set():
                        break
                    rng = np.random.default_rng((self.seed, epoch, b))
                    if not put_or_stop(queues[wid], self._load_batch(local, batch, rng)):
                        break
            except BaseException as exc:  # noqa: BLE001 — must reach the consumer
                # a failed worker must not end the epoch early without a
                # trace: the exception itself goes to the consumer, which raises
                put_or_stop(queues[wid], exc)
            finally:
                # close the handles before the sentinel: the sentinel means
                # "this worker holds no h5 handle any more" (a worker still
                # inside h5py's close at interpreter exit deadlocks h5py's
                # own atexit handler); the sentinel always goes out
                try:
                    for ds in local:
                        try:
                            ds.dataset.close()
                        except Exception:
                            logging.getLogger(__name__).warning(
                                "loader worker failed to close an h5 handle", exc_info=True)
                finally:
                    put_or_stop(queues[wid], None)

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True) for w in range(n_workers)
        ]
        for t in threads:
            t.start()

        empty_exc = queue.Empty  # bound now: module globals vanish at teardown
        shut = []

        def shutdown_workers():
            if shut:  # idempotent: atexit and the generator's finally both call it
                return
            shut.append(True)
            stop.set()
            for q in queues:  # unblock producers stuck on put()
                try:
                    q.get_nowait()
                except empty_exc:
                    pass
            for t in threads:
                t.join(timeout=10.0)
                if t.is_alive():
                    logging.getLogger(__name__).warning(
                        "loader worker %s still running after 10s; "
                        "interpreter exit may block on h5py teardown", t.name)

        # an abandoned iterator's finally runs only at garbage collection,
        # which at interpreter exit comes after h5py's atexit handler;
        # atexit runs last-registered first, so this joins the workers before it
        atexit.register(shutdown_workers)

        try:
            done = [False] * n_workers
            b = 0
            while not all(done):
                wid = b % n_workers
                b += 1
                if done[wid]:
                    continue
                item = queues[wid].get()
                if item is None:
                    done[wid] = True
                    continue
                if isinstance(item, BaseException):
                    raise RuntimeError("loader worker failed while reading a batch") from item
                yield item
        finally:
            try:
                atexit.unregister(shutdown_workers)
            except Exception:
                pass  # generator collected during interpreter teardown
            shutdown_workers()
