"""Config-driven data module with a background-prefetch loader
(``data/datamodule.py`` of the JAX package).

The reference's ``DataModuleFromConfig`` with torch DataLoader worker
semantics: items are made inline (``num_workers: 0``), by a thread pool (the
default: the native patch ops and the JPEG decoder release the GIL) or, with
``worker_type: process``, by a persistent spawn-based process pool (for
datasets whose per-item Python label math would serialize on the GIL). Each
collates numpy batches behind a bounded prefetch queue. Shuffle on train
only, reseeded each epoch from ``(seed, epoch)`` (DistributedSampler
``set_epoch`` semantics), ``drop_last`` for static batch shapes. The batches
are bit-equal to the JAX package's for the same datasets and seed.

Every producer thread puts with a timeout, in a loop that rechecks its stop
event, and the consumer joins it when it stops: a consumer that stops early
(``limit_val_batches``, ``max_steps``) leaves no thread blocked on a full
queue.
"""

from __future__ import annotations

import itertools
import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..config import instantiate_from_config
from ..parallel.mesh import world


_PUT_POLL_S = 0.1
_JOIN_S = 60.0
THREAD_NAME = "gdt-loader"  # the name of every producer thread and its pool's


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first; False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_PUT_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _consume(q: "queue.Queue", producer: threading.Thread, stop: threading.Event):
    """Yield the producer's batches until its ``None``; raise what it raised.
    On exit (the end, an error, or a consumer that stops early) stop the
    producer and join it."""
    producer.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
        producer.join(timeout=_JOIN_S)


def collate(items) -> Dict[str, Any]:
    """Stack numpy-able fields; keep strings/objects as lists."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, (str, bytes)):
            out[key] = list(vals)
        else:
            try:
                out[key] = np.stack([np.asarray(v) for v in vals])
            except Exception:  # ragged -> keep as list
                out[key] = list(vals)
    return out


def _worker_main(dataset, seed: int, worker_id: int, task_q, result_q):
    """Process-pool worker: pull (batch_id, indices), push (batch_id, batch).

    Each worker owns a pickled copy of the dataset (torch spawn-DataLoader
    semantics). Augmentation RNG is reseeded per worker so workers don't
    replay identical perturbation streams (torch ``worker_init_fn`` analogue);
    item-keyed RNG (``default_rng((seed, idx))``-style datasets) is unaffected.
    """
    if hasattr(dataset, "_rng"):
        dataset._rng = np.random.default_rng((seed, worker_id))
    while True:
        task = task_q.get()
        if task is None:
            return
        batch_id, idxs = task
        try:
            result_q.put((batch_id, collate([dataset[int(i)] for i in idxs]), None))
        except Exception as e:  # noqa: BLE001 — surfaced in the parent
            result_q.put((batch_id, None, f"{type(e).__name__}: {e}"))


class _ProcessPool:
    """Persistent spawn-based worker pool (torch persistent_workers=True).

    spawn, not fork: the parent has a live CUDA context and PyTorch's
    threads, which a fork would clone mid-flight.
    """

    def __init__(self, dataset, num_workers: int, seed: int):
        ctx = multiprocessing.get_context("spawn")
        self.task_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self.procs = []
        for w in range(num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(dataset, seed, w, self.task_q, self.result_q),
                daemon=True,
            )
            p.start()
            self.procs.append(p)

    def get_result(self, timeout: float = 600.0):
        # Short poll interval so a dead worker (OOM-killed, import error in
        # the spawn bootstrap) surfaces within seconds — torch DataLoader
        # semantics — instead of blocking the full timeout on a result that
        # can never arrive.
        waited = 0.0
        while True:
            try:
                return self.result_q.get(timeout=min(5.0, timeout - waited))
            except queue.Empty:
                dead = [
                    (i, p.exitcode)
                    for i, p in enumerate(self.procs)
                    if not p.is_alive()
                ]
                if dead:
                    raise RuntimeError(
                        f"loader worker(s) died without a result "
                        f"(id, exitcode): {dead}"
                    ) from None
                waited += 5.0
                if waited >= timeout:
                    raise RuntimeError(
                        f"loader result timed out after {timeout}s"
                    ) from None

    def shutdown(self):
        for _ in self.procs:
            self.task_q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        self.procs = []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        num_workers: int = 0,
        seed: int = 23,
        prefetch: int = 4,
        drop_last: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        worker_type: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 0)
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be thread|process, got {worker_type!r}")
        self.worker_type = worker_type
        self._pool: Optional[_ProcessPool] = None
        # Several processes: each reads a disjoint strided slice of the same
        # seed-shared global order (torch DistributedSampler semantics).
        self.shard_id = shard_id
        self.num_shards = max(num_shards, 1)
        self._epoch = 0

    def _is_iterable(self) -> bool:
        """Iterable-style dataset: has ``__iter__`` but no ``__getitem__`` —
        the protocol torch uses for ``IterableDataset``.
        """
        return hasattr(self.dataset, "__iter__") and not hasattr(
            self.dataset, "__getitem__"
        )

    def _iterable_epoch(self) -> Iterator[Dict[str, Any]]:
        """One epoch over an iterable dataset. Shuffle is ignored (the
        reference forces ``shuffle=False`` for iterable datasets) and
        sharding strides the item stream so each process consumes a disjoint
        subset. Batches are assembled on a producer thread behind the same
        bounded prefetch queue as the map-style path."""
        def item_stream():
            it = iter(self.dataset)
            if self.num_shards > 1:
                it = itertools.islice(it, self.shard_id, None, self.num_shards)
            return it

        def batch_stream():
            buf = []
            for item in item_stream():
                buf.append(item)
                if len(buf) == self.batch_size:
                    yield collate(buf)
                    buf = []
            if buf and not self.drop_last:
                yield collate(buf)

        self._epoch += 1
        if self.num_workers <= 0:
            yield from batch_stream()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for batch in batch_stream():
                    if not _put(q, batch, stop):
                        return
                _put(q, None, stop)
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                _put(q, e, stop)

        yield from _consume(q, threading.Thread(target=producer, name=THREAD_NAME, daemon=True),
                            stop)

    def _padded_total(self) -> int:
        """Global order length after padding to a multiple of num_shards.

        Shards must be equal-length: steps and checkpoint saves are
        collective across processes, so a process with one extra batch would
        deadlock the others at epoch end. torch's DistributedSampler pads the
        order by repeating leading indices for this reason; so does this.
        """
        n = len(self.dataset)
        if self.num_shards <= 1:
            return n
        return -(-n // self.num_shards) * self.num_shards

    def _local_len(self) -> int:
        return self._padded_total() // self.num_shards

    def __len__(self):
        if self._is_iterable():
            raise TypeError(
                "iterable dataset has no length (torch IterableDataset "
                "semantics)"
            )
        n = self._local_len() // self.batch_size
        if not self.drop_last and self._local_len() % self.batch_size:
            n += 1
        return n

    def __call__(self) -> Iterator[Dict[str, Any]]:
        if self._is_iterable():
            yield from self._iterable_epoch()
            return
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if self.num_shards > 1:
            pad = self._padded_total() - len(order)
            if pad:  # repeat leading indices (DistributedSampler semantics)
                order = np.concatenate([order, order[:pad]])
            order = order[self.shard_id :: self.num_shards]
        self._epoch += 1
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size)
        ]
        if not self.drop_last and len(order) % self.batch_size:
            batches.append(order[-(len(order) % self.batch_size) :])

        if self.num_workers <= 0:
            for idxs in batches:
                yield collate([self.dataset[int(i)] for i in idxs])
            return

        if self.worker_type == "process":
            yield from self._process_epoch(batches)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix=THREAD_NAME) as pool:
                    for idxs in batches:
                        items = list(pool.map(lambda i: self.dataset[int(i)], idxs))
                        if not _put(q, collate(items), stop):
                            return
                _put(q, None, stop)
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                _put(q, e, stop)

        yield from _consume(q, threading.Thread(target=producer, name=THREAD_NAME, daemon=True),
                            stop)

    def _process_epoch(self, batches) -> Iterator[Dict[str, Any]]:
        """One epoch through the persistent process pool: whole batches are
        farmed to workers (up to ``prefetch + num_workers`` in flight) and
        re-emitted IN ORDER through a reorder buffer, so batch sequence is
        identical to the inline/thread paths."""
        if self._pool is None:
            self._pool = _ProcessPool(self.dataset, self.num_workers, self.seed)
        pool, pending = self._pool, {}
        tasks = enumerate(batches)
        for batch_id, idxs in itertools.islice(tasks, self.prefetch + self.num_workers):
            pool.task_q.put((batch_id, np.asarray(idxs)))
        try:
            for next_emit in range(len(batches)):
                while next_emit not in pending:
                    batch_id, batch, err = pool.get_result()
                    if err is not None:
                        raise RuntimeError(f"loader worker failed on batch {batch_id}: {err}")
                    pending[batch_id] = batch
                    nxt = next(tasks, None)
                    if nxt is not None:
                        pool.task_q.put((nxt[0], np.asarray(nxt[1])))
                yield pending.pop(next_emit)
        except BaseException:
            # abandoned mid-epoch: the pool's queues hold stale results for
            # this epoch's batch ids — rebuild it rather than poison the next
            self._pool.shutdown()
            self._pool = None
            raise

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


class WrappedDataset:
    """Wrap an arbitrary object into an indexable dataset."""

    def __init__(self, dataset):
        self.data = dataset

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


class DataModuleFromConfig:
    def __init__(
        self,
        batch_size: int,
        train=None,
        validation=None,
        test=None,
        predict=None,
        wrap: bool = False,
        num_workers: Optional[int] = None,
        shuffle_test_loader: bool = False,
        use_worker_init_fn: bool = False,
        shuffle_val_dataloader: bool = False,
        persistent_workers: bool = False,
        seed: int = 23,
        worker_type: str = "thread",
        **_: Any,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None else batch_size * 2
        self.seed = seed
        self.worker_type = worker_type
        self.wrap = wrap
        self.dataset_configs: Dict[str, Any] = {}
        for name, cfg in (
            ("train", train),
            ("validation", validation),
            ("test", test),
            ("predict", predict),
        ):
            if cfg is not None:
                self.dataset_configs[name] = cfg
        self.datasets: Dict[str, Any] = {}
        self._loaders: Dict[str, _Loader] = {}
        self._shuffle_val = shuffle_val_dataloader
        self._shuffle_test = shuffle_test_loader

    def prepare_data(self):  # the Lightning hook; nothing to download
        pass

    def setup(self, stage: Optional[str] = None):
        self.datasets = {
            k: instantiate_from_config(cfg) for k, cfg in self.dataset_configs.items()
        }
        if self.wrap:
            self.datasets = {k: WrappedDataset(v) for k, v in self.datasets.items()}
        self.teardown()
        self._loaders.clear()  # new datasets -> new loaders (epoch counters reset)

    def _parallel_context(self):
        """(shard_id, num_shards): one data shard per process, (rank, world
        size) of the process group (``parallel.world()``); (0, 1) outside
        one."""
        w = world()
        return w.rank, w.size

    def _loader(self, split: str, shuffle: bool) -> _Loader:
        # One cached _Loader per split: each __call__ advances its epoch
        # counter, so every epoch reshuffles with a fresh (seed, epoch) key —
        # torch DistributedSampler.set_epoch semantics. (A fresh _Loader per
        # call would replay epoch-0's order forever.)
        loader = self._loaders.get(split)
        if loader is None:
            if split not in self.datasets:
                raise KeyError(
                    f"datamodule has no {split!r} split (configured: "
                    f"{sorted(self.datasets)}); add a `{split}:` dataset "
                    "entry under data.params in the config"
                )
            shard_id, num_shards = self._parallel_context()
            loader = _Loader(
                self.datasets[split],
                batch_size=self.batch_size,
                shuffle=shuffle,
                num_workers=self.num_workers,
                seed=self.seed,
                shard_id=shard_id,
                num_shards=num_shards,
                worker_type=self.worker_type,
            )
            self._loaders[split] = loader
        return loader

    def teardown(self, stage: Optional[str] = None):
        for loader in self._loaders.values():
            loader.shutdown()

    def train_dataloader(self):
        return self._loader("train", shuffle=True)()

    def val_dataloader(self):
        return self._loader("validation", shuffle=self._shuffle_val)()

    def test_dataloader(self):
        return self._loader("test", shuffle=self._shuffle_test)()

    def predict_dataloader(self):
        return self._loader("predict", shuffle=False)()
