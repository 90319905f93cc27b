"""Windowed HDF5 training dataset, resumable infinite sampler and ordered
prefetch loader (port of climate2weather_tpu/data/dataset.py, numpy only).

- ``InfiniteSampler``: the JAX package's index stream, bit for bit: a
  per-epoch shuffle by ``numpy.random.RandomState(derive_seed(seed, epoch))``,
  rank-strided, resumed exactly by ``start_idx = cur_ndata``.
- ``WindowDataset`` (registered as ``cosmo_dataset``): item i is the window
  x[i:i+window] of the HDF5 dataset ``"x"`` [T, C, H, W], flattened
  frame-major into channels. The file is read through ``io/hdf5.py``
  (h5py is not needed); a window read touches only its chunks.
- ``PrefetchLoader``: host threads assemble [rounds, B, ...] float32 batches
  ahead of the train step, delivered in exact sampler order. The JAX
  package's native C++ assembler for host-side NHWC batches is not ported;
  ``channels_first=False`` transposes with numpy.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator

import numpy as np

from climate2weather_tpu_torch.io import hdf5
from climate2weather_tpu_torch.utils.registry import register
from climate2weather_tpu_torch.utils.seeding import derive_seed


class InfiniteSampler:
    """Infinite, shuffled, rank-strided, resumable index stream."""

    def __init__(
        self,
        dataset_size: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        start_idx: int = 0,
    ):
        assert dataset_size > 0
        assert num_replicas > 0
        assert 0 <= rank < num_replicas
        self.dataset_size = dataset_size
        self.start_idx = start_idx + rank
        self.stride = num_replicas
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        idx = self.start_idx
        epoch = None
        order = None
        while True:
            if epoch != idx // self.dataset_size:
                epoch = idx // self.dataset_size
                order = np.arange(self.dataset_size)
                if self.shuffle:
                    np.random.RandomState(derive_seed(self.seed, epoch)).shuffle(order)
            yield int(order[idx % self.dataset_size])
            idx += self.stride


class AbstractSDADataset:
    """Interface for windowed SDA training datasets (reference
    dataset.py:43-57): a dataset is an indexable of [window, C, H, W] (or
    flattened) items with ``window``/``flatten``/``num_features`` metadata.
    Register implementations under a name to use them from configs."""

    @property
    def window(self) -> int:
        raise NotImplementedError

    @property
    def flatten(self) -> bool:
        raise NotImplementedError

    @property
    def num_features(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def load_window(self, i: int):
        raise NotImplementedError


@register("cosmo_dataset")
class WindowDataset(AbstractSDADataset):
    """Sliding-time-window dataset over an HDF5 [T, C, H, W] array."""

    def __init__(
        self,
        data_path: str,
        num_features: int,
        spatial_res: int,
        window: int,
        cached: bool = False,
        flatten: bool = True,
        h5_var: str = "x",
    ):
        self._data_path = os.path.abspath(data_path)
        assert os.path.isfile(self._data_path), self._data_path
        self._h5_var = h5_var
        self._window = int(window)
        self._flatten = bool(flatten)
        self._cached = bool(cached)
        self._local = threading.local()

        with hdf5.open_file(self._data_path) as f:
            shape = f[self._h5_var].shape
            if self._cached:
                self._cache = f[self._h5_var][:]
            else:
                self._cache = None
        self._shape = tuple(shape)

        assert self._shape[-1] == self._shape[-2] == spatial_res, (
            f"spatial_res {spatial_res} != data {self._shape[-2:]}"
        )
        assert num_features == self.num_features, (
            f"The number of specified features ({num_features}) does not match "
            f"the number of features in the data ({self.num_features})."
        )
        self.spatial_res = spatial_res

    # -- reference-compatible surface --------------------------------------
    def __len__(self) -> int:
        return self._shape[0] - self._window + 1

    @property
    def window(self) -> int:
        return self._window

    @property
    def flatten(self) -> bool:
        return self._flatten

    @property
    def num_features(self) -> int:
        return self._shape[-3]

    @property
    def raw_data_shape(self):
        return self._shape

    @property
    def data_path(self) -> str:
        return self._data_path

    def _reader(self):
        if self._cache is not None:
            return self._cache
        # one lazy h5 handle per reader thread (reference: per-worker handle,
        # dataset.py:115-116)
        if not hasattr(self._local, "ds"):
            self._local.ds = hdf5.open_file(self._data_path)[self._h5_var]
        return self._local.ds

    def load_window(self, i: int) -> np.ndarray:
        """[window, C, H, W] float32 raw window."""
        return np.asarray(self._reader()[i : i + self._window], np.float32)

    def load_window_flat(self, i: int) -> np.ndarray:
        """[window*C, H, W] float32 — a pure contiguous copy (the window is
        contiguous in the [T, C, H, W] store), frame-major channel order.
        The NHWC transpose happens in the train step, on the device."""
        w = self.load_window(i)
        return w.reshape(self._window * w.shape[1], *w.shape[2:])

    def __getitem__(self, i: int) -> np.ndarray:
        """NHWC item: [H, W, window*C] (flatten=True) or [window, H, W, C]."""
        x = self.load_window(i)  # [w, C, H, W]
        if self._flatten:
            w, c, h, wd = x.shape
            # -> [H, W, w, C] -> [H, W, w*C]; frame-major channel order
            return np.ascontiguousarray(x.transpose(2, 3, 0, 1)).reshape(h, wd, w * c)
        return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


class PrefetchLoader:
    """Threaded batch assembly with ordered, bounded prefetch.

    Yields [rounds, B, ...] float32 numpy arrays ready for the device.

    Ordering contract: batches come out in exact sampler order regardless of
    ``num_threads`` — workers atomically take a (ticket, indices) unit under
    one lock and deliver into a ticket-ordered reassembly buffer, so the
    stream is bit-identical to single-threaded assembly and ndata-resume is
    exactly reproducible (the reference torch DataLoader's order-preserving
    behavior, training_loop.py:174-181).  In-flight
    memory is bounded at ``prefetch + num_threads`` batches.
    """

    def __init__(
        self,
        dataset: WindowDataset,
        sampler: InfiniteSampler,
        batch_size: int,
        rounds: int = 1,
        num_threads: int = 2,
        prefetch: int = 2,
        channels_first: bool = True,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.rounds = rounds
        # channels_first=True yields [rounds, B, w*C, H, W] assembled by pure
        # contiguous copies (the train step permutes to NHWC on the device);
        # False yields [rounds, B, H, W, w*C] transposed on the host
        self.channels_first = channels_first
        self.num_threads = num_threads
        self._stop = threading.Event()
        self._index_iter = iter(sampler)
        self._index_lock = threading.Lock()
        self._threads = []
        # ticket-ordered reassembly
        self._cond = threading.Condition()
        self._ready: dict = {}  # ticket -> batch
        self._next_ticket = 0  # next unit handed to a worker
        self._next_out = 0  # next ticket the consumer takes
        self._max_inflight = prefetch + num_threads
        self._fatal = False  # a worker error permanently breaks the stream

    def _grab_work(self):
        """Atomically claim the next (ticket, index-block) unit.

        On iterator failure/exhaustion the exception is returned *under the
        claimed ticket* so the consumer sees it in order; leaving the ticket
        undelivered would deadlock ``__next__``.
        """
        with self._index_lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            try:
                idxs = [
                    next(self._index_iter)
                    for _ in range(self.rounds * self.batch_size)
                ]
            except BaseException as e:
                return ticket, e
        return ticket, idxs

    def _build(self, idxs):
        if self.channels_first:
            # single-copy assembly straight into the batch buffer
            ds = self.dataset
            w = ds.window
            wc = w * ds.num_features
            H = Wd = ds.spatial_res
            n = self.rounds * self.batch_size
            batch = np.empty((n, wc, H, Wd), np.float32)
            reader = ds._reader()
            for j, i in enumerate(idxs):
                batch[j] = reader[i : i + w].reshape(wc, H, Wd)
            return batch.reshape((self.rounds, self.batch_size, wc, H, Wd))
        items = [self.dataset[i] for i in idxs]
        return np.stack(items).reshape(
            (self.rounds, self.batch_size) + items[0].shape
        )

    def _worker(self):
        while not self._stop.is_set():
            ticket, idxs = self._grab_work()
            if isinstance(idxs, BaseException):
                batch = idxs
            else:
                try:
                    batch = self._build(idxs)
                except BaseException as e:  # deliver the error in ticket
                    batch = e  # order — a dead ticket would deadlock
            with self._cond:
                while (
                    not self._stop.is_set()
                    and ticket - self._next_out >= self._max_inflight
                ):
                    self._cond.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                self._ready[ticket] = batch
                self._cond.notify_all()
                if isinstance(batch, StopIteration):
                    return  # iterator exhausted: nothing left to produce
                if isinstance(batch, BaseException):
                    # Worker errors are FATAL to the stream: the failed
                    # ticket's sampler indices are already consumed, so
                    # "retrying" next() would silently skip one batch while
                    # ndata accounting advances — breaking the bit-identical
                    # ndata-resume contract.  Mark the stream broken; the
                    # consumer must restart from the last checkpoint (which
                    # re-derives the index stream from cur_ndata).
                    self._fatal = True
                    return

    def start(self) -> "PrefetchLoader":
        for _ in range(self.num_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._threads:
            self.start()
        with self._cond:
            while self._next_out not in self._ready:
                if self._fatal:
                    raise RuntimeError(
                        "PrefetchLoader stream is broken — a worker failed; "
                        "restart from the last checkpoint"
                    )
                if self._stop.is_set():
                    raise RuntimeError(
                        "PrefetchLoader was stopped while a consumer was "
                        "waiting for a batch"
                    )
                # timed wait: stop()/worker-death from another thread must
                # not leave a consumer parked forever on a bare wait()
                self._cond.wait(timeout=0.5)
            batch = self._ready.pop(self._next_out)
            self._next_out += 1
            self._cond.notify_all()
        if isinstance(batch, StopIteration):
            raise StopIteration  # finite index iterator exhausted
        if isinstance(batch, BaseException):
            raise RuntimeError(
                "PrefetchLoader worker failed; the stream is not resumable "
                "past this point — resume training from the last checkpoint"
            ) from batch
        return batch

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
