"""Host-side loader parallelism (the port's own copy of the JAX package's
data/prefetch.py): batches are built on a background thread while the card
runs the previous step; numpy and file reads release the GIL."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


class PrefetchIterator:
    """Wrap a batch iterable; keep up to `depth` ready batches ahead.

    A consumer that stops early (a train loop breaking at max_updates on an
    endless stream) must call close(): otherwise the fill thread stays
    blocked on the full queue, pinning `depth` + 1 batches and the dataset.
    close() is idempotent; the iterator is also a context manager.
    """

    def __init__(self, iterable: Iterable, depth: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(iterable,), daemon=True)
        self._thread.start()

    def _put_stop_aware(self, item) -> bool:
        """A blocking put that gives up once close() is called; True if put."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, iterable):
        try:
            for item in iterable:
                if not self._put_stop_aware(item):
                    return
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:  # run a generator's finalisers now
                try:
                    close()
                except BaseException:
                    pass
            self._put_stop_aware(_SENTINEL)

    def close(self):
        """Stop the fill thread and release its buffered batches."""
        self._stop.set()
        try:  # unblock a put() waiting on the full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterable: Iterable, depth: int = 3) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth)


class ParallelMap:
    """Parallel map over a list with worker threads; results in input order.
    The first error of a worker is raised after all have stopped."""

    def __init__(self, fn: Callable, n_workers: int = 3):
        self.fn = fn
        self.n_workers = n_workers

    def __call__(self, items: list) -> list:
        results = [None] * len(items)
        it = iter(range(len(items)))
        lock = threading.Lock()
        errors: list[BaseException] = []

        def worker():
            while True:
                with lock:
                    try:
                        i = next(it)
                    except StopIteration:
                        return
                try:
                    results[i] = self.fn(items[i])
                except BaseException as e:
                    errors.append(e)
                    return

        threads = [threading.Thread(target=worker) for _ in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
