"""Batch prefetch: the next batches' gather (and upload) overlap the step.

Counterpart of ``lifelong_clip_tpu/data/prefetch.py``. The online stream's
index order is known up front (``utils/stream.py``), so a daemon thread
gathers batch N+1 on the host, and with ``place`` copies it to the card,
while the main thread runs step N:

    host gather (numpy fancy-index) -> place -> queue -> consumer

``DeviceUpload`` is the ``place`` for the card: it copies each batch into a
pinned host buffer and from there to the card with ``non_blocking=True`` on
a side stream; the consumer's stream waits on an event recorded after the
copy, so the step never reads a batch before it has landed and never waits
for the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch


class _Uploaded:
    """A batch on its way to the card: the device tensor and the event
    recorded after its copy on the side stream."""

    def __init__(self, tensor, event):
        self.tensor, self.event = tensor, event

    def ready(self):
        """The tensor, for the calling thread's current stream: the stream
        waits on the copy, and the caching allocator keeps the memory until
        that stream's work on it is done."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.event)
        self.tensor.record_stream(stream)
        return self.tensor


class DeviceUpload:
    """``place`` for ``BatchPrefetcher`` on a CUDA device: host array ->
    pinned buffer -> the device, non-blocking on a side stream. A ring of
    ``RING`` pinned buffers (the prefetcher's default depth + 1) is reused
    in turn; before a buffer is overwritten the copy out of it is waited
    for (its event)."""

    RING = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._ring = [None] * self.RING
        self._events = [None] * self.RING
        self._next = 0

    def __call__(self, array) -> _Uploaded:
        slot = self._next
        self._next = (slot + 1) % len(self._ring)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        src = torch.from_numpy(array)
        buf = self._ring[slot]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self._ring[slot] = torch.empty(
                src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return _Uploaded(dev, event)


class BatchPrefetcher:
    """Iterate ``(batch_indices, images, labels)`` in stream order with
    lookahead.

    ``gather`` maps an index array to (images, labels) numpy arrays;
    ``place`` (default: the identity) maps the images where the step wants
    them, e.g. ``DeviceUpload``; labels stay on the host. A daemon thread
    runs gather and place at most ``depth`` batches ahead of the consumer.
    An exception in the worker re-raises at the consumer."""

    _DONE = object()

    def __init__(self, index_batches: Iterable, gather: Callable,
                 place: Optional[Callable] = None, depth: int = 2):
        self._q = queue.Queue()
        self._ahead = threading.Semaphore(max(depth, 1))
        self._stop = threading.Event()
        self._gather = gather
        self._place = place or (lambda x: x)
        self._batches = list(index_batches)
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for idx in self._batches:
                self._ahead.acquire()
                if self._stop.is_set():
                    return
                images, labels = self._gather(idx)
                self._q.put((idx, self._place(images), labels))
        except Exception as e:  # surfaced at the consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    if self._err is not None:
                        raise self._err
                    return
                self._ahead.release()
                idx, images, labels = item
                if isinstance(images, _Uploaded):
                    images = images.ready()
                yield idx, images, labels
        finally:
            self.close()

    def close(self):
        """Stop the worker after the batch it is on (the consumer left
        early); idempotent."""
        self._stop.set()
        self._ahead.release()
