"""Background host-to-device prefetch (counterpart of
``deepspeed_tpu/data/prefetch.py``): a bounded queue whose worker thread
pulls batches from the wrapped loader and runs the engine's transfer to the
card *before* the training loop asks for them.

``DevicePrefetcher`` keeps the JAX contract. With depth >= 2 it
double-buffers the input path: while the captured step for batch N runs,
the worker packs batch N+1 and copies it to the card. The worker captures
``loader.state_dict()`` immediately after pulling each item and enqueues the
pair ``(device_batch, state)``, so when the consumer pops batch *k*, the
state that rides with it is "the loader just after producing batch *k*",
however far ahead the worker has run; ``state_dict()`` returns that
last-delivered snapshot, so a checkpoint taken between steps resumes at the
batch after the one the consumer saw. ``reseed`` and ``load_state_dict``
halt the worker first, so the wrapped loader is never touched from two
threads; a finite loader ends the iteration; a worker's exception reaches
the consumer. ``counters()`` reports gets, starved gets (the consumer found
the queue empty) and the mean and maximum queue depth; each starved get
also publishes ``data.prefetch_starved`` on the telemetry bus, as in JAX
(the admission controller reads it as backpressure).

The card's side of the transfer is ``CopyStream``, the engine's ``put_fn``
on a CUDA device: the worker copies each array into a pinned host tensor
(a copy from pageable memory with ``non_blocking=True`` is synchronous),
runs the host-to-device copies on a stream of its own, made on the
engine's device (a new thread's current device is card 0, so every stream,
event and copy names the device), and records an event after them. The
result is a ``PlacedBatch``: the consumer calls ``wait()``, which makes
its current stream wait for that event and marks each tensor as used by
that stream (``record_stream``), so the caching allocator does not hand a
batch's block to the worker's next copy while the step still reads it.
The worker's copies run on their own stream and allocate from the
ordinary pool, so they go on while the engine captures a step graph on
another stream (``capture_error_mode="thread_local"``): a capture records
only its own stream's work and allocates only its own stream's blocks
from the graph's pool.
"""

import copy
import queue
import threading
from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.telemetry.bus import KIND_PREFETCH_STARVED, publish

_END = object()  # worker→consumer: wrapped loader raised StopIteration


class PlacedBatch(dict):
    """A batch the prefetch worker has placed on the engine's device: a dict
    of tensors, and the event recorded after their copies (None on the
    CPU)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None):
        super().__init__(tensors)
        self.event = event

    def wait(self) -> "PlacedBatch":
        """Make the current stream wait for the copies, and record it as a
        user of every tensor; returns the batch."""
        if self.event is not None:
            device = next(iter(self.values())).device
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.event)
            for t in self.values():
                t.record_stream(stream)
        return self


class CopyStream:
    """The host-to-device copies of a prefetch worker: each tensor of a
    batch of host tensors goes through pinned memory to ``device`` on a
    dedicated CUDA stream, and an event is recorded after the copies. On
    the CPU the tensors are returned as they are."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None

    def __call__(self, tensors: Dict[str, torch.Tensor]) -> PlacedBatch:
        if self.device.type != "cuda":
            return PlacedBatch(tensors)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in tensors.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        return PlacedBatch(out, event)


class DevicePrefetcher:
    """Wrap a loader-protocol iterator with a bounded prefetch queue.

    ``put_fn`` is the host→device transfer (the engine passes its
    ``_prefetch_put``); ``None`` leaves batches on host. The wrapper itself
    speaks the loader protocol (``state_dict``/``load_state_dict``/
    ``reseed``/``order_version``/``seed``) by delegating to the wrapped
    loader — mutating calls halt the worker first so the underlying
    iterator is never touched from two threads.
    """

    def __init__(self, loader, put_fn: Optional[Callable] = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.put_fn = put_fn
        self.depth = depth
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._delivered_state: Optional[Dict[str, Any]] = None
        self._last_order_version = getattr(loader, "order_version", 0)
        # starvation accounting
        self._gets = 0
        self._starved_gets = 0
        self._depth_sum = 0
        self._depth_max = 0

    # -- worker ------------------------------------------------------------
    def _worker(self, it):
        try:
            while not self._stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    self._put_blocking(_END)
                    return
                state = None
                if hasattr(self.loader, "state_dict"):
                    state = copy.deepcopy(self.loader.state_dict())
                if self.put_fn is not None:
                    item = self.put_fn(item)
                if not self._put_blocking((item, state)):
                    return
        except BaseException as e:  # propagate into the consumer
            self._error = e
            self._put_blocking(_END)

    def _put_blocking(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _ensure_worker(self):
        if getattr(self.loader, "order_version", 0) != self._last_order_version:
            self._halt()
        # a worker that has ended with items still queued (the last batches
        # of a finite loader, then the end or its error) is not replaced:
        # a new one would drop them and iterate a re-iterable loader again
        # (the JAX module restarts it there)
        if self._thread is None or (not self._thread.is_alive()
                                    and self._queue.empty()):
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            self._stop.clear()
            self._queue = queue.Queue(maxsize=self.depth)
            self._last_order_version = getattr(self.loader,
                                               "order_version", 0)
            self._thread = threading.Thread(
                target=self._worker, args=(iter(self.loader),),
                name="ds-prefetch", daemon=True)
            self._thread.start()

    def _halt(self):
        """Stop the worker and discard anything it staged."""
        self._stop.set()
        if self._thread is not None:
            # drain so a blocked put() observes the stop event
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    self._thread.join(timeout=0.1)
            self._thread = None
        with self._queue.mutex:
            self._queue.queue.clear()
        self._stop.clear()

    # -- iterator ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_worker()
        depth = self._queue.qsize()
        self._gets += 1
        self._depth_sum += depth
        self._depth_max = max(self._depth_max, depth)
        if depth == 0:
            # the consumer is about to block on the producer
            self._starved_gets += 1
            publish(KIND_PREFETCH_STARVED, severity="warning",
                    starved_gets=self._starved_gets, gets=self._gets)
        got = self._queue.get()
        if got is _END:
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        item, state = got
        if state is not None:
            self._delivered_state = state
        return item

    def counters(self) -> Dict[str, float]:
        """Prefetch health counters (the JAX module's ``Perf/*`` gauges)."""
        gets = max(self._gets, 1)
        return {
            "prefetch_depth": float(self.depth),
            "prefetch_gets": float(self._gets),
            "prefetch_starved_gets": float(self._starved_gets),
            "prefetch_queue_depth_avg": self._depth_sum / gets,
            "prefetch_queue_depth_max": float(self._depth_max),
        }

    def stop(self):
        self._halt()

    # -- loader protocol ---------------------------------------------------
    @property
    def order_version(self) -> int:
        return getattr(self.loader, "order_version", 0)

    @property
    def seed(self):
        return getattr(self.loader, "seed", None)

    @property
    def batch_size(self):
        return getattr(self.loader, "batch_size", None)

    def reseed(self, offset: int):
        self._halt()
        self._delivered_state = None
        self.loader.reseed(offset)
        self._last_order_version = getattr(self.loader, "order_version", 0)

    def state_dict(self) -> Dict[str, Any]:
        if self._delivered_state is not None:
            return copy.deepcopy(self._delivered_state)
        return copy.deepcopy(self.loader.state_dict())

    def load_state_dict(self, state: Dict[str, Any]):
        self._halt()
        self._delivered_state = None
        self.loader.load_state_dict(state)
        self._last_order_version = getattr(self.loader, "order_version", 0)
