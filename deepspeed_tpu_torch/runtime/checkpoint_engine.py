"""Checkpoint engines (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine.py``: ``CheckpointEngine`` :26,
``select_checkpoint_engine`` :104, ``MsgpackCheckpointEngine`` :125 and
``AsyncCheckpointEngine`` :143).

A checkpoint file is one ``torch.save`` of a dict of tensors and plain
Python values, written through ``checkpoint_manifest.atomic_write_stream``:
the bytes stream into the ``.tmp`` file of the atomic rename protocol while
their size and crc32 are counted, so the manifest's digest is that of the
file on disk and no serialised copy of the payload is held in memory. A
file loads with ``torch.load(map_location="cpu", weights_only=True,
mmap=True)``: the tensors are views of the mapped file, so a load of many
GB holds no second host copy, and only tensors and plain Python values
load. The manifest schema is the JAX package's, and either package's
``verify_tag_dir`` accepts a tag directory the other wrote.

Parameters and optimizer moments change in place at every step (the next
captured replay, B4), so a save must have copied each tensor to the host
before it returns. ``TorchCheckpointEngine.save`` writes synchronously:
``torch.save`` copies each device storage to the host as it writes it
(after a ``torch.cuda.synchronize()``, so the step has finished), and
returns once the file is durable, so no step runs in between and the host
holds one tensor at a time. ``AsyncCheckpointEngine.save`` first takes a
host copy of every tensor (``to_host``) and hands only that copy to its
writer thread, so training may go on at once.

Under a process group only rank 0 writes (the engine gathers what is
sharded to it first), so a tag has the same files at every world; its
manifest's ``topology`` block (``runtime/layout.topology_metadata``)
records the world, the ZeRO stage and the flat layout it was saved from.
"""

import os
import queue
import threading
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime import checkpoint_manifest as cm
from deepspeed_tpu_torch.utils.logging import log_dist

# a tag's files: the JAX package's names with a .pt suffix
MODEL_STATES = "mp_rank_00_model_states.pt"
ENGINE_STATES = "engine_states.pt"
OPTIM_STATES = "zero_pp_rank_0_mp_rank_00_optim_states.pt"


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _sync_cuda():
    """Wait for queued work on the card (the step that last wrote the
    tensors about to be read)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def to_host(tree):
    """Host copies of every tensor in ``tree`` (nested dicts, lists and
    tuples), taken once the card has finished its queued work. A copy even
    of a CPU tensor: the live one changes at the next step."""
    _sync_cuda()
    return _map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)


def write_torch_file(state: Dict[str, Any], path: str):
    """``torch.save(state)`` durably to ``path``; returns ``(digest,
    retries)``: the size and crc32 of the file, and the failed attempts.
    A device tensor is copied to the host as it is written."""
    return cm.atomic_write_stream(path, lambda f: torch.save(state, f))


def load_torch_file(path: str) -> Dict[str, Any]:
    """A checkpoint file, its tensors mapped from the file on the host."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


class CheckpointEngine:
    """The reference checkpoint engine's surface: ``create / save / load /
    commit``. Every ``save()`` between two ``commit()`` calls records the
    written file's size and crc32; ``commit(tag)`` turns the records for
    the tag's directory into a durable ``manifest.json``, the proof that
    ``load_checkpoint`` verifies before it trusts the tag."""

    def __init__(self, config_params=None):
        # written by save() or the async writer thread, drained by commit()
        self._manifest_lock = threading.Lock()
        self._manifest_files: Dict[str, Dict[str, Dict[str, object]]] = {}
        # the topology block of the next commit's manifests
        self._topology_metadata: Optional[Dict[str, Any]] = None
        self.io_retry_count = 0

    def create(self, tag: str):
        log_dist(f"[ckpt] checkpointing tag {tag}", ranks=[0])

    def save(self, state_dict: Dict[str, Any], path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        return True

    def pinned_tags(self) -> set:
        """Tags the retention GC must not delete now: none for a
        synchronous engine (its writes are durable before ``save``
        returns); the async engine pins every tag with a write in flight."""
        return set()

    def set_topology_metadata(self, metadata: Optional[Dict[str, Any]]):
        """The topology block written into every manifest of the next
        ``commit`` (what a later load on another device count reads)."""
        with self._manifest_lock:
            self._topology_metadata = metadata

    # -- manifest bookkeeping -------------------------------------------
    def _record_write(self, path: str, digest: Dict[str, object]):
        d, name = os.path.dirname(path), os.path.basename(path)
        with self._manifest_lock:
            self._manifest_files.setdefault(d, {})[name] = digest

    def _drop_records(self):
        with self._manifest_lock:
            self._manifest_files = {}

    def _commit_manifests(self, tag: str):
        """One manifest per recorded tag directory; files saved outside a
        directory named ``tag`` are not part of the tag and are dropped."""
        with self._manifest_lock:
            recorded, self._manifest_files = self._manifest_files, {}
            topology = self._topology_metadata
        for d, files in recorded.items():
            if os.path.basename(d) == str(tag):
                cm.write_manifest(d, tag, files, topology=topology)


def select_checkpoint_engine(config) -> CheckpointEngine:
    """The async engine when the ``nebula`` block is enabled (as the
    reference picks its Nebula engine), else the synchronous one."""
    nebula = getattr(config, "nebula", None)
    if nebula is not None and getattr(nebula, "enabled", False):
        return AsyncCheckpointEngine()
    return TorchCheckpointEngine()


class TorchCheckpointEngine(CheckpointEngine):
    """The default engine: one ``torch.save`` file per ``save``, durable
    before it returns."""

    def save(self, state_dict: Dict[str, Any], path: str):
        _sync_cuda()
        digest, retries = write_torch_file(state_dict, path)
        self._record_write(path, digest)
        self.io_retry_count += retries
        log_dist(f"[ckpt] saved {path}", ranks=[0])

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        return load_torch_file(path)

    def commit(self, tag: str) -> bool:
        self._commit_manifests(tag)
        return True


class AsyncCheckpointEngine(CheckpointEngine):
    """Asynchronous save (the reference Nebula engine's async path).

    ``save()`` takes host copies of the state synchronously (so training
    may change its tensors as soon as it returns) and hands serialisation
    and file IO to one background writer thread. ``commit(tag)`` blocks
    until every pending write has durably landed and raises any writer
    error there. ``load()`` waits for pending writes first."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._queue: "queue.Queue" = queue.Queue()
        # _errors, _pending and _inflight_tags cross the writer and caller
        # threads: every access holds the lock
        self._lock = threading.Lock()
        self._errors: list = []
        self._pending: list = []
        # tag -> writes in flight into that tag's directory (what
        # pinned_tags() reads; _pending alone cannot serve, because wait()
        # pops it while writes may still be on the queue)
        self._inflight_tags: Dict[str, int] = {}
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    @staticmethod
    def _tag_of(path: str) -> str:
        """Files live at ``<save_dir>/<tag>/<file>``."""
        return os.path.basename(os.path.dirname(path))

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            host_state, path, done = item
            try:
                digest, retries = write_torch_file(host_state, path)
                self._record_write(path, digest)
                self.io_retry_count += retries
                log_dist(f"[ckpt] async saved {path}", ranks=[0])
            except Exception as e:  # raised at commit()
                with self._lock:
                    self._errors.append((path, e))
            finally:
                # unpin before signalling done: a waiter may run the GC at
                # once, and it must see the updated pins
                tag = self._tag_of(path)
                with self._lock:
                    count = self._inflight_tags.get(tag, 0) - 1
                    if count > 0:
                        self._inflight_tags[tag] = count
                    else:
                        self._inflight_tags.pop(tag, None)
                done.set()

    def save(self, state_dict: Dict[str, Any], path: str):
        # snapshot and enqueue unconditionally: an earlier failure must not
        # drop later files; every failure is raised together at commit()
        host_state = to_host(state_dict)
        done = threading.Event()
        tag = self._tag_of(path)
        with self._lock:
            self._pending.append(done)
            self._inflight_tags[tag] = self._inflight_tags.get(tag, 0) + 1
        self._queue.put((host_state, path, done))

    def pinned_tags(self) -> set:
        with self._lock:
            return set(self._inflight_tags)

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        self.wait()  # never read a file a pending write may still replace
        self._raise_errors()  # a failed write leaves a stale file behind
        return load_torch_file(path)

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for done in pending:
            done.wait()

    def _raise_errors(self):
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            # the tag is invalid: its other files must not be certified by
            # a manifest at the next commit
            self._drop_records()
            paths = ", ".join(p for p, _ in errors)
            raise RuntimeError(
                f"async checkpoint write failed for {len(errors)} "
                f"file(s): {paths}") from errors[0][1]

    def commit(self, tag: str) -> bool:
        self.wait()
        self._raise_errors()
        self._commit_manifests(tag)
        log_dist(f"[ckpt] tag {tag} committed (all async writes durable)",
                 ranks=[0])
        return True
