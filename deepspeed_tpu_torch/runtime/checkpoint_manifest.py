"""Checkpoint durability and integrity (a copy of
``deepspeed_tpu/runtime/checkpoint_manifest.py``, which imports no jax:
the port keeps its own, with the same on-disk manifest schema, so that
either package verifies a tag directory the other wrote).

* ``atomic_write_bytes`` / ``atomic_write_stream``: tmp file + flush +
  fsync + ``os.replace`` + parent-directory fsync, with exponential-backoff
  retry on transient ``OSError``. The stream form writes through
  ``DigestWriter``, which counts the bytes and the crc32 as they pass, so a
  payload of many GB is never held in memory to be digested;
* per-tag ``manifest.json`` (file list + byte sizes + crc32, and a
  ``topology`` block) written by ``CheckpointEngine.commit`` and checked by
  ``verify_tag_dir`` before a load trusts the tag;
* ``find_valid_tags`` / ``latest_valid_tag``: the fallback scan used when
  the newest tag is torn.
"""

import errno
import json
import os
import time
import zlib
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_NAME = "manifest.json"
# v1: {version, tag, files}. v2 adds an optional "topology" block (world
# size, zero stage, axis sizes, per-leaf partition specs) so that a resume
# on a different device count can be detected and resharded (the JAX
# package's runtime/reshard.py; in the port, ROADMAP A.3). v1 manifests
# stay loadable: no topology block means the saved topology is unknowable.
MANIFEST_VERSION = 2
# fields of the v2 topology block, named in back-compat error messages
TOPOLOGY_FIELDS = ("world_size", "zero_stage", "axis_sizes",
                   "partition_specs")
LATEST_NAME = "latest"
LAST_VALID_TAG_ENV = "DS_TPU_LAST_VALID_TAG"

# Transient-IO retry policy. Read at call time (not bound as argument
# defaults) so tests and deployments can tune them on the module.
IO_RETRIES = 3
IO_BACKOFF_S = 0.1

# OSErrors that no amount of retrying will fix — surface them immediately.
_PERMANENT_ERRNOS = frozenset({errno.ENOSPC, errno.EDQUOT, errno.EROFS})


def _fsync_dir(path: str):
    """fsync a DIRECTORY so a rename into it survives power loss (POSIX
    does not promise the dirent is durable until the dir itself is
    synced). Best-effort: some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def retry_io(fn: Callable, what: str, retries: Optional[int] = None,
             backoff_s: Optional[float] = None):
    """Run ``fn()`` retrying transient ``OSError`` with exponential backoff.

    Returns ``(result, attempts_failed)`` so callers can export a retry
    counter. Non-OSError exceptions and permanently-fatal errnos (ENOSPC,
    EROFS, ...) propagate immediately.
    """
    retries = IO_RETRIES if retries is None else retries
    backoff_s = IO_BACKOFF_S if backoff_s is None else backoff_s
    failures = 0
    while True:
        try:
            return fn(), failures
        except OSError as e:
            if e.errno in _PERMANENT_ERRNOS or failures >= retries:
                raise
            failures += 1
            delay = backoff_s * (2 ** (failures - 1))
            logger.warning(
                "transient IO failure (%s): %s; retry %d/%d in %.2fs",
                what, e, failures, retries, delay)
            if delay > 0:
                time.sleep(delay)


def payload_digest(payload: bytes) -> Dict[str, object]:
    """Size + crc32 of an in-memory payload (manifest entry shape)."""
    return {"bytes": len(payload), "crc32": f"{zlib.crc32(payload):08x}"}


def file_digest(path: str, chunk_size: int = 1 << 20) -> Dict[str, object]:
    """Streamed size + crc32 of a file on disk."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {"bytes": size, "crc32": f"{crc:08x}"}


class DigestWriter:
    """A write-only file wrapper that counts the bytes written through it
    and their crc32: ``digest()`` equals ``file_digest`` of the file once
    it is closed."""

    def __init__(self, f):
        self._f = f
        self.size = 0
        self.crc = 0

    def write(self, data) -> int:
        n = self._f.write(data)
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(memoryview(data).cast("B"))
        return n

    def flush(self):
        self._f.flush()

    def digest(self) -> Dict[str, object]:
        return {"bytes": self.size, "crc32": f"{self.crc:08x}"}


def atomic_write_stream(path: str, write: Callable[[DigestWriter], None],
                        retries: Optional[int] = None,
                        backoff_s: Optional[float] = None):
    """Durably write what ``write(f)`` writes to the ``DigestWriter`` ``f``
    to ``path``: a sibling tmp file, flush + fsync, ``os.replace`` over the
    target, fsync of the parent dir. Transient OSErrors retry the whole
    cycle (``write`` is called again). Returns ``(digest, failures)``: the
    size and crc32 of what landed, and the number of failed attempts."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"

    def _once():
        with open(tmp, "wb") as f:
            out = DigestWriter(f)
            write(out)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(parent)
        return out.digest()

    try:
        return retry_io(_once, what=path, retries=retries,
                        backoff_s=backoff_s)
    finally:
        # a failed attempt may leave the tmp file; never leave it to be
        # mistaken for checkpoint data
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass


def atomic_write_bytes(path: str, payload: bytes,
                       retries: Optional[int] = None,
                       backoff_s: Optional[float] = None) -> int:
    """Durably write ``payload`` to ``path`` (``atomic_write_stream``).
    Returns the number of failed attempts (for retry counters)."""
    _, failures = atomic_write_stream(path, lambda f: f.write(payload),
                                      retries=retries, backoff_s=backoff_s)
    return failures


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------
def manifest_path(tag_dir: str) -> str:
    return os.path.join(tag_dir, MANIFEST_NAME)


def write_manifest(tag_dir: str, tag: str,
                   files: Dict[str, Dict[str, object]],
                   topology: Optional[Dict] = None) -> str:
    """Write ``tag_dir/manifest.json`` naming every file of the tag with
    its size and crc32, plus (v2) the topology the state was laid out for.
    Written durably LAST, so its presence certifies the whole tag: a crash
    at any earlier point leaves a tag without a manifest, which loads
    treat as never-committed."""
    doc = {
        "version": MANIFEST_VERSION,
        "tag": str(tag),
        "files": {name: dict(entry) for name, entry in sorted(files.items())},
    }
    if topology is not None:
        doc["topology"] = topology
    payload = json.dumps(doc, indent=2, sort_keys=True).encode()
    path = manifest_path(tag_dir)
    atomic_write_bytes(path, payload)
    return path


def read_manifest(tag_dir: str) -> Optional[Dict]:
    """Parsed manifest, or None when absent/unreadable (legacy tag)."""
    try:
        with open(manifest_path(tag_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def manifest_topology(tag_dir: str) -> Optional[Dict]:
    """The tag's saved topology block, or None for v1/absent manifests
    (pre-topology-metadata checkpoints: same-topology resume only)."""
    manifest = read_manifest(tag_dir)
    if manifest is None:
        return None
    return manifest.get("topology")


def verify_tag_dir(tag_dir: str, check_data: bool = True
                   ) -> Optional[List[str]]:
    """Check a tag directory against its manifest.

    Returns ``[]`` when every listed file exists with the recorded size
    (and crc32 when ``check_data``), a list of human-readable problems on
    mismatch, or ``None`` when there is no manifest to check (pre-manifest
    checkpoint — the caller decides whether to trust it)."""
    manifest = read_manifest(tag_dir)
    if manifest is None:
        return None
    problems = []
    for name, entry in manifest.get("files", {}).items():
        path = os.path.join(tag_dir, name)
        if not os.path.exists(path):
            problems.append(f"missing file: {name}")
            continue
        size = os.path.getsize(path)
        if size != entry.get("bytes"):
            problems.append(
                f"size mismatch: {name} has {size} bytes, manifest says "
                f"{entry.get('bytes')}")
            continue
        if check_data:
            crc = file_digest(path)["crc32"]
            if crc != entry.get("crc32"):
                problems.append(
                    f"crc mismatch: {name} is {crc}, manifest says "
                    f"{entry.get('crc32')}")
    return problems


def find_valid_tags(base_dir: str, check_data: bool = True,
                    exclude=()) -> List[str]:
    """Tags under ``base_dir`` whose manifest verifies, newest first
    (manifest mtime — commit order — with dir name as tiebreaker)."""
    if not os.path.isdir(base_dir):
        return []
    candidates = []
    for name in os.listdir(base_dir):
        if name in exclude:
            continue
        tag_dir = os.path.join(base_dir, name)
        if not os.path.isdir(tag_dir):
            continue
        mpath = manifest_path(tag_dir)
        if not os.path.exists(mpath):
            continue
        if verify_tag_dir(tag_dir, check_data=check_data) == []:
            candidates.append((os.path.getmtime(mpath), name))
    return [name for _, name in sorted(candidates, reverse=True)]


def latest_valid_tag(base_dir: str, check_data: bool = True,
                     exclude=()) -> Optional[str]:
    tags = find_valid_tags(base_dir, check_data=check_data, exclude=exclude)
    return tags[0] if tags else None


# ---------------------------------------------------------------------------
# 'latest' pointer
# ---------------------------------------------------------------------------
def write_latest(save_dir: str, tag: str):
    """Atomically + durably update the ``latest`` pointer: a crash mid-
    write can never leave a truncated pointer wedging recovery."""
    atomic_write_bytes(os.path.join(save_dir, LATEST_NAME),
                       str(tag).encode())


def read_latest(load_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(load_dir, LATEST_NAME)) as f:
            tag = f.read().strip()
        return tag or None
    except OSError:
        return None
