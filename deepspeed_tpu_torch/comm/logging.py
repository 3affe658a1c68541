"""Communication op logging (a copy of ``deepspeed_tpu/comm/logging.py``:
``wire_factor`` :34 and ``CommsLogger`` :64, which import no jax; the port
keeps its own).

Every collective of ``comm/comm.py`` reports its op, payload and axis size
here when the logger is enabled (the config's ``comms_logger`` block).
Under a CUDA graph the Python wrapper of a collective runs once, at
capture: ``runtime/compiled_step.py`` takes the records its capture made
back (a capture runs nothing) and adds them once per replay, as it does for
kernel launches, so the counters count executed collectives.
"""

import threading
from collections import defaultdict
from typing import Dict, Optional

from deepspeed_tpu_torch.utils.logging import log_dist


def _itemsize(dtype) -> int:
    return getattr(dtype, "itemsize", 0)


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``: numpy's spelling, as the JAX
    package records it."""
    return str(dtype).replace("torch.", "")


def _nelems(x) -> int:
    try:
        return int(x.numel())
    except Exception:
        return 0


def _nbytes(x) -> int:
    return _nelems(x) * _itemsize(getattr(x, "dtype", None))


def wire_factor(op_name: str, world: Optional[int]) -> float:
    """Bytes sent per device over the interconnect, as a multiple of the
    op's INPUT payload, under the standard ring accounting:

    - ``all_reduce``: 2(w-1)/w  (reduce-scatter + all-gather rounds)
    - ``reduce_scatter`` / ``all_to_all``: (w-1)/w of the full input
    - ``all_gather``: (w-1) x the local shard (the input here IS the shard)
    - ``broadcast``: charged as an all-reduce (the JAX package lowers it so)
    - ``ppermute``: every device forwards its full payload once

    ``world=None`` (axis size unknown) charges the full payload; ``world=1``
    is free: nothing crosses a wire.
    """
    if world is None:
        return 1.0
    w = int(world)
    if w <= 1:
        return 0.0
    base = op_name.split(".")[0]
    if base in ("all_reduce", "broadcast"):
        return 2.0 * (w - 1) / w
    if base in ("reduce_scatter", "all_to_all"):
        return (w - 1) / w
    if base == "all_gather":
        return float(w - 1)
    return 1.0  # ppermute / unknown: payload crosses once


def _new_record():
    return {"count": 0, "bytes": 0, "wire_bytes": 0, "wire_dtype": None,
            "level": None, "msg_sizes": defaultdict(int)}


class CommsLogger:
    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, prof_ops=None, debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug
        self._lock = threading.Lock()
        # op name -> {"count", "bytes" (logical payload), "wire_bytes"
        # (ring-accounted bytes sent per device in the wire dtype),
        # "wire_dtype", "msg_sizes": {size: count}}
        self.comms_dict: Dict[str, Dict] = defaultdict(_new_record)
        # wire bytes by interconnect level: "ici" (inside a slice) and "dcn"
        # (across slices) of the hierarchical exchange (comm/bucketed.py)
        self.level_bytes: Dict[str, int] = defaultdict(int)

    def configure(self, config) -> None:
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.prof_ops = list(config.prof_ops)
        self.debug = config.debug

    def _should_log(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        return self.prof_all or op_name in self.prof_ops

    def append(self, op_name: str, tensor, axis, log_name: Optional[str] = None,
               wire_dtype=None, world: Optional[int] = None,
               level: Optional[str] = None) -> None:
        """Record one collective. ``bytes`` counts the input payload in the
        tensor's own dtype; ``wire_bytes`` the payload in ``wire_dtype``
        (the tensor's when None) times :func:`wire_factor` at axis size
        ``world``."""
        name = log_name or op_name
        if not self._should_log(name):
            return
        size = _nbytes(tensor)
        wire_payload = (size if wire_dtype is None
                        else _nelems(tensor) * _itemsize(wire_dtype))
        wire = int(round(wire_payload * wire_factor(op_name, world)))
        with self._lock:
            rec = self.comms_dict[name]
            rec["count"] += 1
            rec["bytes"] += size
            rec["wire_bytes"] += wire
            if wire_dtype is not None:
                rec["wire_dtype"] = _dtype_name(wire_dtype)
            rec["msg_sizes"][size] += 1
            if level is not None:
                rec["level"] = str(level)
                self.level_bytes[str(level)] += wire
        if self.verbose:
            log_dist(f"comm op: {name} | axis: {axis} | msg size: {size} "
                     f"bytes | wire: {wire} bytes", ranks=[0])

    # -- capture accounting (runtime/compiled_step.py) --------------------
    def snapshot(self) -> Dict[str, Dict]:
        """A copy of the records, to diff against after a capture."""
        with self._lock:
            return {name: dict(rec, msg_sizes=dict(rec["msg_sizes"]))
                    for name, rec in self.comms_dict.items()}

    def since(self, before: Dict[str, Dict]) -> Dict[str, Dict]:
        """The records added since ``before`` (a ``snapshot()``)."""
        out = {}
        for name, rec in self.snapshot().items():
            old = before.get(name, _new_record())
            delta = {k: rec[k] - old[k]
                     for k in ("count", "bytes", "wire_bytes")}
            if not delta["count"]:
                continue
            delta["wire_dtype"] = rec["wire_dtype"]
            delta["level"] = rec["level"]
            delta["msg_sizes"] = {
                s: n - old["msg_sizes"].get(s, 0)
                for s, n in rec["msg_sizes"].items()
                if n != old["msg_sizes"].get(s, 0)}
            out[name] = delta
        return out

    def add(self, records: Dict[str, Dict], sign: int = 1) -> None:
        """Add ``records`` (a ``since()`` result) ``sign`` times: once per
        replay of a graph whose capture made them, or -1 at the capture."""
        if not records:
            return
        with self._lock:
            for name, d in records.items():
                rec = self.comms_dict[name]
                for k in ("count", "bytes", "wire_bytes"):
                    rec[k] += sign * d[k]
                if d["wire_dtype"] is not None:
                    rec["wire_dtype"] = d["wire_dtype"]
                if d.get("level") is not None:
                    rec["level"] = d["level"]
                    self.level_bytes[d["level"]] += sign * d["wire_bytes"]
                for s, n in d["msg_sizes"].items():
                    rec["msg_sizes"][s] += sign * n
                    if not rec["msg_sizes"][s]:
                        del rec["msg_sizes"][s]
                if not rec["count"]:
                    del self.comms_dict[name]

    def counters(self) -> Dict[str, float]:
        """Flat cumulative counters: per-op ``<name>_count`` /
        ``<name>_bytes`` / ``<name>_wire_bytes`` plus
        ``total_wire_bytes``."""
        out: Dict[str, float] = {}
        total_wire = 0
        with self._lock:
            for name, rec in sorted(self.comms_dict.items()):
                key = name.replace("/", "_").replace(" ", "_")
                out[f"{key}_count"] = float(rec["count"])
                out[f"{key}_bytes"] = float(rec["bytes"])
                out[f"{key}_wire_bytes"] = float(rec["wire_bytes"])
                total_wire += rec["wire_bytes"]
            out["ici_bytes"] = float(self.level_bytes.get("ici", 0))
            out["dcn_bytes"] = float(self.level_bytes.get("dcn", 0))
        out["total_wire_bytes"] = float(total_wire)
        return out

    def total_wire_bytes(self) -> int:
        with self._lock:
            return sum(rec["wire_bytes"] for rec in self.comms_dict.values())

    def log_summary(self) -> str:
        lines = ["Comm. Op            Count    Total Bytes    Wire Bytes"]
        with self._lock:
            for name, rec in sorted(self.comms_dict.items()):
                wire = rec["wire_bytes"]
                dt = f" ({rec['wire_dtype']})" if rec["wire_dtype"] else ""
                lines.append(f"{name:<20}{rec['count']:<9}{rec['bytes']:<15}"
                             f"{wire}{dt}")
                for size, cnt in sorted(rec["msg_sizes"].items()):
                    lines.append(f"    msg size {size:>12} B  x{cnt}")
        summary = "\n".join(lines)
        log_dist(summary, ranks=[0])
        return summary

    def reset(self) -> None:
        with self._lock:
            self.comms_dict.clear()
            self.level_bytes.clear()


# process-global instance, configured by the engine from the comms_logger block
comms_logger = CommsLogger()
