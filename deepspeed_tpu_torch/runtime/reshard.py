"""Checkpoint re-layout across world and stage changes (counterpart of
``deepspeed_tpu/runtime/reshard.py``: ``decide`` :74, ``verify_state_dict``
:106, and the gather and place phases).

A tag holds whole tensors by parameter name at every world (rank 0
gathers each one at save), so a load on another world or ZeRO stage is:

1. **detect**: the tag's manifest ``topology`` block against the live
   topology (``layout.topology_matches``); a difference is logged as a
   reshard, not refused. A tag with no block (a v1 manifest) loads
   with no comparison.
2. **verify**: every loaded tensor's shape against the record saved with
   the partition specs, so a tensor that drifted fails here by name.
3. **place**: each rank copies its slice of each tensor into its live
   shard (``ZeroOptimizer.load_state_dict``) and the whole parameters
   into its parameter buffer, in place, so the captured steps stay valid.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.parallel.mesh import MeshTopology
from deepspeed_tpu_torch.runtime import checkpoint_manifest as cm
from deepspeed_tpu_torch.runtime import layout


class ReshardError(RuntimeError):
    """A topology-changed load that cannot proceed safely."""


@dataclass
class ReshardDecision:
    """Outcome of the detect phase for one (tag, live topology) pair."""

    saved: Optional[Dict[str, Any]]  # manifest topology block (None = v1)
    mismatches: List[str] = field(default_factory=list)
    detect_s: float = 0.0

    @property
    def needed(self) -> bool:
        return bool(self.mismatches)

    def describe(self) -> str:
        if self.saved is None:
            return "no saved topology metadata (pre-v2 manifest)"
        if not self.mismatches:
            return "saved topology matches live topology"
        return "topology changed: " + ", ".join(self.mismatches)


def decide(load_dir: str, tag: str, topology: MeshTopology,
           zero_stage: Optional[int] = None) -> ReshardDecision:
    """Detect phase: the tag's topology block against ``topology``."""
    t0 = time.monotonic()
    saved = cm.manifest_topology(os.path.join(load_dir, str(tag)))
    if saved is None:
        return ReshardDecision(saved=None, detect_s=time.monotonic() - t0)
    return ReshardDecision(
        saved=saved, detect_s=time.monotonic() - t0,
        mismatches=layout.topology_matches(saved, topology,
                                           zero_stage=zero_stage))


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = value
    return out


def verify_state_dict(state_sd: Dict[str, Any],
                      saved_specs: Dict[str, Dict[str, Any]],
                      label: str) -> Tuple[int, float]:
    """Verify phase: every loaded tensor whose name has a saved record
    with a ``shape`` must have that shape. ``state_sd`` maps names (or
    name/key paths) to tensors; a record keyed by the parameter name
    covers every tensor under it (an optimizer's moments). Returns
    (tensors verified, seconds); raises ``ReshardError`` naming the
    tensors that differ."""
    t0 = time.monotonic()
    bad: List[str] = []
    checked = 0
    for path, leaf in _flatten(state_sd).items():
        rec = saved_specs.get(path) or saved_specs.get(path.rsplit("/", 1)[0])
        if rec is None or "shape" not in rec or not hasattr(leaf, "shape"):
            continue
        checked += 1
        want = tuple(int(d) for d in rec["shape"])
        if tuple(leaf.shape) != want:
            bad.append(f"{path}: saved {want}, loaded {tuple(leaf.shape)}")
    if bad:
        raise ReshardError(
            f"{label} state does not match the saved partition record for "
            f"{len(bad)} tensor(s): " + "; ".join(bad[:5])
            + ("; ..." if len(bad) > 5 else ""))
    return checked, time.monotonic() - t0
