"""Expert-sharded checkpoint files (counterpart of
``deepspeed_tpu/runtime/moe_checkpoint.py`` and the JAX engine's
``_save_sharded`` / ``_merge_expert_files``, ``engine.py:2535-2575``).

Every ``StackedExperts`` leaf of a saved state (the model's parameters, and
the optimizer's moments of those parameters) is split along its expert axis
and each expert's slices go to a file of their own,
``expert_{e}_mp_rank_00_{kind}_states.pt`` (the JAX package's names with
the port's ``.pt`` suffix); the main file keeps the other leaves and, under
``moe_experts``, each split leaf's axis and expert count. A load re-stacks
the slices into whole tensors, which the engine copies into its live
storage. A leaf is found by its path: nested dict keys joined by ``/``, one
of which names the expert parameter (``h.0.mlp.experts.wi`` in the model's
state, ``state/h.0.mlp.experts.wi/exp_avg`` in the optimizer's).
"""

import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.moe.layer import expert_axis


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) and v:
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _expert_axis_of(path: str, ndim: int) -> Optional[int]:
    for part in path.split("/"):
        ax = expert_axis(part, ndim)
        if ax is not None:
            return ax
    return None


def find_expert_leaves(state: Dict[str, Any]) -> Dict[str, int]:
    """``{path: expert axis}`` of every expert tensor in a nested dict."""
    out = {}
    for path, leaf in _flatten(state).items():
        if torch.is_tensor(leaf):
            ax = _expert_axis_of(path, leaf.ndim)
            if ax is not None:
                out[path] = ax
    return out


def split_expert_state(state: Dict[str, Any], expert_info: Dict[str, int]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """``(state without the expert leaves, meta, number of expert
    files)``; ``meta`` holds each split leaf's axis and expert count."""
    flat = _flatten(state)
    counts = {p: int(flat[p].shape[ax]) for p, ax in expert_info.items()}
    for p in expert_info:
        flat.pop(p)
    meta = {"axes": dict(expert_info), "counts": counts}
    return _unflatten(flat), meta, max(counts.values())


def expert_slice(state: Dict[str, Any], expert_info: Dict[str, int],
                 e: int) -> Dict[str, torch.Tensor]:
    """Expert ``e``'s slice of every expert leaf that has it (a copy: the
    file holds the slice alone, not its whole leaf's storage)."""
    flat = _flatten(state)
    return {p: flat[p].select(ax, e).contiguous().clone()
            for p, ax in expert_info.items() if e < flat[p].shape[ax]}


def merge_expert_slices(dense: Dict[str, Any], meta: Dict[str, Any],
                        slices_by_expert: Dict[int, Dict[str, torch.Tensor]]
                        ) -> Dict[str, Any]:
    """The inverse of the split: the slices re-stacked into whole leaves
    and put back into ``dense``."""
    flat = _flatten(dense)
    for p, ax in meta["axes"].items():
        n = int(meta["counts"][p])
        flat[p] = torch.stack([slices_by_expert[e][p] for e in range(n)],
                              dim=int(ax))
    return _unflatten(flat)


def expert_states_filename(e: int, kind: str = "model") -> str:
    """The JAX package's per-expert file name with the port's suffix."""
    return f"expert_{e}_mp_rank_00_{kind}_states.pt"


def load_with_experts(load: Callable[[str], Dict[str, Any]], tag_dir: str,
                      name: str, kind: str) -> Dict[str, Any]:
    """The tag's file ``name``, read by ``load(path)``, with the expert
    leaves its ``moe_experts`` record names merged back from the
    per-expert files of ``kind`` (JAX engine ``_merge_expert_files``); a
    dense model's file as it is."""
    payload = dict(load(os.path.join(tag_dir, name)))
    meta = payload.pop("moe_experts", None)
    if not meta:
        return payload
    n_files = max(int(n) for n in meta["counts"].values())
    slices = {e: load(os.path.join(tag_dir, expert_states_filename(
                  e, kind)))["experts"] for e in range(n_files)}
    return merge_expert_slices(payload, meta, slices)
