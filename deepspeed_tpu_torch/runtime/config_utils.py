"""Config helpers (counterpart of ``deepspeed_tpu/runtime/config_utils.py``):
plain dataclasses with ``from_dict``, unknown keys warned about and skipped,
deprecated aliases through ``_aliases = {old: new}``."""

import dataclasses
import json
from typing import Any, Dict

from deepspeed_tpu_torch.utils.logging import logger


def get_scalar_param(param_dict: Dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys in the user JSON."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        seen, dup = set(), []
        for k, _ in ordered_pairs:
            if k in seen:
                dup.append(k)
            seen.add(k)
        raise ValueError(f"Duplicate keys in DeepSpeed config: {dup}")
    return d


class ConfigModel:
    """Dataclass mixin: ``from_dict`` warns about unknown keys, maps
    ``_aliases`` and runs ``__post_init__validate__`` when defined."""

    _aliases: Dict[str, str] = {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        if d is None:
            d = {}
        if not isinstance(d, dict):
            raise TypeError(
                f"{cls.__name__} config block must be a dict, got {type(d)}")
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in d.items():
            key = cls._aliases.get(key, key)
            if key in field_names:
                kwargs[key] = value
            else:
                logger.warning("%s: ignoring unknown config key %r",
                               cls.__name__, key)
        inst = cls(**kwargs)
        if hasattr(inst, "__post_init__validate__"):
            inst.__post_init__validate__()
        return inst

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def pretty_json(d: Dict) -> str:
    return json.dumps(d, indent=2, sort_keys=True, default=str)
