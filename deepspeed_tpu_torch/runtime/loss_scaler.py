"""fp16 dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``).

The JAX package threads the scaler state through its compiled step and
decides the skip with ``lax.cond``; here the state is host-side Python and
the overflow check is one device reduction read once per step, and only
when fp16 is on (the JAX engine's ``_check_overflow`` gate, engine.py:452).
"""

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    scale: float = 1.0     # current loss scale
    good_steps: int = 0    # consecutive non-overflow steps
    hysteresis: int = 1    # remaining tolerated overflows


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    dynamic: bool = False
    scale_window: int = 1000
    min_scale: float = 1.0
    max_hysteresis: int = 1
    scale_factor: float = 2.0


def init_loss_scale(fp16_config=None, enabled: bool = True
                    ) -> Tuple[LossScaleState, LossScaleConfig]:
    """Initial (state, policy) from an ``Fp16Config``."""
    if fp16_config is None or not enabled:
        return LossScaleState(), LossScaleConfig()
    dynamic = fp16_config.dynamic_loss_scale
    init_scale = (2.0 ** fp16_config.initial_scale_power if dynamic
                  else float(fp16_config.loss_scale))
    state = LossScaleState(scale=init_scale, good_steps=0,
                           hysteresis=int(fp16_config.hysteresis))
    cfg = LossScaleConfig(
        dynamic=dynamic,
        scale_window=int(fp16_config.loss_scale_window),
        min_scale=float(fp16_config.min_loss_scale),
        max_hysteresis=int(fp16_config.hysteresis),
        scale_factor=2.0)
    return state, cfg


def has_overflow(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """A device bool: any inf or NaN in any of ``grads``."""
    if not grads:
        return torch.tensor(False)
    return torch.stack([~torch.isfinite(g).all() for g in grads]).any()


def update_loss_scale(state: LossScaleState, overflow: bool,
                      cfg: LossScaleConfig) -> LossScaleState:
    """On overflow consume hysteresis, then halve (down to ``min_scale``);
    after ``scale_window`` clean steps, double."""
    if not cfg.dynamic:
        return state
    if overflow:
        hyst = state.hysteresis - 1
        if hyst <= 0:
            return LossScaleState(
                scale=max(state.scale / cfg.scale_factor, cfg.min_scale),
                good_steps=0, hysteresis=cfg.max_hysteresis)
        return LossScaleState(scale=state.scale, good_steps=0, hysteresis=hyst)
    if state.good_steps + 1 >= cfg.scale_window:
        return LossScaleState(scale=state.scale * cfg.scale_factor,
                              good_steps=0, hysteresis=cfg.max_hysteresis)
    return LossScaleState(scale=state.scale, good_steps=state.good_steps + 1,
                          hysteresis=cfg.max_hysteresis)
