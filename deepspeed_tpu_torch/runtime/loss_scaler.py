"""fp16 dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``).

As in the JAX package, the scaler state is device tensors threaded through
the step: the engine's step function reads the scale, decides the skip and
updates the state on the card with branch-free tensor arithmetic (the
counterpart of the ``lax.cond`` in the jitted step), so a captured step
needs no host read. The host reads the overflow flag once per step, and
only when fp16 is on (the JAX engine's ``_check_overflow`` gate,
engine.py:452).
"""

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass
class LossScaleState:
    """Device state: three 0-dim tensors."""

    scale: torch.Tensor       # f32, current loss scale
    good_steps: torch.Tensor  # i32, consecutive non-overflow steps
    hysteresis: torch.Tensor  # i32, remaining tolerated overflows

    @classmethod
    def make(cls, scale: float, good_steps: int, hysteresis: int,
             device="cpu") -> "LossScaleState":
        return cls(torch.tensor(scale, dtype=torch.float32, device=device),
                   torch.tensor(good_steps, dtype=torch.int32, device=device),
                   torch.tensor(hysteresis, dtype=torch.int32, device=device))

    def copy_(self, other: "LossScaleState") -> "LossScaleState":
        """Write ``other`` into this state's tensors, in place (a captured
        step keeps the addresses it was captured with)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))
        return self


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    """Static policy (constants of the step)."""

    dynamic: bool = False
    scale_window: int = 1000
    min_scale: float = 1.0
    max_hysteresis: int = 1
    scale_factor: float = 2.0


def init_loss_scale(fp16_config=None, enabled: bool = True, device="cpu"
                    ) -> Tuple[LossScaleState, LossScaleConfig]:
    """Initial (state on ``device``, policy) from an ``Fp16Config``."""
    if fp16_config is None or not enabled:
        return LossScaleState.make(1.0, 0, 1, device), LossScaleConfig()
    dynamic = fp16_config.dynamic_loss_scale
    init_scale = (2.0 ** fp16_config.initial_scale_power if dynamic
                  else float(fp16_config.loss_scale))
    state = LossScaleState.make(init_scale, 0, int(fp16_config.hysteresis),
                                device)
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


def update_loss_scale(state: LossScaleState, overflow,
                      cfg: LossScaleConfig) -> LossScaleState:
    """On overflow consume hysteresis, then halve (down to ``min_scale``);
    after ``scale_window`` clean steps, double. ``overflow`` is a bool or a
    0-dim bool tensor; the result is a new state of tensors, computed on the
    state's device without a host read (the two branches of the JAX
    ``lax.cond`` as ``torch.where``)."""
    if not cfg.dynamic:
        return state
    overflow = torch.as_tensor(overflow, device=state.scale.device)
    hyst = state.hysteresis - 1
    drop = overflow & (hyst <= 0)
    grew = ~overflow & (state.good_steps + 1 >= cfg.scale_window)
    scale = torch.where(
        drop, torch.clamp(state.scale / cfg.scale_factor, min=cfg.min_scale),
        torch.where(grew, state.scale * cfg.scale_factor, state.scale))
    good_steps = torch.where(overflow | grew, 0, state.good_steps + 1)
    hysteresis = torch.where(overflow & ~drop, hyst, cfg.max_hysteresis)
    return LossScaleState(scale, good_steps.to(torch.int32),
                          hysteresis.to(torch.int32))
