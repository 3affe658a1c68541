"""Progressive Layer Dropping (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``, DeepSpeed's
``runtime/progressive_layer_drop.py``: the PLD paper's keep-probability
schedule).

``theta(t) = (1 - theta) * exp(-gamma * t) + theta`` decays the layer keep
probability from 1.0 toward ``theta``. The engine computes the same
schedule on the device from a step counter and hands ``pld_theta`` to the
model, whose layer i survives with probability ``1 - (i / L) * (1 -
theta)`` (``models.transformer_lm.pld_keep_probability``); this host copy is
the engine's record of it (``get_state``), updated once per step.
"""

import math
from typing import Any, Dict


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def get_state(self) -> Dict[str, Any]:
        return {"progressive_layer_drop": True,
                "pld_theta": self.get_theta()}

    def update_state(self, global_step: int) -> float:
        self.current_theta = (
            (1.0 - self.theta) * math.exp(-self.gamma * global_step)
            + self.theta)
        return self.current_theta
