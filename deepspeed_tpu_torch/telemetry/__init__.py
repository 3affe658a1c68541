"""Process-local telemetry (counterpart of ``deepspeed_tpu/telemetry/``):
what is ported of it, the event bus. The flight recorder, crash reports and
memory accounting are ROADMAP A.11."""

from deepspeed_tpu_torch.telemetry.bus import (TelemetryBus, publish,
                                               telemetry_bus)

__all__ = ["TelemetryBus", "telemetry_bus", "publish"]
