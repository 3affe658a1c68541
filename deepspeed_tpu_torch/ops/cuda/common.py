"""Shared constants of the port's kernels (counterpart of
``deepspeed_tpu/ops/pallas/common.py``).

``NEG_INF`` is finite on purpose: a masked score becomes
``exp(-1e30 - m) == 0.0`` exactly, so a masked key gets zero weight, while a
row whose keys are all masked so far still has a finite running max that the
first visible key replaces. ``-inf`` would turn such a row into NaN.

``check_current_device``: a kernel launches on the current device's current
stream, so a wrapper refuses a tensor that lies on another card (a rank
whose card was never made current: ``comm.init_distributed`` calls
``torch.cuda.set_device``).
"""

NEG_INF = -1e30


def check_current_device(t) -> None:
    """Raise unless the CUDA tensor ``t`` lies on the current device."""
    import torch

    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(
            f"a kernel input lies on {t.device} while cuda:{current} is the "
            "current device; make the rank's card current first "
            "(torch.cuda.set_device, as comm.init_distributed does)")
