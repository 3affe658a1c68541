"""Shared constants of the port's kernels (counterpart of
``deepspeed_tpu/ops/pallas/common.py``).

``NEG_INF`` is finite on purpose: a masked score becomes
``exp(-1e30 - m) == 0.0`` exactly, so a masked key gets zero weight, while a
row whose keys are all masked so far still has a finite running max that the
first visible key replaces. ``-inf`` would turn such a row into NaN.
"""

NEG_INF = -1e30
