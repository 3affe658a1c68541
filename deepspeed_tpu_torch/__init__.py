"""deepspeed_tpu_torch: the PyTorch / CUDA port of ``deepspeed_tpu``.

``deepspeed_tpu`` (JAX, Pallas kernels for the TPU) stays the reference;
this package serves the same GPT models on NVIDIA Hopper cards, one ported
slice at a time, with every Pallas kernel rewritten by hand for the GPU
(``csrc/``). It imports torch and numpy, never jax or ``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``. ``initialize`` (training) is
not ported yet.
"""

from deepspeed_tpu_torch.version import __version__  # noqa: F401


def init_inference(*args, **kwargs):
    """Build an InferenceEngine (counterpart of
    ``deepspeed_tpu.init_inference``), imported lazily so that importing the
    package stays light."""
    from deepspeed_tpu_torch.inference.engine import init_inference as _init

    return _init(*args, **kwargs)
