"""deepspeed_tpu_torch: the PyTorch / CUDA port of ``deepspeed_tpu``.

``deepspeed_tpu`` (JAX, Pallas kernels for the TPU) stays the reference;
this package trains and serves the same GPT models on NVIDIA Hopper cards,
one ported slice at a time, with every Pallas kernel rewritten by hand for
the GPU (``csrc/``). It imports torch and numpy, never jax or
``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``: ``initialize`` (training),
``init_inference`` (serving), ``DeepSpeedConfig`` and
``add_config_arguments``, each imported lazily so that importing the package
stays light.
"""

from deepspeed_tpu_torch.version import __version__  # noqa: F401


def initialize(*args, **kwargs):
    """Build a DeepSpeedEngine (counterpart of ``deepspeed_tpu.initialize``);
    see ``runtime/engine.py``."""
    from deepspeed_tpu_torch.runtime.engine import initialize as _init

    return _init(*args, **kwargs)


def init_inference(*args, **kwargs):
    """Build an InferenceEngine (counterpart of
    ``deepspeed_tpu.init_inference``); see ``inference/engine.py``."""
    from deepspeed_tpu_torch.inference.engine import init_inference as _init

    return _init(*args, **kwargs)


def __getattr__(name):
    if name == "DeepSpeedConfig":
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

        return DeepSpeedConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def add_config_arguments(parser):
    """Attach the --deepspeed / --deepspeed_config argparse flags."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for argument parsing)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed JSON config file")
    return parser
