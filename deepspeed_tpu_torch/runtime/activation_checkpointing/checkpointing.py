"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``, itself
the JAX form of DeepSpeed's ``runtime/activation_checkpointing/
checkpointing.py``).

The JAX module maps everything onto ``jax.checkpoint(fn, policy=...)``;
this one maps it onto ``torch.utils.checkpoint`` (non-reentrant):

* recompute in the backward -> ``torch.utils.checkpoint.checkpoint``;
* a policy -> a selective-checkpoint policy
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``) that
  saves the outputs of the dispatcher ops it names. The policies keep the
  names of ``jax.checkpoint_policies``: ``everything_saveable`` (no
  recomputation), ``nothing_saveable`` (full recomputation),
  ``dots_with_no_batch_dims_saveable`` (``aten.mm``/``aten.addmm``: the
  parameter products), ``dots_saveable`` (also the batched products,
  ``aten.bmm``), ``save_only_these_names`` and ``save_from_both_policies``.
  A name tags the outputs of one op, as ``checkpoint_name`` tags a value in
  JAX: the flash forward (``deepspeed_tpu_torch::flash_fwd``) carries
  ``attn_out`` and ``attn_lse`` (``ops/cuda/flash_attention.py``);
* ``partition_activations``, ``contiguous_memory_optimization`` and
  ``synchronize_checkpoint_boundary`` are accepted and inert, as in JAX
  (one card holds every activation); ``cpu_checkpointing`` is an offload
  and is refused (ROADMAP A.10);
* the reference's RNG-state stashing -> the random draws a checkpointed
  call makes through ``bernoulli_mask`` are recorded in its forward and
  handed back, in order, in its recompute, so the recompute sees the
  forward's dropout masks without reading or restoring any generator state
  (which a captured CUDA step may not do). A draw inside a checkpoint that
  is itself nested in another is not supported (no model nests them).
  Under data parallelism each mask is drawn over the global micro batch
  and the rank keeps its rows (``GlobalBatchDraws``): what is recorded and
  handed back is that slice;
* the Megatron RNG-state tracker -> ``RNGStateTracker`` over named
  ``torch.Generator``s.

``configure()`` / ``is_configured()`` / ``checkpoint()`` keep the module-level
API of the reference.
"""

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint as _tuc

_CONFIG = None
_LOCK = threading.Lock()

# -- policies ---------------------------------------------------------------
# op name -> the names its outputs carry (the counterpart of checkpoint_name)
_OUTPUT_NAMES = {}
_NO_BATCH_DOTS = ("aten::mm", "aten::addmm")
_BATCH_DOTS = ("aten::bmm", "aten::baddbmm")


def name_op_outputs(op_name: str, *names: str) -> None:
    """Tag every output of the dispatcher op ``op_name`` (``"ns::op"``) with
    ``names``, for ``save_only_these_names``."""
    _OUTPUT_NAMES[op_name] = frozenset(names)


def _op_name(func) -> str:
    name = getattr(func, "name", None)
    return name() if callable(name) else str(func)


def everything_saveable(ctx, func, *args, **kwargs) -> bool:
    return True


def nothing_saveable(ctx, func, *args, **kwargs) -> bool:
    return False


def dots_with_no_batch_dims_saveable(ctx, func, *args, **kwargs) -> bool:
    return _op_name(func) in _NO_BATCH_DOTS


def dots_saveable(ctx, func, *args, **kwargs) -> bool:
    return _op_name(func) in _NO_BATCH_DOTS + _BATCH_DOTS


def save_only_these_names(*names: str) -> Callable:
    wanted = frozenset(names)

    def policy(ctx, func, *args, **kwargs):
        return bool(_OUTPUT_NAMES.get(_op_name(func), frozenset()) & wanted)

    return policy


def save_from_both_policies(a: Callable, b: Callable) -> Callable:
    def policy(ctx, func, *args, **kwargs):
        return (a(ctx, func, *args, **kwargs)
                or b(ctx, func, *args, **kwargs))

    return policy


def _selective(policy: Callable) -> Callable:
    """A policy as ``create_selective_checkpoint_contexts`` takes it."""
    save = _tuc.CheckpointPolicy.MUST_SAVE
    recompute = _tuc.CheckpointPolicy.PREFER_RECOMPUTE

    def sac_policy(ctx, func, *args, **kwargs):
        return save if policy(ctx, func, *args, **kwargs) else recompute

    return sac_policy


def policy_from_config(ac_config=None, remat: str = "full"):
    """The policy of a config block and ``tpu.remat``: ``none`` (save
    everything: no recomputation), ``full`` (save nothing) or
    ``selective`` (save the parameter products, recompute the rest)."""
    if ac_config is not None and getattr(ac_config, "cpu_checkpointing",
                                         False):
        raise NotImplementedError(
            "activation_checkpointing.cpu_checkpointing keeps the saved "
            "activations in host memory, an offload that is not ported to "
            "deepspeed_tpu_torch yet (ROADMAP A.10)")
    if remat == "none":
        return everything_saveable
    if remat == "selective":
        return dots_with_no_batch_dims_saveable
    if remat == "full":
        return nothing_saveable
    raise ValueError(f"unknown remat policy {remat!r}")


class _ActCkptState:
    def __init__(self, ac_config=None, remat: str = "full"):
        self.config = ac_config
        self.remat = remat
        self.policy = policy_from_config(ac_config, remat)
        self.profile = bool(getattr(ac_config, "profile", False))
        self.number_checkpoints = getattr(ac_config, "number_checkpoints",
                                          None)


def configure(deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              remat: str = "full"):
    """Module-level setup (the reference's ``configure``): an engine config
    carrying an ``activation_checkpointing`` block, or the reference's
    keyword flags. Returns the state."""
    global _CONFIG
    from deepspeed_tpu_torch.runtime.config import \
        ActivationCheckpointingConfig

    ac = None
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing", None)
    if ac is None:
        ac = ActivationCheckpointingConfig()
    if partition_activations is not None:
        ac.partition_activations = partition_activations
    if contiguous_checkpointing is not None:
        ac.contiguous_memory_optimization = contiguous_checkpointing
    if num_checkpoints is not None:
        ac.number_checkpoints = num_checkpoints
    if checkpoint_in_cpu is not None:
        ac.cpu_checkpointing = checkpoint_in_cpu
    if synchronize is not None:
        ac.synchronize_checkpoint_boundary = synchronize
    if profile is not None:
        ac.profile = profile
    state = _ActCkptState(ac, remat)
    with _LOCK:
        _CONFIG = state
    return state


def is_configured() -> bool:
    return _CONFIG is not None


def reset():
    global _CONFIG
    with _LOCK:
        _CONFIG = None


# -- the draws of a checkpointed call -----------------------------------------
_current = threading.local()


class _Draws:
    """The masks one checkpointed call drew, in order."""

    def __init__(self):
        self.masks = []
        self.replaying = False
        self.next = 0


@contextlib.contextmanager
def _drawing(draws: _Draws, replay: bool):
    """Record (forward) or hand back (recompute) ``draws``. The recompute
    runs on autograd's thread, so the current record is thread-local."""
    previous = getattr(_current, "draws", None)
    _current.draws = draws
    draws.replaying, draws.next = replay, 0
    try:
        yield
    finally:
        _current.draws = previous


@dataclasses.dataclass(frozen=True)
class GlobalBatchDraws:
    """A mask generator under data parallelism: ``bernoulli_mask`` draws
    each mask over the global micro batch (``world`` times the rank's rows
    on dim 0) from ``generator`` and keeps this rank's rows, ``rank * b ..
    (rank + 1) * b``, as the JAX engine draws one mask over the global
    batch. Every rank draws alike, so the generators stay equal; draws that
    are not per row (the stochastic-depth gates, ``base_generator``) are
    equal on every rank."""

    generator: torch.Generator
    rank: int
    world: int


def base_generator(generator):
    """The ``torch.Generator`` behind a ``GlobalBatchDraws`` (or
    ``generator`` itself)."""
    return getattr(generator, "generator", generator)


def bernoulli_mask(shape, p: float, generator, device) -> torch.Tensor:
    """A ``bool`` tensor of ``shape`` whose entries are True with probability
    ``p``, drawn from ``generator`` (``jax.random.bernoulli``'s meaning; a
    ``GlobalBatchDraws`` draws the global batch's mask and keeps this
    rank's rows). Inside a checkpointed call the forward's draw is recorded
    and its recompute gets the same tensor back without drawing."""
    draws = getattr(_current, "draws", None)
    if draws is not None and draws.replaying:
        mask = draws.masks[draws.next]
        draws.next += 1
        return mask
    if isinstance(generator, GlobalBatchDraws):
        rows = shape[0]
        full = torch.empty((rows * generator.world, *shape[1:]),
                           dtype=torch.bool, device=device).bernoulli_(
            p, generator=generator.generator)
        # a copy of the rank's rows: the global draw is freed at once
        mask = full[generator.rank * rows:(generator.rank + 1) * rows].clone()
    else:
        mask = torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
            p, generator=generator)
    if draws is not None:
        draws.masks.append(mask)
    return mask


def _contexts(policy: Callable):
    """``context_fn`` for ``torch.utils.checkpoint``: the draw record, and
    the selective contexts unless the policy saves nothing."""
    draws = _Draws()
    forward, recompute = [_drawing(draws, False)], [_drawing(draws, True)]
    if policy is not nothing_saveable:
        f, r = _tuc.create_selective_checkpoint_contexts(_selective(policy))
        forward.append(f)
        recompute.append(r)
    return _Stack(forward), _Stack(recompute)


class _Stack:
    """Several context managers entered as one."""

    def __init__(self, managers):
        self.managers = managers
        self.stack = None

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        for m in self.managers:
            self.stack.enter_context(m)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def checkpoint(function: Callable, *args, policy=None, **kwargs) -> Any:
    """``function(*args, **kwargs)`` under recomputation (the reference's
    ``CheckpointFunction.apply``): the backward re-runs the forward, keeping
    what ``policy`` (default: the configured one) saves. The generators'
    states are not read: draws go through ``bernoulli_mask``."""
    state = _CONFIG or _ActCkptState()
    policy = policy if policy is not None else state.policy
    if policy is everything_saveable:
        return function(*args, **kwargs)
    return _tuc.checkpoint(function, *args, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=lambda: _contexts(policy), **kwargs)


def checkpoint_wrapper(function: Callable, policy=None) -> Callable:
    """Decorator form: a callable that runs ``function`` under
    ``checkpoint`` with the policy configured at call time."""

    def wrapped(*args, **kwargs):
        return checkpoint(function, *args, policy=policy, **kwargs)

    return wrapped


# the reference's CheckpointFunction is an autograd.Function; as in the JAX
# module, the wrapped callable is the whole mechanism here
CheckpointFunction = checkpoint_wrapper


# -- RNG tracker (the reference's Megatron CudaRNGStatesTracker) ---------------
class RNGStateTracker:
    """Named generator streams for porting Megatron-style code. ``fork``
    returns a new generator seeded from the named stream's next draw, so
    forks are reproducible from the streams' states, which ``get_states`` /
    ``set_states`` save and restore."""

    def __init__(self):
        self._gens = {}

    def add(self, name: str, seed_or_generator):
        """A stream from a seed (a CPU generator) or a generator given."""
        if name in self._gens:
            raise ValueError(f"rng state {name!r} already added")
        gen = seed_or_generator
        if isinstance(seed_or_generator, int):
            gen = torch.Generator().manual_seed(seed_or_generator)
        self._gens[name] = gen

    def get_states(self):
        return {name: (g.device, g.get_state()) for name, g in self._gens.items()}

    def set_states(self, states):
        self._gens = {}
        for name, (device, state) in states.items():
            gen = torch.Generator(device=device)
            gen.set_state(state)
            self._gens[name] = gen

    def fork(self, name: str = "model-parallel-rng") -> torch.Generator:
        """The next child stream of ``name``."""
        if name not in self._gens:
            raise KeyError(f"rng state {name!r} was never added")
        gen = self._gens[name]
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=gen.device))
        return torch.Generator(device=gen.device).manual_seed(seed)

    def reset(self):
        self._gens.clear()


_RNG_TRACKER = RNGStateTracker()


def get_rng_tracker() -> RNGStateTracker:
    return _RNG_TRACKER


# the model-parallel stream's offset from the seed (the JAX module folds
# 2718 + the tensor-parallel rank into its key)
MODEL_PARALLEL_SEED_OFFSET = 2718


def model_parallel_reconfigure(seed: int,
                               tp_rank: Optional[int] = None) -> None:
    """Seed the tracker (the reference's ``model_parallel_cuda_manual_seed``):
    ``default`` from ``seed`` everywhere, ``model-parallel-rng`` offset by
    the tensor-parallel rank."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("default", seed)
    _RNG_TRACKER.add("model-parallel-rng",
                     seed + MODEL_PARALLEL_SEED_OFFSET + (tp_rank or 0))
