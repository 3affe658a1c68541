"""Captured steps: the port's counterpart of the JAX engines' jit caches
(``deepspeed_tpu/runtime/engine.py``: ``_build_train_step`` :1379,
``_build_fwd_bwd`` :1273 and ``_build_apply`` :1323; the inference
engine's ``_decode_k_fn``, ``deepspeed_tpu/inference/engine.py:650-680``).

A step is a function of tensors only: it reads nothing back to the host,
takes no Python scalar that changes from step to step, and keeps no
allocation past its return other than its outputs. ``CompiledStep`` runs it
in one of two ways. On the CPU it calls the function. On a CUDA card it
runs the first ``warmup`` calls of each input signature as they are (real
steps, on a side stream), then captures the function once for that
signature with ``torch.cuda.graph`` and replays the graph from then on, as
``jax.jit`` compiles once per input shapes. A replay copies the inputs into
the graph's static input buffers, replays, and returns fresh copies of the
graph's static outputs (the next replay overwrites those). A capture or
replay error raises: there is no eager fallback on the card.

Kernel launch counts: the kernel wrappers count their launches on the host,
and a replay calls no wrapper. So each graph records the launches its
capture saw (and takes them back from the counters: a capture runs
nothing) and adds them to the counters once per replay. The comms logger's
records of the collectives (``comm/logging.py``) are kept the same way.

Collectives: a step may hold NCCL collectives (the ZeRO exchanges). Their
communicators are made before any capture (``comm.warm_up``, and the
warm-up calls run every collective of the step on the side stream that
captures), and a graph is captured with ``capture_error_mode=
"thread_local"``: ProcessGroupNCCL's watchdog thread queries CUDA events
while the capture runs, which the default "global" mode would count as an
illegal call and so invalidate the capture.

Lifetimes: a graph holds raw device pointers. What a wrapper makes or looks
up during a capture and a replay later reads (block-sparse index tables,
B4's pointer table) goes to ``hold``, and the graph keeps a reference to it
for as long as the graph lives. Work that can only be done once the capture
has ended (filling a buffer whose address the capture recorded) goes to
``after_capture``.
"""

import collections
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.comm.logging import comms_logger

_capture: Optional["_CaptureState"] = None


class _CaptureState:
    def __init__(self):
        self.held = []
        self.after = []


def capturing() -> bool:
    """True while a ``CompiledStep`` captures a graph."""
    return _capture is not None


def hold(obj) -> None:
    """Keep ``obj`` alive for as long as the graph being captured lives
    (no-op outside a capture)."""
    if _capture is not None:
        _capture.held.append(obj)


def after_capture(fn: Callable[[], Any]) -> None:
    """Run ``fn`` once the graph being captured is complete, or now outside
    a capture."""
    if _capture is not None:
        _capture.after.append(fn)
    else:
        fn()


def _counters():
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam

    return {"flash_attention_fwd": (fa, "launches"),
            "flash_attention_bwd_dq": (fa, "launches_dq"),
            "flash_attention_bwd_dkv": (fa, "launches_dkv"),
            "flash_attention_fwd_segment": (fa, "launches_segment"),
            "flash_attention_bwd_dq_segment": (fa, "launches_dq_segment"),
            "flash_attention_bwd_dkv_segment": (fa, "launches_dkv_segment"),
            "fused_adamw": (fadam, "launches"),
            "block_sparse_fwd": (bsa, "launches_sparse_fwd"),
            "block_sparse_dq": (bsa, "launches_sparse_dq"),
            "block_sparse_dkv": (bsa, "launches_sparse_dkv")}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by kernel name (replays included); the
    ``_segment`` entries count the flash kernels' segment-variant launches
    among their totals."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _add_launch_counts(counts: Dict[str, int], sign: int = 1) -> None:
    for name, (mod, attr) in _counters().items():
        setattr(mod, attr, getattr(mod, attr) + sign * counts.get(name, 0))


def _map(fn, out):
    if isinstance(out, (tuple, list)):
        return type(out)(_map(fn, x) for x in out)
    return fn(out) if torch.is_tensor(out) else out


def _signature(inputs: Dict[str, torch.Tensor]):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))


class _Graph:
    def __init__(self, graph, inputs, outputs, launches, held, comms=None):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.held = held
        self.comms = comms or {}
        self.replays = 0

    def replay(self, inputs: Dict[str, torch.Tensor]):
        for key, x in inputs.items():
            self.inputs[key].copy_(x, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        _add_launch_counts(self.launches)
        comms_logger.add(self.comms)
        return _map(torch.clone, self.outputs)


class CompiledStep:
    """``fn(*static, **inputs)`` run directly on the CPU, and on a card
    warmed up, captured once per (``static``, input shapes and dtypes) and
    replayed. ``static`` are hashable Python values the function is
    specialised on (part of the key, baked into the graph); ``inputs`` are
    tensors on the step's device. At most ``max_graphs`` graphs are kept,
    least recently used first out; they share one memory pool (``pool``,
    or one of their own), which is safe because the graphs replay one at a
    time on one stream and their outputs are copied out at once.
    ``generators`` are the CUDA generators the function draws from,
    registered with every graph so that each replay advances them."""

    def __init__(self, fn: Callable, device, *, warmup: int = 2,
                 max_graphs: int = 8, pool=None,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.warmup = warmup
        self.max_graphs = max_graphs
        self.generators = tuple(generators)
        self._pool = pool
        self._stream = None
        self._graphs: "collections.OrderedDict[Any, _Graph]" = \
            collections.OrderedDict()
        self._warm: Dict[Any, int] = {}

    @property
    def graphs(self) -> Dict[Any, _Graph]:
        return self._graphs

    def eager(self, inputs: Dict[str, torch.Tensor], *static):
        """The step function itself, uncaptured (a reference to hold the
        graphs against)."""
        return self.fn(*static, **inputs)

    def __call__(self, inputs: Dict[str, torch.Tensor], *static):
        if self.device.type != "cuda":
            return self.fn(*static, **inputs)
        key = (static, _signature(inputs))
        graph = self._graphs.get(key)
        if graph is None:
            warm = self._warm.get(key, 0)
            if warm < self.warmup:
                self._warm[key] = warm + 1
                return self._on_side_stream(
                    lambda: self.fn(*static, **inputs))
            graph = self._capture(key, inputs, static)
        else:
            self._graphs.move_to_end(key)
        return graph.replay(inputs)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _on_side_stream(self, fn):
        """A warm-up call: the capture stream's first use of cuBLAS and the
        kernels happens outside the capture."""
        stream, current = self._side_stream(), torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def _capture(self, key, inputs, static) -> _Graph:
        global _capture
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_in = {k: v.clone() for k, v in inputs.items()}
        # the capture draws from the graphs' own pool, never from the blocks
        # the warm-up calls left cached: release those, or the card holds
        # the step's transients twice (GPT-2 6.7B at ZeRO stage 2 on 4
        # cards: a 57.9 GB peak over 39.9 GB of state, 80 GB per card)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        comms_before = comms_logger.snapshot()
        state = _CaptureState()
        _capture = state
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*static, **static_in)
        finally:
            _capture = None
            seen = {name: n - before[name]
                    for name, n in launch_counts().items()}
            _add_launch_counts(seen, sign=-1)
            comms = comms_logger.since(comms_before)
            comms_logger.add(comms, sign=-1)
        for fn in state.after:
            fn()
        entry = _Graph(graph, static_in, outputs, seen, state.held, comms)
        self._graphs[key] = entry
        while len(self._graphs) > self.max_graphs:
            _, old = self._graphs.popitem(last=False)
            old.graph.reset()
        return entry
