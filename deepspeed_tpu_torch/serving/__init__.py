"""Serving front door (counterpart of ``deepspeed_tpu/serving/``):
shared-prefix KV cache, SLO admission, routing, the fleet, disaggregated
prefill.

Layers over ``inference/scheduler.py``'s continuous batching:

* :class:`PrefixCache` -- prefill a popular prompt prefix once, copy its KV
  cache into every admission that shares it (exact: keys are padded column
  prefixes, continuations never cross a ring block);
* :class:`SLOAdmissionController` -- telemetry-bus-driven load shedding
  that holds a p95 TTFT SLO with a bounded queue;
* :class:`PrefixRouter` -- hash-affine, depth-balanced placement across
  replicas;
* :mod:`fleet` -- replica health, request journaling, exact failover
  replay and graceful drain;
* :mod:`disagg` -- prefill workers handing their KV caches to a decode
  scheduler.

``build_serving`` is the config entry point, the serving analogue of
``deepspeed_tpu_torch.initialize(config=...)``.
"""

from typing import Any, Dict, Optional

from deepspeed_tpu_torch.inference.scheduler import (
    AdmissionRejected,
    ContinuousBatchingScheduler,
    DeadlineExceededError,
    DrainingError,
    QueueFullError,
    RequestShedError,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    ring_engaged
from deepspeed_tpu_torch.serving.admission import (
    AdmissionConfig,
    SLOAdmissionController,
)
from deepspeed_tpu_torch.serving.fleet import (
    DOWN,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    FleetCoordinator,
    FleetHealth,
    GracefulDrain,
    HealthConfig,
    JournalEntry,
    ReplicaDead,
    RequestJournal,
)
from deepspeed_tpu_torch.serving.disagg import (
    DisaggServer,
    KVHandoff,
    PrefillWorker,
    lane_kv_bytes,
)
from deepspeed_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    PrefixCacheConfig,
)
from deepspeed_tpu_torch.serving.router import (
    ROLE_DECODE,
    ROLE_PREFILL,
    NoLiveReplicasError,
    PrefixRouter,
    route_trace,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionRejected",
    "ContinuousBatchingScheduler",
    "DOWN",
    "DeadlineExceededError",
    "DisaggServer",
    "DrainingError",
    "FleetCoordinator",
    "FleetHealth",
    "GracefulDrain",
    "HEALTHY",
    "HealthConfig",
    "JournalEntry",
    "KVHandoff",
    "NoLiveReplicasError",
    "PrefixCache",
    "PrefixCacheConfig",
    "PrefixRouter",
    "PrefillWorker",
    "QueueFullError",
    "RECOVERING",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "ReplicaDead",
    "RequestJournal",
    "RequestShedError",
    "SLOAdmissionController",
    "SUSPECT",
    "build_serving",
    "lane_kv_bytes",
    "route_trace",
]


def _default_align(engine, prompt_bucket: Optional[int]) -> int:
    """Ring layout block when the model rings, else the prompt bucket —
    the boundaries admission prefill naturally produces."""
    mcfg = getattr(engine.module, "config", None)
    ring = ring_engaged(mcfg) if mcfg is not None else None
    if ring is not None:
        return ring[2]
    return prompt_bucket if prompt_bucket else 64


def build_serving(engine, config: Optional[Dict[str, Any]] = None,
                  reject_callback=None,
                  draft_engine=None) -> ContinuousBatchingScheduler:
    """Assemble the front door from one config dict::

        build_serving(engine, {
            "slots": 8,
            "prompt_bucket": 64,
            "temperature": 0.0,
            "max_pending": 256,
            "prefix_cache": {"promote_after": 2,
                             "budget_bytes": 512 << 20},
            "admission": {"slo_ttft_p95_s": 2.0, "window": 64},
            "journal": True,
            "spec_k": 4,   # with draft_engine=: speculative decoding
        })

    ``prefix_cache``/``admission``/``journal`` accept a knob dict,
    ``True`` (all defaults), or ``False``/absent (off). Unknown keys
    raise — a typo'd knob silently running with defaults is how SLOs
    get missed. ``draft_engine`` (parameter, not a config key — it is a
    live engine, not a knob) plus ``spec_k`` turn on exact-greedy
    speculative decoding in the scheduler.

    A tensor- or expert-parallel engine serves with the same contract:
    every rank calls ``build_serving`` with the same config, and rank 0 of
    the engine's tp x ep group decides (admission, the prefix cache, the
    tokens) while the others follow (``ContinuousBatchingScheduler``).
    """
    cfg = dict(config or {})
    slots = int(cfg.pop("slots", 8))
    prompt_bucket = cfg.pop("prompt_bucket", None)
    temperature = float(cfg.pop("temperature", 0.0))
    eos_token_id = cfg.pop("eos_token_id", None)
    max_pending = cfg.pop("max_pending", None)
    spec_k = int(cfg.pop("spec_k", 0))
    pc_cfg = cfg.pop("prefix_cache", False)
    adm_cfg = cfg.pop("admission", False)
    journal_cfg = cfg.pop("journal", False)
    if cfg:
        raise ValueError(f"unknown serving config keys: {sorted(cfg)}")

    prefix_cache = None
    if pc_cfg:
        knobs = dict(pc_cfg) if isinstance(pc_cfg, dict) else {}
        knobs.setdefault("align", _default_align(engine, prompt_bucket))
        prefix_cache = PrefixCache(PrefixCacheConfig(**knobs))

    admission = None
    if adm_cfg:
        knobs = dict(adm_cfg) if isinstance(adm_cfg, dict) else {}
        admission = SLOAdmissionController(AdmissionConfig(**knobs))

    journal = None
    if journal_cfg:
        knobs = dict(journal_cfg) if isinstance(journal_cfg, dict) else {}
        journal = RequestJournal(**knobs)

    return ContinuousBatchingScheduler(
        engine, slots=slots, prompt_bucket=prompt_bucket,
        temperature=temperature, eos_token_id=eos_token_id,
        max_pending=max_pending, prefix_cache=prefix_cache,
        admission_controller=admission, reject_callback=reject_callback,
        journal=journal, draft_engine=draft_engine, spec_k=spec_k)
