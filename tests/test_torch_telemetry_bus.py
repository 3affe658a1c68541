"""The port's telemetry bus against the JAX package's.

One scripted sequence runs through a ``TelemetryBus`` of each package:
subscribe (twice, once a duplicate) and unsubscribe, a recorder whose bound
method is held weakly and dies, a subscriber that raises (called every
time, warned about once), ``counts``, ``set_rank`` and ``reset``. The
events, what each subscriber saw, the warnings and the counts must be the
same, event for event, apart from the ``ts`` stamp.
"""

import gc

import pytest

import deepspeed_tpu.telemetry.bus as jbus
import deepspeed_tpu.utils.logging as jlogging
import deepspeed_tpu_torch.telemetry.bus as tbus
import deepspeed_tpu_torch.utils.logging as tlogging
from deepspeed_tpu_torch import telemetry


def _strip(events):
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events]


class _Recorder:
    def __init__(self):
        self.seen = []

    def on_event(self, ev):
        self.seen.append(ev)


def _script(mod, logger, monkeypatch):
    warned = []
    monkeypatch.setattr(logger, "warning",
                        lambda msg, *args: warned.append(args[-1]))
    bus = mod.TelemetryBus(rank=3)
    plain, raised = [], []
    rec = _Recorder()

    def fn(ev):
        plain.append(ev)

    def bad(ev):
        raised.append(ev["kind"])
        raise RuntimeError("subscriber fault")

    assert bus.subscribe(fn) is fn
    bus.subscribe(fn)                       # a duplicate is kept once
    bus.subscribe(rec.on_event)
    bus.subscribe(bad)
    bus.subscribe(plain.append)             # a builtin bound method: strong
    events = [
        bus.publish(mod.KIND_SERVE_ADMIT, request_id=1, lane=0,
                    prompt_len=7),
        bus.publish("custom.kind", step=5, severity="warning", x=1.5),
    ]
    seen = list(rec.seen)
    del rec
    gc.collect()                            # the weak bound method dies
    events.append(bus.publish(mod.KIND_SERVE_EVICT, request_id=1, tokens=3))
    bus.unsubscribe(fn)
    bus.unsubscribe(bad)
    bus.subscribe(bad)                      # warned about again: a new start
    events.append(bus.publish(mod.KIND_SERVE_ADMIT, request_id=2))
    counts = bus.counts()
    bus.set_rank(7)
    events.append(bus.publish(mod.KIND_RING_DECLINE, severity="warning",
                              reason="no ring"))
    bus.reset()
    events.append(bus.publish(mod.KIND_SERVE_DRAIN, phase="begin"))
    return {"events": _strip(events), "plain": _strip(plain),
            "recorder": _strip(seen), "raised": raised,
            "warned": [(type(e).__name__, str(e)) for e in warned],
            "counts": counts, "after_reset": bus.counts(),
            "rank": bus.rank, "subscribers": len(bus._subscribers)}


def test_scripted_sequence_matches_jax(monkeypatch):
    want = _script(jbus, jlogging.logger, monkeypatch)
    got = _script(tbus, tlogging.logger, monkeypatch)
    assert got == want
    assert got["warned"] == [("RuntimeError", "subscriber fault")] * 2
    assert got["raised"] == ["serve.admit", "custom.kind", "serve.evict",
                             "serve.admit", "ring.decline"]
    assert len(got["recorder"]) == 2 and got["subscribers"] == 0


def test_kinds_are_jax_kinds():
    kinds = {k: v for k, v in vars(jbus).items() if k.startswith("KIND_")}
    assert {k: v for k, v in vars(tbus).items()
            if k.startswith("KIND_")} == kinds
    assert len(kinds) == 33


@pytest.mark.parametrize("env", [{}, {"RANK": "5"},
                                 {"JAX_PROCESS_INDEX": "2", "RANK": "5"},
                                 {"DS_TPU_RANK": "4", "RANK": "x"}],
                         ids=["none", "rank", "jax_index", "ds_rank"])
def test_default_rank_reads_jax_variables(monkeypatch, env):
    for var in ("DS_TPU_RANK", "JAX_PROCESS_INDEX", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tbus._default_rank() == jbus._default_rank()
    assert tbus.TelemetryBus().rank == jbus.TelemetryBus().rank


def test_global_bus_and_publish():
    """The process-global bus and the one-line ``publish``; the package
    exports the bus alone."""
    assert telemetry.telemetry_bus is tbus.telemetry_bus
    assert telemetry.__all__ == ["TelemetryBus", "telemetry_bus", "publish"]
    got = []
    before = tbus.telemetry_bus.counts().get("serve.stats", 0)
    tbus.telemetry_bus.subscribe(got.append)
    try:
        ev = tbus.publish(tbus.KIND_SERVE_STATS, step=2, queue_depth=3)
    finally:
        tbus.telemetry_bus.unsubscribe(got.append)
    assert got == [ev]
    assert {k: v for k, v in ev.items() if k != "ts"} == {
        "kind": "serve.stats", "rank": tbus.telemetry_bus.rank,
        "severity": "info", "step": 2, "queue_depth": 3}
    assert tbus.telemetry_bus.counts()["serve.stats"] == before + 1
