"""Prefix-affine, depth-balanced routing across scheduler replicas
(counterpart of ``deepspeed_tpu/serving/router.py``, the whole module).

One scheduler replica holds one prefix cache, so WHERE a request lands
decides whether its shared prefix is warm: hashing by the prompt's
leading block sends all requests of one tenant/system-prompt to the
same replica (cache affinity), while pure hashing lets a hot prefix
overload its home replica. ``PrefixRouter`` does the standard
compromise — hash-affine with bounded spill: the hashed home replica
wins unless its reported queue depth exceeds the cluster minimum by
more than ``spill_slack``, in which case the request goes to the
shallowest queue (losing the warm prefix but bounding tail latency).

The router is process-topology-agnostic: it sees only prompts, a depth
vector, and (optionally) a liveness mask from ``fleet.FleetHealth``.
``chip_smoke.py``'s ``frontdoor`` phase drives real scheduler replicas in
separate processes over pipes; unit tests drive it with synthetic depths.
``home`` is the crc32 of the leading block's ``repr`` as in JAX, so both
packages place a prompt on the same replica.
"""

import zlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

# Replica roles for disaggregated serving (serving/disagg.py): a
# ``prefill`` replica runs chunked prompt prefills and hands the KV off;
# a ``decode`` replica runs the continuous-batching token loop. The
# router only ever places DECODE traffic, so role-aware call sites fold
# prefill replicas out of the candidate set (route_trace below;
# FleetCoordinator keeps pool-local sub-routers).
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


class NoLiveReplicasError(RuntimeError):
    """Every replica in the fleet is down — nothing can take traffic."""


class PrefixRouter:
    def __init__(self, n_replicas: int, align: int = 64,
                 spill_slack: int = 2):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if spill_slack < 0:
            raise ValueError(f"spill_slack must be >= 0, got {spill_slack}")
        self.n_replicas = int(n_replicas)
        self.align = int(align)
        self.spill_slack = int(spill_slack)
        self.spills = 0
        self.affine = 0
        self.failovers = 0

    def home(self, prompt: Sequence[int]) -> int:
        """The hash-affine replica for this prompt's leading block."""
        head = tuple(int(t) for t in prompt[:self.align])
        digest = zlib.crc32(repr(head).encode())
        return digest % self.n_replicas

    def route(self, prompt: Sequence[int], depths: Sequence[int],
              live: Optional[Sequence[bool]] = None) -> Tuple[int, str]:
        """(replica index, 'affine'|'spill'|'failover') given reported
        queue depths and an optional liveness mask.

        Only live replicas are candidates — for the home AND for spills
        (routing to a dead replica loses the request outright). The home
        mapping itself stays a pure hash: when a down replica recovers,
        its mask bit flips back and every affine prompt returns to it
        with no rebalancing step (re-affinity is free).
        """
        if len(depths) != self.n_replicas:
            raise ValueError(
                f"got {len(depths)} depths for {self.n_replicas} replicas")
        if live is not None:
            live = [bool(x) for x in live]
            if len(live) != self.n_replicas:
                raise ValueError(
                    f"got {len(live)} live flags for "
                    f"{self.n_replicas} replicas")
            if not any(live):
                raise NoLiveReplicasError(
                    f"all {self.n_replicas} replicas are down")
        pref = self.home(prompt)
        candidates = [i for i in range(self.n_replicas)
                      if live is None or live[i]]
        if live is not None and not live[pref]:
            # home is dead: deterministic hand-off to the shallowest
            # survivor (ties to the lowest index)
            self.failovers += 1
            return min(candidates,
                       key=lambda i: (depths[i], i)), "failover"
        floor = min(depths[i] for i in candidates)
        if depths[pref] <= floor + self.spill_slack:
            self.affine += 1
            return pref, "affine"
        self.spills += 1
        # ties break to the lowest index — deterministic for tests
        return min(candidates, key=lambda i: (depths[i], i)), "spill"

    def stats(self) -> dict:
        total = self.affine + self.spills + self.failovers
        return {"affine": self.affine, "spills": self.spills,
                "failovers": self.failovers,
                "spill_rate": (self.spills / total) if total else 0.0}


def route_trace(router: PrefixRouter, prompts: List[Sequence[int]],
                costs: Sequence[int] = None,
                live: Union[Sequence[bool],
                            Callable[[int], Sequence[bool]], None] = None,
                roles: Optional[Sequence[str]] = None) -> List[int]:
    """Assign a whole trace against simulated depths (each routed request
    deepens its replica by its cost; default 1). Used by the benches to
    report affinity/spill/failover rates without spawning processes.

    The simulation used to silently skip ``route()``'s liveness and role
    machinery, so the failover branch was untestable offline:

    * ``live`` — a fixed mask, or a callable ``live(step) -> mask`` to
      script an outage mid-trace (replica dies at step 40, recovers at
      80). Dead replicas take nothing; ``router.failovers`` counts the
      requests whose hash home was down.
    * ``roles`` — per-replica :data:`ROLE_PREFILL`/:data:`ROLE_DECODE`.
      This trace is DECODE traffic, so prefill replicas are folded out
      of the candidate set exactly as a role-aware front door would
      (they still occupy their global indices — placement indices stay
      comparable with the fleet's).
    """
    depths = [0] * router.n_replicas
    role_ok = None
    if roles is not None:
        if len(roles) != router.n_replicas:
            raise ValueError(
                f"got {len(roles)} roles for {router.n_replicas} replicas")
        bad = set(roles) - {ROLE_PREFILL, ROLE_DECODE}
        if bad:
            raise ValueError(f"unknown replica roles {sorted(bad)}; "
                             f"choose from ('{ROLE_PREFILL}', "
                             f"'{ROLE_DECODE}')")
        role_ok = [r == ROLE_DECODE for r in roles]
        if not any(role_ok):
            raise NoLiveReplicasError(
                "every replica is a prefill replica — decode traffic "
                "has nowhere to land")
    out = []
    for i, p in enumerate(prompts):
        mask = live(i) if callable(live) else live
        if mask is not None:
            mask = [bool(x) for x in mask]
        if role_ok is not None:
            base = mask if mask is not None \
                else [True] * router.n_replicas
            mask = [a and b for a, b in zip(base, role_ok)]
        r, _ = router.route(p, depths, live=mask)
        depths[r] += 1 if costs is None else int(costs[i])
        out.append(r)
    return out
