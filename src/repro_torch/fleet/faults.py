"""Fabric failure model for the fleet planner (DELTA-Failsafe).

Two pieces live here:

`FabricHealth` is the planner's book of record for what is broken *right
now*: per-pod-pair link degradation fractions and dark OCS planes.  Its
`mask()` is the (P, P) capacity-availability factor threaded through the
degraded-mode DES (`TorchDES.makespan(..., mask=...)`): 1.0 means a healthy
pair, 0.25 means three of four planes serving that pair are dark, 0.0 a
fabric partition.  A dark plane multiplies *every* pair uniformly — a plane
carries 1/num_planes of each logical circuit, so losing it is a uniform
capacity haircut, which is also exactly what a staggered plane
reconfiguration looks like (ROADMAP "parallel OCS planes").

`FaultInjector` turns a seed into a reproducible *fault trace*: a list of
plain dicts (`{"step": ..., "kind": ..., ...}`) in the trace format the
reference's fleet layer (via `to_fleet_events`) and its training-loop
failure model (`FailureInjector.from_trace`) both consume, so chaos tests
and a step-level injector share one seeded failure model instead of two
disconnected ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

TRACE_KINDS = ("link_failure", "link_recovery", "port_failure",
               "port_recovery", "plane_failure", "plane_recovery",
               "step_failure")


@dataclass
class FabricHealth:
    """Current fabric damage: per-pair link fractions and dark planes."""

    num_pods: int
    num_planes: int = 4
    dark_planes: set[int] = field(default_factory=set)
    link_frac: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.link_frac is None:
            self.link_frac = np.ones((self.num_pods, self.num_pods))
        else:
            self.link_frac = np.asarray(self.link_frac, dtype=np.float64)

    # ------------------------------------------------------------- events
    def fail_link(self, pair: tuple[int, int], fraction: float = 1.0) -> None:
        """Degrade a pod pair: `fraction` of its circuit capacity is lost
        (cumulative — two 0.5 failures kill the pair)."""
        i, j = int(pair[0]), int(pair[1])
        frac = max(0.0, float(self.link_frac[i, j]) - float(fraction))
        self.link_frac[i, j] = self.link_frac[j, i] = frac

    def recover_link(self, pair: tuple[int, int]) -> None:
        i, j = int(pair[0]), int(pair[1])
        self.link_frac[i, j] = self.link_frac[j, i] = 1.0

    def fail_plane(self, plane: int) -> None:
        self.dark_planes.add(int(plane))

    def recover_plane(self, plane: int) -> None:
        self.dark_planes.discard(int(plane))

    # ------------------------------------------------------------ queries
    @property
    def plane_factor(self) -> float:
        up = self.num_planes - len(self.dark_planes)
        return max(up, 0) / self.num_planes

    @property
    def healthy(self) -> bool:
        return not self.dark_planes and bool((self.link_frac >= 1.0).all())

    def mask(self) -> np.ndarray:
        """(P, P) per-pair capacity availability in [0, 1]."""
        return self.link_frac * self.plane_factor

    def local_mask(self, pods: Sequence[int]) -> np.ndarray:
        """Restrict the fleet mask to a tenant's local pod window."""
        idx = np.asarray(list(pods), dtype=np.int64)
        return self.mask()[np.ix_(idx, idx)]

    def degraded_pairs(self) -> list[tuple[int, int]]:
        """Upper-triangle pod pairs with any capacity loss (fleet ids)."""
        m = self.mask()
        out = []
        for i in range(self.num_pods):
            for j in range(i + 1, self.num_pods):
                if m[i, j] < 1.0:
                    out.append((i, j))
        return out

    def availability(self) -> float:
        """Mean per-pair capacity availability in [0, 1] (off-diagonal
        mean of `mask()`): the one-number fabric health summary the
        snapshot round-trip property pins."""
        if self.num_pods < 2:
            return float(self.plane_factor)
        m = self.mask()
        iu, iv = np.triu_indices(self.num_pods, k=1)
        return float(m[iu, iv].mean())

    def affects(self, pods: Iterable[int]) -> bool:
        """Does the current damage touch a tenant spanning `pods`?"""
        if self.dark_planes:
            return True
        idx = np.asarray(list(pods), dtype=np.int64)
        return bool((self.link_frac[np.ix_(idx, idx)] < 1.0).any())

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        return {"num_pods": self.num_pods,
                "num_planes": self.num_planes,
                "dark_planes": sorted(self.dark_planes),
                "link_frac": self.link_frac.tolist()}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "FabricHealth":
        return cls(num_pods=snap["num_pods"],
                   num_planes=snap["num_planes"],
                   dark_planes=set(snap["dark_planes"]),
                   link_frac=np.asarray(snap["link_frac"]))


class FaultInjector:
    """Seeded generator of reproducible fault traces.

    A trace is a list of plain dicts, one per fault, each carrying
    `step` (monotone event index), `kind` (one of TRACE_KINDS) and the
    kind's parameters.  Transient *flaps* are emitted as a failure
    immediately followed by its recovery at the next step.
    """

    def __init__(self, num_pods: int, num_planes: int = 4, *, seed: int = 0,
                 link_rate: float = 0.5, port_rate: float = 0.25,
                 plane_rate: float = 0.15, flap_rate: float = 0.3,
                 max_fraction: float = 1.0, max_ports: int = 4):
        self.num_pods = int(num_pods)
        self.num_planes = int(num_planes)
        self.rng = np.random.default_rng(seed)
        self.rates = {"link": link_rate, "port": port_rate,
                      "plane": plane_rate}
        self.flap_rate = float(flap_rate)
        self.max_fraction = float(max_fraction)
        self.max_ports = int(max_ports)
        # planes currently dark *within the generated trace*: a second
        # plane_failure for an already-dark plane would make its matching
        # plane_recovery ambiguous, so draws exclude them
        self._dark: set[int] = set()

    def _one(self, step: int) -> list[dict]:
        kinds = list(self.rates)
        probs = np.asarray([self.rates[k] for k in kinds], dtype=np.float64)
        probs /= probs.sum()
        kind = kinds[int(self.rng.choice(len(kinds), p=probs))]
        flap = bool(self.rng.random() < self.flap_rate)
        if kind == "plane" and len(self._dark) >= self.num_planes:
            kind = "link"   # every plane is already dark; keep the trace
        if kind == "link":
            i = int(self.rng.integers(self.num_pods))
            j = int(self.rng.integers(self.num_pods - 1))
            j = j if j < i else j + 1
            frac = float(self.rng.uniform(0.25, self.max_fraction))
            ev = {"step": step, "kind": "link_failure",
                  "pair": (min(i, j), max(i, j)), "fraction": round(frac, 3)}
            rec = {"kind": "link_recovery", "pair": ev["pair"]}
        elif kind == "port":
            pod = int(self.rng.integers(self.num_pods))
            count = int(self.rng.integers(1, self.max_ports + 1))
            ev = {"step": step, "kind": "port_failure",
                  "pod": pod, "count": count}
            rec = {"kind": "port_recovery", "pod": pod, "count": count}
        else:
            # collision-free draw: uniform over the planes still lit
            healthy = sorted(set(range(self.num_planes)) - self._dark)
            plane = int(healthy[int(self.rng.integers(len(healthy)))])
            ev = {"step": step, "kind": "plane_failure", "plane": plane}
            rec = {"kind": "plane_recovery", "plane": plane}
            self._dark.add(plane)
            if flap:
                self._dark.discard(plane)   # its recovery is in the trace
        if flap:
            return [ev, {"step": step + 1, **rec}]
        return [ev]

    def trace(self, length: int) -> list[dict]:
        """Generate `length` fault events (flap recoveries included)."""
        out: list[dict] = []
        self._dark = set()   # each trace() restarts from a lit fabric
        step = 0
        while len(out) < length:
            events = self._one(step)
            out.extend(events)
            step = out[-1]["step"] + 1
        return out[:length]


def step_failure_trace(fail_at: Iterable[int]) -> list[dict]:
    """Wrap training-step failure indices in the shared trace format."""
    return [{"step": int(s), "kind": "step_failure"} for s in sorted(
        set(int(s) for s in fail_at))]
