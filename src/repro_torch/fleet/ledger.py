"""Double-entry OCS port ledger for multi-tenant pods (paper Sec. VI).

Every fleet pod owns a fixed number of physical OCS ports.  A tenant admitted
onto a pod span holds, per pod:

  entitled   fair-share ports (== its GPUs in the pod, paper Sec. V-A1)
  donated    entitled ports the tenant has returned to the shared pool
             (port-minimized plans free these, Fig. 9/10)
  granted    surplus ports received from the pool on top of its entitlement
  allocated  ports wired into the tenant's currently committed topology
  seized     entitled ports taken out of service by a hardware failure

`limits = entitled - seized - donated + granted` is the port budget the
planner may use (the `ClusterSpec.port_limits` of the tenant's local view).
With `failed` the per-pod count of dark physical ports,

      sum_t limits_t  +  pool  +  failed  ==  capacity    (per pod, exactly)

is the conservation equation `check()` enforces: ports never appear or
vanish, they only move between tenants, the pool and the failed set.  Per
tenant, `allocated + surplus == limits` with `surplus >= 0`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np


class LedgerError(RuntimeError):
    """An operation would violate port conservation."""


# default-argument sentinel for TenantAccount's book arrays: keeps the
# fields typed as real ndarrays while __post_init__ substitutes zeros
# shaped like `entitled`
_UNSET_BOOK: np.ndarray = np.empty(0, dtype=np.int64)


@dataclass
class TenantAccount:
    """Per-tenant port books, all arrays indexed by *fleet* pod id."""

    name: str
    entitled: np.ndarray
    donated: np.ndarray = field(default_factory=lambda: _UNSET_BOOK)
    granted: np.ndarray = field(default_factory=lambda: _UNSET_BOOK)
    allocated: np.ndarray = field(default_factory=lambda: _UNSET_BOOK)
    seized: np.ndarray = field(default_factory=lambda: _UNSET_BOOK)

    def __post_init__(self) -> None:
        self.entitled = np.asarray(self.entitled, dtype=np.int64)
        zeros = np.zeros_like(self.entitled)
        for f in ("donated", "granted", "allocated", "seized"):
            if getattr(self, f) is None or getattr(self, f) is _UNSET_BOOK:
                setattr(self, f, zeros.copy())

    @property
    def limits(self) -> np.ndarray:
        return self.entitled - self.seized - self.donated + self.granted

    @property
    def surplus(self) -> np.ndarray:
        return self.limits - self.allocated


class PortLedger:
    """Tracks per-pod port capacity, per-tenant allocations and surplus."""

    def __init__(self, capacity: Sequence[int]):
        self.capacity = np.asarray(capacity, dtype=np.int64)
        if (self.capacity < 0).any():
            raise LedgerError("negative pod capacity")
        self.num_pods = len(self.capacity)
        self.accounts: dict[str, TenantAccount] = {}
        # physical ports taken out of service by hardware failures
        self.failed = np.zeros_like(self.capacity)

    # ------------------------------------------------------------- queries
    def __contains__(self, name: str) -> bool:
        return name in self.accounts

    def account(self, name: str) -> TenantAccount:
        try:
            return self.accounts[name]
        except KeyError:
            raise LedgerError(f"unknown tenant {name!r}") from None

    def limits(self, name: str) -> np.ndarray:
        return self.account(name).limits

    def surplus(self, name: str) -> np.ndarray:
        return self.account(name).surplus

    def pool(self) -> np.ndarray:
        """Per-pod ports owned by no tenant (grantable)."""
        total = sum((a.limits for a in self.accounts.values()),
                    np.zeros_like(self.capacity))
        return self.capacity - self.failed - total

    def headroom(self) -> np.ndarray:
        """Per-pod ports free for *new entitlements*: donated ports stay
        reserved for their donor (withdrawable), so admission only sees
        capacity minus failed ports and everything entitled or granted."""
        total = sum((a.entitled - a.seized + a.granted
                     for a in self.accounts.values()),
                    np.zeros_like(self.capacity))
        return self.capacity - self.failed - total

    # ---------------------------------------------------------- lifecycle
    def admit(self, name: str, entitled: Sequence[int]) -> TenantAccount:
        if name in self.accounts:
            raise LedgerError(f"tenant {name!r} already admitted")
        ent = np.asarray(entitled, dtype=np.int64)
        if ent.shape != self.capacity.shape or (ent < 0).any():
            raise LedgerError(f"bad entitlement shape/sign for {name!r}")
        if (ent > self.pool()).any():
            raise LedgerError(
                f"admitting {name!r} needs {ent.tolist()} ports but the "
                f"pool has {self.pool().tolist()}")
        acct = TenantAccount(name=name, entitled=ent)
        self.accounts[name] = acct
        return acct

    def release(self, name: str) -> TenantAccount:
        """Remove a tenant; its limits return to the pool implicitly."""
        return self.accounts.pop(self.account(name).name)

    # ------------------------------------------------------------ postings
    def commit(self, name: str, allocated: Sequence[int]) -> None:
        """Record the ports wired by the tenant's committed topology."""
        acct = self.account(name)
        alloc = np.asarray(allocated, dtype=np.int64)
        if alloc.shape != self.capacity.shape or (alloc < 0).any():
            raise LedgerError(f"bad allocation shape/sign for {name!r}")
        if (alloc > acct.limits).any():
            raise LedgerError(
                f"{name!r} would wire {alloc.tolist()} ports with limits "
                f"{acct.limits.tolist()}")
        acct.allocated = alloc

    def donate(self, name: str, amount: Sequence[int] | None = None
               ) -> np.ndarray:
        """Move (part of) a tenant's surplus entitlement into the pool."""
        acct = self.account(name)
        amt = acct.surplus.copy() if amount is None \
            else np.asarray(amount, dtype=np.int64)
        # donations come from the (surviving) entitlement, never from grants
        amt = np.minimum(amt, acct.entitled - acct.seized - acct.donated
                         - np.maximum(acct.allocated - acct.granted, 0))
        amt = np.maximum(amt, 0)
        if (amt > acct.surplus).any():
            raise LedgerError(f"{name!r} cannot donate more than surplus")
        acct.donated += amt
        return amt

    def withdraw_donation(self, name: str,
                          amount: Sequence[int] | None = None) -> np.ndarray:
        """Take donated ports back (traffic grew); limited by the pool."""
        acct = self.account(name)
        want = acct.donated.copy() if amount is None \
            else np.asarray(amount, dtype=np.int64)
        amt = np.minimum(np.minimum(want, acct.donated),
                         np.maximum(self.pool(), 0))
        acct.donated -= amt
        return amt

    def grant(self, name: str, amount: Sequence[int]) -> None:
        """Grant pool ports to a (bottlenecked) tenant."""
        acct = self.account(name)
        amt = np.asarray(amount, dtype=np.int64)
        if (amt < 0).any():
            raise LedgerError("negative grant")
        if (amt > self.pool()).any():
            raise LedgerError(
                f"granting {amt.tolist()} to {name!r} exceeds pool "
                f"{self.pool().tolist()}")
        acct.granted += amt

    def reclaim(self, name: str, amount: Sequence[int] | None = None
                ) -> np.ndarray:
        """Return (part of) a tenant's grants to the pool."""
        acct = self.account(name)
        amt = acct.granted.copy() if amount is None \
            else np.minimum(np.asarray(amount, dtype=np.int64), acct.granted)
        if (amt < 0).any():
            raise LedgerError("negative reclaim")
        if (acct.allocated > acct.limits - amt).any():
            raise LedgerError(
                f"reclaiming {amt.tolist()} from {name!r} would strand its "
                f"committed allocation; commit a smaller plan first")
        acct.granted -= amt
        return amt

    # ------------------------------------------------------------ failures
    def fail_ports(self, pod: int, count: int) -> list[str]:
        """Take `count` physical ports on `pod` out of service.

        Ports are consumed in escalation order: the free pool first (which
        includes donated reservations), then surplus grants pulled back from
        tenants, then surplus entitlement (recorded as `seized`), and only
        as a last resort ports wired into committed topologies.  Returns the
        names of *stranded* tenants — those whose committed allocation now
        exceeds their limits.  The caller must re-commit a smaller plan for
        each before the next `check()`.
        """
        pod, count = int(pod), int(count)
        if count < 0:
            raise LedgerError("negative failure count")
        count = min(count, int(self.capacity[pod] - self.failed[pod]))
        remaining = count
        stranded: list[str] = []

        def from_pool() -> int:
            take = min(remaining, max(int(self.pool()[pod]), 0))
            self.failed[pod] += take
            return remaining - take

        remaining = from_pool()
        # pull surplus grants back into the pool, then fail them there
        for name in sorted(self.accounts):
            if remaining <= 0:
                break
            acct = self.accounts[name]
            free = min(int(acct.granted[pod]), int(acct.surplus[pod]),
                       remaining)
            if free > 0:
                amt = np.zeros_like(self.capacity)
                amt[pod] = free
                self.reclaim(name, amt)
                remaining = from_pool()
        # seize surplus entitlement (no stranding yet)
        for name in sorted(self.accounts):
            if remaining <= 0:
                break
            acct = self.accounts[name]
            take = min(int(acct.surplus[pod]),
                       int(acct.entitled[pod] - acct.seized[pod]
                           - acct.donated[pod]), remaining)
            if take > 0:
                acct.seized[pod] += take
                self.failed[pod] += take
                remaining -= take
        # strand: seize entitlement wired into committed topologies
        for name in sorted(self.accounts):
            if remaining <= 0:
                break
            acct = self.accounts[name]
            take = min(int(acct.entitled[pod] - acct.seized[pod]
                           - acct.donated[pod]), remaining)
            if take > 0:
                acct.seized[pod] += take
                self.failed[pod] += take
                remaining -= take
                stranded.append(name)
        # last resort: force-reclaim grants wired into topologies
        for name in sorted(self.accounts):
            if remaining <= 0:
                break
            acct = self.accounts[name]
            take = min(int(acct.granted[pod]), remaining)
            if take > 0:
                acct.granted[pod] -= take
                self.failed[pod] += take
                remaining -= take
                if name not in stranded:
                    stranded.append(name)
        if remaining > 0:  # pragma: no cover - count clamped above
            raise LedgerError(f"could not fail {remaining} ports on pod {pod}")
        return stranded

    def restore_ports(self, pod: int, count: int) -> int:
        """Bring failed ports on `pod` back: seized entitlements are made
        whole first (deterministic tenant order), the rest returns to the
        pool.  Returns the number of ports actually restored."""
        pod, count = int(pod), int(count)
        if count < 0:
            raise LedgerError("negative restore count")
        count = min(count, int(self.failed[pod]))
        remaining = count
        for name in sorted(self.accounts):
            if remaining <= 0:
                break
            acct = self.accounts[name]
            take = min(int(acct.seized[pod]), remaining)
            if take > 0:
                acct.seized[pod] -= take
                self.failed[pod] -= take
                remaining -= take
        self.failed[pod] -= remaining
        return count

    # ---------------------------------------------------------- invariants
    def check(self) -> None:
        """Raise LedgerError unless port conservation holds exactly."""
        if (self.failed < 0).any() or (self.failed > self.capacity).any():
            raise LedgerError(f"failed ports out of range: "
                              f"{self.failed.tolist()}")
        total = np.zeros_like(self.capacity)
        for acct in self.accounts.values():
            for f in ("entitled", "donated", "granted", "allocated",
                      "seized"):
                if (getattr(acct, f) < 0).any():
                    raise LedgerError(f"{acct.name!r}.{f} went negative")
            if (acct.seized > acct.entitled).any():
                raise LedgerError(f"{acct.name!r} seized beyond entitlement")
            if (acct.donated > acct.entitled - acct.seized).any():
                raise LedgerError(f"{acct.name!r} donated beyond entitlement")
            if (acct.allocated > acct.limits).any():
                raise LedgerError(f"{acct.name!r} allocated beyond limits")
            if (acct.allocated + acct.surplus != acct.limits).any():
                raise LedgerError(f"{acct.name!r} books don't balance")
            total += acct.limits
        pool = self.capacity - self.failed - total
        if (pool < 0).any():
            raise LedgerError(
                f"pool went negative: {pool.tolist()} (capacity "
                f"{self.capacity.tolist()}, failed {self.failed.tolist()})")
        if (total + pool + self.failed != self.capacity).any():
            raise LedgerError("conservation equation violated")

    def snapshot(self) -> dict:
        """JSON-friendly state dump (benchmarks / debugging)."""
        return {
            "capacity": self.capacity.tolist(),
            "pool": self.pool().tolist(),
            "failed": self.failed.tolist(),
            "tenants": {
                n: {"entitled": a.entitled.tolist(),
                    "donated": a.donated.tolist(),
                    "granted": a.granted.tolist(),
                    "allocated": a.allocated.tolist(),
                    "seized": a.seized.tolist(),
                    "surplus": a.surplus.tolist()}
                for n, a in self.accounts.items()},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PortLedger":
        """Rebuild a ledger from a `snapshot()` dict (crash recovery)."""
        ledger = cls(snap["capacity"])
        ledger.failed = np.asarray(snap.get("failed",
                                            [0] * ledger.num_pods),
                                   dtype=np.int64)
        for name, books in snap["tenants"].items():
            ledger.accounts[name] = TenantAccount(
                name=name,
                entitled=books["entitled"],
                donated=np.asarray(books["donated"], dtype=np.int64),
                granted=np.asarray(books["granted"], dtype=np.int64),
                allocated=np.asarray(books["allocated"], dtype=np.int64),
                seized=np.asarray(books.get("seized",
                                            [0] * ledger.num_pods),
                                  dtype=np.int64))
        ledger.check()
        return ledger


def scatter(local: Sequence[int], pods: Iterable[int],
            num_pods: int) -> np.ndarray:
    """Expand a tenant-local per-pod vector onto fleet pod ids."""
    out = np.zeros(num_pods, dtype=np.int64)
    for value, pod in zip(local, pods):
        out[pod] = int(value)
    return out


def gather(fleet_vec: np.ndarray, pods: Iterable[int]) -> np.ndarray:
    """Restrict a fleet per-pod vector to a tenant's local pod order."""
    return np.asarray([int(fleet_vec[p]) for p in pods], dtype=np.int64)
