"""The device's profile over the traced window.

The traced window is a slice of the measured one, set by the traffic
file's `trace` (`TraceSlice`): whole fitness batches and the host's work
around them, not the whole window, because the profiler takes about 50 us
and 5 KB of host memory per device event to hand its trace over (a whole
window of 2-3 million events: two minutes and 13-15 GB).

torch.profiler's CUPTI trace of the card, read as raw events: the
profiler is started and stopped through `torch.autograd`'s own calls, so
no per-event Python objects are built beyond the device's events (a
window holds millions of kernels).  A marker kernel on an idle card at
either end of the window ties the device's clock to the host's
`perf_counter`, so that each idle gap can be put against what the host was
doing then.  The markers are found by name: a device event outside them
(none is expected) is left out of the window.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass

import numpy as np

MARK_CYCLES = 1_000_000     # the markers' length: ~0.5 ms at 2 GHz
MARKER = "spin_kernel"      # the kernel of `torch.cuda._sleep`


@dataclass
class DeviceProfile:
    window_s: float                   # host clock, marker to marker
    busy_s: float                     # union of the device's operations
    kernels: dict[str, float]         # device seconds by full name
    counts: dict[str, int]            # calls by full name
    gap_t0: np.ndarray                # idle gaps, start on perf_counter
    gap_s: np.ndarray                 # idle gaps, length
    events: int = 0
    read_s: float = 0.0               # stopping the profiler, reading it

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and calls of the kernels whose name holds
        `pattern`."""
        names = [k for k in self.kernels if pattern in k]
        return (sum(self.kernels[k] for k in names),
                sum(self.counts[k] for k in names))


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::",
                                                 "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    short = "".join(out).strip().split("::")[-1]
    return short or name[:64]


class DeviceTrace:
    """Start before the window, stop after it; `profile` then holds the
    window's device profile."""

    def __init__(self) -> None:
        self.profile: DeviceProfile | None = None

    def start(self) -> None:
        import torch
        from torch.autograd import profiler as ap
        self._prof = ap.profile(use_device="cuda", use_cpu=False,
                                use_kineto=True)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._h0 = time.perf_counter_ns()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> DeviceProfile:
        import torch
        torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = torch.autograd._disable_profiler()
        cuda = torch._C._autograd.DeviceType.CUDA
        ev = []
        for e in result.events():
            if e.device_type() == cuda:
                s = e.start_ns()
                ev.append((s, s + e.duration_ns(), e.name()))
        del result
        ev.sort()
        self.profile = summarize(ev, self._h0, h1)
        self.profile.read_s = time.perf_counter() - t
        return self.profile


class TraceSlice:
    """Opens `tracer` once `after` fitness batches of the window have
    returned (0: at the window's start) and closes it when `batches` more
    have, or at the window's end, whichever comes first.  `batch_done` is
    called as each batch returns, `close` when the window ends; both run
    on the thread that drives the program."""

    def __init__(self, tracer, after: int, batches: int) -> None:
        if after < 0 or batches < 1:
            raise ValueError(f"trace slice after {after}, batches {batches}")
        self.tracer, self.after, self.batches = tracer, after, batches
        self.seen = 0
        self.state = "waiting"          # -> "open" -> "closed"

    def open_now(self) -> None:
        if self.state == "waiting" and self.seen >= self.after:
            self.tracer.start()
            self.state = "open"

    def batch_done(self) -> None:
        self.seen += 1
        if self.state == "open" and self.seen >= self.after + self.batches:
            self.tracer.stop()
            self.state = "closed"
        self.open_now()

    def close(self):
        """The profile; raises where the window ended before the slice
        opened (too few batches for `after`)."""
        if self.state == "waiting":
            raise RuntimeError(f"the window ended after {self.seen} fitness "
                               f"batches, before the traced slice opened "
                               f"(after {self.after})")
        if self.state == "open":
            self.tracer.stop()
            self.state = "closed"
        return self.tracer.profile


def summarize(ev: list[tuple[int, int, str]], h0: int, h1: int,
              marker: str = MARKER) -> DeviceProfile:
    """The window between the two marker kernels (the first and the last
    device events whose name holds `marker`) from sorted (start_ns,
    end_ns, name) events."""
    marks = [i for i, e in enumerate(ev) if marker in e[2]]
    if len(marks) < 2:
        names = sorted({e[2][:48] for e in ev[:3] + ev[-3:]})
        raise RuntimeError(f"the device trace lacks its two marker kernels "
                           f"({len(ev)} device events, {len(marks)} "
                           f"markers; first and last named {names})")
    first, last = marks[0], marks[-1]
    offset = ev[first][0] - h0        # device ns - host perf_counter ns
    lo, hi = ev[first][1], ev[last][0]
    inner = ev[first + 1:last]
    kernels: dict[str, float] = {}
    counts: dict[str, int] = {}
    for s, e, name in inner:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
        counts[name] = counts.get(name, 0) + 1
    starts = np.array([max(s, lo) for s, _, _ in inner] or [lo],
                      dtype=np.int64)
    ends = np.array([min(e, hi) for _, e, _ in inner] or [lo],
                    dtype=np.int64)
    # union of the intervals: a new block starts where a start lies past
    # every end before it
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(starts), dtype=bool)
    new[1:] = starts[1:] > run_end[:-1]
    block_start = starts[new]
    block_end = np.maximum.reduceat(ends, np.nonzero(new)[0])
    busy = float(np.clip(block_end - block_start, 0, None).sum()) * 1e-9
    gap_lo = np.concatenate([[lo], block_end])
    gap_hi = np.concatenate([block_start, [hi]])
    keep = gap_hi > gap_lo
    gap_t0 = (gap_lo[keep] - offset) * 1e-9
    gap_s = (gap_hi[keep] - gap_lo[keep]) * 1e-9
    return DeviceProfile(window_s=(h1 - h0) * 1e-9, busy_s=busy,
                         kernels=kernels, counts=counts, gap_t0=gap_t0,
                         gap_s=gap_s, events=len(inner))


def idle_by_activity(prof: DeviceProfile,
                     spans: list[tuple[str, float, float]],
                     outside: str = "harness") -> dict[str, float]:
    """Idle seconds of the window by what the host was doing: each gap
    goes to the innermost of `spans` (name, t0, dur on perf_counter) that
    holds its midpoint, else to `outside`."""
    mid = prof.gap_t0 + 0.5 * prof.gap_s
    order = np.argsort(mid)
    mids = mid[order]
    names = [outside]
    label = np.zeros(len(mids), dtype=np.int64)
    # paint the longest spans first, so that inner spans win
    for name, t0, dur in sorted(spans, key=lambda s: -s[2]):
        if name not in names:
            names.append(name)
        a, b = np.searchsorted(mids, [t0, t0 + dur])
        label[a:b] = names.index(name)
    sums = np.bincount(label, weights=prof.gap_s[order],
                       minlength=len(names))
    return {n: float(v) for n, v in zip(names, sums) if v > 0}
