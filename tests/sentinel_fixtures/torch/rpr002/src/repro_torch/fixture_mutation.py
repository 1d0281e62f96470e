"""RPR002 fixture: caller-passed options mutation vs. the safe idioms."""
import dataclasses
from dataclasses import dataclass


@dataclass
class LaneOptions:
    device: str = "cuda"


def peek(opts: LaneOptions) -> str:
    return opts.device  # keeps the field read (out of RPR001's scope)


def bad(opts: LaneOptions) -> None:
    opts.device = "cpu"  # TP: caller's object mutated


def bad_fallback(opts=None) -> None:
    opts = opts or LaneOptions()
    opts.device = "cpu"  # TP: `or` fallback still aliases the caller's


def good(opts: LaneOptions) -> None:
    opts = dataclasses.replace(opts, device="cpu")
    opts.device = "meta"  # near miss: mutation of a local copy


def _private(opts: LaneOptions) -> None:
    opts.device = "cpu"  # near miss: private helpers own their arguments
