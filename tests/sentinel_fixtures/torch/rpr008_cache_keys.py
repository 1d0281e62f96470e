"""RPR008 fixture: cache keys that are not hashable statics."""
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

_ENGINE_CACHE = {}


class BucketKey(NamedTuple):
    n: int
    lanes: int


class Lanes(NamedTuple):
    caps: torch.Tensor


@dataclass
class MutableBox:
    v: int


def bad_param(arrs: list):
    _ENGINE_CACHE[(arrs, 3)] = 1  # TP: list-annotated parameter


def bad_dataclass():
    b = MutableBox(1)
    _ENGINE_CACHE[(b,)] = 1  # TP: non-frozen dataclass is unhashable


def bad_tensor_param(x: torch.Tensor):
    _ENGINE_CACHE[(x.shape[0], x)] = 1  # TP: a tensor hashes by identity


def bad_tensor_local(n: int):
    t = torch.arange(n)
    return _ENGINE_CACHE.get((n, t))  # TP: a torch-made local


def bad_lanes(c):
    lanes = Lanes(c)
    _ENGINE_CACHE[(lanes, 2)] = 1  # TP: a container of a tensor


@functools.lru_cache
def bad_lru(x: torch.Tensor):  # TP: a tensor lru_cache parameter
    return x.sum()


def good(key: BucketKey, d: int):
    _ENGINE_CACHE[(key, d)] = 2  # near miss: scalar NamedTuple + int


def good_shape(x: torch.Tensor):
    _ENGINE_CACHE[(tuple(x.shape), str(x.dtype), x.device.type)] = 3  # near


@functools.lru_cache
def good_lru(n: int):  # near miss
    return n * 2
