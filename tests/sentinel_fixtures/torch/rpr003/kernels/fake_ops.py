"""RPR003 fixture (a hot `kernels/` path): float64 on the device."""
import torch


def build(n: int):
    acc = torch.zeros(n, dtype=torch.float64)  # TP: float64 on the card
    ok = torch.zeros(n, dtype=torch.float32)  # near miss: float32
    ids = torch.arange(n, dtype=torch.int64)  # near miss: integer dtype
    return acc, ok, ids


def widen(x):
    return x.double()  # TP


def named(x):
    return x.to("float64")  # TP: the dtype by name
