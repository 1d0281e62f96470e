"""RPR004 fixture (a hot `des_torch` path): float64-default staging."""
import numpy as np
import torch


def stage(vals):
    buf = np.zeros((8,))  # TP: float64 default crosses the device seam
    payload = np.array([1.0, 2.0])  # TP: float payload, no dtype
    typed = np.zeros((8,), dtype=np.float32)  # near miss: explicit dtype
    cast = np.array([3.0, 4.0]).astype(np.float32)  # near miss: .astype
    idx = np.array([1, 2])  # near miss: integer payload
    return buf, payload, typed, cast, idx


def upload(vals, dev):
    t = torch.as_tensor(vals, device=dev)  # TP: keeps a float64 dtype
    u = torch.tensor(vals, dtype=torch.float32, device=dev)  # near miss
    w = torch.as_tensor(vals).to(torch.float32)  # near miss: explicit cast
    return t, u, w
