"""RPR011 fixture: float32 matmuls switched to reduced precision."""
import torch


def bad_matmul():
    torch.backends.cuda.matmul.allow_tf32 = True  # TP


def bad_cudnn():
    torch.backends.cudnn.allow_tf32 = True  # TP


def bad_precision():
    torch.set_float32_matmul_precision("high")  # TP


def good():
    torch.backends.cuda.matmul.allow_tf32 = False  # near miss
    torch.set_float32_matmul_precision("highest")  # near miss
    return torch.backends.cudnn.allow_tf32  # near miss: a read
