"""RPR006 fixture (a hot `des_torch` path): host syncs per iteration."""
import torch


def _drain(x: torch.Tensor) -> float:
    return x.sum().item()  # TP: a loop below calls this function


def _check(x: torch.Tensor) -> None:
    if bool((x < 0).any()):  # near miss: called once, before the loop
        raise ValueError("negative")


def bad(x: torch.Tensor, steps: int) -> int:
    _check(x)
    total = torch.zeros(())
    for _ in range(steps):
        total = total + x
        if total.sum() > 10:  # TP: `if` on a tensor, once per iteration
            break
        _drain(total)
    return int(total)  # near miss: one sync after the loop


def bad_while(x: torch.Tensor) -> None:
    y = torch.cumsum(x, 0)
    while y.numel() > 1:  # near miss: numel is a host value
        y = y[1:]
        print(float(y[0]))  # TP: float of a tensor per iteration
        torch.cuda.synchronize()  # TP
    y.cpu()  # near miss: after the loop


def good(x: torch.Tensor, steps: int, mode: str = "fast"):
    n = x.shape[0]
    for _ in range(steps):
        if n > 1:  # near miss: the shape is a host value
            x = x * 2
        if mode == "fast":  # near miss: a plain parameter
            x = x + 1
    return x
