"""AdamW with a configurable moment dtype (the reference's
`repro.training.optimizer`).

For the >=300B architectures the first/second moments are stored in
bfloat16 so the optimizer state fits; updates always compute in float32.
The reference's tensor math, written out: `torch.optim.AdamW` has no
bfloat16 moments, no global-norm clip and not the reference's decay rule.

Parameters are an `LM` (or any mapping of names to tensors); they and
the moments, keyed by the parameter names, are updated in place, as the
reference's jitted step donates its state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn

Named = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 20
    state_dtype: torch.dtype = torch.float32   # bfloat16 for the huge archs


def _named(params: nn.Module | Named) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to parameter `name`.  The reference
    decays every leaf of two or more dimensions, and its per-layer leaves
    are stacked over the layer groups, so every parameter of a layer or an
    encoder layer is decayed, its 1-D norms and biases too; the port holds
    those unstacked, hence the prefix."""
    return p.ndim >= 2 or name.startswith(("layers.", "encoder."))


def init_state(params: nn.Module | Named, cfg: AdamWConfig) -> dict:
    """{"m": {name: zeros}, "v": {name: zeros} in `cfg.state_dtype`,
    "step": 0-d int32}, on the parameters' device."""
    named = _named(params)
    device = next(iter(named.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=cfg.state_dtype)
                  for n, p in named.items()},
            "v": {n: torch.zeros_like(p, dtype=cfg.state_dtype)
                  for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (None
    entries, parameters without a gradient, count as zeros)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.values()
          if g is not None]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(params: nn.Module | Named,
                  grads: Mapping[str, torch.Tensor | None], state: dict,
                  cfg: AdamWConfig,
                  grad_norm: torch.Tensor | None = None) -> dict:
    """One AdamW step: writes every parameter and moment in place (each
    in its own dtype) and returns the state with its step advanced; the
    float32 temporaries of one parameter at a time are all it allocates.
    `grad_norm` is `global_norm(grads)` where the caller has it already.
    A parameter whose gradient is None (no path from the loss reaches it)
    updates with a zero gradient, as the reference's zero cotangent does:
    its moments shrink by b1 and b2, and weight decay still applies."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = _schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for name, p in _named(params).items():
        g = grads.get(name)
        g = torch.zeros_like(p, dtype=torch.float32) if g is None \
            else g.float() * scale
        m, v = state["m"][name], state["v"][name]
        # float32 moments take the sum in place; others round below
        m32 = torch.add(cfg.b1 * m.float(), (1 - cfg.b1) * g,
                        out=m if m.dtype == torch.float32 else None)
        v32 = torch.add(cfg.b2 * v.float(), (1 - cfg.b2) * g * g,
                        out=v if v.dtype == torch.float32 else None)
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and decays(name, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
    return {"m": state["m"], "v": state["v"], "step": step}
