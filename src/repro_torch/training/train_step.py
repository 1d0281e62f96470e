"""Prefill / decode / eval step factories (the reference's
`repro.training.train_step`, its serving and evaluation half).

`make_prefill_step` / `make_decode_step` are the serving entry points;
`make_forward_loss` is the forward-only evaluation loss.  Each step runs
without autograd and updates the cache it is given in place, as the
reference's jitted steps donate it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_forward_loss(cfg: ModelConfig, has_xkv: bool = False):
    """Forward-only loss (evaluation)."""

    @torch.no_grad()
    def eval_step(params: M.LM, batch: dict) -> torch.Tensor:
        xkv = batch.get("xkv") if has_xkv else None
        return M.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                         xkv=xkv)

    return eval_step


def make_prefill_step(cfg: ModelConfig, has_xkv: bool = False):
    @torch.no_grad()
    def prefill_step(params: M.LM, cache: dict, tokens: torch.Tensor,
                     xkv: torch.Tensor | None = None):
        logits, cache = M.forward(cfg, params, tokens,
                                  xkv=xkv if has_xkv else None, cache=cache)
        return logits[:, -1:], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """One token for every sequence in the batch against the KV cache:
    returns (next_tok (B, 1) int32, logits, cache)."""

    @torch.no_grad()
    def decode_step(params: M.LM, cache: dict, tokens: torch.Tensor):
        logits, cache = M.forward(cfg, params, tokens, cache=cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        return next_tok.to(torch.int32), logits, cache

    return decode_step
