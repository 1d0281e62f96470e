"""Train / prefill / decode / eval step factories (the reference's
`repro.training.train_step`).

`make_train_step` builds a (state, batch) -> (state, metrics) function:
gradients by autograd of the plain model (microbatches accumulated in
float32 buffers), per-layer remat, then the AdamW update in place.  The
reference's `mesh`/`data_axes` are left out: on one device they are
identities (the sharding rules are not ported yet).

`make_prefill_step` / `make_decode_step` are the serving entry points;
`make_forward_loss` is the forward-only evaluation loss.  Each of these
runs without autograd and updates the cache it is given in place, as the
reference's jitted steps donate it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    accum_steps: int = 1, remat: bool = True,
                    has_xkv: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": LM, "opt": optimizer state}; the parameters and
    the moments are updated in place.  batch = {"tokens", "labels"[, "xkv"]} with a
    leading global-batch dim; accum_steps splits it into microbatches.
    metrics = {"loss", "grad_norm", "step"}, 0-d tensors on the device
    (the step reads nothing back to the host).
    """

    def grads_of(params: M.LM, tokens, labels, xkv):
        names, leaves = zip(*params.named_parameters())
        with torch.enable_grad():
            loss = M.loss_fn(cfg, params, tokens, labels, xkv=xkv,
                             remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), dict(zip(names, grads))

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        xkv = batch.get("xkv") if has_xkv else None
        if accum_steps > 1:
            mb = tokens.shape[0] // accum_steps

            def micro(x):
                return None if x is None else \
                    x.reshape(accum_steps, mb, *x.shape[1:])

            tok, lab, xk = micro(tokens), micro(labels), micro(xkv)
            # float32 accumulators: .grad would sum in the parameters'
            # dtype (bf16 by default)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.named_parameters()}
            for a in range(accum_steps):
                la, ga = grads_of(params, tok[a], lab[a],
                                  None if xk is None else xk[a])
                loss = loss + la
                for n, g in ga.items():
                    if g is not None:
                        grads[n] += g.float()
            loss = loss / accum_steps
            grads = {n: g / accum_steps for n, g in grads.items()}
        else:
            loss, grads = grads_of(params, tokens, labels, xkv)
        grad_norm = opt.global_norm(grads)
        new_opt = opt.apply_updates(params, grads, state["opt"], ocfg,
                                    grad_norm=grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "step": new_opt["step"]}
        return {"params": params, "opt": new_opt}, metrics

    return train_step


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


def init_train_state(cfg: ModelConfig, ocfg: opt.AdamWConfig, *,
                     device: torch.device | str,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """{"params": an `LM` drawn from `generator` on `device`, "opt": its
    zero AdamW state}."""
    params = M.LM(cfg, dtype=dtype, device=device, generator=generator)
    return {"params": params, "opt": opt.init_state(params, ocfg)}
