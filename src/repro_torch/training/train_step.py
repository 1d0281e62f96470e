"""Train / prefill / decode / eval step factories (the reference's
`repro.training.train_step`).

`make_train_step` builds a (state, batch) -> (state, metrics) function:
gradients by autograd of the plain model (microbatches accumulated in
float32 buffers), remat on the reference's schedule, then the AdamW
update in place.  On a mesh (parameters and batch DTensors, placed by
`distributed.sharding`), the same code runs sharded.

`make_prefill_step` / `make_decode_step` are the serving entry points;
`make_forward_loss` is the forward-only evaluation loss.  Each of these
runs without autograd and updates the cache it is given in place, as the
reference's jitted steps donate it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    accum_steps: int = 1, remat: bool = True,
                    has_xkv: bool = False, mesh=None,
                    data_axes: tuple[str, ...] = ()):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": LM, "opt": optimizer state}; the parameters and
    the moments are updated in place.  batch = {"tokens", "labels"[, "xkv"]} with a
    leading global-batch dim; accum_steps splits it into microbatches.
    metrics = {"loss", "grad_norm", "step"}, 0-d tensors on the device
    (the step reads nothing back to the host).
    mesh/data_axes: when given, the reshaped (accum, micro, ...) batch of a
    sharded step is redistributed to keep the *micro* dim on the data
    axes -- else the reshape leaves the data sharding on the accumulation
    dim and every microstep runs on a fraction of the devices.
    """

    def _constrain_micro(x):
        if mesh is None or not data_axes or x is None or \
                not isinstance(x, DTensor):
            return x
        want = sharding.placements(
            sharding.P(None, data_axes, *([None] * (x.ndim - 2))), mesh)
        return x if tuple(x.placements) == want else \
            x.redistribute(sharding.device_mesh(mesh), want)

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
                return None if x is None else _constrain_micro(
                    x.reshape(accum_steps, mb, *x.shape[1:]))

            tok, lab, xk = micro(tokens), micro(labels), micro(xkv)
            # float32 accumulators: .grad would sum in the parameters'
            # dtype (bf16 by default)
            loss = 0.0
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
        metrics = {"loss": _whole(loss), "grad_norm": _whole(grad_norm),
                   "step": new_opt["step"]}
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as every rank reads it: a DTensor's full value (a loss
    over batch shards is a partial mean until it is reduced)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


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
        # on a mesh, the vocab gathered onto each batch shard first
        next_tok = torch.argmax(L.constrain_batch(logits[:, -1]), dim=-1,
                                keepdim=True)
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
