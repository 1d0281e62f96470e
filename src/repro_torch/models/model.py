"""Generic decoder stack covering all assigned architecture families.

The layer pattern is periodic with period cfg.group_size (e.g. jamba:
7 mamba + 1 attention, MoE every 2nd layer -> period 8).  The reference
(`repro.models.model`) stacks each pattern position's leaves over the
n_groups repetitions and scans over groups; here the `LM` module holds
one `Layer` per layer in order, layer i = g * group_size + j being the
reference's pattern position j of group g, and the stack is a loop over
layers.

Families:
  dense / moe        causal GQA attention (+ optional MoE FFN)
  ssm                Mamba-2 SSD blocks, no attention
  hybrid             attention every cfg.attn_every layers (jamba)
  vlm                cross-attention to stubbed image embeddings
  encdec             bidirectional encoder + causal decoder w/ cross-attn
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


# ------------------------------------------------------------------- init
class Layer(nn.Module):
    """Parameters of pattern position j (its kind depends only on j):
    ln1, ln2, attn or mamba, moe or mlp, and lnx with xattn where the
    layer cross-attends.  Absent parts are None."""

    def __init__(self, cfg: ModelConfig, j: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        d = cfg.d_model
        self.ln1 = L._const((d,), 1.0, dtype, device)
        self.ln2 = L._const((d,), 1.0, dtype, device)
        self.attn = L.Attention(cfg, **kw) if cfg.is_attn_layer(j) else None
        self.mamba = None if cfg.is_attn_layer(j) else L.Mamba2(cfg, **kw)
        self.moe = L.MoE(cfg, **kw) if cfg.is_moe_layer(j) else None
        self.mlp = L.SwiGLU(cfg, **kw) \
            if self.moe is None and cfg.d_ff > 0 else None
        xattn = cfg.is_xattn_layer(j) or bool(cfg.encoder_layers and
                                              cfg.cross_attn_every == 1)
        self.lnx = L._const((d,), 1.0, dtype, device) if xattn else None
        self.xattn = L.Attention(cfg, cross=True, **kw) if xattn else None


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln1 = L._const((cfg.d_model,), 1.0, dtype, device)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L._const((cfg.d_model,), 1.0, dtype, device)
        self.mlp = L.SwiGLU(cfg, **kw)


class LM(nn.Module):
    """The model's parameters (`init_params`): embed (vocab, d), final_ln,
    head (d, vocab) unless the embeddings are tied, `layers` in layer
    order and, for an encoder-decoder, `encoder`.  Random weights with the
    reference's shapes and scales, drawn from `generator` on `device`."""

    def __init__(self, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        g = cfg.group_size
        if cfg.layers % g:
            raise ValueError(f"{cfg.name}: layers={cfg.layers} not "
                             f"divisible by pattern period {g}")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.embed = L._normal((cfg.vocab, cfg.d_model), 0.02, **kw)
        self.final_ln = L._const((cfg.d_model,), 1.0, dtype, device)
        self.head = None if cfg.tie_embeddings else L._normal(
            (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), **kw)
        self.layers = nn.ModuleList(Layer(cfg, i % g, **kw)
                                    for i in range(cfg.layers))
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers)) \
            if cfg.encoder_layers else None

    def forward(self, tokens: torch.Tensor, xkv: torch.Tensor | None = None,
                cache: dict | None = None):
        return forward(self.cfg, self, tokens, xkv=xkv, cache=cache)


# ------------------------------------------------------------------ cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, enc_len: int = 0,
               device: torch.device | str) -> dict:
    """{"pos": 0, "layers": [per layer {"k", "v"} (B, max_len, KV, hd) or
    {"conv" (B, K-1, conv_dim), "ssm" (B, nh, hd, n) float32}],
    "enc": (B, enc_len, d) when enc_len}."""
    g = cfg.group_size
    caches: list[dict] = []
    for i in range(cfg.layers):
        if cfg.is_attn_layer(i % g):
            shape = (batch, max_len, cfg.kv_heads, cfg.hd)
            caches.append({"k": torch.zeros(shape, dtype=dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=device)})
        else:
            d_in = cfg.ssm_expand * cfg.d_model
            nh = d_in // cfg.ssm_head_dim
            conv_dim = d_in + 2 * cfg.ssm_state
            caches.append({
                "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)})
    cache: dict = {"pos": 0, "layers": caches}
    if enc_len:
        cache["enc"] = torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=dtype, device=device)
    return cache


# ---------------------------------------------------------------- forward
def _apply_layer(cfg: ModelConfig, j: int, p: Layer, x: torch.Tensor,
                 positions, cache_j, xkv, pos_scalar: int) -> torch.Tensor:
    """One layer; its cache (`cache_j`), when given, is written in
    place."""
    # layer boundary: batch on data axes (+ optional SP)
    x = L.constrain_batch(x, boundary=True)
    if cfg.is_attn_layer(j):
        attn_cache = None
        if cache_j is not None:
            attn_cache = {"k": cache_j["k"], "v": cache_j["v"],
                          "len": pos_scalar}
        h, _ = L.attention_block(p.attn, cfg,
                                 L.rmsnorm(x, p.ln1, cfg.norm_eps),
                                 positions, causal=True, cache=attn_cache)
        x = x + h
    else:
        h, _ = L.mamba_block(p.mamba, cfg, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                             cache=cache_j)
        x = x + h
    if p.xattn is not None and xkv is not None:
        h, _ = L.attention_block(p.xattn, cfg,
                                 L.rmsnorm(x, p.lnx, cfg.norm_eps),
                                 positions, causal=False, kv_source=xkv)
        x = x + h
    if p.moe is not None:
        x = x + L.moe_block(p.moe, cfg, L.rmsnorm(x, p.ln2, cfg.norm_eps))
    elif p.mlp is not None:
        x = x + L.swiglu(p.mlp, L.rmsnorm(x, p.ln2, cfg.norm_eps))
    return x


def _remat(fn, *args):
    """fn(*args), its activations recomputed in the backward pass instead
    of kept (the reference's `jax.checkpoint`)."""
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_group(cfg: ModelConfig, group, x: torch.Tensor, positions, xkv,
                 pos_scalar: int) -> torch.Tensor:
    """One pattern period of layers, the reference's remat schedule: the
    caller recomputes the whole group in the backward pass, and where the
    period holds more than one layer each layer is recomputed again on its
    own (the reference's per-layer `jax.checkpoint` inside its group
    body), so every layer's forward runs three times in a step."""
    for j, p in enumerate(group):
        if len(group) > 1:
            x = _remat(_apply_layer, cfg, j, p, x, positions, None, xkv,
                       pos_scalar)
        else:
            x = _apply_layer(cfg, j, p, x, positions, None, xkv, pos_scalar)
    return x


def _encoder_layer(cfg: ModelConfig, p: EncoderLayer, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h, _ = L.attention_block(p.attn, cfg, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                             positions, causal=False)
    x = x + h
    return x + L.swiglu(p.mlp, L.rmsnorm(x, p.ln2, cfg.norm_eps))


def encode(cfg: ModelConfig, params: LM, enc_embeds: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """Bidirectional encoder over stubbed frontend embeddings.  With
    `remat` (the reference's default, which its `forward` keeps) each
    layer is recomputed in the backward pass when autograd records."""
    positions = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)
    remat = remat and torch.is_grad_enabled()
    x = enc_embeds
    for p in params.encoder:
        x = _remat(_encoder_layer, cfg, p, x, positions) if remat \
            else _encoder_layer(cfg, p, x, positions)
    return x


def forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            xkv: torch.Tensor | None = None, cache: dict | None = None,
            remat: bool = False) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, S) -> logits (B, S, V); updates the cache when given.

    xkv: stubbed modality embeddings (image patches / encoder output) for
    vlm / encdec families.  A given cache is updated in place (its K/V
    and states written, `pos` advanced by S, the modality source stored
    at prefill for the decode steps to reuse) and returned.  `remat`
    recomputes the layers' activations in the backward pass, on the
    reference's schedule (`_remat_group`; without a cache, when autograd
    records); the values do not change.
    """
    _, s = tokens.shape
    dev = tokens.device
    x = L.embed_lookup(tokens, params.embed)
    pos_scalar = cache["pos"] if cache is not None else 0
    positions = pos_scalar + torch.arange(s, device=dev)
    # modality source for cross-attention: encoder output (encdec) or raw
    # patch embeddings (vlm); cached at prefill so decode steps reuse it
    enc_cached = cache.get("enc") if cache is not None else None
    if xkv is not None and cfg.encoder_layers:
        xkv = encode(cfg, params, xkv)
    if xkv is None:
        xkv = enc_cached

    g = cfg.group_size
    remat = remat and cache is None and torch.is_grad_enabled()
    if remat:
        for i in range(0, len(params.layers), g):
            x = _remat(_remat_group, cfg, params.layers[i:i + g], x,
                       positions, xkv, pos_scalar)
    else:
        for i, p in enumerate(params.layers):
            cj = cache["layers"][i] if cache is not None else None
            x = _apply_layer(cfg, i % g, p, x, positions, cj, xkv,
                             pos_scalar)
    if cache is not None:
        cache["pos"] = pos_scalar + s
        if xkv is not None and (cfg.cross_attn_every or cfg.encoder_layers):
            cache["enc"] = xkv
    x = L.rmsnorm(x, params.final_ln, cfg.norm_eps)
    head = params.head if params.head is not None else params.embed.T
    return L.matmul(x, head), cache


def loss_fn(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            labels: torch.Tensor, xkv: torch.Tensor | None = None,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 (the training and eval
    loss)."""
    logits, _ = forward(cfg, params, tokens, xkv=xkv, remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # (B, S, 1) as the gather gives it: on a mesh, the masked partial
    # result of a gather from vocab-sharded logits keeps that rank
    gold = torch.gather(logits, -1, labels[..., None].long())
    return torch.mean(logz[..., None] - gold)
