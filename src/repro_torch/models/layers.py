"""Model-zoo primitives: RMSNorm, RoPE, GQA attention (dense, streaming
and single-step), SwiGLU, sort-based MoE dispatch, Mamba-2 SSD (chunked
scan + recurrent step).

The math is plain functions on tensors under the JAX reference's names
(`repro.models.layers`); each takes the `nn.Module` that holds its
parameters (`Attention`, `SwiGLU`, `MoE`, `Mamba2`) where the reference
takes a parameter dict, and reads the same leaves by attribute.
Softmax/normalization statistics accumulate in float32, and every cast of
the reference is mirrored, so a bf16 model rounds where the reference
does.  Attention is written out in einsums: no fused or library
attention, as parity is held against the reference's einsums.

The reference's sharding hints (`sharding_hints`, `constrain_batch`,
`_seq_shard`) are identities without a mesh and are not ported here.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

DENSE_ATTN_MAX_KV = 8192   # use dense masked attention up to this KV length
NEG = -1e30                # the reference's mask fill


def _normal(shape, std: float, dtype, device, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, dtype=dtype, device=device,
                                    generator=generator) * std)


def _const(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype,
                                   device=device))


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def _expand_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """Repeat KV heads up to `heads` (GQA), each head `heads // KV` times
    in a row, as `jnp.repeat` does."""
    kv = k.shape[2]
    if kv == heads:
        return k
    return k.repeat_interleave(heads // kv, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Masked-softmax attention: float32 scores, the probabilities cast
    back to q's dtype before the PV product."""
    _, sq, h, hd = q.shape
    sk = k.shape[1]
    ke = _expand_kv(k, h)
    ve = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), ke.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(sk, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(~mask, NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, ve)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0, kv_block: int = 1024
                    ) -> torch.Tensor:
    """Streaming-softmax attention with GQA over `kv_block`-key blocks:
    float32 running max, sum and accumulator; the last block padded and
    its padding masked (`kv_pos < Sk`), as the causal mask is from
    `q_offset`.  q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    nblk = -(-sk // kv_block)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        start = i * kv_block
        kc = k[:, start:start + kv_block]
        vc = v[:, start:start + kv_block]
        pad = kv_block - kc.shape[1]
        if pad:
            kc = F.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = F.pad(vc, (0, 0, 0, 0, 0, pad))
        kc = _expand_kv(kc, h)
        vc = _expand_kv(vc, h)
        s = torch.einsum("bqhd,bchd->bhqc", qf, kc.float())
        kv_pos = start + torch.arange(kv_block, device=q.device)
        mask = (kv_pos < sk)[None, :]
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p,
                                                   vc.float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """Single-step attention against a (possibly padded) KV cache.

    q: (B, 1, H, hd); k, v: (B, Smax, KV, hd); kv_len: valid prefix length.
    """
    _, _, h, hd = q.shape
    ke = _expand_kv(k, h)
    ve = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(hd)
    qf = q[:, 0].float() * scale                              # (B, H, hd)
    s = torch.einsum("bhd,bshd->bhs", qf, ke.float())
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < kv_len
    s = s.masked_fill(~mask[:, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, ve.float())
    return out[:, None].to(q.dtype)


# ----------------------------------------------------------- attn wrapper
class Attention(nn.Module):
    """Parameters of one self- or cross-attention (`init_attention`): a
    cross-attention carries no bias and no qk-norm."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        std = 1.0 / math.sqrt(d)
        init = functools.partial(_normal, std=std, dtype=dtype,
                                 device=device, generator=generator)
        self.wq = init((d, cfg.heads, hd))
        self.wk = init((d, cfg.kv_heads, hd))
        self.wv = init((d, cfg.kv_heads, hd))
        self.wo = init((cfg.heads, hd, d))
        bias = cfg.qkv_bias and not cross
        norm = cfg.qk_norm and not cross
        for name, heads in (("bq", cfg.heads), ("bk", cfg.kv_heads),
                            ("bv", cfg.kv_heads)):
            self.register_parameter(name, _const((heads, hd), 0.0, dtype,
                                                 device) if bias else None)
        for name in ("qn", "kn"):
            self.register_parameter(name, _const((hd,), 1.0, dtype, device)
                                    if norm else None)


def attention_block(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    use_rope: bool = True):
    """Self- or cross-attention.  Returns (out, new_cache).

    With a cache ({"k", "v", "len"}), this call's K/V are written into the
    cache tensors in place at position `len`; a write past the cache's
    length raises (the reference's `dynamic_update_slice` clamps its start
    and overwrites the last slots instead).  One token attends to the
    cache's valid prefix; a prefill attends within its own K/V (the cache
    starts empty).
    """
    src = kv_source if kv_source is not None else x
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", src, p.wk)
    v = torch.einsum("bsd,dhk->bshk", src, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if p.qn is not None:
        q = rmsnorm(q, p.qn, cfg.norm_eps)
        k = rmsnorm(k, p.kn, cfg.norm_eps)
    if use_rope and kv_source is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    s = x.shape[1]
    if cache is not None and kv_source is None:
        idx = cache["len"]
        ck, cv = cache["k"], cache["v"]
        if idx + s > ck.shape[1]:
            raise ValueError(f"KV cache overflow: writing {s} positions at "
                             f"{idx} into a cache of {ck.shape[1]}")
        ck[:, idx:idx + s] = k
        cv[:, idx:idx + s] = v
        new_cache = {"k": ck, "v": cv, "len": idx + s}
        if s == 1:
            out = decode_attention(q, ck, cv, idx + s)
        else:
            # prefill: attend within this call's K/V (cache starts empty)
            out = flash_attention(q, k, v, causal=causal, q_offset=idx)
    elif k.shape[1] <= DENSE_ATTN_MAX_KV:
        out = dense_attention(q, k, v, causal=causal and kv_source is None)
    else:
        out = flash_attention(q, k, v, causal=causal and kv_source is None)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return y, new_cache


# ------------------------------------------------------------------ mlps
class SwiGLU(nn.Module):
    """`init_mlp`: wi, wg (d, f) and wo (f, d)."""

    def __init__(self, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        init = functools.partial(_normal, std=1.0 / math.sqrt(d),
                                 dtype=dtype, device=device,
                                 generator=generator)
        self.wi = init((d, f))
        self.wg = init((d, f))
        self.wo = init((f, d))


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


class MoE(nn.Module):
    """`init_moe`: a float32 router (d, E) and E experts' SwiGLU weights
    stacked on a leading axis."""

    def __init__(self, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        init = functools.partial(_normal, std=1.0 / math.sqrt(d),
                                 device=device, generator=generator)
        self.router = init((d, e), dtype=torch.float32)
        self.wi = init((e, d, f), dtype=dtype)
        self.wg = init((e, d, f), dtype=dtype)
        self.wo = init((e, f, d), dtype=dtype)


def moe_block(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with *per-sequence* sort-based dispatch (the reference's
    `vmap` over sequences, here batched over the leading axis).

    Each sequence's (token, choice) pairs are sorted stably by expert, so
    the pairs past an expert's capacity C = ceil(S * topk / E *
    cfg.moe_capacity) drop in token order, as `jnp.argsort`'s do; they
    land in the drop bin E*C, whose row is discarded.
    """
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = int(max(1, math.ceil(s * k / e * cfg.moe_capacity)))
    dev = x.device
    logits = x.float() @ p.router                               # (B, S, E)
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((b, e), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(s * k, device=dev) - torch.gather(starts, 1,
                                                          sorted_e)
    keep = rank < c
    buf_slot = torch.where(keep, sorted_e * c + rank, e * c)   # drop bin
    tok = order // k                                            # (B, S*K)
    rows = torch.arange(b, device=dev)[:, None]
    xbuf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=dev)
    xbuf[rows, buf_slot] = x[rows, tok]
    xe = xbuf[:, :-1].reshape(b, e, c, d)
    h = F.silu(torch.einsum("becd,edf->becf", xe, p.wg)) * \
        torch.einsum("becd,edf->becf", xe, p.wi)
    ye = torch.einsum("becf,efd->becd", h, p.wo).reshape(b, e * c, d)
    ye = torch.cat([ye, torch.zeros((b, 1, d), dtype=ye.dtype, device=dev)],
                   dim=1)
    g = torch.gather(gates.reshape(b, s * k), 1, order)
    contrib = ye[rows, buf_slot] * g[..., None].to(ye.dtype) * \
        keep[..., None]
    out = torch.zeros((b * s, d), dtype=x.dtype, device=dev)
    out.index_add_(0, (rows * s + tok).reshape(-1),
                   contrib.reshape(b * s * k, d).to(x.dtype))
    return out.reshape(b, s, d)


# ----------------------------------------------------------------- mamba2
class Mamba2(nn.Module):
    """`init_mamba`: in_proj (d, 2 d_in + 2n + nh), the depthwise conv,
    float32 A_log and dt_bias, the gated norm and out_proj."""

    def __init__(self, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * n
        std = 1.0 / math.sqrt(d)
        init = functools.partial(_normal, dtype=dtype, device=device,
                                 generator=generator)
        self.in_proj = init((d, 2 * d_in + 2 * n + nh), std)
        self.conv_w = init((cfg.ssm_conv, conv_dim), 0.1)
        self.conv_b = _const((conv_dim,), 0.0, dtype, device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=device)))
        self.dt_bias = _const((nh,), 0.0, torch.float32, device)
        self.norm_w = _const((d_in,), 1.0, dtype, device)
        self.out_proj = init((d_in, d), std)


def _mamba_split(p: Mamba2, cfg: ModelConfig, x: torch.Tensor):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    zxbcdt = x @ p.in_proj
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, nh], dim=-1)
    return z, xbc, dt, d_in, n, nh


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, kernel K.  state: (B, K-1, C) rolling window."""
    k = w.shape[0]
    if state is not None:
        ctx = torch.cat([state, xbc], dim=1)
        new_state = ctx[:, -(k - 1):, :] if k > 1 else state
    else:
        ctx = F.pad(xbc, (0, 0, k - 1, 0))
        new_state = ctx[:, -(k - 1):, :] if k > 1 else None
    out = sum(ctx[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b), new_state


def mamba_block(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                cache: dict | None = None, chunk: int = 128):
    """Mamba-2 SSD block.  Train/prefill: chunked scan; decode (one token
    with a cache): the recurrence, its ssm state in float32.

    Returns (out, new_cache); a given cache ({"conv", "ssm"}) is
    overwritten in place with the new states (a prefill starts from zero
    states, as the reference's does).
    """
    b, s, _ = x.shape
    z, xbc, dt, d_in, n, nh = _mamba_split(p, cfg, x)
    hd = cfg.ssm_head_dim
    a = -torch.exp(p.A_log)                                   # (nh,)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,S,nh)

    if cache is not None and s == 1:
        xbc_conv, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                            cache["conv"])
        xs, bm, cm = torch.split(xbc_conv, [d_in, n, n], dim=-1)
        xh = xs.reshape(b, 1, nh, hd).float()
        dtb = dt[:, 0]                                        # (B, nh)
        da = torch.exp(dtb * a)                               # (B, nh)
        bt = bm[:, 0].float()                                 # (B, n)
        ct = cm[:, 0].float()
        upd = (dtb[..., None] * xh[:, 0])[..., None] * bt[:, None, None, :]
        ssm_state = cache["ssm"] * da[..., None, None] + upd  # (B,nh,hd,n)
        y = torch.einsum("bhpn,bn->bhp", ssm_state, ct)[:, None]
    else:
        xbc_conv, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b)
        xs, bm, cm = torch.split(xbc_conv, [d_in, n, n], dim=-1)
        y, ssm_state = _ssd_chunked(
            xs.reshape(b, s, nh, hd).float(), dt, a, bm.float(), cm.float(),
            chunk)
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(ssm_state)
        new_cache = cache
    yf = y.reshape(b, s, d_in).to(x.dtype)
    out = rmsnorm(yf * F.silu(z), p.norm_w, cfg.norm_eps)
    return out @ p.out_proj, new_cache


def _ssd_chunked(xh, dt, a, bm, cm, chunk: int):
    """State-space duality (Mamba-2): intra-chunk quadratic attention-like
    term + inter-chunk recurrent state passing.

    xh: (B,S,nh,hd) f32; dt: (B,S,nh); a: (nh,); bm/cm: (B,S,n).
    S is padded up to a multiple of `chunk` and the result sliced back.
    Returns y: (B,S,nh,hd), final_state: (B,nh,hd,n).
    """
    b, s, nh, hd = xh.shape
    n = bm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    ln = chunk
    xc = xh.reshape(b, nc, ln, nh, hd)
    dtc = dt.reshape(b, nc, ln, nh)
    bc = bm.reshape(b, nc, ln, n)
    cc = cm.reshape(b, nc, ln, n)

    da = dtc * a                                   # log-decay per step
    cum = torch.cumsum(da, dim=2)                  # (B,nc,L,nh)
    # intra-chunk: y_intra[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s x_s B_s.C_t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,L,L,nh)
    tri = torch.tril(torch.ones((ln, ln), dtype=torch.bool,
                                device=xh.device))
    # mask *before* exp: above the diagonal seg is positive and overflows
    seg = seg.masked_fill(~tri[None, None, :, :, None], NEG)
    decay = torch.exp(seg)
    scores = torch.einsum("bcln,bcmn->bclm", cc, bc)        # (B,nc,L,L)
    w = scores[..., None] * decay * dtc[:, :, None, :, :]   # (B,nc,L,L,nh)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xc)

    # chunk-level states: S_c = sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,L,nh)
    contrib = torch.einsum("bclh,bclhp,bcln->bchpn",
                           dtc * dec_end, xc, bc)            # per chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,nh)
    state = torch.zeros((b, nh, hd, n), dtype=torch.float32,
                        device=xh.device)
    prev = []                      # the state *entering* each chunk
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + contrib[:, ci]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,nh,hd,n)
    # inter-chunk: y_inter[t] = C_t . (exp(cum_t) * S_prev)
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp",
                           cc, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, nc * ln, nh, hd)
    return y[:, :s], state
