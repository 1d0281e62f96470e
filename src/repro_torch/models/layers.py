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

`sharding_hints` (alias `attention_hints`) installs the reference's
sharding hints for a run on a mesh: `constrain_batch` pins (B, ...)
activations to batch sharding over the data axes at layer and MoE
boundaries (and, with `seq_parallel`, sequence-shards the layer
boundaries over the model axis); `_seq_shard` sequence-shards q/k/v
inside attention (Ulysses-style, for head counts that do not divide the
model axis: qwen2.5's 40 heads, whisper's 20 on a 16-way axis).  Each is
a `DTensor.redistribute` to the reference's spec; with no hints
installed, or on a plain tensor, it returns its input unchanged.

On DTensors (a run on a mesh, hints or not) every op meets only
DTensors: tensors made on the spot (positions, masks) are replicated on
the mesh (`like`); every product is `einsum`/`matmul`, which settles each
mesh dim on the einsum's letters and multiplies the local shards; the
streaming attention loop runs on each device's (batch, heads) shard
(`_flash_on_shards`); the MoE's per-sequence sort and scatter run on
each device's batch shard (`_batch_local`), where the reference's `vmap`
keeps them local to the batch shard.  Each device does its share of the
work as the reference's partitioner splits it: the embedding lookup is
vocab-parallel (`embed_lookup`); K/V projections whose weight is
replicated meet q's head_dim shard (`_on_head_dim`), so the KV cache and
the attention products are computed on that shard; and the SSM scan runs
on shards of the SSM heads where the model axis divides them
(`_ssd_on_heads`), else per batch shard.  Every redistribution of an
operand is explicit; DTensor's own rules are left only the elementwise
ops and reductions between the products.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (P, axis_sizes, data_axes,
                                              device_mesh, placements)

DENSE_ATTN_MAX_KV = 8192   # use dense masked attention up to this KV length
NEG = -1e30                # the reference's mask fill


_HINTS: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("sharding_hints", default=None)


@contextlib.contextmanager
def sharding_hints(mesh, data_axes: tuple[str, ...],
                   model_axes: tuple[str, ...] = ("model",),
                   seq_shard: bool = False, seq_parallel: bool = False):
    """Install sharding hints for a run on `mesh`.

    batch pinning (always): activations keep the batch dim on the data axes
    at layer/MoE boundaries.
    seq_shard: Ulysses-style q/k/v sequence sharding inside attention (for
    head counts that do not divide the model axis).
    seq_parallel: Megatron-SP-style sequence sharding of the *layer
    boundary* activations over the model axis -- shrinks the remat carry
    stack by the model-axis size.
    """
    token = _HINTS.set({"mesh": mesh, "data": data_axes,
                        "model": model_axes, "seq_shard": seq_shard,
                        "seq_parallel": seq_parallel})
    try:
        yield
    finally:
        _HINTS.reset(token)


# the reference's alias
attention_hints = sharding_hints


def _size(hints: dict, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(hints["mesh"])
    return math.prod(sizes[a] for a in axes)


def _redistribute(x: torch.Tensor, spec: P, hints: dict) -> torch.Tensor:
    want = placements(spec, hints["mesh"])
    if tuple(x.placements) == want:
        return x
    return x.redistribute(device_mesh(hints["mesh"]), want)


def constrain_batch(x: torch.Tensor, boundary: bool = False
                    ) -> torch.Tensor:
    """Pin (B, ...) activations to batch sharding over the data axes.

    Without this, the partitioner may resolve FSDP weight contractions by
    *replicating* the batch and all-reducing partial sums.

    boundary=True additionally sequence-shards dim 1 over the model axes
    when seq_parallel is enabled (layer-boundary activations only).
    """
    hints = _HINTS.get()
    if hints is None or not isinstance(x, DTensor) or x.ndim < 2:
        return x
    data = hints["data"]
    dsize = _size(hints, data)
    if dsize <= 1 or x.shape[0] % dsize:
        return x
    rest: list = [None] * (x.ndim - 1)
    if boundary and hints.get("seq_parallel") and x.ndim >= 3:
        model = hints["model"]
        msize = _size(hints, model)
        if msize > 1 and x.shape[1] % msize == 0 and x.shape[1] >= msize:
            rest[0] = model if len(model) > 1 else model[0]
    return _redistribute(x, P(data if len(data) > 1 else data[0], *rest),
                         hints)


def _seq_shard(x: torch.Tensor) -> torch.Tensor:
    """Constrain (B, S, heads, hd) to (data, model, None, None)."""
    hints = _HINTS.get()
    if hints is None or not hints["seq_shard"] or \
            not isinstance(x, DTensor) or x.ndim != 4:
        return x
    model = hints["model"]
    msize = _size(hints, model)
    if x.shape[1] % msize or x.shape[1] < msize:
        return x
    return _redistribute(
        x, P(hints["data"], model if len(model) > 1 else model[0], None,
             None), hints)


def like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t`, a tensor made on the spot (positions, a mask, an accumulator's
    zeros), replicated on `x`'s mesh when `x` is a DTensor, so that the two
    can meet in one op; `t` itself otherwise.  Every rank makes the same
    `t`, so no collective checks it."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    dm = x.device_mesh
    return DTensor.from_local(t, dm, (Replicate(),) * dm.ndim,
                              run_check=False)


def _contiguous(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient gets the row-major strides of its shape.
    A local product's gradient can carry any stride on a dim of size 1
    (one sequence per device), which DTensor scales into a global stride
    that is not row-major; the ops that consume it then copy it, and a
    `meta` run's sharding propagation builds that copy on the mesh's
    device type, which a CPU build lacks."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.stride() != _contiguous(g.shape):
            g = g.clone(memory_format=torch.contiguous_format)
        return g


def _on_shards(fn, args: tuple, in_pl: tuple, out_pl: tuple,
               out_shape=None):
    """fn(*local shards) -> its output(s) as DTensors of placements
    `out_pl` (a tuple of outputs alike, or a list of one placements tuple
    per output) and global shape `out_shape` (by default the local one
    scaled by the shards).  Each DTensor in `args` is first redistributed
    to its placements in `in_pl` (explicitly: the collectives this costs
    are the region's).  The gradient of an input replicated on a mesh dim
    where an output is not is a partial sum there."""
    dm = next(a for a in args if isinstance(a, DTensor)).device_mesh
    each = isinstance(out_pl[0], (tuple, list))
    outs_pl = [tuple(o) for o in out_pl] if each else [tuple(out_pl)]
    local = []
    for a, pl in zip(args, in_pl):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        pl = tuple(pl)
        if tuple(a.placements) != pl:
            a = a.redistribute(dm, pl)
        grad = tuple(Partial() if isinstance(p, Replicate) and any(
            not isinstance(o[i], Replicate) for o in outs_pl) else p
            for i, p in enumerate(pl))
        local.append(_DenseGrad.apply(a.to_local(grad_placements=grad)))
    out = fn(*local)

    def wrap(t, pl):
        shape = list(t.shape) if out_shape is None else list(out_shape)
        if out_shape is None:
            for p, n in zip(pl, dm.shape):
                if isinstance(p, Shard):
                    shape[p.dim] *= n
        # the global stride given is row-major: so is the local shard
        return DTensor.from_local(t.contiguous(), dm, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    if not isinstance(out, tuple):
        return wrap(out, outs_pl[0])
    return tuple(wrap(t, outs_pl[i] if each else outs_pl[0])
                 for i, t in enumerate(out))


def _settled(t: DTensor) -> list:
    """`t`'s placements with a pending sum (Partial) or a strided shard
    taken to Replicate: what a product on local shards can read."""
    return [p if type(p) is Shard or isinstance(p, Replicate)
            else Replicate() for p in t.placements]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(eq, a, b)` (two operands, no ellipsis); on DTensors,
    computed on each device's shards.

    DTensor's own einsum folds each operand's batch and contracted dims
    into one, and torch 2.11 refuses a fold whose sharded dim is not the
    first it folds (attention's (batch, heads), a sequence-sharded
    (batch, seq), a head_dim-sharded (heads, head_dim)).  Here each mesh
    dim is settled on the letters: a letter sharded in one operand is
    sharded alike in the other where it occurs (a local slice, no
    collective); two operands sharded on different letters gather the
    smaller one on that mesh dim (the second of two equal ones: the keys
    of a sequence-sharded attention, not its queries); the output is
    sharded on the letter, or holds partial sums where the letter is
    contracted."""
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        raise TypeError("einsum of a DTensor and a plain tensor; place "
                        "both on the mesh")
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    pa, pb = _settled(a), _settled(b)
    po = []
    for i in range(a.device_mesh.ndim):
        ca = la[pa[i].dim] if isinstance(pa[i], Shard) else None
        cb = lb[pb[i].dim] if isinstance(pb[i], Shard) else None
        if ca and cb and ca != cb:
            if a.numel() < b.numel():
                pa[i], ca = Replicate(), None
            else:
                pb[i], cb = Replicate(), None
        c = ca or cb
        if c is None:
            po.append(Replicate())
            continue
        if c in la:
            pa[i] = Shard(la.index(c))
        if c in lb:
            pb[i] = Shard(lb.index(c))
        po.append(Shard(out.index(c)) if c in out else Partial())
    size = {**dict(zip(lb, b.shape)), **dict(zip(la, a.shape))}
    return _on_shards(functools.partial(torch.einsum, eq), (a, b),
                      (pa, pb), po, tuple(size[c] for c in out))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` for a (..., k) activation and a (k, n) weight; on
    DTensors, `einsum` on each device's shards."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return einsum(f"{lead}k,kn->{lead}n", x, w)


def _batch_local(fn, batch_args: tuple, param_args: tuple = ()):
    """fn(*batch_args, *param_args), computed per batch shard: directly on
    plain tensors; on DTensors (a run on a mesh) on each device's shards
    (`_on_shards`), the (B, ...) `batch_args` batch-sharded over the data
    axes where B divides (else replicated), the parameters replicated,
    and every output batch-sharded alike.  This is where the reference's
    `vmap` over sequences keeps a sort or scatter local to the batch
    shard, for which DTensor has no sharding rule."""
    args = (*batch_args, *param_args)
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    if not all(isinstance(a, DTensor) for a in args):
        # a plain tensor is whole on every rank: run per shard beside
        # DTensors, each rank would take it for its own shard
        raise TypeError("a batch-local region got DTensors and plain "
                        "tensors together; place every input on the mesh")
    batch = _batch_placements(args[0], batch_args[0].shape[0])
    rep = (Replicate(),) * len(batch)
    return _on_shards(fn, args, (*(batch,) * len(batch_args),
                                 *(rep,) * len(param_args)), batch)


def _mesh_of(x: DTensor):
    """The logical mesh of a run: the hints' (a `FoldedMesh` names the
    data axes its device mesh folds), else `x`'s device mesh."""
    hints = _HINTS.get()
    return hints["mesh"] if hints is not None else x.device_mesh


def _batch_axes(mesh, b: int):
    """The spec entry of a batch of `b`: the data axes where `b` divides
    them, else None (replicated)."""
    data = data_axes(mesh)
    return data if b % math.prod(axis_sizes(mesh)[a] for a in data) == 0 \
        else None


def _batch_placements(x: DTensor, b: int) -> tuple:
    """Placements of a (B, ...) tensor sharded on B over the data axes
    where B divides them, else replicated."""
    mesh = _mesh_of(x)
    return placements(P(_batch_axes(mesh, b)), mesh)


def _lookup(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def _lookup_rows(tokens: torch.Tensor, rows: torch.Tensor, *, start: int
                 ) -> torch.Tensor:
    """Each token's row of a table shard holding the vocab rows [start,
    start + len(rows)), zeros for a token outside it: summed over the
    shards, the lookup.  Its gradient reaches the shard's own rows
    only."""
    local = tokens - start
    hit = (local >= 0) & (local < rows.shape[0])
    out = rows[torch.where(hit, local, 0)]
    return out.masked_fill(~hit[..., None], 0)


def embed_lookup(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """The (B, S, d) rows of `embed` for `tokens`: an index on plain
    tensors.  On a mesh, vocab-parallel: each device looks its batch
    shard's tokens up in its own shard of the table, the rows of a
    vocab-sharded table are partial sums (zeros for the tokens another
    shard holds) settled by one all-reduce of the (B, S, d) rows, and
    those of a d-sharded one are gathered; no device reads the whole
    table."""
    if not isinstance(embed, DTensor):
        return _batch_local(_lookup, (tokens,), (embed,))
    if not isinstance(tokens, DTensor):
        raise TypeError("a lookup of plain tokens in a table on the mesh; "
                        "place the tokens on the mesh")
    dm = embed.device_mesh
    batch = _batch_placements(embed, tokens.shape[0])
    table, rows = _settled(embed), []
    for i, b in enumerate(batch):
        if isinstance(b, Shard) and isinstance(table[i], Shard):
            table[i] = Replicate()     # no rule shards the table there
        rows.append(b if isinstance(b, Shard) else Partial()
                    if table[i] == Shard(0) else Shard(2)
                    if table[i] == Shard(1) else Replicate())
    _, offset = compute_local_shape_and_global_offset(embed.shape, dm, table)
    out = _on_shards(functools.partial(_lookup_rows, start=offset[0]),
                     (tokens, embed), (batch, table), rows,
                     (*tokens.shape, embed.shape[1]))
    return out.redistribute(dm, batch)


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
    cos = like(torch.cos(ang)[..., None, :], x)
    sin = like(torch.sin(ang)[..., None, :], x)
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
    q = _seq_shard(q)
    ke = _seq_shard(_expand_kv(k, h))
    ve = _seq_shard(_expand_kv(v, h))
    scale = 1.0 / math.sqrt(hd)
    s = einsum("bqhd,bshd->bhqs", q.float(), ke.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(sk, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(like(~mask, s), NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return einsum("bhqs,bshd->bqhd", p, ve)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0, kv_block: int = 1024
                    ) -> torch.Tensor:
    """Streaming-softmax attention with GQA over `kv_block`-key blocks:
    float32 running max, sum and accumulator; the last block padded and
    its padding masked (`kv_pos < Sk`), as the causal mask is from
    `q_offset`.  q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).

    On DTensors the streaming loop runs on each device's shards
    (`_flash_on_shards`)."""
    q = _seq_shard(q)
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    core = functools.partial(_flash, causal=causal, kv_block=kv_block)
    if isinstance(q, DTensor):
        return _flash_on_shards(core, q, k, v, q_pos)
    return core(q, k, v, q_pos)


def _flash_on_shards(core, q, k, v, q_pos):
    """`core` on each device's (batch, heads) shard: the batch on the
    data axes where it divides; on the model axis the heads where they
    divide, else q's sequence (q_pos alike, K/V whole), else nothing.
    K/V are expanded to the query heads first, so that a device's query
    heads find their K/V heads in its shard."""
    b, sq, h, hd = q.shape
    hints = _HINTS.get()
    mesh = hints["mesh"] if hints is not None else q.device_mesh
    data = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in data)
    bd = (data if len(data) > 1 else data[0]) \
        if data and b % dsize == 0 else None
    msize = sizes.get("model", 1)
    heads = msize > 1 and h % msize == 0
    seq = msize > 1 and not heads and sq % msize == 0
    qs = P(bd, "model" if seq else None, "model" if heads else None, None)
    ks = P(bd, None, "model" if heads else None, None)
    ke, ve = _expand_kv(k, h), _expand_kv(v, h)
    pl = functools.partial(placements, mesh=mesh)
    return _on_shards(core, (q, ke, ve, like(q_pos, q)),
                      (pl(qs), pl(ks), pl(ks),
                       pl(P("model" if seq else None))),
                      pl(qs), q.shape)


def _flash(q, k, v, q_pos, *, causal: bool, kv_block: int):
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    nblk = -(-sk // kv_block)
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
    s = einsum("bhd,bshd->bhs", qf, ke.float())
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < kv_len
    s = s.masked_fill(like(~mask[:, None, :], s), NEG)
    p = torch.softmax(s, dim=-1)
    out = einsum("bhs,bshd->bhd", p, ve.float())
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


def _on_head_dim(w: torch.Tensor, q: torch.Tensor, src: torch.Tensor
                 ) -> torch.Tensor:
    """The (d, KV, hd) K or V weight `w` where it meets q's head_dim
    shard: on each mesh dim where q (B, S, H, hd) is sharded on head_dim
    and `w` and the K/V source are replicated (KV heads that do not divide
    the model axis), `w`'s local slice of head_dim, taken without a
    collective; so k and v come out on the head_dim shard that q, the KV
    cache and the attention products hold, as the reference partitions
    them, instead of whole on every device.  `w` itself elsewhere."""
    if not isinstance(q, DTensor):
        return w
    want = tuple(Shard(2) if pq == Shard(3) and isinstance(pw, Replicate)
                 and isinstance(ps, Replicate) else pw
                 for pq, pw, ps in zip(q.placements, w.placements,
                                       src.placements))
    return w if want == tuple(w.placements) else \
        w.redistribute(w.device_mesh, want)


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
    q = einsum("bsd,dhk->bshk", x, p.wq)
    k = einsum("bsd,dhk->bshk", src, _on_head_dim(p.wk, q, src))
    v = einsum("bsd,dhk->bshk", src, _on_head_dim(p.wv, q, src))
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
    y = einsum("bshk,hkd->bsd", out, p.wo)
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
    h = F.silu(matmul(x, p.wg)) * matmul(x, p.wi)
    return matmul(h, p.wo)


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
    x = constrain_batch(x)   # sorts/scatters below defeat propagation
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    c = int(max(1, math.ceil(s * k / e * cfg.moe_capacity)))
    xe, buf_slot, tok, keep, g = _batch_local(
        functools.partial(_moe_dispatch, e=e, k=k, c=c), (x,),
        (p.router,))
    h = F.silu(einsum("becd,edf->becf", xe, p.wg)) * \
        einsum("becd,edf->becf", xe, p.wi)
    ye = einsum("becf,efd->becd", h, p.wo).reshape(b, e * c, d)
    out = _batch_local(functools.partial(_moe_combine, s=s),
                       (ye, buf_slot, tok, keep, g))
    return constrain_batch(out)


def _moe_dispatch(x: torch.Tensor, router: torch.Tensor, *, e: int, k: int,
                  c: int):
    """Route each sequence's tokens: the (B, E, C, D) expert buffers, and
    for each (token, choice) pair in expert order its buffer slot (E*C:
    the drop bin), token, whether it was kept and its gate."""
    b, s, d = x.shape
    dev = x.device
    logits = x.float() @ router                                 # (B, S, E)
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
    g = torch.gather(gates.reshape(b, s * k), 1, order)
    return xe, buf_slot, tok, keep, g


def _moe_combine(ye: torch.Tensor, buf_slot: torch.Tensor, tok: torch.Tensor,
                 keep: torch.Tensor, g: torch.Tensor, *, s: int
                 ) -> torch.Tensor:
    """The experts' (B, E*C, D) outputs gathered back to their (B, S, D)
    tokens, each pair weighted by its gate (a dropped pair adds 0)."""
    b, _, d = ye.shape
    dev = ye.device
    ye = torch.cat([ye, torch.zeros((b, 1, d), dtype=ye.dtype, device=dev)],
                   dim=1)
    rows = torch.arange(b, device=dev)[:, None]
    contrib = ye[rows, buf_slot] * g[..., None].to(ye.dtype) * \
        keep[..., None]
    out = torch.zeros((b * s, d), dtype=ye.dtype, device=dev)
    out.index_add_(0, (rows * s + tok).reshape(-1), contrib.reshape(-1, d))
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


def _mamba_split(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                 whole: bool = False):
    """in_proj's output split into z | xbc | dt; with `whole`, a fused dim
    sharded on the mesh is gathered first (its split does not fall on the
    shard boundaries)."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    zxbcdt = matmul(x, p.in_proj)
    if whole and isinstance(zxbcdt, DTensor):
        want = tuple(Replicate() if q == Shard(2) else q
                     for q in _settled(zxbcdt))
        if want != tuple(zxbcdt.placements):
            zxbcdt = zxbcdt.redistribute(zxbcdt.device_mesh, want)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, nh], dim=-1)
    return z, xbc, dt, d_in, n, nh


def _scan_on_heads(x: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether the chunked scan runs on shards of the SSM heads: a run on
    a mesh whose model axis divides them."""
    if not isinstance(x, DTensor):
        return False
    m = axis_sizes(_mesh_of(x)).get("model", 1)
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return m > 1 and nh % m == 0


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, kernel K.  state: (B, K-1, C) rolling window."""
    k = w.shape[0]
    if state is not None:
        ctx = torch.cat([state, xbc], dim=1)
        new_state = ctx[:, -(k - 1):, :] if k > 1 else state
    else:
        # zeros before the sequence (a concatenation, which DTensor
        # shards as the sequence is, where padding loses the placement)
        ctx = torch.cat([xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2])),
                         xbc], dim=1)
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
    decode = cache is not None and s == 1
    heads = not decode and _scan_on_heads(x, cfg)
    z, xbc, dt, d_in, n, nh = _mamba_split(p, cfg, x, whole=heads)
    hd = cfg.ssm_head_dim
    a = -torch.exp(p.A_log)                                   # (nh,)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B,S,nh)

    if decode:
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
        y = einsum("bhpn,bn->bhp", ssm_state, ct)[:, None]
    elif heads:
        y, ssm_state, conv_state = _ssd_on_heads(p, xbc, dt, a, d_in=d_in,
                                                 n=n, hd=hd, chunk=chunk)
        z = z.redistribute(z.device_mesh, y.placements)
    else:
        xbc_conv, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b)
        xs, bm, cm = torch.split(xbc_conv, [d_in, n, n], dim=-1)
        # per sequence, so on a mesh each batch shard scans its own (the
        # scan's cumulative sums have no sharding rule both ways)
        y, ssm_state = _batch_local(
            functools.partial(_ssd_batch, chunk=chunk),
            (xs.reshape(b, s, nh, hd).float(), dt, bm.float(), cm.float()),
            (a,))
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(ssm_state)
        new_cache = cache
    yf = y.reshape(b, s, d_in).to(x.dtype)
    out = rmsnorm(yf * F.silu(z), p.norm_w, cfg.norm_eps)
    return matmul(out, p.out_proj), new_cache


def _ssd_on_heads(p: Mamba2, xbc: DTensor, dt: DTensor, a: DTensor, *,
                  d_in: int, n: int, hd: int, chunk: int):
    """The conv and the chunked scan on each device's shard of the SSM
    heads (the model axis divides nh) and its batch shard.  B and C, which
    every head reads, are convolved whole on each device; their (L x L)
    chunk scores, shared by the heads, are computed on each device's rows
    of the chunk and gathered; x's channels, dt and A on the device's
    heads are convolved and scanned there.  Returns y (B, S, d_in) and the
    final SSM state (B, nh, hd, n), both sharded on the heads as the
    cache's spec shards the state, and the conv window (B, K-1, d_in +
    2n)."""
    mesh = _mesh_of(xbc)
    dm = xbc.device_mesh
    bd = _batch_axes(mesh, xbc.shape[0])
    pl = functools.partial(placements, mesh=mesh)
    heads, whole, rep = pl(P(bd, None, "model")), pl(P(bd)), pl(P())
    xs, bc = torch.split(xbc, [d_in, 2 * n], dim=-1)
    bc, bc_state = _on_shards(functools.partial(_conv_from, c0=d_in),
                              (bc, p.conv_w, p.conv_b), (whole, rep, rep),
                              whole)
    nc = -(-xbc.shape[1] // chunk)
    rows = pl(P(bd, None, "model", None)) \
        if chunk % axis_sizes(mesh)["model"] == 0 else whole
    shape = (xbc.shape[0], nc, chunk, chunk)
    local, first = compute_local_shape_and_global_offset(shape, dm, rows)
    scores = _on_shards(
        functools.partial(_chunk_scores, chunk=chunk,
                          rows=slice(first[2], first[2] + local[2])),
        (bc,), (whole,), rows, shape).redistribute(dm, whole)
    _, first = compute_local_shape_and_global_offset(a.shape, dm,
                                                     pl(P("model")))
    y, state, xs_state = _on_shards(
        functools.partial(_ssd_heads, hd=hd, c0=first[0] * hd, chunk=chunk),
        (xs, dt, p.conv_w, p.conv_b, a, bc, scores),
        (heads, heads, rep, rep, pl(P("model")), whole, whole),
        [heads, pl(P(bd, "model")), heads])
    conv_state = torch.cat([xs_state.redistribute(dm, whole), bc_state],
                           dim=-1)
    return y, state, conv_state


def _conv_from(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               c0: int):
    """`_causal_conv` of the channels from c0 on of the whole weight."""
    return _causal_conv(xbc, w[:, c0:], b[c0:])


def _chunk_scores(bc: torch.Tensor, *, chunk: int, rows: slice
                  ) -> torch.Tensor:
    """The `rows` of each chunk's (L x L) scores C_l . B_m from the
    convolved (B, S, 2n) B and C channels (`_ssd_chunked`'s, S padded to
    whole chunks)."""
    b, s, n2 = bc.shape
    nc = -(-s // chunk)
    if nc * chunk - s:
        bc = F.pad(bc, (0, 0, 0, nc * chunk - s))
    bm, cm = bc.float().reshape(b, nc, chunk, n2).split(n2 // 2, dim=-1)
    return torch.einsum("bcln,bcmn->bclm", cm[:, :, rows], bm)


def _ssd_heads(xs, dt, w, cb, a, bc, scores, *, hd: int, c0: int,
               chunk: int):
    """One device's conv and scan: xs (B, S, nh_l * hd) its channels from
    x's channel c0, dt (B, S, nh_l), a (nh_l,); w and cb the whole conv
    weight and bias, bc (B, S, 2n) the convolved B and C channels, scores
    their chunk scores."""
    b, s, c = xs.shape
    xs, xs_state = _causal_conv(xs, w[:, c0:c0 + c], cb[c0:c0 + c])
    bm, cm = torch.split(bc, [bc.shape[-1] // 2] * 2, dim=-1)
    y, state = _ssd_chunked(xs.reshape(b, s, c // hd, hd).float(), dt, a,
                            bm.float(), cm.float(), chunk, scores)
    return y.reshape(b, s, c), state, xs_state


def _ssd_batch(xh, dt, bm, cm, a, *, chunk: int):
    return _ssd_chunked(xh, dt, a, bm, cm, chunk)


def _ssd_chunked(xh, dt, a, bm, cm, chunk: int, scores=None):
    """State-space duality (Mamba-2): intra-chunk quadratic attention-like
    term + inter-chunk recurrent state passing.

    xh: (B,S,nh,hd) f32; dt: (B,S,nh); a: (nh,); bm/cm: (B,S,n); scores:
    the chunks' (B,nc,L,L) C.B products where computed already.
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
    if scores is None:
        scores = torch.einsum("bcln,bcmn->bclm", cc, bc)    # (B,nc,L,L)
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
