"""The port's model-zoo primitives (`repro_torch.models.layers`) against
the JAX reference's (`repro.models.layers`) on the CPU, in float32.

The same inputs, made with numpy from a seed, and the same weights (the
reference's init functions, carried over by `load_state_dict`) go
through both.  Tolerance: rtol 1e-5 / atol 1e-5 for every primitive
(float32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREG
from repro.models import layers as JL
from repro_torch.configs import REGISTRY as TREG
from repro_torch.models import layers as TL

RTOL = ATOL = 1e-5


def _cfgs(arch, **changes):
    """The reduced config of `arch` in both packages."""
    return (dataclasses.replace(JREG[arch].config.reduced(), **changes),
            dataclasses.replace(TREG[arch].config.reduced(), **changes))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _module(cls, tcfg, ref_params, **kw):
    """A port module carrying the reference's weights."""
    m = cls(tcfg, dtype=torch.float32, device="cpu",
            generator=torch.Generator().manual_seed(0), **kw)
    m.load_state_dict({k: _t(v) for k, v in ref_params.items()})
    return m


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _close(TL.rmsnorm(_t(x), _t(w), 1e-6),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 12, 4, 32)
    pos = np.arange(5, 17)
    if batched:
        pos = np.stack([pos, pos + 30])
    _close(TL.rope(_t(x), _t(pos), 1e6),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0),
                                             (True, 7)])
def test_dense_attention(causal, q_offset):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 9, 4, 16), _rand(rng, 2, 16, 2, 16), \
        _rand(rng, 2, 16, 2, 16)
    _close(TL.dense_attention(_t(q), _t(k), _t(v), causal, q_offset),
           JL.dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, q_offset))


@pytest.mark.parametrize("causal,sq,sk,q_offset", [
    (False, 8, 40, 0), (True, 40, 40, 0), (True, 8, 40, 32),
    (True, 5, 37, 20)])
def test_flash_attention_against_flash_and_dense(causal, sq, sk, q_offset):
    """Sk not a multiple of the block (padded last block), with and
    without a causal offset: the reference's flash and its dense."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, sq, 4, 16), _rand(rng, 2, sk, 2, 16), \
        _rand(rng, 2, sk, 2, 16)
    got = TL.flash_attention(_t(q), _t(k), _t(v), causal, q_offset,
                             kv_block=16)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, JL.flash_attention(jq, jk, jv, causal, q_offset,
                                   kv_block=16))
    _close(got, JL.dense_attention(jq, jk, jv, causal, q_offset))


def test_decode_attention_on_a_padded_cache():
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 3, 1, 4, 16), _rand(rng, 3, 20, 2, 16), \
        _rand(rng, 3, 20, 2, 16)
    _close(TL.decode_attention(_t(q), _t(k), _t(v), 13),
           JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 13))


@pytest.mark.parametrize("arch,cross", [("qwen3-0.6b", False),
                                        ("qwen2.5-14b", False),
                                        ("whisper-large-v3", True)])
def test_attention_block(arch, cross):
    """qk-norm (qwen3), qkv bias (qwen2.5) and a cross-attention without
    RoPE (whisper), with their init's shapes."""
    jcfg, tcfg = _cfgs(arch)
    p = JL.init_attention(jax.random.PRNGKey(5), jcfg, cross=cross,
                          dtype=jnp.float32)
    if "bq" in p:   # the init's zeros would hide a bias mistake
        p = {**p, "bq": p["bq"] + 0.1, "bk": p["bk"] - 0.2,
             "bv": p["bv"] + 0.3}
    m = _module(TL.Attention, tcfg, p, cross=cross)
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 10, tcfg.d_model)
    src = _rand(rng, 2, 12, tcfg.d_model) if cross else None
    pos = np.arange(10)
    want, _ = JL.attention_block(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=not cross,
        kv_source=None if src is None else jnp.asarray(src))
    got, _ = TL.attention_block(m, tcfg, _t(x), _t(pos), causal=not cross,
                                kv_source=None if src is None else _t(src))
    _close(got, want)


def test_swiglu():
    jcfg, tcfg = _cfgs("yi-6b")
    p = JL.init_mlp(jax.random.PRNGKey(6), jcfg, dtype=jnp.float32)
    x = _rand(np.random.default_rng(6), 2, 7, tcfg.d_model)
    _close(TL.swiglu(_module(TL.SwiGLU, tcfg, p), _t(x)),
           JL.swiglu(p, jnp.asarray(x)))


@pytest.mark.parametrize("capacity", [None, 0.5])
def test_moe_block(capacity):
    """At the reduced config's capacity (no drops) and at 0.5, where
    tokens past an expert's capacity drop: the stable sort decides which,
    in token order as the reference's."""
    changes = {} if capacity is None else {"moe_capacity": capacity}
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", **changes)
    p = JL.init_moe(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    b, s = 3, 16
    x = _rand(np.random.default_rng(7), b, s, tcfg.d_model)
    m = _module(TL.MoE, tcfg, p)
    _close(TL.moe_block(m, tcfg, _t(x)), JL.moe_block(p, jcfg,
                                                      jnp.asarray(x)))
    # what each expert receives per sequence, against its capacity
    e, k = tcfg.moe_experts, tcfg.moe_top_k
    c = int(max(1, np.ceil(s * k / e * tcfg.moe_capacity)))
    idx = torch.topk(torch.softmax(_t(x) @ m.router, -1), k, -1).indices
    counts = torch.stack([torch.bincount(i.reshape(-1), minlength=e)
                          for i in idx])
    assert (int(counts.max()) > c) == (capacity is not None)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(8)
    xbc, w, bias = _rand(rng, 2, 9, 24), _rand(rng, 4, 24), _rand(rng, 24)
    state = _rand(rng, 2, 3, 24) if with_state else None
    got, got_state = TL._causal_conv(_t(xbc), _t(w), _t(bias),
                                     None if state is None else _t(state))
    want, want_state = JL._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
        None if state is None else jnp.asarray(state))
    _close(got, want)
    _close(got_state, want_state)


@pytest.mark.parametrize("s", [24, 128, 130])
def test_ssd_chunked(s):
    """One short chunk, exactly one chunk, and two chunks with a padded
    tail: y and the final state."""
    rng = np.random.default_rng(9 + s)
    b, nh, hd, n = 2, 4, 8, 16
    xh = _rand(rng, b, s, nh, hd)
    dt = np.log1p(np.exp(_rand(rng, b, s, nh))).astype(np.float32) * 0.1
    a = -np.exp(np.log(np.linspace(1.0, 16.0, nh))).astype(np.float32)
    bm, cm = _rand(rng, b, s, n), _rand(rng, b, s, n)
    y, state = TL._ssd_chunked(_t(xh), _t(dt), _t(a), _t(bm), _t(cm), 128)
    want_y, want_state = JL._ssd_chunked(
        jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm), 128)
    assert y.shape == (b, s, nh, hd)
    _close(y, want_y)
    _close(state, want_state)


def test_mamba_block_prefill_and_decode():
    """A prefill that fills the cache, then three recurrent steps: outputs
    and the conv and ssm states each step."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    p = JL.init_mamba(jax.random.PRNGKey(10), jcfg, dtype=jnp.float32)
    p = {**p, "dt_bias": p["dt_bias"] + 0.5}
    m = _module(TL.Mamba2, tcfg, p)
    d_in = tcfg.ssm_expand * tcfg.d_model
    nh, b = d_in // tcfg.ssm_head_dim, 2
    conv = (b, tcfg.ssm_conv - 1, d_in + 2 * tcfg.ssm_state)
    ssm = (b, nh, tcfg.ssm_head_dim, tcfg.ssm_state)
    jcache = {"conv": jnp.zeros(conv), "ssm": jnp.zeros(ssm)}
    tcache = {"conv": torch.zeros(conv), "ssm": torch.zeros(ssm)}
    rng = np.random.default_rng(10)
    for s in (13, 1, 1, 1):
        x = _rand(rng, b, s, tcfg.d_model)
        want, jcache = JL.mamba_block(p, jcfg, jnp.asarray(x), cache=jcache)
        got, tcache = TL.mamba_block(m, tcfg, _t(x), cache=tcache)
        _close(got, want)
        _close(tcache["conv"], jcache["conv"])
        _close(tcache["ssm"], jcache["ssm"])
    # without a cache: the chunked scan alone, no cache back
    x = _rand(rng, b, 20, tcfg.d_model)
    got, none = TL.mamba_block(m, tcfg, _t(x))
    assert none is None
    _close(got, JL.mamba_block(p, jcfg, jnp.asarray(x))[0])
