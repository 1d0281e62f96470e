"""The port's LM stack (`repro_torch.models.model`) against the JAX
reference's (`repro.models.model`) on the CPU, at `reduced()` sizes in
float32, with the reference's `init_params` weights carried over by
`convert.lm_params_from_jax`; and mirrors of tests/test_models.py's
decode and MoE-capacity tests on the port.

Tolerances: forward logits and the loss within rel 1e-4 of max |logit|
(every family: float32 sums in another order through a few layers);
decode against the full forward rel 2e-2, as tests/test_models.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREG
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import REGISTRY as TREG
from repro_torch.models import model as TM

ARCHS = sorted(TREG)
REL = 1e-4


def port_model(tcfg, jparams):
    """The port's LM for `tcfg` carrying the reference's weights."""
    lm = TM.LM(tcfg, dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(convert.lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams)))
    return lm


def pair(arch, **changes):
    """(reference config, port config, reference weights, port LM)."""
    jcfg = dataclasses.replace(JREG[arch].config.reduced(), **changes)
    tcfg = dataclasses.replace(TREG[arch].config.reduced(), **changes)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, tcfg, jparams, port_model(tcfg, jparams)


def inputs(cfg, b=2, s=16, seed=0):
    """Tokens and the modality input (vlm / encdec), numpy from a seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
    xkv = rng.standard_normal((b, xl, cfg.d_model)).astype(np.float32) \
        if xl else None
    return tokens, xkv


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_forward_matches_reference(arch):
    jcfg, tcfg, jparams, lm = pair(arch)
    tokens, xkv = inputs(tcfg)
    want, _ = JM.forward(jcfg, jparams, _j(tokens), xkv=_j(xkv))
    got, cache = TM.forward(tcfg, lm, _t(tokens), xkv=_t(xkv))
    assert cache is None
    assert got.shape == (2, 16, tcfg.vocab)
    assert rel_err(got, want) < REL, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_shapes_dtypes_and_scales(arch):
    """The port's random init at the default bf16 against the reference's
    `init_params`: the same leaves with the same shapes and dtypes (the
    router, A_log and dt_bias float32), constants equal and random leaves
    of the same scale; the reference's bf16 weights cross over bit for
    bit."""
    jcfg = JREG[arch].config.reduced()
    tcfg = TREG[arch].config.reduced()
    want = convert.lm_params_from_jax(tcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))))
    lm = TM.LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    got = lm.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), name
        wf, gf = w.float(), g.float()
        if name.endswith("A_log"):      # log(linspace(1, 16)) in float32
            torch.testing.assert_close(gf, wf, rtol=1e-6, atol=0)
        elif bool((wf == wf.flatten()[0]).all()):       # ones, zeros
            assert torch.equal(gf, wf), name
        else:                           # normal draws times the scale
            assert wf.numel() >= 256, name
            assert abs(float(gf.std()) / float(wf.std()) - 1) < 0.1, name
    lm.load_state_dict(want)
    for name, w in want.items():
        assert torch.equal(lm.state_dict()[name].view(torch.uint8),
                           w.view(torch.uint8)), name


def test_state_dict_layout():
    """Layer g * group_size + j holds the reference's pattern position j
    of group g (jamba: attention at j = 7, MoE at odd j)."""
    jcfg, tcfg, jparams, lm = pair("jamba-1.5-large-398b")
    g = tcfg.group_size
    assert g == 8 and len(lm.layers) == tcfg.layers
    for i, layer in enumerate(lm.layers):
        j = i % g
        assert (layer.attn is not None) == tcfg.is_attn_layer(j)
        assert (layer.moe is not None) == tcfg.is_moe_layer(j)
    want = np.asarray(jparams["groups"][7]["attn"]["wq"][0])
    np.testing.assert_array_equal(lm.layers[7].attn.wq.detach().numpy(),
                                  want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
@torch.no_grad()
def test_decode_matches_full_forward(arch):
    """tests/test_models.py's decode check on the port."""
    cfg = TREG[arch].config.reduced()
    lm = TM.LM(cfg, dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))
    b, s = 2, 24
    tokens, xkv = (_t(a) for a in inputs(cfg, b, s))
    enc_len = xkv.shape[1] if xkv is not None else 0
    cache = TM.init_cache(cfg, b, s + 2, dtype=torch.float32,
                          enc_len=enc_len, device="cpu")
    _, cache = TM.forward(cfg, lm, tokens, xkv=xkv, cache=cache)
    assert cache["pos"] == s
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, 1)))
    lg_dec, _ = TM.forward(cfg, lm, nxt, cache=cache)
    lg_full, _ = TM.forward(cfg, lm, torch.cat([tokens.long(), nxt], 1),
                            xkv=xkv)
    err = rel_err(lg_dec[:, 0], lg_full[:, -1])
    assert err < 2e-2, f"{arch}: decode mismatch {err}"


@torch.no_grad()
def test_moe_routing_is_capacity_bounded():
    """Token drops beyond capacity: sane output, no NaN, and the
    reference's logits (its drops are the port's)."""
    jcfg, tcfg, jparams, lm = pair("granite-moe-1b-a400m",
                                   moe_capacity=0.5)
    tokens, _ = inputs(tcfg, 2, 16, seed=1)
    got, _ = TM.forward(tcfg, lm, _t(tokens))
    assert bool(torch.isfinite(got).all())
    want, _ = JM.forward(jcfg, jparams, _j(tokens))
    assert rel_err(got, want) < REL


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
@torch.no_grad()
def test_loss_matches_reference(arch):
    jcfg, tcfg, jparams, lm = pair(arch)
    tokens, xkv = inputs(tcfg, seed=2)
    labels = np.roll(tokens, -1, axis=1)
    want = float(JM.loss_fn(jcfg, jparams, _j(tokens), _j(labels),
                            xkv=_j(xkv)))
    got = TM.loss_fn(tcfg, lm, _t(tokens), _t(labels), xkv=_t(xkv))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= REL * abs(want)


@torch.no_grad()
def test_bf16_default_serves():
    """The modules default to bf16 (the router, A_log, dt_bias and the ssm
    state float32, as the reference's): a prefill into a bf16 cache and a
    decode step of the hybrid family stay finite, in bf16."""
    cfg = TREG["jamba-1.5-large-398b"].config.reduced()
    lm = TM.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert lm.embed.dtype == torch.bfloat16
    assert lm.layers[1].moe.router.dtype == torch.float32
    tokens, _ = inputs(cfg, 2, 8)
    cache = TM.init_cache(cfg, 2, 9, device="cpu")
    _, cache = lm(_t(tokens), cache=cache)
    logits, _ = lm(_t(tokens[:, :1]), cache=cache)
    assert logits.dtype == torch.bfloat16
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_init_rejects_a_layer_count_off_the_pattern():
    cfg = dataclasses.replace(TREG["jamba-1.5-large-398b"].config.reduced(),
                              layers=12)
    with pytest.raises(ValueError, match="pattern period 8"):
        TM.LM(cfg, device="cpu", generator=torch.Generator())


def test_no_library_attention():
    """Attention is the reference's einsums, written out: no fused or
    library attention anywhere in the model zoo, the serving path or the
    training path."""
    from pathlib import Path
    root = Path(TM.__file__).resolve().parents[1]
    files = [*(root / "models").glob("*.py"),
             root / "training" / "train_step.py",
             root / "training" / "optimizer.py",
             root / "launch" / "serve.py",
             root / "launch" / "train.py"]
    for path in files:
        text = path.read_text()
        for name in ("scaled_dot_product_attention", "MultiheadAttention",
                     "multi_head_attention_forward", "flash_attn",
                     "torch.nn.attention"):
            assert name not in text, f"{path.name}: {name}"
