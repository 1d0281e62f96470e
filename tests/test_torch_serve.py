"""The port's serving path (`repro_torch.training.train_step`'s prefill
and decode steps, `repro_torch.launch.serve`, the serve_decode example)
against the JAX reference's on the CPU, at `reduced()` sizes in float32.

The reference's prefill step and 8 decode steps run jitted; the port's
take the reference's weights and, teacher-forced, the reference's
tokens.  Tolerance: logits each step within rel 1e-4 of max |logit|,
and every cache tensor at the end within rtol/atol 1e-4 (float32 sums in
another order, through the prompt and 8 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.training import train_step as jts
from repro_torch.launch import serve
from repro_torch.examples import serve_decode
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.training import train_step as tts
from test_torch_models import _t, inputs, pair, rel_err

REL = 1e-4
STEPS = 8


def _compare_caches(tcfg, tcache, jcache):
    g = tcfg.group_size
    assert tcache["pos"] == int(jcache["pos"])
    for j, stacked in enumerate(jcache["layers"]):
        for gi in range(tcfg.layers // g):
            for name, leaf in stacked.items():
                np.testing.assert_allclose(
                    tcache["layers"][gi * g + j][name].numpy(),
                    np.asarray(leaf[gi]), rtol=REL, atol=REL,
                    err_msg=f"layer {gi * g + j} {name}")
    if "enc" in jcache:
        np.testing.assert_allclose(tcache["enc"].numpy(),
                                   np.asarray(jcache["enc"]), rtol=REL,
                                   atol=REL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jparams, lm = pair(arch)
    b, s = 2, 12
    tokens, xkv = inputs(tcfg, b, s, seed=3)
    xl = xkv.shape[1] if xkv is not None else 0
    jcache = JM.init_cache(jcfg, b, s + STEPS, dtype=jnp.float32,
                           enc_len=xl)
    tcache = TM.init_cache(tcfg, b, s + STEPS, dtype=torch.float32,
                           enc_len=xl, device="cpu")
    has_xkv = xkv is not None
    jpre = jax.jit(jts.make_prefill_step(jcfg, has_xkv=has_xkv))
    jdec = jax.jit(jts.make_decode_step(jcfg))
    tpre = tts.make_prefill_step(tcfg, has_xkv=has_xkv)
    tdec = tts.make_decode_step(tcfg)

    want, jcache = jpre(jparams, jcache, jnp.asarray(tokens),
                        *([jnp.asarray(xkv)] if has_xkv else []))
    got, tcache = tpre(lm, tcache, _t(tokens), _t(xkv))
    assert got.shape == (b, 1, tcfg.vocab)
    assert rel_err(got, want) < REL, "prefill"
    tok = jnp.argmax(want[:, -1], axis=-1, keepdims=True).astype(jnp.int32)
    for step in range(STEPS):
        jnext, want, jcache = jdec(jparams, jcache, tok)
        tnext, got, tcache = tdec(lm, tcache, _t(tok))
        assert tnext.dtype == torch.int32 and tnext.shape == (b, 1)
        assert rel_err(got, want) < REL, f"decode step {step}"
        tok = jnext      # teacher-forced: the reference's tokens
    _compare_caches(tcfg, tcache, jcache)


def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", "granite-moe-1b-a400m", "--reduce",
                      "--batch", "2", "--prompt-len", "8",
                      "--decode-steps", "4", "--model-parallel", "4",
                      "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[serve] granite-moe-1b-a400m-smoke: "
                               "prefill 2x8 in ")
    assert "; decoded 8 tokens in " in lines[0]
    assert lines[0].endswith(" tok/s)")
    assert lines[1].startswith("[serve] sample token ids: [")
    assert out["tokens"].shape == (2, 5) and out["tokens"].dtype == \
        torch.int32
    assert lines[1] == f"[serve] sample token ids: " \
        f"{out['tokens'][0].tolist()}"
    assert bool(torch.isfinite(out["logits"]).all())
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    assert out["tok_per_s"] == pytest.approx(8 / out["decode_s"])
    cfg = serve.REGISTRY["granite-moe-1b-a400m"].config.reduced()
    # float32 weights; `total_params` leaves out the final norm's d
    assert out["param_bytes"] == 4 * (cfg.total_params() + cfg.d_model)


def test_serve_main_is_seeded(capsys):
    argv = ["--arch", "whisper-large-v3", "--reduce", "--batch", "2",
            "--prompt-len", "6", "--decode-steps", "3", "--device", "cpu"]
    a = serve.main(argv)
    b = serve.main(argv)
    c = serve.main(argv + ["--seed", "1"])
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["logits"], c["logits"])


def test_serve_main_mesh_path_equals_the_plain_steps(capsys):
    """With a process group (a world of one rank, as `torchrun
    --nproc-per-node 1` gives), `serve.main` places parameters, cache and
    inputs on a one-device mesh (--model-parallel 1, or 4 clamped to the
    one rank): its tokens and last logits equal the plain prefill and
    decode steps from the same seed, bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    make_host_mesh(1, "cpu")
    argv = ["--arch", "qwen3-0.6b", "--reduce", "--batch", "2",
            "--prompt-len", "6", "--decode-steps", "3", "--device", "cpu"]
    runs = [serve.main(argv + ["--model-parallel", mp]) for mp in "14"]
    cfg = serve.REGISTRY["qwen3-0.6b"].config.reduced()
    params = TM.LM(cfg, dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    cache = TM.init_cache(cfg, 2, 9, dtype=torch.float32, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    logits, cache = tts.make_prefill_step(cfg)(params, cache, prompt)
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
    toks = [tok]
    decode = tts.make_decode_step(cfg)
    for _ in range(3):
        tok, logits, cache = decode(params, cache, tok)
        toks.append(tok)
    for out in runs:
        assert torch.equal(out["tokens"], torch.cat(toks, dim=1))
        assert torch.equal(out["logits"], logits)


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--reduce"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve_decode.main([])


def test_cache_overflow_raises_where_the_reference_clamps():
    """A write past the cache's length: the reference's
    `dynamic_update_slice` clamps its start and overwrites the last
    slots; the port raises."""
    jcfg, tcfg, jparams, lm = pair("qwen3-0.6b")
    b, max_len = 1, 6
    tokens, _ = inputs(tcfg, b, 4, seed=4)
    more, _ = inputs(tcfg, b, 3, seed=5)
    jcache = JM.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    _, jcache = JM.forward(jcfg, jparams, jnp.asarray(tokens), cache=jcache)
    k_before = np.asarray(jcache["layers"][0]["k"][0, 0])
    _, jcache = JM.forward(jcfg, jparams, jnp.asarray(more), cache=jcache)
    k_after = np.asarray(jcache["layers"][0]["k"][0, 0])
    # clamped to start 3: slot 3 of the prompt's K overwritten, pos past
    assert int(jcache["pos"]) == 7
    np.testing.assert_array_equal(k_after[:3], k_before[:3])
    assert not np.allclose(k_after[3], k_before[3])

    tcache = TM.init_cache(tcfg, b, max_len, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        _, tcache = TM.forward(tcfg, lm, _t(tokens), cache=tcache)
        with pytest.raises(ValueError, match="KV cache overflow"):
            TM.forward(tcfg, lm, _t(more), cache=tcache)
        step = tts.make_decode_step(tcfg)
        tcache = TM.init_cache(tcfg, b, 4, dtype=torch.float32,
                               device="cpu")
        _, tcache = TM.forward(tcfg, lm, _t(tokens), cache=tcache)
        with pytest.raises(ValueError, match="writing 1 positions at 4"):
            step(lm, tcache, _t(more[:, :1]))


def test_flash_prefill_attends_within_its_own_call():
    """A prefill into a cache attends only to its own K/V (the reference's
    "cache starts empty"): its logits equal a cache-less forward's."""
    _, tcfg, _, lm = pair("qwen3-0.6b")
    tokens, _ = inputs(tcfg, 2, 10, seed=6)
    cache = TM.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, _ = TM.forward(tcfg, lm, _t(tokens), cache=cache)
        want, _ = TM.forward(tcfg, lm, _t(tokens))
    assert rel_err(got, want) < REL
    assert TL.DENSE_ATTN_MAX_KV == 8192


def test_eval_step_matches_loss(capsys):
    _, tcfg, _, lm = pair("mamba2-130m")
    tokens, _ = inputs(tcfg, seed=7)
    batch = {"tokens": _t(tokens), "labels": _t(np.roll(tokens, -1, 1))}
    got = tts.make_forward_loss(tcfg)(lm, batch)
    assert not got.requires_grad
    with torch.no_grad():
        want = TM.loss_fn(tcfg, lm, batch["tokens"], batch["labels"])
    assert float(got) == float(want)


def test_serve_decode_example_returns_zero(capsys):
    assert serve_decode.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("+ python -m repro_torch.launch.serve --arch "
                             "qwen3-0.6b --reduce --batch 4 --prompt-len 64"
                             " --decode-steps 32")
    assert out[1].startswith("[serve] qwen3-0.6b-smoke: prefill 4x64 in ")
    assert out[2].startswith("[serve] sample token ids: ")
