"""The port's training step (`repro_torch.training.train_step.
make_train_step`: autograd of the plain model, float32 accumulation,
per-layer remat, the port's AdamW) against the reference's
`jax.jit(repro.training.train_step.make_train_step)` on the CPU, at
`reduced()` sizes in float32, from the reference's `init_train_state`
carried over by `convert.train_state_from_jax`, on the reference's data
stream (batch 2, seq 16).

Tolerances: the loss within rel 1e-5 and the grad norm within rel 1e-4 at
every step (float32 sums in another order; the gradients agree to a few
1e-6 of each leaf's max |g|).  Parameters are not compared elementwise
at a tight tolerance: Adam's first steps update each element by about
lr * g / |g|, so a gradient near zero whose sign differs between two
summation orders moves that element by up to ~2 lr.  They must lie
within 2 x the sum of the steps' learning rates everywhere and within
0.05 x that sum on 99.9% of elements.  (Accumulation and remat against
the reference's are in tests/test_torch_training.py, which shares these
helpers.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREG
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import convert
from repro_torch.configs import REGISTRY as TREG
from repro_torch.models import model as TM
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.data import SyntheticLM

ARCHS = ["qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-130m",
         "jamba-1.5-large-398b", "whisper-large-v3", "llama-3.2-vision-11b"]
LOSS_REL, GNORM_REL = 1e-5, 1e-4
STEPS, B, S = 3, 2, 16
OCFG = dict(lr=1e-3, warmup_steps=5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: at these sizes the port's steps gain
    nothing from a thread pool, and one per worker oversubscribes the
    cores when the suite runs in several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xkv_len(cfg) -> int:
    return cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens


def pair(arch, **ocfg_changes):
    """(reference config, port config, reference AdamW config, port AdamW
    config, reference train state, port train state with its weights)."""
    jcfg = JREG[arch].config.reduced()
    tcfg = TREG[arch].config.reduced()
    jo = jopt.AdamWConfig(**OCFG, **ocfg_changes)
    to = topt.AdamWConfig(**OCFG, **ocfg_changes)
    jstate = ref_init(arch)
    return jcfg, tcfg, jo, to, jstate, port_state(tcfg, jstate)


@functools.lru_cache(maxsize=None)
def ref_init(arch):
    """The reference's float32 train state (float32 moments) of `arch`,
    reduced: its arrays are immutable, so the tests share one."""
    return jts.init_train_state(JREG[arch].config.reduced(),
                                jopt.AdamWConfig(), jax.random.PRNGKey(0),
                                dtype=jnp.float32)


def port_state(tcfg, jstate) -> dict:
    """The port's train state holding the reference's `jstate`."""
    sd = convert.train_state_from_jax(tcfg, jax.tree.map(np.asarray,
                                                         jstate))
    lm = TM.LM(tcfg, dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(sd["params"])
    return {"params": lm, "opt": sd["opt"]}


def batches(cfg, n, b=B, s=S, seed=0):
    """The data stream's batches 0..n-1 as numpy, with the modality input
    of a vlm / encdec model."""
    data = SyntheticLM(vocab=cfg.vocab, seed=seed)
    xl = _xkv_len(cfg)
    return [data.batch(i, b, s, (xl, cfg.d_model) if xl else None)
            for i in range(n)]


def run_ref(jcfg, jo, jstate, bs, **kw):
    step = jax.jit(jts.make_train_step(jcfg, jo, has_xkv="xkv" in bs[0],
                                       **kw))
    metrics = []
    for b in bs:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def run_port(tcfg, to, tstate, bs, **kw):
    step = tts.make_train_step(tcfg, to, has_xkv="xkv" in bs[0], **kw)
    metrics = []
    for b in bs:
        tstate, m = step(tstate, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return tstate, metrics


def lr_sum(ocfg, steps) -> float:
    return sum(ocfg.lr * min(t / max(ocfg.warmup_steps, 1), 1.0)
               for t in range(1, steps + 1))


def check_metrics(got, want, tag):
    for t, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == t + 1
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"]), \
            (tag, t, g["loss"], w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            GNORM_REL * abs(w["grad_norm"]), (tag, t, g, w)


def check_params(tcfg, tstate, jstate, bound):
    """Every parameter within 2 x `bound` and 99.9% of all elements within
    0.05 x `bound` of the reference's."""
    got = convert.lm_params_to_jax(tcfg, tstate["params"].state_dict())
    diffs = jax.tree.map(lambda a, b: np.abs(np.asarray(a) - np.asarray(b))
                         .ravel(), got, jax.tree.map(np.asarray,
                                                     jstate["params"]))
    flat = np.concatenate(jax.tree.leaves(diffs))
    assert flat.max() <= 2 * bound, flat.max() / bound
    assert np.mean(flat <= 0.05 * bound) >= 0.999, \
        np.mean(flat <= 0.05 * bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jcfg, tcfg, jo, to, jstate, tstate = pair(arch)
    bs = batches(tcfg, STEPS)
    jstate, want = run_ref(jcfg, jo, jstate, bs, remat=False)
    tstate, got = run_port(tcfg, to, tstate, bs, remat=False)
    check_metrics(got, want, arch)
    check_params(tcfg, tstate, jstate, lr_sum(to, STEPS))
    assert int(tstate["opt"]["step"]) == STEPS
    assert tstate["opt"]["step"].dtype == torch.int32


def test_remat_recomputes_each_layer_under_autograd_only():
    """With remat the forward under autograd runs each layer through
    torch.utils.checkpoint (its saved tensors are the layer inputs); under
    no_grad, or with a cache, it runs them plainly, and the logits are the
    same."""
    cfg = TREG["qwen3-0.6b"].config.reduced()
    lm = TM.LM(cfg, dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(batches(cfg, 1)[0]["tokens"])
    calls = []
    orig = TM.checkpoint

    def spy(*a, **k):
        calls.append(k.get("use_reentrant"))
        return orig(*a, **k)

    TM.checkpoint = spy
    try:
        with_remat, _ = TM.forward(cfg, lm, tokens, remat=True)
        assert calls == [False] * cfg.layers
        with torch.no_grad():
            no_grad, _ = TM.forward(cfg, lm, tokens, remat=True)
        assert len(calls) == cfg.layers
    finally:
        TM.checkpoint = orig
    plain, _ = TM.forward(cfg, lm, tokens)
    torch.testing.assert_close(with_remat, plain, rtol=0, atol=0)
    torch.testing.assert_close(no_grad, plain, rtol=0, atol=0)


def test_init_train_state_has_the_reference_layout():
    """The default bfloat16 train state: the reference's leaves with its
    shapes and dtypes (float32 router, A_log, dt_bias), zero moments in
    the state dtype, step 0 (int32) on the parameters' device."""
    jcfg = JREG["jamba-1.5-large-398b"].config.reduced()
    tcfg = TREG["jamba-1.5-large-398b"].config.reduced()
    want = jax.eval_shape(lambda k: jts.init_train_state(
        jcfg, jopt.AdamWConfig(state_dtype=jnp.bfloat16), k),
        jax.random.PRNGKey(0))
    to = topt.AdamWConfig(state_dtype=torch.bfloat16)
    tstate = tts.init_train_state(tcfg, to, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    got = convert.train_state_to_jax(tcfg, tstate)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        # bfloat16 crosses as 2-byte words
        assert g.dtype == (np.dtype("V2") if w.dtype == jnp.bfloat16
                           else w.dtype), (g.dtype, w.dtype)
    for key in ("m", "v"):
        for t in tstate["opt"][key].values():
            assert t.dtype == torch.bfloat16 and not bool(t.any())
    step = tstate["opt"]["step"]
    assert step.shape == () and step.dtype == torch.int32 and int(step) == 0
