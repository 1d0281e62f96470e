"""The port's training substrate against the JAX reference's on the CPU:
the data stream (`training/data.py`), fault tolerance
(`distributed/fault_tolerance.py`), AdamW (`training/optimizer.py`),
checkpoints (`training/checkpoint.py`), the train step's accumulation
and remat, and the slice as a whole (`launch/train.py`,
`examples/train_lm.py`).

Tolerances: the data stream and the fault-tolerance bookkeeping exactly;
AdamW on identical float32 parameters and gradients rtol 1e-6, atol 1e-7
over 5 steps (the same float32 operations per element; the global norm
sums its leaves in another order), its bfloat16 moments bit for bit
without clipping and within 1 ulp with it;
checkpoints bit for bit, in both directions; the train step as in
tests/test_torch_train_step.py; a resumed, fault-injected run of
`launch.train.main` loss for loss at rel 1e-4 (rel 1e-5 at step 0:
float32 sums in another order, amplified by Adam over 12 steps).
"""
import ast
import dataclasses
import json
import os
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft
from repro.fleet.faults import FaultInjector
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro.training.data import SyntheticLM as JData
from repro_torch import convert
from repro_torch.configs import REGISTRY as TREG
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.examples import train_lm
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.data import SyntheticLM as TData
from test_torch_train_step import (JREG, batches, check_metrics,
                                   check_params, lr_sum, one_torch_thread,
                                   pair, port_state, run_port, run_ref)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seed,step,b,s,xkv", [
    (101, 7, 12, 4, 32, None), (512, 0, 0, 2, 16, (16, 128)),
    (151936, 3, 99, 8, 128, None), (51866, 1, 5, 2, 16, (32, 128))])
def test_synthetic_data_matches_reference_byte_for_byte(vocab, seed, step,
                                                        b, s, xkv):
    want = JData(vocab=vocab, seed=seed).batch(step, b, s, xkv)
    got = TData(vocab=vocab, seed=seed).batch(step, b, s, xkv)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert (got[key].dtype, got[key].shape) == (w.dtype, w.shape), key
        assert got[key].tobytes() == w.tobytes(), key
    shifted = TData(vocab=vocab, seed=seed).with_seed(seed + 1)
    assert shifted == TData(vocab=vocab, seed=seed + 1)
    assert shifted.batch(step, b, s)["tokens"].tobytes() == \
        JData(vocab=vocab, seed=seed + 1).batch(step, b, s)["tokens"] \
        .tobytes()


# -------------------------------------------------------- fault tolerance
def test_watchdog_flags_what_the_reference_flags():
    durations = np.random.default_rng(0).uniform(0.9, 1.1, 80)
    durations[[3, 7, 20, 21, 55, 79]] = [9.0, 4.0, 3.5, 2.5, 30.0, 3.05]
    seen = {"j": [], "t": []}
    j = jft.StepWatchdog(on_straggler=lambda *a: seen["j"].append(a))
    t = tft.StepWatchdog(on_straggler=lambda *a: seen["t"].append(a))
    flags = [(j.observe(i, d), t.observe(i, d))
             for i, d in enumerate(durations)]
    assert all(a == b for a, b in flags)
    assert sum(a for a, _ in flags) == j.stragglers == t.stragglers >= 3
    assert seen["j"] == seen["t"] and t.history == j.history


def test_failure_injector_traces_match_reference():
    trace = FaultInjector(num_pods=8, seed=3).trace(30) + \
        jft.FailureInjector(fail_at=(9, 4, 9)).to_trace()
    j = jft.FailureInjector.from_trace(trace)
    t = tft.FailureInjector.from_trace(trace)
    assert t.fail_at == j.fail_at and 4 in t.fail_at and 9 in t.fail_at
    assert t.to_trace() == j.to_trace()
    assert tft.FailureInjector(fail_at=(9, 4, 9)).to_trace() == \
        jft.FailureInjector(fail_at=(9, 4, 9)).to_trace()
    for inj in (j, t):
        with pytest.raises(RuntimeError, match="injected failure at step 4"):
            inj.maybe_fail(4)
        inj.maybe_fail(4)     # once each
        inj.maybe_fail(5)


@pytest.mark.parametrize("fail_at,steps,every", [
    ((7,), 10, 5), ((2, 3, 11), 14, 4), ((0,), 3, 50), ((1, 2, 4, 6), 8, 3)])
def test_run_resilient_matches_reference(fail_at, steps, every):
    """The same steps run, checkpoints saved, restores, restarts and final
    step; and the same error once max_restarts is exceeded.  (No
    watchdog: its straggler count reads the wall clock of microsecond
    steps.)"""
    def drive(mod):
        log, saved = [], []
        inj = mod.FailureInjector(fail_at=fail_at)

        def do_step(step):
            inj.maybe_fail(step)
            log.append(step)
            return {"loss": float(step)}

        def restore():
            return saved[-1] if saved else 0

        try:
            out = mod.run_resilient(steps, do_step, saved.append, restore,
                                    ckpt_every=every)
        except RuntimeError as exc:
            out = str(exc)
        return out, log, saved

    assert drive(tft) == drive(jft)


# -------------------------------------------------------------- optimizer
def _ref_params(arch):
    jcfg = JREG[arch].config.reduced()
    return jcfg, TREG[arch].config.reduced(), jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32))


def _grads(jparams, rng, scale):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), jparams)


def _run_adamw(arch, steps, scale, zero=(), bf16=False, **changes):
    """`steps` AdamW steps of both packages from the reference's weights
    on the same random gradients, the moments in bfloat16 with `bf16`;
    the port's parameters as a name -> tensor mapping, its gradients for
    the names in `zero` None where the reference's are zeros.  Returns
    (port params, port state, the reference's params and moments by the
    port's names).

    The reference's update runs jitted, as its train step runs it, but
    op by op with bfloat16 moments: XLA's fused float32 arithmetic rounds
    a few moments differently in their last bit, which rounding to
    bfloat16 can turn into one bfloat16 ulp, and a later step's
    cancellation into several."""
    jcfg, tcfg, jp = _ref_params(arch)
    jo = jopt.AdamWConfig(**changes, **(
        {"state_dtype": jnp.bfloat16} if bf16 else {}))
    to = topt.AdamWConfig(**changes, **(
        {"state_dtype": torch.bfloat16} if bf16 else {}))
    tp = convert.lm_params_from_jax(tcfg, jp)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts_ = jopt.init_state(jp, jo), topt.init_state(tp, to)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = _grads(jp, rng, scale)
        tg = convert.lm_params_from_jax(tcfg, g)
        for name in zero:
            tg[name] = None
        if zero:
            g = convert.lm_params_to_jax(tcfg, {
                n: torch.zeros_like(tp[n]) if v is None else v
                for n, v in tg.items()})
        update = jopt.apply_updates if bf16 else jax.jit(
            jopt.apply_updates, static_argnums=3)
        jp, js = update(jp, jax.tree.map(jnp.asarray, g), js, jo)
        ts_ = topt.apply_updates(tp, tg, ts_, to)
    want = {"params": convert.lm_params_from_jax(tcfg, jax.tree.map(
        np.asarray, jp))}
    want.update({k: convert.lm_params_from_jax(tcfg, jax.tree.map(
        np.asarray, js[k])) for k in ("m", "v")})
    assert int(ts_["step"]) == int(js["step"]) == steps
    return tp, ts_, want


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference_on_identical_gradients(clip):
    """5 steps on mamba2-130m's reduced weights (every kind of leaf of the
    decay rule: stacked norms, conv_b, dt_bias, A_log, the untied head),
    gradients of norm ~30 so that clipping at 1.0 acts."""
    tp, ts_, want = _run_adamw("mamba2-130m", 5, 0.1, grad_clip=clip,
                               lr=1e-2, warmup_steps=2)
    for name, p in tp.items():
        torch.testing.assert_close(p, want["params"][name], rtol=1e-6,
                                   atol=1e-7, msg=name)
        for k in ("m", "v"):
            torch.testing.assert_close(ts_[k][name], want[k][name],
                                       rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_bf16_moments_match_reference(clip):
    """bfloat16 moments (float32 parameters), 5 steps.  Without clipping
    every moment is bit for bit the reference's and the parameters agree
    as in float32.  With clipping the scale g * clip / |g| carries the
    global norm's other summation order into the last bit of the float32
    moments, so a few of them round to the other neighbouring bfloat16:
    within 1 ulp (6 of 853,504 elements at this seed), and the parameters
    within lr_sum * 2^-7 (the update of a 1-ulp moment moves by at most
    that share)."""
    tp, ts_, want = _run_adamw("qwen3-0.6b", 5, 0.1, bf16=True, lr=1e-2,
                               warmup_steps=2, grad_clip=clip)
    ulps = 1 if clip else 0
    for k in ("m", "v"):
        for name, t in ts_[k].items():
            assert t.dtype == torch.bfloat16
            d = t.view(torch.int16).int() - want[k][name].view(torch.int16) \
                .int()
            assert int(d.abs().max()) <= ulps, (k, name)
    bound = lr_sum(topt.AdamWConfig(lr=1e-2, warmup_steps=2), 5) * 2.0 ** -7
    for name, p in tp.items():
        assert p.dtype == torch.float32
        if clip:
            assert float((p - want["params"][name]).abs().max()) <= bound
        else:
            torch.testing.assert_close(p, want["params"][name], rtol=1e-6,
                                       atol=1e-7, msg=name)


def test_zero_gradient_decays_layers_not_final_ln():
    """The reference decays its stacked per-layer leaves (ndim >= 2), the
    1-D norms of every layer among them, but not the top-level final_ln:
    one step with zero gradients shrinks a layer's ln1 by lr * wd and
    leaves final_ln at 1, in both packages."""
    tp, _, want = _run_adamw("qwen3-0.6b", 1, 0.0, lr=1e-2, warmup_steps=1)
    for name in ("layers.0.ln1", "layers.1.ln2", "layers.1.attn.qn"):
        shrunk = torch.full_like(tp[name], 1.0 - 1e-2 * 0.1)
        torch.testing.assert_close(tp[name], shrunk, rtol=0, atol=1e-7)
        torch.testing.assert_close(want["params"][name], shrunk, rtol=0,
                                   atol=1e-7)
    assert torch.equal(tp["final_ln"], torch.ones_like(tp["final_ln"]))
    assert torch.equal(want["params"]["final_ln"], tp["final_ln"])


def test_none_gradient_updates_as_the_reference_zero():
    """mamba2-130m's ln2 reaches no loss (d_ff = 0): autograd gives None,
    the reference a zero cotangent.  A None gradient updates as zeros:
    still decayed, its moments staying 0."""
    zero = ("layers.0.ln2", "layers.1.ln2")
    tp, ts_, want = _run_adamw("mamba2-130m", 3, 0.1, zero=zero, lr=1e-2,
                               warmup_steps=2)
    for name in zero:
        torch.testing.assert_close(tp[name], want["params"][name],
                                   rtol=1e-6, atol=1e-7)
        assert float(tp[name].max()) < 1.0
        assert not bool(ts_["m"][name].any()) and \
            not bool(ts_["v"][name].any())


def test_adamw_minimizes_quadratic():
    """tests/test_training.py's quadratic on the port."""
    ocfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = topt.init_state(params, ocfg)
    for _ in range(200):
        state = topt.apply_updates(params, {"w": 2 * params["w"]}, state,
                                   ocfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_updates_moments_in_place_and_takes_the_norm():
    """The moments are written in place, as the reference's jitted step
    donates its state: the returned m and v are the tensors it was
    given.  A norm passed in gives what the update computes itself."""
    ocfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1,
                            state_dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    make = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in (("layers.0.ln1", (8,)), ("w", (4, 8)))}
    grads = {n: torch.from_numpy(rng.standard_normal(v.shape)
                                 .astype(np.float32) * 10)
             for n, v in make.items()}
    runs = []
    for norm in (None, topt.global_norm(grads)):
        params = {n: torch.from_numpy(v.copy()) for n, v in make.items()}
        state = topt.init_state(params, ocfg)
        m, v = dict(state["m"]), dict(state["v"])
        for _ in range(3):
            state = topt.apply_updates(params, grads, state, ocfg,
                                       grad_norm=norm)
        assert all(state["m"][n] is m[n] and state["v"][n] is v[n]
                   for n in params)
        assert int(state["step"]) == 3 and bool(m["w"].any())
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for n in make:
        assert torch.equal(p1[n], p2[n])
        assert torch.equal(s1["m"][n], s2["m"][n])
        assert torch.equal(s1["v"][n], s2["v"][n])


def test_no_library_optimizer():
    """The port writes AdamW out: no source file imports or names
    torch.optim."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 30
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Attribute):
                names = [f"{getattr(node.value, 'id', '')}.{node.attr}"]
            else:
                continue
            bad += [f"{path.name}:{node.lineno}" for n in names
                    if n == "torch.optim" or n.startswith("torch.optim.")]
    assert not bad, bad


# -------------------------------------------------- accumulation and remat
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_accumulation_and_remat_match_reference(arch):
    """One step of batch 8 without clipping, accum_steps=4 with remat,
    against the reference's accum_steps=4 with remat (the train-step
    tolerances); then the port alone: accum_steps=1 against 4 (the
    reference test's limits: loss rel 1e-4, parameters max abs 5e-3), and
    remat against none at accum_steps=4 (the recomputed forward gives the
    same loss and gradients: rel 1e-6)."""
    jcfg, tcfg, jo, to, jstate, tstate = pair(arch, grad_clip=0.0)
    bs = batches(tcfg, 1, b=8, seed=2)
    one, plain = port_state(tcfg, jstate), port_state(tcfg, jstate)
    jstate, want = run_ref(jcfg, jo, jstate, bs, accum_steps=4, remat=True)
    tstate, got = run_port(tcfg, to, tstate, bs, accum_steps=4, remat=True)
    check_metrics(got, want, arch)
    check_params(tcfg, tstate, jstate, lr_sum(to, 1))
    got_sd = tstate["params"].state_dict()

    one, m1 = run_port(tcfg, to, one, bs, accum_steps=1, remat=False)
    assert m1[0]["loss"] == pytest.approx(got[0]["loss"], rel=1e-4)
    for name, p in one["params"].state_dict().items():
        assert float((p - got_sd[name]).abs().max()) < 5e-3, name

    plain, m0 = run_port(tcfg, to, plain, bs, accum_steps=4, remat=False)
    assert m0[0]["loss"] == pytest.approx(got[0]["loss"], rel=1e-6)
    assert m0[0]["grad_norm"] == pytest.approx(got[0]["grad_norm"],
                                               rel=1e-6)
    for name, p in plain["params"].state_dict().items():
        torch.testing.assert_close(got_sd[name], p, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ checkpoints
def _moments_filled(tcfg, tstate, seed=0):
    """`tstate` with random moments and step 7 (the init's are zeros)."""
    g = torch.Generator().manual_seed(seed)
    for key in ("m", "v"):
        tstate["opt"][key] = {
            n: torch.randn(t.shape, generator=g).abs().to(t.dtype)
            for n, t in tstate["opt"][key].items()}
    tstate["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    return tstate


def _assert_tree_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_port_checkpoint_restores_in_reference(arch, tmp_path):
    jcfg, tcfg, _, _, jstate, tstate = pair(arch)
    tstate = _moments_filled(tcfg, tstate)
    path = tckpt.save(str(tmp_path), 7, tstate, extra={"note": "hi"})
    restored, step, extra = jckpt.restore(path, jstate)
    assert step == 7 and extra == {"note": "hi"}
    _assert_tree_equal(restored, convert.train_state_to_jax(tcfg, tstate))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_reference_checkpoint_restores_in_port(arch, tmp_path):
    jcfg, tcfg, _, _, jstate, template = pair(arch)
    want = _moments_filled(tcfg, port_state(tcfg, jstate), seed=1)
    jtree = jax.tree.map(jnp.asarray, convert.train_state_to_jax(tcfg, want))
    path = jckpt.save(str(tmp_path), 7, jtree, extra={"note": "hi"})
    got, step, extra = tckpt.restore(path, template)
    assert step == 7 and extra == {"note": "hi"}
    _assert_tree_equal(convert.train_state_to_jax(tcfg, got),
                       convert.train_state_to_jax(tcfg, want))
    assert got["params"] is not template["params"]
    assert got["opt"]["step"].dtype == torch.int32


def test_bf16_checkpoints_are_the_reference_files(tmp_path):
    """A bfloat16 train state (bf16 weights and moments): the port writes
    the reference's files byte for byte (2-byte words under descr '<V2',
    manifest dtype "bfloat16") and restores the reference's checkpoint
    bit for bit.  The reference's own restore cannot read a bfloat16 leaf
    back (numpy has no cast from V2 to ml_dtypes' bfloat16), for its own
    checkpoint as for the port's."""
    jcfg = JREG["qwen3-0.6b"].config.reduced()
    tcfg = TREG["qwen3-0.6b"].config.reduced()
    jstate = jts.init_train_state(jcfg, jopt.AdamWConfig(
        state_dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstate["opt"]["m"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16),
        jstate["opt"]["m"])
    sd = convert.train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate))
    lm = convert_lm(tcfg, sd["params"])
    tstate = {"params": lm, "opt": sd["opt"]}
    jpath = jckpt.save(str(tmp_path / "ref"), 3, jstate)
    tpath = tckpt.save(str(tmp_path / "port"), 3, tstate)
    names = sorted(os.listdir(jpath))
    assert names == sorted(os.listdir(tpath))
    for name in names:
        if name != "manifest.json":
            assert (Path(jpath) / name).read_bytes() == \
                (Path(tpath) / name).read_bytes(), name
    jm, tm = (json.loads((Path(p) / "manifest.json").read_text())
              for p in (jpath, tpath))
    assert jm["leaves"] == tm["leaves"]
    assert tm["leaves"]["params/embed"]["dtype"] == "bfloat16"
    emb = np.load(Path(tpath) / "params_embed.npy").view(ml_dtypes.bfloat16)
    assert emb.tobytes() == np.asarray(jstate["params"]["embed"]).tobytes()
    got, step, _ = tckpt.restore(jpath, tstate)
    assert step == 3
    _assert_tree_equal(convert.train_state_to_jax(tcfg, got),
                       convert.train_state_to_jax(tcfg, tstate))
    for path in (jpath, tpath):
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore(path, jstate)


def convert_lm(tcfg, state_dict):
    """The port's bfloat16 LM holding `state_dict`."""
    lm = TM.LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(state_dict)
    return lm


def test_restore_casts_to_the_template_and_places_on_device(tmp_path):
    """A float32 checkpoint restored into a bfloat16 template comes back
    in bfloat16 (the reference's astype: round to nearest even), on the
    device asked for, in a new module; the template is untouched."""
    _, tcfg, _, _, _, tstate = pair("qwen3-0.6b")
    path = tckpt.save(str(tmp_path), 1, tstate)
    template = {"params": tstate["params"].to(torch.bfloat16),
                "opt": {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                            if k != "step" else v)
                        for k, v in tstate["opt"].items()}}
    before = {n: p.clone() for n, p in template["params"].state_dict()
              .items()}
    saved = np.load(Path(path) / "params_embed.npy")
    got, step, _ = tckpt.restore(path, template, device="cpu")
    assert got["params"].embed.dtype == torch.bfloat16
    assert torch.equal(got["params"].embed,
                       torch.from_numpy(saved).to(torch.bfloat16))
    assert got["opt"]["m"]["embed"].dtype == torch.bfloat16
    for n, p in template["params"].state_dict().items():
        assert torch.equal(p, before[n]), n


def test_restore_with_shardings_on_one_device(tmp_path):
    """The elastic restore (tests/test_training.py::
    test_checkpoint_elastic_restore_with_shardings) on a one-device mesh:
    every leaf placed by its sharding comes back a plain tensor on the
    mesh's device, equal to the saved one."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    _, tcfg, _, _, _, tstate = pair("qwen3-0.6b")
    path = tckpt.save(str(tmp_path), 1, tstate)
    mesh = make_host_mesh(1, "cpu")
    sh = shd.named(shd.tree_specs(tstate, mesh, "state", cfg=tcfg), mesh)
    got, step, _ = tckpt.restore(path, tstate, shardings=sh)
    assert step == 1
    want = dict(tstate["params"].named_parameters())
    for n, p in got["params"].named_parameters():
        assert not isinstance(p, DTensor) and p.device.type == "cpu"
        assert torch.equal(p, want[n]), n
    for k in ("m", "v"):
        for n, t in got["opt"][k].items():
            assert not isinstance(t, DTensor)
            assert torch.equal(t, tstate["opt"][k][n]), (k, n)
    assert torch.equal(got["opt"]["step"], tstate["opt"]["step"])


def test_train_main_mesh_path_equals_the_plain_step(capsys):
    """With a process group (a world of one rank, as `torchrun
    --nproc-per-node 1` gives), `launch.train.main` places its state and
    batches on a one-device mesh (--model-parallel 1, or 4 clamped to the
    one rank): its losses and final parameters equal a plain loop of the
    same step from the same seed, bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    make_host_mesh(1, "cpu")
    argv = ["--arch", "qwen3-0.6b", "--reduce", "--steps", "3",
            "--batch", "2", "--seq", "8", "--log-every", "100",
            "--device", "cpu"]
    runs = [ttrain.main(argv + ["--model-parallel", mp]) for mp in "14"]
    cfg = TREG["qwen3-0.6b"].config.reduced()
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=5)
    state = tts.init_train_state(cfg, ocfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    step = tts.make_train_step(cfg, ocfg, remat=False)
    data = TData(vocab=cfg.vocab, seed=0)
    losses = []
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in
                 data.batch(i, 2, 8).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    want = dict(state["params"].named_parameters())
    for out in runs:
        assert out["losses"] == losses
        for n, p in out["state"]["params"].named_parameters():
            assert torch.equal(p, want[n]), n


def test_latest_missing_leaf_and_shape_mismatch(tmp_path):
    """`latest` skips a `.tmp` directory; a leaf the checkpoint lacks is a
    KeyError, one of another shape a ValueError (the reference's errors)."""
    _, tcfg, _, _, _, tstate = pair("qwen3-0.6b")
    assert tckpt.latest(str(tmp_path / "none")) is None
    path = tckpt.save(str(tmp_path), 2, tstate)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tckpt.latest(str(tmp_path)) == path == jckpt.latest(str(tmp_path))
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    del manifest["leaves"]["opt/v/groups/[0]/attn/wq"]
    broken = tmp_path / "broken"
    shutil.copytree(path, broken)
    (broken / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(KeyError, match="opt/v/groups/\\[0\\]/attn/wq"):
        tckpt.restore(str(broken), tstate)
    wider = dataclasses.replace(tcfg, vocab=tcfg.vocab + 1)
    other = {"params": TM.LM(wider, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(0))}
    other["opt"] = topt.init_state(other["params"], topt.AdamWConfig())
    with pytest.raises(ValueError, match="shape mismatch for params/embed"):
        tckpt.restore(path, other)


# --------------------------------------------------- the slice as a whole
ARGS = ["--arch", "qwen3-0.6b", "--resume", "--reduce", "--steps", "12",
        "--batch", "2", "--seq", "16", "--ckpt-every", "5",
        "--simulate-failure", "7", "--log-every", "1"]
STEP_LINE = re.compile(r"^\[train\] step +(\d+) loss ([-\d.]+) gnorm")


def test_resumed_fault_injected_run_matches_reference(tmp_path, monkeypatch,
                                                      capsys):
    """The reference's init_train_state saved as a step-0 checkpoint; its
    `launch.train.main` and the port's, each resuming from its own copy,
    with a failure at step 7 (restored from step 5): one restart each,
    the same steps printed, the same losses."""
    jcfg = JREG["qwen3-0.6b"].config.reduced()
    jstate = jts.init_train_state(jcfg, jopt.AdamWConfig(),
                                  jax.random.PRNGKey(0), dtype=jnp.float32)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jckpt.save(str(ref_dir), 0, jstate)
    shutil.copytree(ref_dir, port_dir)

    ref_losses = []
    real = jtrain.run_resilient

    def spy(num_steps, do_step, *a, **k):
        def record(step):
            out = do_step(step)
            ref_losses.append(out["loss"])
            return out
        return real(num_steps, record, *a, **k)

    monkeypatch.setattr(jtrain, "run_resilient", spy)
    monkeypatch.setattr(sys, "argv", ["train", *ARGS, "--ckpt-dir",
                                      str(ref_dir)])
    jtrain.main()
    ref_out = capsys.readouterr().out
    out = ttrain.main([*ARGS, "--ckpt-dir", str(port_dir), "--device", "cpu"])
    port_out = capsys.readouterr().out

    assert out["restarts"] == 1 and out["steps"] == 12
    assert out["plan"] is None
    assert "(1 restarts, " in ref_out and "(1 restarts, " in port_out
    ref_lines = [STEP_LINE.match(x) for x in ref_out.splitlines()]
    port_lines = [STEP_LINE.match(x) for x in port_out.splitlines()]
    ref_steps = [(int(m[1]), float(m[2])) for m in ref_lines if m]
    port_steps = [(int(m[1]), float(m[2])) for m in port_lines if m]
    assert [s for s, _ in port_steps] == [s for s, _ in ref_steps] == \
        [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10, 11]
    for (step, got), (_, want) in zip(port_steps, ref_steps):
        assert got == pytest.approx(want, rel=1e-4), step
    assert len(out["losses"]) == len(ref_losses) == 14
    for i, (got, want) in enumerate(zip(out["losses"], ref_losses)):
        assert got == pytest.approx(want, rel=1e-5 if i == 0 else 1e-4), i
    # replays equal their first run (the same batches on the CPU)
    assert out["losses"][7:9] == out["losses"][5:7]
    for text in (ref_out, port_out):
        assert "[train] resumed from " in text and " at step 0" in text
        assert re.search(r"\[train\] restored .*step_00000005 -> step 5",
                         text)
    assert out["first"] == pytest.approx(np.mean(out["losses"][:10]))
    assert out["last"] == pytest.approx(np.mean(out["losses"][-10:]))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    assert train_lm.main(["--quick", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[topo] delta-fast" in out
    assert "[train] done: 60 steps" in out and "WARNING" not in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000050",
                                            "step_00000060"]


def test_train_lm_default_ckpt_dir_is_fresh_per_run(monkeypatch):
    """Without --ckpt-dir each run checkpoints into a new, empty
    directory that is removed at its end: a second run does not find the
    first one's checkpoints."""
    seen = []

    def fake_main(cmd):
        d = Path(cmd[cmd.index("--ckpt-dir") + 1])
        seen.append((d, d.is_dir() and not any(d.iterdir())))
        (d / "step_00000050").mkdir()
        return {}

    monkeypatch.setattr(ttrain, "main", fake_main)
    for _ in range(2):
        assert train_lm.main(["--quick", "--device", "cpu"]) == 0
    (d1, empty1), (d2, empty2) = seen
    assert d1 != d2 and empty1 and empty2
    assert not d1.exists() and not d2.exists()


def test_plan_topology_matches_reference(capsys):
    """--plan-topology's DAG is the reference's array for array, and the
    three methods print the reference's NCTs and ports (the GA on the
    CPU; the seconds aside)."""
    from repro.configs import REGISTRY as JARCH, make_job as jmake_job
    from repro.core.schedule import build_comm_dag as jbuild
    from test_torch_configs import assert_same_arrays, dag_arrays
    arch = JARCH["qwen3-0.6b"]
    want = jbuild(jmake_job(arch, seq_len=128, microbatches=min(
        arch.plan.num_microbatches, 2 * arch.plan.pp)))
    assert_same_arrays(dag_arrays(ttrain.topology_dag("qwen3-0.6b", 128)),
                       dag_arrays(want))
    jtrain.plan_topology("qwen3-0.6b", 128)
    ref = capsys.readouterr().out
    res = ttrain.plan_topology("qwen3-0.6b", 128, "cpu")
    port = capsys.readouterr().out

    def lines(text):
        return [re.sub(r" \([0-9.]+s\)$", "", x) for x in text.splitlines()
                if x.startswith("[topo]")]
    assert lines(port) == lines(ref) and len(lines(ref)) == 4
    assert list(res) == ["prop-alloc", "iter-halve", "delta-fast"]
    assert all(r.feasible for r in res.values())


def test_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--reduce", "--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_lm.main(["--quick"])
