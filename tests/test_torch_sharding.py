"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's (`repro.distributed.sharding`): for the ten registry
architectures, reduced and at full size, the specs of the parameters, the
train state, the cache and the batch on the 16 x 16, 2 x 16 x 16 and
1 x 1 meshes, leaf for leaf (the reference's stack dim dropped); the
FSDP switch; `assign`'s divisibility fallback; the sharding hints'
identity without a mesh; and `named`/`place` on a one-device mesh, which
leave plain tensors.  Shapes only: the port's trees are built on `meta`
and the reference's through `jax.eval_shape`."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.distributed import sharding as jax_shd
from repro.models import model as jax_M
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import convert
from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
BATCH, SEQ, ENC = 32, 64, 48


def _ref_flat(specs) -> dict[str, tuple]:
    """The reference's spec tree as {"groups/[0]/attn/wq": entries}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        parts = []
        for p in path:
            if hasattr(p, "key"):
                parts.append(str(p.key))
            else:
                parts.append(f"[{p.idx}]")
        out["/".join(parts)] = tuple(spec)
    return out


def _unstacked(spec: tuple) -> tuple:
    """A stacked leaf's spec without its stack dim (never sharded)."""
    assert not spec or spec[0] is None, spec
    return spec[1:]


def _check_params(port: dict, ref: dict, cfg, prefix: str = "") -> int:
    """Every port spec against the reference leaf's; returns the count."""
    layout = convert.ref_leaves(cfg, port)
    n = 0
    for path, names in layout.items():
        want = ref[prefix + path]
        if isinstance(names, str):
            assert tuple(port[names]) == want, (path, port[names], want)
            n += 1
            continue
        for name in names:
            assert tuple(port[name]) == _unstacked(want), \
                (name, port[name], want)
            n += 1
    assert len(layout) == len([k for k in ref if k.startswith(prefix)
                               and not k.endswith("step")])
    return n


def _configs(arch: str):
    return (("reduced", REGISTRY[arch].config.reduced(),
             JAX_REGISTRY[arch].config.reduced()),
            ("full", REGISTRY[arch].config, JAX_REGISTRY[arch].config))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_equal_reference(arch):
    for size, cfg, jcfg in _configs(arch):
        lm = M.LM(cfg, device="meta", generator=None)
        state = {"params": lm, "opt": opt.init_state(lm, opt.AdamWConfig())}
        jparams = jax.eval_shape(
            lambda c=jcfg: jax_M.init_params(c, jax.random.PRNGKey(0)))
        jstate = jax.eval_shape(
            lambda c=jcfg: jax_ts.init_train_state(
                c, jax_opt.AdamWConfig(), jax.random.PRNGKey(0)))
        xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
        cache = M.init_cache(cfg, BATCH, SEQ, enc_len=xl, device="meta")
        jcache = jax.eval_shape(
            lambda c=jcfg: jax_M.init_cache(c, BATCH, SEQ, enc_len=xl))
        batch = {"tokens": torch.empty((BATCH, SEQ), dtype=torch.int32,
                                       device="meta"),
                 "xkv": torch.empty((BATCH, ENC, cfg.d_model),
                                    device="meta")}
        jbatch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
                  "xkv": jax.ShapeDtypeStruct((BATCH, ENC, cfg.d_model),
                                              jnp.float32)}
        for mname, (sizes, axes) in MESHES.items():
            mesh, jmesh = AbstractMesh(sizes, axes), JaxAbstractMesh(sizes,
                                                                     axes)
            tag = (arch, size, mname)
            got = shd.tree_specs(lm, mesh, "params", cfg=cfg)
            want = _ref_flat(jax_shd.tree_specs(jparams, jmesh, "params",
                                                cfg=jcfg))
            assert _check_params(got, want, cfg) == len(got), tag

            got = shd.tree_specs(state, mesh, "state", cfg=cfg)
            want = _ref_flat(jax_shd.tree_specs(jstate, jmesh, "state",
                                                cfg=jcfg))
            _check_params(got["params"], want, cfg, "params/")
            _check_params(got["opt"]["m"], want, cfg, "opt/m/")
            _check_params(got["opt"]["v"], want, cfg, "opt/v/")
            assert tuple(got["opt"]["step"]) == want["opt/step"] == ()

            got = shd.tree_specs(cache, mesh, "cache")
            want = _ref_flat(jax_shd.tree_specs(jcache, jmesh, "cache"))
            assert tuple(got["pos"]) == want["pos"], tag
            if xl:
                assert tuple(got["enc"]) == want["enc"], tag
            g = cfg.group_size
            for i, layer in enumerate(got["layers"]):
                for leaf, spec in layer.items():
                    assert tuple(spec) == _unstacked(
                        want[f"layers/[{i % g}]/{leaf}"]), (tag, i, leaf)

            got = shd.tree_specs(batch, mesh, "batch")
            want = _ref_flat(jax_shd.tree_specs(jbatch, jmesh, "batch"))
            assert {k: tuple(v) for k, v in got.items()} == want, tag


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_fsdp_switch_is_the_reference(arch):
    cfg, jcfg = REGISTRY[arch].config, JAX_REGISTRY[arch].config
    on = cfg.total_params() > shd.FSDP_THRESHOLD
    assert on == (jcfg.total_params() > jax_shd.FSDP_THRESHOLD)
    # forced on, the data-axis rules agree too (reduced: every arch)
    small, jsmall = cfg.reduced(), jcfg.reduced()
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    jmesh = JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    lm = M.LM(small, device="meta", generator=None)
    jparams = jax.eval_shape(
        lambda: jax_M.init_params(jsmall, jax.random.PRNGKey(0)))
    got = shd.tree_specs(lm, mesh, "params", fsdp=True)
    want = _ref_flat(jax_shd.tree_specs(jparams, jmesh, "params",
                                        fsdp=True))
    _check_params(got, want, small)


def test_assign_divisibility_fallback():
    one = AbstractMesh((1, 1), ("data", "model"))
    assert shd.assign((7, 13), one, [(("model",), [0, 1])]) == \
        shd.P(None, None)  # size-1 axis -> nothing to shard
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    jmesh = JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for shape, rules in (((7, 32), [(("model",), [0, 1])]),
                         ((8, 16), [(("model",), [0, 1])]),
                         ((64, 48), [(("pod", "data"), [1, 0]),
                                     (("model",), [0, 1])]),
                         ((3, 5, 16), [(("model",), [2, 1, 0])])):
        assert tuple(shd.assign(shape, mesh, rules)) == \
            tuple(jax_shd.assign(shape, jmesh, rules)), (shape, rules)


def test_hints_are_identities_without_a_mesh():
    x = torch.randn(4, 8, 2, 3)
    assert L.constrain_batch(x) is x
    assert L.constrain_batch(x, boundary=True) is x
    assert L._seq_shard(x) is x
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with L.sharding_hints(mesh, ("data",), seq_shard=True,
                          seq_parallel=True):
        # a plain tensor: nothing to redistribute
        assert L.constrain_batch(x, boundary=True) is x
        assert L._seq_shard(x) is x
    assert L.attention_hints is L.sharding_hints


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    single = AbstractMesh((16, 16), ("data", "model"))
    assert shd.placements(shd.P("data", None, "model"), single) == \
        (Shard(0), Shard(2))
    assert shd.placements(shd.P(None, ("data",)), single) == \
        (Shard(1), Replicate())
    assert shd.placements(shd.P(), single) == (Replicate(), Replicate())
    multi = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), "model"), multi) == \
        (Shard(0), Shard(0), Shard(1))


def test_named_on_one_device_places_plain_tensors():
    """A 1 x 1 mesh (a world-size-1 gloo group): every placement is the
    identity, and the state's tensors stay plain and unmoved."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, "cpu")          # clamped to the one rank
    assert shd.axis_sizes(mesh) == {"data": 1, "model": 1}
    cfg = REGISTRY["qwen3-0.6b"].config.reduced()
    state = ts.init_train_state(cfg, opt.AdamWConfig(), device="cpu",
                                generator=torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    before = {n: p for n, p in state["params"].named_parameters()}
    placed = shd.place(state, shd.named(
        shd.tree_specs(state, mesh, "state", cfg=cfg), mesh))
    assert placed["params"] is state["params"]
    for n, p in placed["params"].named_parameters():
        assert p is before[n] and not isinstance(p, DTensor)
    for n, t in placed["opt"]["m"].items():
        assert t is state["opt"]["m"][n]
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    placed = shd.place(cache, shd.named(shd.tree_specs(cache, mesh,
                                                       "cache"), mesh))
    assert placed["pos"] == 0
    assert all(not isinstance(t, DTensor) for layer in placed["layers"]
               for t in layer.values())
