"""The port's int8 ring all-reduce (`repro_torch.distributed.compression`)
against the reference's: the reference's ring on 4 fake XLA devices
(tests/test_distributed.py's case: seed 0, x of (4, 1000)) and the port's
on 4 gloo ranks, both in processes of their own, get the same x.  Totals
and residuals agree within 1 ulp and meet the reference test's bounds;
`mean_grads_int8` over two steps with error feedback likewise."""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STEPS_SHAPE = (2, 4, 10, 30)        # steps, ranks, gradient shape

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compression import (mean_grads_int8,
                                               ring_allreduce_int8)
    mesh = jax.make_mesh((4,), ("data",))
    x = np.load(sys.argv[2])
    g = np.load(sys.argv[3])

    def ring(v):
        total, res = ring_allreduce_int8(v.reshape(-1), "data")
        return total[None], res[None]

    def two_steps(g1, g2):
        m1, r1 = mean_grads_int8({"w": g1[0]}, "data")
        m2, r2 = mean_grads_int8({"w": g2[0]}, "data", r1)
        return m1["w"][None], r1["w"][None], m2["w"][None], r2["w"][None]

    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map
    total, res = jax.jit(shard_map(ring, mesh=mesh, in_specs=P("data"),
                                   out_specs=P("data")))(jnp.asarray(x))
    steps = jax.jit(shard_map(two_steps, mesh=mesh,
                              in_specs=(P("data"), P("data")),
                              out_specs=P("data")))(jnp.asarray(g[0]),
                                                    jnp.asarray(g[1]))
    np.savez(sys.argv[1], total=np.asarray(total), res=np.asarray(res),
             **{k: np.asarray(v) for k, v in zip(("m1", "r1", "m2", "r2"),
                                                 steps)})
""")

_PORT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, out, xfile, gfile, store):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=4)
        from repro_torch.distributed.compression import (
            mean_grads_int8, ring_allreduce_int8)
        x = torch.from_numpy(np.load(xfile)[rank])
        g = np.load(gfile)
        total, res = ring_allreduce_int8(x)
        m1, r1 = mean_grads_int8({"w": torch.from_numpy(g[0, rank])})
        m2, r2 = mean_grads_int8({"w": torch.from_numpy(g[1, rank])},
                                 residual=r1)
        np.savez(f"{out}.{rank}.npz", total=total.numpy(), res=res.numpy(),
                 m1=m1["w"].numpy(), r1=r1["w"].numpy(),
                 m2=m2["w"].numpy(), r2=r2["w"].numpy())
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=tuple(sys.argv[1:5]), nprocs=4)
""")


def _run(code: str, script: Path, *args: str) -> None:
    """`code` as a script of its own (spawned ranks import it by path)."""
    import os
    script.write_text(code)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(script), *args],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=240, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return int(np.abs(ia - ib).max())


def _residual_ulps(got: np.ndarray, want: np.ndarray, x: np.ndarray) -> float:
    """The residual x - q * scale is a difference of two nearly equal
    float32 numbers whose roundings XLA chooses per compiled program (in
    the ring alone it contracts the product and the difference into one
    fused multiply-subtract): the two packages' residuals differ by units
    in the last place of x, not of the small residual.  So the distance
    in units of x's last place."""
    return float((np.abs(got - want) / np.spacing(np.abs(x))).max())


def test_int8_ring_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1000)).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(STEPS_SHAPE) \
        .astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "g.npy", g)
    files = (str(tmp_path / "x.npy"), str(tmp_path / "g.npy"))
    _run(_REF, tmp_path / "ref_ring.py", str(tmp_path / "ref.npz"), *files)
    _run(_PORT, tmp_path / "port_ring.py", str(tmp_path / "port"), *files,
         str(tmp_path / "store"))
    ref = np.load(tmp_path / "ref.npz")
    port = [np.load(tmp_path / f"port.{r}.npz") for r in range(4)]

    total = np.stack([p["total"] for p in port])
    res = np.stack([p["res"] for p in port])
    assert _ulps(total, ref["total"]) <= 1
    assert _residual_ulps(res, ref["res"], x) <= 1
    # the reference test's bounds (tests/test_distributed.py)
    exact = x.sum(axis=0)
    scale = np.abs(x).max() * 4 / 127
    err = np.abs(total - exact[None]).max()
    assert err <= 4 * scale + 1e-5, (err, scale)
    assert all(np.array_equal(total[0], total[r]) for r in range(4))
    assert np.abs(res).max() <= scale + 1e-6

    # two steps with error feedback: the second step reduces g2 + r1
    got = {k: np.stack([p[k] for p in port]) for k in ("m1", "r1", "m2",
                                                        "r2")}
    m1, r1, m2 = got["m1"], got["r1"], got["m2"]
    assert _ulps(m1, ref["m1"]) <= 1
    assert _ulps(m2, ref["m2"]) <= 1
    # in the reference's compiled mean_grads_int8 the scale and the
    # product round otherwise than in its ring alone: 2 units of the
    # reduced value's last place here, where the ring's residuals are
    # within 1
    assert _residual_ulps(r1, ref["r1"], g[0]) <= 2
    # the second step's residual is of g2 + r1: the difference in r1
    # carries into it, plus the rounding above
    fed = g[1] + ref["r1"]
    assert (np.abs(got["r2"] - ref["r2"]) <= np.abs(r1 - ref["r1"])
            + 2 * np.spacing(np.abs(fed))).all()
    for step, (mean, fed) in enumerate(((m1, g[0]), (m2, g[1] + r1))):
        s = np.abs(fed).max() * 4 / 127
        assert np.abs(mean - fed.mean(axis=0)[None]).max() <= \
            s + 1e-6, step
        assert all(np.array_equal(mean[0], mean[r]) for r in range(4))
