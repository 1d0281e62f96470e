"""The benchmark's plain reference against the port, on the CPU.

At gpt-7b's width (Table I's profiling example, 4 pods) and a cut
megatron-177b: the reference's float64 DES gives the port's numpy DES's
makespan and communication time exactly, its Alg. 2 the port's X̄, and
the port's float32 torch DES lies within float32 reach of it; the lower
precisions finish and move the makespan by about their resolution.
"""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from harness.check import Judge, rel_gap  # noqa: E402
from harness.job import raw_dag  # noqa: E402
from reference.des import BFLOAT16, FLOAT32, to_bfloat16  # noqa: E402

JOBS = [("gpt-7b", 8), ("megatron-177b", 8)]


def _dag(arch: str, microbatches: int):
    from repro_torch.configs import ALL_ARCHS, make_job
    from repro_torch.core.schedule import build_comm_dag
    return build_comm_dag(make_job(ALL_ARCHS[arch], seq_len=4096,
                                   microbatches=microbatches), 400.0)


def _topologies(dag, k: int, seed: int) -> list[np.ndarray]:
    from repro_torch.core.ga import TopologySpace
    space = TopologySpace(dag)
    genomes = space.random_init_batch(np.random.default_rng(seed), k)
    return [space.to_matrix(g) for g in genomes]


@pytest.mark.parametrize("arch,microbatches", JOBS)
def test_reference_des_and_bound_equal_the_ports(arch, microbatches):
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.xbound import x_upper_bound
    dag = _dag(arch, microbatches)
    judge = Judge(raw_dag(dag))
    assert np.array_equal(judge.xbar, x_upper_bound(dag))
    problem = DESProblem(dag)
    ideal = simulate(problem, np.zeros_like(judge.xbar), ideal=True)
    assert judge.ideal.makespan == ideal.makespan
    assert judge.ideal.comm_time == ideal.comm_time
    for x in _topologies(dag, 6, 1):
        want, got = simulate(problem, x), judge.run(x)
        assert got.feasible and want.feasible
        assert got.makespan == want.makespan
        assert got.comm_time == want.comm_time


@pytest.mark.parametrize("arch,microbatches", JOBS)
def test_port_torch_des_within_float32_of_the_reference(arch, microbatches):
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import DESOptions, TorchDES
    from repro_torch.core.ga import TopologySpace
    torch.set_num_threads(1)
    dag = _dag(arch, microbatches)
    judge = Judge(raw_dag(dag))
    space = TopologySpace(dag)
    genomes = space.random_init_batch(np.random.default_rng(2), 8)
    des = TorchDES(DESProblem(dag), options=DESOptions(device="cpu"))
    ms, feas = des.batch_genome_makespan(genomes, space.edge_u, space.edge_v)
    for g, m, f in zip(genomes, ms, feas):
        ref = judge.run(space.to_matrix(g))
        assert bool(f) == ref.feasible
        assert rel_gap(float(m), ref.makespan) < 1e-5


def test_lower_precisions_finish_near_their_resolution():
    dag = _dag("megatron-177b", 8)
    judge = Judge(raw_dag(dag))
    gaps32, gaps16 = [], []
    for x in _topologies(dag, 4, 3):
        ref = judge.run(x)
        low32, low16 = judge.run(x, FLOAT32), judge.run(x, BFLOAT16)
        assert low32.feasible and low16.feasible
        gaps32.append(rel_gap(low32.makespan, ref.makespan))
        gaps16.append(rel_gap(low16.makespan, ref.makespan))
    assert 0 < max(gaps32) < 1e-4
    assert 1e-4 < max(gaps16) < 0.2


def test_bfloat16_rounds_to_nearest_even():
    one = np.float32(1.0)
    assert to_bfloat16(one) == 1.0
    assert to_bfloat16(one + np.float32(2.0 ** -8)) == 1.0      # a tie
    assert to_bfloat16(one + np.float32(3 * 2.0 ** -9)) == 1.0 + 2.0 ** -7
    assert to_bfloat16(np.float32(1.0 + 3 * 2.0 ** -8)) == 1.0 + 2.0 ** -6
    out = to_bfloat16(np.array([np.inf, -np.inf, 3.0], dtype=np.float32))
    assert out[0] == np.inf and out[1] == -np.inf and out[2] == 3.0
    assert np.isnan(to_bfloat16(np.float32(np.nan)))
