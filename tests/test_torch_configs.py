"""The port's architecture registry on the CPU against the JAX reference:
every `ALL_ARCHS` entry's `ArchSpec`, its `JobSpec` and its communication
DAG at a reduced microbatch count, `ModelConfig.reduced`, the shape
table and its skip rule; and the registry's MoE cases of
tests/test_moe_dag.py (EP traffic where ep > 1, none where ep == 1, and
delta-fast on granite-moe-1b-a400m at 4 microbatches).

Tolerances: specs, job fields and DAG arrays (tasks, deps, volumes, pods,
port limits) exact; the GA's topology exact from the same seed under a
generation cap (a wall-clock limit would let the two searches differ),
its makespan from each package's exact numpy DES on that topology
exact."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.core.ga as jax_ga
import repro.core.schedule as jax_schedule
import repro_torch.configs as port_configs
import repro_torch.core.ga as port_ga
import repro_torch.core.schedule as port_schedule
from repro_torch.core.des_torch import DESOptions

NAMES = sorted(jax_configs.ALL_ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the CPU DES's small ops oversubscribe
    the cores when the suite runs in several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dag_arrays(dag) -> dict:
    """A DAG as plain arrays: every task's fields, the deps, the volumes,
    the pods of each task and the cluster's port limits."""
    return {
        "tasks": [dataclasses.astuple(t) for t in dag.tasks],
        "deps": np.array([(d.pre, d.succ, d.delta) for d in dag.deps],
                         dtype=np.float64).reshape(-1, 3),
        "volumes": np.array([t.volume for t in dag.tasks]),
        "pods": np.array([(t.src_pod, t.dst_pod) for t in dag.tasks]),
        "port_limits": np.asarray(dag.cluster.port_limits),
        "num_pods": dag.cluster.num_pods,
        "cluster": dataclasses.asdict(dag.cluster),
    }


def assert_same_arrays(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_registry_names_match_reference():
    assert sorted(port_configs.ALL_ARCHS) == NAMES
    assert len(NAMES) == 15
    assert list(port_configs.REGISTRY) == list(jax_configs.REGISTRY)
    assert list(port_configs.PAPER_WORKLOADS) == \
        list(jax_configs.PAPER_WORKLOADS)
    assert port_configs.__all__ == jax_configs.__all__


@pytest.mark.parametrize("name", NAMES)
def test_arch_spec_matches_reference(name):
    port, ref = port_configs.ALL_ARCHS[name], jax_configs.ALL_ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    # the provenance strings, field by field
    assert (port.source, port.notes) == (ref.source, ref.notes)


@pytest.mark.parametrize("name", NAMES)
def test_job_spec_matches_reference(name):
    for kw in ({}, {"seq_len": 4096}, {"microbatches": 4}):
        ref = jax_configs.make_job(jax_configs.ALL_ARCHS[name], **kw)
        port = port_configs.make_job(port_configs.ALL_ARCHS[name], **kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), kw


@pytest.mark.parametrize("name", NAMES)
def test_comm_dag_matches_reference(name):
    ref = jax_schedule.build_comm_dag(jax_configs.make_job(
        jax_configs.ALL_ARCHS[name], microbatches=4))
    port = port_schedule.build_comm_dag(port_configs.make_job(
        port_configs.ALL_ARCHS[name], microbatches=4))
    assert_same_arrays(dag_arrays(ref), dag_arrays(port))
    assert port.summary() == ref.summary()


@pytest.mark.parametrize("name", sorted(jax_configs.REGISTRY))
def test_reduced_matches_reference(name):
    ref = jax_configs.REGISTRY[name].config.reduced()
    port = port_configs.REGISTRY[name].config.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.name == f"{name}-smoke"


def test_shapes_and_skip_rule_match_reference():
    assert {k: dataclasses.asdict(v)
            for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    from repro.configs.base import SUBQUADRATIC_FAMILIES as ref_sub
    from repro_torch.configs.base import SUBQUADRATIC_FAMILIES as port_sub
    assert port_sub == ref_sub
    skipped = 0
    for name in NAMES:
        for shape in jax_configs.SHAPES:
            want = jax_configs.shape_applicable(
                jax_configs.ALL_ARCHS[name].config,
                jax_configs.SHAPES[shape])
            got = port_configs.shape_applicable(
                port_configs.ALL_ARCHS[name].config,
                port_configs.SHAPES[shape])
            assert got == want, (name, shape)
            skipped += not got[0]
    assert skipped > 0          # the long_500k rule is exercised


# ------------------------------------------- tests/test_moe_dag.py mirrors
def test_registry_moe_workloads_emit_ep_traffic():
    """tests/test_moe_dag.py:86 in both packages."""
    for name in ("grok-1-314b", "jamba-1.5-large-398b",
                 "granite-moe-1b-a400m"):
        ref = jax_schedule.build_comm_dag(jax_configs.make_job(
            jax_configs.REGISTRY[name], microbatches=4))
        port = port_schedule.build_comm_dag(port_configs.make_job(
            port_configs.REGISTRY[name], microbatches=4))
        assert port.ep_volume_fraction() > 0
        assert port.ep_volume_fraction() == ref.ep_volume_fraction()


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_ep_a2a_task_tags_match_reference(name):
    """tests/test_moe_dag.py:66 in the port: each EP all-to-all task's tag
    names its stage, whose volume it carries, as the reference's does."""
    archs = {**port_configs.PAPER_WORKLOADS, **port_configs.REGISTRY}
    ref_archs = {**jax_configs.PAPER_WORKLOADS, **jax_configs.REGISTRY}
    job = port_configs.make_job(archs[name], microbatches=4)
    port = port_schedule.build_comm_dag(job)
    ref = jax_schedule.build_comm_dag(
        jax_configs.make_job(ref_archs[name], microbatches=4))
    assert [t.tag for t in port.tasks] == [t.tag for t in ref.tasks]
    ep = [t for t in port.real_tasks() if t.kind.startswith("ep_a2a")]
    assert ep
    for t in ep:
        assert t.volume == pytest.approx(job.ep_a2a_stage_volume(t.tag[2]))


def test_ep1_workloads_have_no_ep_tasks():
    """tests/test_moe_dag.py:109 in the port."""
    archs = {**port_configs.PAPER_WORKLOADS,
             **{n: port_configs.REGISTRY[n] for n in (
                 "yi-6b", "qwen2.5-14b", "phi3-mini-3.8b",
                 "whisper-large-v3")}}
    seen = 0
    for name, arch in archs.items():
        if arch.plan.ep != 1:
            continue
        dag = port_schedule.build_comm_dag(
            port_configs.make_job(arch, microbatches=4))
        assert not any(t.kind.startswith("ep_a2a")
                       for t in dag.real_tasks()), name
        assert dag.ep_volume_fraction() == 0.0
        seen += 1
    assert seen >= 4


def test_delta_fast_on_reduced_moe_job_matches_reference():
    """tests/test_moe_dag.py:192 (delta-fast on granite-moe-1b-a400m at 4
    microbatches) in both packages, under a generation cap: the port's
    topology equals the reference's from the same seed."""
    kw = dict(seed=0, pop_size=16, max_generations=12, patience=10,
              time_limit=1e9)
    ref_dag = jax_schedule.build_comm_dag(jax_configs.make_job(
        jax_configs.REGISTRY["granite-moe-1b-a400m"], microbatches=4))
    port_dag = port_schedule.build_comm_dag(port_configs.make_job(
        port_configs.REGISTRY["granite-moe-1b-a400m"], microbatches=4))
    ref = jax_ga.delta_fast(ref_dag, jax_ga.GAOptions(**kw))
    port = port_ga.delta_fast(port_dag, port_ga.GAOptions(
        **kw, des_options=DESOptions(device="cpu")))
    assert port.feasible and np.isfinite(port.makespan)
    assert port.total_ports > 0
    np.testing.assert_array_equal(port.x, ref.x)
    assert port.makespan == ref.makespan
    assert port.generations == ref.generations
