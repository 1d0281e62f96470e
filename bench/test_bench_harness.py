"""The harness end to end on the CPU, at a tiny cell.

A temporary copy of `bench/` and `BENCHMARK.json` gains a configuration
(megatron-177b cut to 8 microbatches), traffic mixes, limits and a
metric reader as new files and entries only; the harness finds and runs
them.  The same cell proves that the checks pass on the program as it is
and come out not correct under each planted fault, and that the lower
precision control reads above the limits.
"""
import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from harness import check, job  # noqa: E402
from harness.cell import run_cell  # noqa: E402
from harness.faults import FAULTS  # noqa: E402
from harness.probe import Probe  # noqa: E402
from harness.spec import Spec  # noqa: E402
from harness.traffic import drive  # noqa: E402

TINY = {"arch": "megatron-177b", "seq_len": 4096, "microbatches": 8,
        "inter_pod_gbps": 400.0}
DUMMY_METRIC = '''"""dummy_generations.tiny: GA generations in the window."""


def read(run):
    return run.counters.get("ga_generations_total")
'''


def _tiny_config() -> dict:
    import dataclasses

    from repro_torch.configs import ALL_ARCHS
    cfg = json.loads((BENCH / "configs" / "megatron-462b.json").read_text())
    arch = ALL_ARCHS[TINY["arch"]]
    cfg.update(name="megatron-177b-mb8", job=TINY,
               model=dataclasses.asdict(arch.config),
               parallelism=dataclasses.asdict(arch.plan),
               expect={"pods": 24, "tasks": 45, "deps": 330, "genes": 5,
                       "xbar_sum": 80})
    return cfg


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added as new files and
    entries; every file the copy had is left as it was."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("bench_copy")
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    (bench / "configs" / "megatron-177b-mb8.json").write_text(
        json.dumps(_tiny_config()))
    for mix in ("search", "replan"):
        traf = json.loads((bench / "traffic" / f"{mix}.json").read_text())
        traf["ga"]["pop_size"] = 8
        traf["check"]["lanes"] = 16
        (bench / "traffic" / f"tiny-{mix}.json").write_text(json.dumps(traf))
        limits = (bench / "limits" / f"m462b.{mix}.json").read_text()
        (bench / "limits" / f"tiny.{mix}.json").write_text(limits)
    (bench / "metrics" / "dummy_generations.tiny.py").write_text(
        DUMMY_METRIC)

    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "megatron-177b-mb8", "source": "test",
                            "file": "bench/configs/megatron-177b-mb8.json",
                            "reduced": ["microbatches"], "why": "test"})
    for mix in ("search", "replan"):
        spec["workloads"].append({"name": f"tiny.{mix}",
                                  "config": "megatron-177b-mb8",
                                  "traffic": f"tiny-{mix}", "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            mix = "search" if "m462b.search" in m["workloads"] else "replan"
            m["workloads"].append(f"tiny.{mix}")
    spec["per_layer"].append({
        "name": "dummy_generations.tiny", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "GA driver (host)",
        "moves": "search_gen_s", "workloads": ["tiny.search"]})
    # a metric of an existing family needs no file: its family's reader
    spec["per_layer"].append({
        "name": "ga_host_ms.tiny", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "GA driver (host)",
        "moves": "plan_s", "workloads": ["tiny.replan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data
    return Spec.load(root, bench)


def _run(spec, name, traced=False, faults=(), seed=2 ** 31 + 17):
    lines: list[str] = []
    res = run_cell(spec, name, seed, 1.0, traced, time.perf_counter(),
                   device="cpu", log=lines.append, forbidden=(),
                   faults=faults)
    return res, lines


@pytest.mark.parametrize("name", ["tiny.search", "tiny.replan"])
def test_result_line_shape_and_correct(tiny, name):
    res, lines = _run(tiny, name)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert json.loads(json.dumps(res)) == res
    assert res["correct"] is True, lines
    assert res["failed"] == 0 and res["attempted"] >= 1
    e2e = {"tiny.search": {"setup_s", "search_gen_s"},
           "tiny.replan": {"setup_s", "plan_s"}}[name]
    assert set(res["metrics"]) == e2e
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    limits = tiny.limits(tiny.workload(name))
    assert list(res["checks"]) == list(limits)
    for k, c in res["checks"].items():
        assert c["limit"] == limits[k] and c["value"] <= c["limit"]
    # the checks, each with its limit, are the last lines of the log
    assert [ln.split()[1] for ln in lines[-len(limits):]] == list(limits)


def test_added_traffic_and_reader_are_found_without_edits(tiny):
    res, _ = _run(tiny, "tiny.search", traced=True)
    assert res["metrics"]["dummy_generations.tiny"]["value"] >= 1
    assert res["metrics"]["ga_host_ms.search"]["value"] > 0
    assert res["metrics"]["trip_us.search"]["value"] > 0
    # no device on the CPU: the device's metrics are left out, not 0
    assert "device_idle.search" not in res["metrics"]
    assert "fill_maxmin_roofline.search" not in res["metrics"]
    res, _ = _run(tiny, "tiny.replan", traced=True)
    assert set(res["metrics"]) == {"xbound_s.replan", "host_des_s.replan",
                                   "ga_host_ms.tiny"}
    assert res["metrics"]["ga_host_ms.tiny"]["value"] > 0
    assert not (tiny.bench / "metrics" / "ga_host_ms.tiny.py").exists()


@pytest.mark.parametrize("fault,caught_by", [
    ("answer_altered", "plan_excess"), ("half_batch", "lane_gap"),
    ("rates_stale", "lane_gap")])
def test_each_fault_makes_the_run_not_correct(tiny, fault, caught_by):
    res, _ = _run(tiny, "tiny.search", faults=(fault,))
    assert res["correct"] is False
    c = res["checks"][caught_by]
    assert not c["value"] <= c["limit"]


def test_lower_precision_control_fails_the_limits(tiny):
    wl = tiny.workload("tiny.search")
    config, traf = tiny.config(wl), tiny.traffic(wl)
    limits = tiny.limits(wl)
    dag = job.build_dag(config)
    judge = check.Judge(job.raw_dag(dag))
    failed = []
    for seed in (11, 12, 13):
        probe = Probe()
        probe.record_outputs()
        try:
            records, _ = drive(traf, config, dag, seed, 1.0, probe, "cpu")
        finally:
            probe.restore()
        low = check.control_readings(records, probe, judge, 16, seed)
        failed.append([k for k, v in low.items() if not v <= limits[k]])
    # the control fails a number on every seed: the float32 certification
    # on each, the bfloat16 lanes on some
    assert all("plan_ms_gap" in f for f in failed)
    assert any("lane_gap" in f for f in failed)


def test_faults_are_registered_and_restored():
    from repro_torch.core import des_torch, ga
    from repro_torch.core.des_torch import TorchDES
    names = (ga._exact_rerank, TorchDES.batch_genome_makespan,
             des_torch._rate_step, ga.x_upper_bound)
    probe = Probe()
    for plant in FAULTS.values():
        plant(probe)
    probe.record_outputs()
    probe.restore()
    assert (ga._exact_rerank, TorchDES.batch_genome_makespan,
            des_torch._rate_step, ga.x_upper_bound) == names
