"""`BENCHMARK.json` against the benchmark's contract and its files; the
sources' imports; the bound arithmetic; the trace's reduction; and every
configuration file's DAG at its full size, on the CPU."""
import ast
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from harness import roofline, trace  # noqa: E402
from harness.cell import forbidden_modules  # noqa: E402
from harness.spec import Spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_names_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and len(SPEC["command"]) <= 32
    assert SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] \
            == c["source"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _one_line(w["why"])
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and _one_line(m["layer"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    spec = Spec.load(ROOT)
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics(w, "per_layer")
        assert layers
        for m in layers:        # what a metric moves, the cell reports
            assert m["moves"] in e2e


def test_each_name_has_its_file_and_the_reader_agrees():
    spec = Spec.load(ROOT)
    for w in SPEC["workloads"]:
        assert spec.traffic(w)["method"] == "delta-fast"
        assert spec.limits(w)
        assert spec.config(w)["name"] == w["config"]
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            reader = spec.reader(m["name"])
            assert callable(reader.read)
            # a metric's unit, layer and what it moves are stated once,
            # in BENCHMARK.json
            for key in ("UNIT", "BETTER", "SOURCE", "LAYER", "MOVES"):
                assert not hasattr(reader, key), (m["name"], key)
    # every reader file serves some metric, by its name or its family's
    served = {m["name"] for k in ("end_to_end", "per_layer")
              for m in SPEC[k]}
    served |= {n.split(".")[0] for n in served}
    for path in (BENCH / "metrics").glob("*.py"):
        assert path.stem in served, path
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(BENCH).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path: Path) -> set[str]:
    """Top-level names of every import in `path`, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    sources = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(sources) > 20
    for path in sources:
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "flax", "repro"}, path
        if not path.name.startswith("test_"):
            assert "benchmarks" not in path.read_text(), path
            assert "chip_smoke" not in names, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "collections",
                                  "dataclasses", "numpy", "reference"}, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert forbidden_modules(("repro", "jax")) == sorted(
        {"repro", "jax"} & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert "repro" in forbidden_modules(("repro",))


def test_fill_maxmin_bound_at_megatron_462b_csr():
    # megatron-462b's padded CSR (N 832, C 80, E 2,432) at 48 lanes: the
    # bytes bind, 238,340 of them at the HBM rate
    b = roofline.fill_maxmin_bytes(48, 832, 80, 2432)
    assert b == 238340
    t, by = roofline.bound_s(b, roofline.fill_maxmin_ops(400, 832, 80, 2432))
    assert by == "bytes" and t == pytest.approx(7.1146e-8, rel=1e-4)
    # at jamba's CSR (N 2,944, C 56, E 8,704) 48 lanes of 7-10 rounds
    # bind on operations
    ops = roofline.fill_maxmin_ops(48 * 10, 2944, 56, 8704)
    t, by = roofline.bound_s(roofline.fill_maxmin_bytes(48, 2944, 56, 8704),
                             ops)
    assert by == "operations" and t == pytest.approx(ops / 67e12)
    assert roofline.fill_maxmin_bytes(96, 832, 80, 2432, m=2) > b


def test_trace_reduction_busy_gaps_and_activity():
    ms = 1_000_000
    h0 = 5 * ms                       # host ns at the first marker
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [(h0 + 100, h0 + 200, spin),
          (h0 + 1 * ms, h0 + 3 * ms, "a"), (h0 + 2 * ms, h0 + 4 * ms, "b"),
          (h0 + 6 * ms, h0 + 7 * ms, "a"), (h0 + 10 * ms, h0 + 11 * ms,
                                             spin)]
    prof = trace.summarize(ev, h0, h0 + 10 * ms)
    # a device event outside the markers is left out of the window
    outside = trace.summarize([(h0, h0 + 50, "c")] + ev, h0, h0 + 10 * ms)
    assert (outside.busy_s, outside.window_s, outside.events) == (
        prof.busy_s, prof.window_s, prof.events)
    assert "c" not in outside.kernels
    assert prof.busy_s == pytest.approx(4e-3)
    assert prof.window_s == pytest.approx(10e-3)
    assert prof.kernel_seconds("a") == (pytest.approx(3e-3), 2)
    assert prof.gap_s.sum() == pytest.approx(10e-3 - 200e-9 - 4e-3)
    spans = [("plan", 0.0, 1.0), ("host_des", h0 * 1e-9 + 4.5e-3, 1e-3)]
    idle = trace.idle_by_activity(prof, spans)
    assert idle["host_des"] == pytest.approx(2e-3)
    assert idle["plan"] == pytest.approx(prof.gap_s.sum() - 2e-3)
    assert trace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "AddFunctor<float>>(int, float*)") == "vectorized_elementwise_kernel"
    assert trace.short_name("(anonymous namespace)::fill_maxmin_kernel(int "
                            "const*, float*)") == "fill_maxmin_kernel"
    with pytest.raises(RuntimeError):
        trace.summarize(ev[1:], h0, h0 + 10 * ms)


@pytest.mark.parametrize("config", sorted(
    p.stem for p in (BENCH / "configs").glob("*.json")))
def test_configuration_dag_counts(config):
    from harness.check import Judge
    from harness.job import build_dag, raw_dag
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert cfg["name"] == config
    dag = build_dag(cfg)          # raises where a count or number differs
    assert dag.num_tasks == cfg["expect"]["tasks"]
    assert len(dag.undirected_pairs()) == cfg["expect"]["genes"]
    judge = Judge(raw_dag(dag))
    assert judge.xbar_sum() == cfg["expect"]["xbar_sum"]
    if config == "megatron-462b":
        from repro_torch.core.des import DESProblem
        from repro_torch.core.des_torch import (DESOptions, TorchDES,
                                                _incidence_csr)
        a = TorchDES(DESProblem(dag), options=DESOptions(device="cpu")).arrays
        con_ptr, ent_task, _ = _incidence_csr(a)
        assert (a.n, a.num_cons, ent_task.shape[1]) == (832, 80, 2432)
        assert np.all(np.diff(con_ptr[0].numpy()) >= 0)


@pytest.mark.parametrize("after,batches,seen,opened,closed", [
    (0, 2, 5, 0, 2), (4, 4, 12, 4, 8), (4, 4, 6, 4, 6), (2, 3, 2, 2, 2)])
def test_trace_slice_opens_and_closes_on_batches(after, batches, seen,
                                                 opened, closed):
    class Tracer:
        profile = None

        def start(self):
            events.append(("start", done[0]))

        def stop(self):
            events.append(("stop", done[0]))
            self.profile = "profile"

    events, done = [], [0]
    sl = trace.TraceSlice(Tracer(), after=after, batches=batches)
    sl.open_now()
    for _ in range(seen):
        done[0] += 1
        sl.batch_done()
    assert sl.close() == "profile"
    assert events == [("start", opened), ("stop", closed)]


def test_trace_slice_never_opened_raises():
    sl = trace.TraceSlice(object(), after=4, batches=4)
    sl.open_now()
    for _ in range(3):
        sl.batch_done()
    with pytest.raises(RuntimeError, match="before the traced slice"):
        sl.close()
    with pytest.raises(ValueError):
        trace.TraceSlice(object(), after=0, batches=0)


def test_each_traffic_mix_traces_a_slice_its_window_reaches():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        assert set(mix["trace"]) == {"after", "batches"}, path.name
        assert mix["trace"]["after"] >= 0 and mix["trace"]["batches"] >= 1
