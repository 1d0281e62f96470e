"""The port's planner and fleet examples (`repro_torch.examples.*`) on the
CPU, each at its smallest setting, against the reference's scripts under
examples/ where their searches can be made to run the same generations.

- quickstart (tests/test_system.py:97), plan_topology (smaller budgets
  through monkeypatch: its delta-joint MILP has a 240 s limit) and
  trace_plan (both trace files pass the reference's `validate_trace`, as
  the reference's do) return 0;
- quickstart under a generation cap in both packages prints the
  reference's lines and plans its topologies (plan_topology's MILP stops
  on a time limit, so only the shape of its lines is checked);
- chaos_fleet and control_plane cap their GA by generations, so their
  printed lines, ledgers, decision histories and per-tenant topologies
  must equal the reference's on the same options;
- fleet_realloc and planes_transition stop their GA on a wall clock: the
  test replaces each package's `GAOptions` in the example with one that
  caps generations instead, then compares them the same way.

Tolerances: printed lines (the NCTs and makespans they print come from
each package's exact numpy DES on equal topologies), ledgers, topologies
and decision histories exact."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest
import torch

import repro.core.ga as jax_ga
import repro.obs as jax_obs
import repro.obs.journal as jax_journal
import repro_torch.core.ga as port_ga
import repro_torch.core.milp as port_milp
import repro_torch.obs as port_obs
import repro_torch.obs.journal as port_journal
from repro_torch.examples import (chaos_fleet, control_plane, fleet_realloc,
                                  plan_topology, planes_transition,
                                  quickstart, trace_plan)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the CPU DES's small ops oversubscribe
    the cores when the suite runs in several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_reference(name: str):
    """The reference's `examples/<name>.py`, imported by path as a fresh
    module (its module-level counters start at 0)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generation_capped(cls, generations: int | None = None):
    """`cls` (a package's GAOptions) with the wall-clock limit replaced by
    a generation cap, so that both packages run the same generations."""
    def make(**kw):
        kw["time_limit"] = 1e9
        if generations is not None:
            kw["max_generations"] = generations
        return cls(**kw)
    return make


def recording(module, made: list):
    """Make every FleetPlanner that `module` builds (recovered ones too)
    append itself to `made`."""
    base = module.FleetPlanner

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    return Recorded


def planner_state(planner, journal) -> dict:
    return {"ledger": planner.ledger.snapshot(),
            "x": {n: t.plan.x.tolist() for n, t in planner.tenants.items()},
            "makespan": {n: t.plan.makespan
                         for n, t in planner.tenants.items()},
            "history": json.dumps(planner.history,
                                  default=journal._json_default)}


def run_fleet_pair(name, monkeypatch, capsys, run_ref, run_port,
                   cap: int | None = ...):
    """Run the reference's and the port's example `name` with recorded
    planners (and, unless `cap` is ..., generation-capped GAOptions);
    returns (stdout, planners) of each."""
    out = []
    for pkg, ga_mod, journal, run in (
            ("ref", jax_ga, jax_journal, run_ref),
            ("port", port_ga, port_journal, run_port)):
        mod = load_reference(name) if pkg == "ref" else \
            sys.modules[f"repro_torch.examples.{name}"]
        made: list = []
        monkeypatch.setattr(mod, "FleetPlanner", recording(mod, made))
        if cap is not ...:
            monkeypatch.setattr(mod, "GAOptions",
                                generation_capped(ga_mod.GAOptions, cap))
        rc = run(mod)
        text = capsys.readouterr().out
        assert rc in (None, 0), (pkg, text[-2000:])
        out.append((text, [planner_state(p, journal) for p in made]))
    return out


def assert_same_run(ref, port) -> None:
    (ref_text, ref_states), (port_text, port_states) = ref, port
    assert port_text.splitlines() == ref_text.splitlines()
    assert len(port_states) == len(ref_states) >= 1
    for a, b in zip(ref_states, port_states):
        assert a == b


# ------------------------------------------------------------- planners
def test_quickstart_example_runs(monkeypatch, capsys):
    """tests/test_system.py:97 for the port's quickstart, then the
    reference's and the port's quickstart with each package's GAOptions
    capped at 20 generations: the same printed lines, and the same plans
    by method (ports and topologies exact, makespans and NCTs at rel
    5e-5)."""
    quickstart.main(CPU, fast=True)
    text = capsys.readouterr().out
    assert "inter-pod DAG: " in text and "best: " in text
    assert "delta-fast" in text

    runs = []
    for mod, ga_mod, run in (
            (load_reference("quickstart"), jax_ga,
             lambda m: m.main(fast=True)),
            (quickstart, port_ga, lambda m: m.main(CPU, fast=True))):
        plans: dict = {}
        inner = mod.compare

        def recorded(*a, inner=inner, plans=plans, **kw):
            plans.update(inner(*a, **kw))
            return plans
        monkeypatch.setattr(mod, "compare", recorded)
        monkeypatch.setattr(mod, "GAOptions",
                            generation_capped(ga_mod.GAOptions, 20))
        run(mod)
        runs.append((capsys.readouterr().out, plans))
    (ref_text, ref), (port_text, port) = runs
    assert port_text.splitlines() == ref_text.splitlines()
    assert list(port) == list(ref) == ["prop-alloc", "sqrt-alloc",
                                       "iter-halve", "delta-fast"]
    for m in ref:
        assert port[m].total_ports == ref[m].total_ports, m
        assert (port[m].x == ref[m].x).all(), m
        for key in ("makespan", "nct"):
            assert getattr(port[m], key) == pytest.approx(
                getattr(ref[m], key), rel=5e-5), (m, key)


# branch-and-bound nodes per HiGHS solve of plan_topology's MILP: its
# main solve reaches the 5% gap at node 973 (the first incumbent comes
# late: none at 700), its port-min phase stops here with an incumbent
PLAN_TOPOLOGY_NODES = 1200


def node_capped(solve, nodes: int):
    """`scipy.optimize.milp` with HiGHS's branch-and-bound capped at
    `nodes` per solve.  scipy reports the expired cap as status 4 (a
    HiGHS model status it does not know, kSolutionLimit); it is given
    status 1, the one an expired time limit gets, so that the planner
    keeps the incumbent as it does at a time limit."""
    from scipy.optimize._highspy._core import HighsModelStatus

    def run(*args, options=None, **kw):
        res = solve(*args, options={**(options or {}), "node_limit": nodes},
                    **kw)
        code = re.search(r"HiGHS Status (\d+):", res.message)
        if res.status == 4 and code is not None and \
                int(code.group(1)) == int(HighsModelStatus.kSolutionLimit):
            res.status = 1
        return res

    return run


def test_plan_topology_example_runs(monkeypatch, capsys):
    """At gpt-7b, with the GA capped by generations and HiGHS by a node
    budget (the example's 240 s time limit kept as a backstop; both
    through monkeypatch), so that the outcome does not hang on the
    machine's speed: under a 10 s limit the main solve found no incumbent
    when the machine was loaded and the example stopped after two
    lines."""
    milp = plan_topology.MILPOptions
    monkeypatch.setattr(plan_topology, "GAOptions",
                        generation_capped(port_ga.GAOptions, 30))
    monkeypatch.setattr(plan_topology, "MILPOptions",
                        lambda **kw: milp(**{**kw, "mip_rel_gap": 0.05}))
    monkeypatch.setattr(port_milp, "milp",
                        node_capped(port_milp.milp, PLAN_TOPOLOGY_NODES))
    plan_topology.main(["--arch", "gpt-7b", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "gpt-7b: 24 tasks, 4 pods"
    assert lines[1].startswith("delta-fast : NCT=")
    assert lines[2].startswith("delta-joint+port-min: NCT=")
    assert lines[3].startswith("co-tenant Model^T: NCT ")
    before, after = (float(v) for v in
                     lines[3].split("NCT ")[1].split(" after")[0]
                     .split(" -> "))
    assert after <= before + 1e-4      # printed at 4 decimals


def test_trace_plan_example_writes_valid_traces(tmp_path, capsys):
    # the example turns the tracer on; the context restores its state
    with port_obs.enabled():
        assert trace_plan.main(["--out", str(tmp_path), *CPU]) == 0
    port_obs.TRACER.clear()
    text = capsys.readouterr().out
    assert "slack report: makespan" in text
    for name in ("schedule_gpt-7b", "spans_gpt-7b"):
        trace = json.loads((tmp_path / f"{name}.json").read_text())
        # the validator that checks the reference's traces
        assert jax_obs.validate_trace(trace) == [], name
        assert trace["traceEvents"]
    spans = json.loads((tmp_path / "spans_gpt-7b.json").read_text())
    names = {e.get("name") for e in spans["traceEvents"]}
    assert {"ga.evolve", "ga.generation", "des.simulate"} <= names


# ---------------------------------------------------------------- fleet
def test_chaos_fleet_matches_reference(monkeypatch, capsys):
    ref, port = run_fleet_pair(
        "chaos_fleet", monkeypatch, capsys, lambda m: m.main(),
        lambda m: m.main(CPU))
    assert_same_run(ref, port)
    assert port[0].splitlines()[-1] == "0 invariant violation(s)"
    assert len(port[1]) == 2        # the planner and its recovery


def test_control_plane_matches_reference(monkeypatch, capsys):
    ref, port = run_fleet_pair(
        "control_plane", monkeypatch, capsys, lambda m: m.main(),
        lambda m: m.main(CPU))
    assert_same_run(ref, port)
    assert port[0].splitlines()[-1] == "OK"


def test_fleet_realloc_matches_reference(monkeypatch, capsys):
    ref, port = run_fleet_pair(
        "fleet_realloc", monkeypatch, capsys, lambda m: m.main(fast=True),
        lambda m: m.main(CPU), cap=12)
    assert_same_run(ref, port)
    assert port[0].splitlines()[-1] == "ledger conservation: OK"


def test_planes_transition_matches_reference(monkeypatch, capsys):
    """The reference's script runs at import and ends in sys.exit: its
    GAOptions is capped where it imports it from, before it runs."""
    made_ref: list = []
    monkeypatch.setattr(jax_ga, "GAOptions",
                        generation_capped(jax_ga.GAOptions))
    import repro.fleet as jax_fleet
    monkeypatch.setattr(jax_fleet, "FleetPlanner",
                        recording(jax_fleet, made_ref))
    with pytest.raises(SystemExit) as done:
        load_reference("planes_transition")
    assert done.value.code == 0
    ref = (capsys.readouterr().out,
           [planner_state(p, jax_journal) for p in made_ref])

    made_port: list = []
    monkeypatch.setattr(planes_transition, "GAOptions",
                        generation_capped(port_ga.GAOptions))
    monkeypatch.setattr(planes_transition, "FleetPlanner",
                        recording(planes_transition, made_port))
    assert planes_transition.main(CPU) == 0
    port = (capsys.readouterr().out,
            [planner_state(p, port_journal) for p in made_port])
    assert_same_run(ref, port)
    assert port[0].splitlines()[-1] == "PASS: 0 violation(s)"
    assert len(port[1]) == 2        # the planner and its replay


def test_examples_raise_without_cuda(monkeypatch, tmp_path):
    """Every example runs its engines on the CUDA device unless told
    otherwise: without one, each raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: quickstart.main([], fast=True),
                lambda: plan_topology.main(["--arch", "gpt-7b"]),
                lambda: trace_plan.main(["--out", str(tmp_path)]),
                lambda: fleet_realloc.main([]),
                lambda: chaos_fleet.main([]),
                lambda: control_plane.main([]),
                lambda: planes_transition.main([])):
        with pytest.raises(RuntimeError, match="CUDA device"):
            run()


def test_examples_are_modules_with_a_main():
    for mod in (quickstart, plan_topology, trace_plan, fleet_realloc,
                chaos_fleet, control_plane, planes_transition):
        assert callable(mod.main)
        src = Path(mod.__file__).read_text()
        assert 'if __name__ == "__main__":' in src
        assert "sys.path" not in src
