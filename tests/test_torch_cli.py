"""The port's control-plane CLI (`repro_torch.launch.topo_plan`) on the
CPU against the reference's (`repro.launch.topo_plan`): the same printed
DAG line, per-method ports, selected method and `--out` topology, for the
paper's gpt-7b and the registry's MoE granite-moe-1b-a400m at 4
microbatches with the three traffic-matrix baselines; one delta-fast run
no worse than the best baseline; whisper-large-v3's configured
placement refused by both; and the device rule (no CUDA device and no
`--device cpu`: the CLI raises).

Tolerances: DAG line, ports, selected method and topology exact;
makespans and NCTs rel 5e-5 (the same exact numpy DES in each package)."""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

import repro.launch.topo_plan as jax_cli
import repro_torch.core.ga as port_ga
import repro_torch.launch.topo_plan as port_cli

BASELINES = "prop-alloc,sqrt-alloc,iter-halve"
REL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the CPU DES's small ops oversubscribe
    the cores when the suite runs in several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_both(args: list[str], tmp_path, monkeypatch, capsys):
    """(stdout, --out payload) of the reference CLI and of the port's."""
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["topo_plan", *args,
                                      "--out", str(ref_out)])
    jax_cli.main()
    ref_text = capsys.readouterr().out
    results = port_cli.main([*args, "--device", "cpu",
                             "--out", str(port_out)])
    port_text = capsys.readouterr().out
    return ((ref_text, json.loads(ref_out.read_text())),
            (port_text, json.loads(port_out.read_text())), results)


@pytest.mark.parametrize("arch", ["gpt-7b", "granite-moe-1b-a400m"])
def test_cli_baselines_match_reference(arch, tmp_path, monkeypatch, capsys):
    (ref_text, ref), (port_text, port), results = run_both(
        ["--arch", arch, "--microbatches", "4", "--methods", BASELINES],
        tmp_path, monkeypatch, capsys)
    # the DAG line, exactly
    assert port_text.splitlines()[0] == ref_text.splitlines()[0]
    assert port_text.splitlines()[0].startswith(f"[plan] {arch}: ")
    assert list(port["all"]) == BASELINES.split(",") == list(results)
    for m, want in ref["all"].items():
        got = port["all"][m]
        assert got["ports"] == want["ports"], m
        assert got["makespan"] == pytest.approx(want["makespan"], rel=REL)
        assert got["nct"] == pytest.approx(want["nct"], rel=REL)
        assert results[m].total_ports == want["ports"]
    assert port["method"] == ref["method"]
    assert port["total_ports"] == ref["total_ports"]
    assert port["topology"] == ref["topology"]
    assert port["arch"] == ref["arch"] == arch
    assert port["bandwidth_gbps"] == ref["bandwidth_gbps"]
    # the selected line and the per-method lines' method names
    assert port_text.splitlines()[-2] == ref_text.splitlines()[-2] \
        == f"[plan] selected: {ref['method']}"


def test_cli_delta_fast_no_worse_than_baselines(tmp_path, capsys):
    out = tmp_path / "plan.json"
    results = port_cli.main([
        "--arch", "gpt-7b", "--microbatches", "4", "--time-limit", "8",
        "--methods", f"{BASELINES},delta-fast", "--device", "cpu",
        "--out", str(out)])
    fast = results["delta-fast"]
    best = min(results[m].nct for m in BASELINES.split(","))
    assert fast.feasible and np.isfinite(fast.makespan)
    assert fast.nct <= best + 1e-9
    payload = json.loads(out.read_text())
    x = np.asarray(payload["topology"])
    assert (x == x.T).all() and x.sum() == payload["total_ports"]
    assert payload["nct"] <= best + 1e-9
    assert "[plan] delta-fast" in capsys.readouterr().out


def test_cli_without_cuda_raises(monkeypatch):
    """No CUDA device and no `--device cpu`: the CLI raises, before any
    method runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_cli.main(["--arch", "gpt-7b", "--microbatches", "4",
                       "--methods", BASELINES])
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_cli.main(["--arch", "gpt-7b", "--microbatches", "4",
                       "--methods", BASELINES, "--device", "cuda"])


def test_cli_rejects_unknown_arch_and_method(capsys):
    with pytest.raises(SystemExit):
        port_cli.main(["--arch", "no-such-model", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown methods"):
        port_cli.main(["--methods", "prop-alloc,no-such-method",
                       "--microbatches", "4", "--device", "cpu"])
    capsys.readouterr()


def test_cli_refuses_an_infeasible_placement_like_reference(monkeypatch,
                                                            capsys):
    """whisper-large-v3's configured placement gives a pod 2 ports and 4
    active pairs: both CLIs print the baselines as infeasible, then their
    GA refuses the placement with the same message."""
    args = ["--arch", "whisper-large-v3", "--microbatches", "4",
            "--methods", "prop-alloc,delta-fast", "--time-limit", "4"]
    monkeypatch.setattr(sys, "argv", ["topo_plan", *args])
    with pytest.raises(ValueError) as ref:
        jax_cli.main()
    ref_text = capsys.readouterr().out
    with pytest.raises(port_ga.InfeasiblePlacement) as port:
        port_cli.main([*args, "--device", "cpu"])
    port_text = capsys.readouterr().out
    assert str(port.value) == str(ref.value)
    assert "placement is infeasible" in str(port.value)
    assert port_text.splitlines() == ref_text.splitlines()
    assert "NCT=     inf" in port_text
