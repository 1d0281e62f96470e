"""The port's Sentinel (`repro_torch.analysis`): golden fixture findings,
suppression and baseline mechanics, CLI exit codes, the baseline-growth
guard, the shipped tree clean, and parity with the reference's
`repro.analysis` on the rules the two share.

A mirror of tests/test_sentinel.py for the port's eleven codes.  The
fixtures under tests/sentinel_fixtures/torch/ each seed at least one true
positive and one near miss per rule; the golden keys below pin both
directions (a rule that stops firing OR starts flagging the idiomatic
pattern fails here).  The reference's own fixtures, rewritten from
`repro` to `repro_torch`, hold the five shared rules (RPR001, 002, 005,
008, 009) to the reference's keys.
"""
import json
import os
import re
import shutil
import tokenize
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro.analysis.engine as ref_engine
from repro_torch.analysis import Baseline, analyze, analyze_paths
from repro_torch.analysis.__main__ import default_paths
from repro_torch.analysis.__main__ import main as sentinel_main
from repro_torch.analysis.check_baseline import main as guard_main
from repro_torch.analysis.engine import RULES, FileContext, is_hot
from repro_torch.analysis.rules import dtype as dtype_rules

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "sentinel_fixtures" / "torch"
REF_FIX = REPO / "tests" / "sentinel_fixtures"

GOLDEN = {
    "RPR001": (FIX / "rpr001", {"LaneSpec.ghost"}),
    "RPR002": (FIX / "rpr002", {"bad.opts", "bad_fallback.opts"}),
    "RPR003": (FIX / "rpr003",
               {"torch.float64:build", ".double():widen", "'float64':named",
                "double:__global__ void widen(const float* a, double* out, "
                "int n) {"}),
    "RPR004": (FIX / "rpr004_fake_des_torch.py",
               {"np.zeros:stage", "np.array:stage",
                "torch.as_tensor:upload"}),
    "RPR005": (FIX / "rpr005_solver_gate.py",
               {"bad_unpack.x", "bad_result.res"}),
    "RPR006": (FIX / "rpr006_fake_des_torch.py",
               {"_drain:item", "bad:if", "bad_while:float",
                "bad_while:synchronize"}),
    "RPR007": (FIX / "rpr007_capture.py",
               {"_step:_STEPS.inc", "bad_graph:time.time", "bad_span:span",
                "_noisy:random.random", "bad_compiled:np.random.rand"}),
    "RPR008": (FIX / "rpr008_cache_keys.py",
               {"bad_param:key[0]", "bad_dataclass:key[0]",
                "bad_tensor_param:key[1]", "bad_tensor_local:key[1]",
                "bad_lanes:key[0]", "bad_lru.x"}),
    "RPR009": (FIX / "rpr009",
               {"bad_direct:optimize_failsafe", "bad_alias:fleet_optimize"}),
    "RPR010": (FIX / "rpr010",
               {"bad_engine:Exception", "bad_kernel:RuntimeError",
                "bad_bare:bare", "bad_engine_method:OSError"}),
    "RPR011": (FIX / "rpr011_precision.py",
               {"bad_matmul:torch.backends.cuda.matmul.allow_tf32",
                "bad_cudnn:torch.backends.cudnn.allow_tf32",
                "bad_precision:set_float32_matmul_precision"}),
}

# the host syncs the port sanctions inline, each once per iteration of a
# loop that needs it (the DES event loop's exit test per trip, and per
# replay of its CUDA graph; the closure's and the max-plus squaring's
# fixpoint tests, the plain filling's round test)
SANCTIONED_SYNCS = {
    ("src/repro_torch/core/des_torch.py", "_LaneDES._simulate:bool"),
    ("src/repro_torch/core/des_torch.py", "_LaneDES._replay:tolist"),
    ("src/repro_torch/kernels/ops.py", "transitive_closure:bool"),
    ("src/repro_torch/kernels/ops.py", "longest_paths:if"),
    ("src/repro_torch/kernels/ref.py", "transitive_closure_ref:bool"),
    ("src/repro_torch/kernels/ref.py", "progressive_filling:bool"),
}

# the reference's fixtures of the rules the two analyzers share
SHARED = {"RPR001": "rpr001", "RPR002": "rpr002",
          "RPR005": "rpr005_solver_gate.py",
          "RPR008": "rpr008_cache_keys.py", "RPR009": "rpr009"}


@pytest.fixture(scope="module")
def shipped():
    """One analysis of the port's default paths: (findings, suppressed)."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return analyze(default_paths(), root=str(REPO))
    finally:
        os.chdir(cwd)


# ------------------------------------------------------------ rule catalog
def test_every_rule_has_fixture_and_metadata():
    import repro_torch.analysis.rules  # noqa: F401 -- registers rules
    assert set(RULES) == set(GOLDEN)
    assert len(RULES) == 11
    for code, r in RULES.items():
        assert r.code == code
        assert r.name and r.summary and r.bug, code
    # the reference's registry is its own and keeps its nine codes
    import repro.analysis.rules  # noqa: F401
    assert set(ref_engine.RULES) == {f"RPR00{i}" for i in range(1, 10)}
    assert not {id(r) for r in ref_engine.RULES.values()} & \
        {id(r) for r in RULES.values()}


@pytest.mark.parametrize("code", sorted(GOLDEN))
def test_fixture_golden_findings(code):
    path, expected = GOLDEN[code]
    findings = analyze_paths([str(path)], select=[code], root=str(REPO))
    assert {f.key for f in findings} == expected
    for f in findings:
        assert f.rule == code
        assert f.line > 0 and f.message
        assert not re.search(r":\d+$", f.key)   # keys carry no line


@pytest.mark.parametrize("code", sorted(GOLDEN))
def test_fixtures_do_not_cross_trigger(code):
    """A fixture seeds only its own rule's findings (no collateral)."""
    path, _ = GOLDEN[code]
    findings = analyze_paths([str(path)], root=str(REPO))
    assert {f.rule for f in findings} == {code}


def test_shipped_tree_is_clean(shipped):
    """The acceptance bar: the analyzer exits clean on the port, and the
    only silenced findings are the sanctioned host syncs."""
    findings, suppressed = shipped
    assert findings == []
    assert {(f.path, f.key) for f in suppressed} == SANCTIONED_SYNCS
    assert {f.rule for f in suppressed} == {"RPR006"}
    # exactly one sanctioned sync in each of TorchDES's event loops: the
    # eager loop's per trip, the graph's per replay
    assert [f.key for f in suppressed
            if f.path.endswith("core/des_torch.py")] == \
        ["_LaneDES._simulate:bool", "_LaneDES._replay:tolist"]


def test_every_suppression_in_the_port_names_its_code_and_reason():
    bare, unexplained = [], []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        with open(path, encoding="utf-8") as f:
            comments = [t for t in tokenize.generate_tokens(f.readline)
                        if t.type == tokenize.COMMENT]
        for tok in comments:
            m = re.search(r"#\s*sentinel:\s*ignore(\[[A-Z0-9,\s]+\])?(.*)",
                          tok.string)
            if m is None:
                continue
            where = f"{path.relative_to(REPO)}:{tok.start[0]}"
            if m.group(1) is None:
                bare.append(where)
            elif len(m.group(2).strip()) < 10:
                unexplained.append(where)
    assert not bare and not unexplained, (bare, unexplained)


def test_hot_modules_and_cuda_sources():
    """The hot scope covers the device seam and not the analyzer, and the
    RPR003 scan reads the three kernel sources (so a clean tree means
    something); no analyzer path carries the reference's hot markers."""
    def hot(path):
        return is_hot(FileContext.parse("<mem>", path, source=""))
    assert hot("src/repro_torch/core/des_torch.py")
    assert hot("src/repro_torch/kernels/ops.py")
    assert hot("src/repro_torch/convert.py")
    assert not hot("src/repro_torch/core/des.py")
    analyzer = sorted((REPO / "src" / "repro_torch" / "analysis")
                      .rglob("*.py"))
    assert len(analyzer) == 16      # 15 modules and rules/__init__.py
    for p in analyzer:
        rel = p.relative_to(REPO).as_posix()
        assert not hot(rel)
        assert "des_jax" not in rel and "kernels" not in rel
    ctxs = [FileContext.parse(str(p), p.relative_to(REPO).as_posix())
            for p in sorted((REPO / "src" / "repro_torch" / "kernels")
                            .glob("*.py"))]
    assert sorted(dtype_rules._cu_sources(ctxs)) == [
        f"src/repro_torch/kernels/csrc/{k}.cu"
        for k in ("maxplus", "tclosure", "waterfill")]


# ------------------------------------------------------------- suppression
def test_inline_suppression_silences_finding():
    path = FIX / "rpr001" / "src" / "repro_torch" / "fixture_suppressed.py"
    findings, suppressed = analyze([str(path)], root=str(REPO))
    assert findings == []
    assert [f.key for f in suppressed] == ["Annotated.kept"]


def test_suppression_is_code_scoped(tmp_path):
    src = ("from dataclasses import dataclass\n"
           "@dataclass(frozen=True)\n"
           "class Thing:\n"
           "    ghost: int = 0  # sentinel: ignore[RPR999]\n")
    p = tmp_path / "src" / "repro_torch" / "mod.py"
    p.parent.mkdir(parents=True)
    p.write_text(src)
    findings = analyze_paths([str(p)], root=str(tmp_path))
    assert [f.rule for f in findings] == ["RPR001"]  # wrong code: not hit


def test_bare_suppression_silences_all_codes():
    src = ("from dataclasses import dataclass\n"
           "@dataclass(frozen=True)\n"
           "class Thing:\n"
           "    ghost: int = 0  # sentinel: ignore\n")
    parsed = FileContext.parse("<mem>", "src/repro_torch/mod.py", source=src)
    assert parsed.suppressions == {4: set()}


def test_syntax_error_reported_as_rpr000(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def nope(:\n")
    findings = analyze_paths([str(p)], root=str(tmp_path))
    assert [f.rule for f in findings] == ["RPR000"]


# ---------------------------------------------------------------- baseline
def test_baseline_split_and_staleness(tmp_path):
    path, _ = GOLDEN["RPR010"]
    findings = analyze_paths([str(path)], select=["RPR010"],
                             root=str(REPO))
    bl = Baseline.from_findings(findings)
    f = tmp_path / "bl.json"
    bl.save(str(f))
    loaded = Baseline.load(str(f))
    new, baselined, stale = loaded.split(findings)
    assert new == [] and len(baselined) == len(findings) and stale == []
    # drop one finding -> its entry is stale
    new, baselined, stale = loaded.split(findings[:-1])
    assert len(stale) == 1


def test_baseline_survives_line_shifts(tmp_path):
    """Baseline ids are line-free: an unrelated edit keeps the match."""
    src = FIX / "rpr004_fake_des_torch.py"
    shifted = tmp_path / src.name
    shifted.write_text("# pad\n# pad\n" + src.read_text())
    base = analyze_paths([str(src)], root=str(REPO))
    moved = analyze_paths([str(shifted)], root=str(tmp_path))
    assert base and len(base) == len(moved)
    for b, m in zip(base, moved):
        assert b.line + 2 == m.line
        assert b.key == m.key


# --------------------------------------------------------------------- CLI
def test_cli_seeded_violation_fails(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = sentinel_main(["tests/sentinel_fixtures/torch/rpr011_precision.py",
                        "--no-baseline"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "RPR011" in out


def test_cli_clean_file_passes(tmp_path, monkeypatch, capsys):
    p = tmp_path / "ok.py"
    p.write_text("x = 1\n")
    monkeypatch.chdir(tmp_path)
    assert sentinel_main(["ok.py"]) == 0


def test_cli_default_paths_read_the_port_only(tmp_path, monkeypatch,
                                              capsys):
    """With no paths: the port's package, chip_smoke.py and the port's
    tests, and not the reference's tests (whose reads would hide a field
    the port never reads)."""
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "spec.py").write_text(
        "from dataclasses import dataclass\n"
        "@dataclass(frozen=True)\n"
        "class Spec:\n"
        "    seen: int = 0\n"
        "    hidden: int = 0\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_spec.py").write_text(
        "def test_seen(s):\n    assert s.seen == 0\n")
    (tmp_path / "tests" / "test_spec.py").write_text(
        "def test_hidden(s):\n    assert s.hidden == 0\n")
    (tmp_path / "chip_smoke.py").write_text(
        "import torch\n"
        "def main():\n"
        "    torch.backends.cuda.matmul.allow_tf32 = True\n")
    monkeypatch.chdir(tmp_path)
    rc = sentinel_main(["--json", "--no-baseline"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["files_analyzed"] == 3
    assert {(f["rule"], f["key"]) for f in payload["findings"]} == {
        ("RPR001", "Spec.hidden"),
        ("RPR011", "main:torch.backends.cuda.matmul.allow_tf32")}
    # outside a checkout, no paths is a usage error
    monkeypatch.chdir(tmp_path / "tests")
    with pytest.raises(SystemExit) as exc:
        sentinel_main([])
    assert exc.value.code == 2


def test_cli_write_baseline_roundtrip(tmp_path, monkeypatch, capsys):
    fixture = (FIX / "rpr004_fake_des_torch.py").read_text()
    p = tmp_path / "fake_des_torch.py"
    p.write_text(fixture)
    monkeypatch.chdir(tmp_path)
    bl = "bl.json"
    assert sentinel_main(["fake_des_torch.py"]) == 1
    assert sentinel_main(["fake_des_torch.py", "--write-baseline",
                          "--baseline", bl]) == 0
    # grandfathered: same findings now pass...
    assert sentinel_main(["fake_des_torch.py", "--baseline", bl]) == 0
    # ...but --no-baseline still shows them
    assert sentinel_main(["fake_des_torch.py", "--baseline", bl,
                          "--no-baseline"]) == 1
    # fixing the file leaves stale entries -> fail until they are removed
    p.write_text("x = 1\n")
    assert sentinel_main(["fake_des_torch.py", "--baseline", bl]) == 1


def test_cli_json_output(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = sentinel_main(["tests/sentinel_fixtures/torch/rpr005_solver_gate.py",
                        "tests/sentinel_fixtures/torch/rpr001",
                        "--json", "--no-baseline"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["rule"] for f in payload["findings"]} == {"RPR001", "RPR005"}
    assert [(f["rule"], f["key"]) for f in payload["suppressed"]] == \
        [("RPR001", "Annotated.kept")]


def test_cli_rejects_unknown_rule(monkeypatch):
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit):
        sentinel_main(["src/repro_torch", "--select", "RPR999"])


# -------------------------------------------------- baseline growth guard
def _write_baseline(path, entries):
    path.write_text(json.dumps({"version": 1, "findings": entries}))


def test_guard_empty_baseline_ok(tmp_path, capsys):
    f = tmp_path / "bl.json"
    _write_baseline(f, [])
    assert guard_main(["--baseline", str(f)]) == 0


def test_guard_missing_baseline_ok(tmp_path):
    assert guard_main(["--baseline", str(tmp_path / "absent.json")]) == 0


def test_guard_fails_when_baseline_grows(tmp_path, capsys):
    f = tmp_path / "bl.json"
    _write_baseline(f, [{"rule": "RPR006", "path": "src/x.py",
                         "key": "loop:item"}])
    assert guard_main(["--baseline", str(f)]) == 1
    out = capsys.readouterr().out
    assert "MAX_BASELINE_ENTRIES" in out or "budget" in out
    # raising the pinned budget (the in-change escape hatch) passes it
    assert guard_main(["--baseline", str(f), "--max-entries", "1"]) == 0


def test_guard_fails_on_duplicates(tmp_path):
    e = {"rule": "RPR006", "path": "src/x.py", "key": "loop:item"}
    f = tmp_path / "bl.json"
    _write_baseline(f, [e, dict(e)])
    assert guard_main(["--baseline", str(f), "--max-entries", "2"]) == 1


def test_guard_fails_on_stale_entry(tmp_path, monkeypatch):
    clean = tmp_path / "ok.py"
    clean.write_text("x = 1\n")
    f = tmp_path / "bl.json"
    _write_baseline(f, [{"rule": "RPR006", "path": "gone.py",
                         "key": "loop:item"}])
    monkeypatch.chdir(tmp_path)
    assert guard_main(["--baseline", str(f), "--max-entries", "1",
                       "--paths", "ok.py"]) == 1


def test_shipped_baseline_is_empty_and_guarded(monkeypatch):
    """The repo ships a zero-entry baseline and the guard agrees."""
    bl = Baseline.load(str(REPO / "sentinel_baseline_torch.json"))
    assert bl.entries == []
    monkeypatch.chdir(REPO)
    assert guard_main(["--baseline", "sentinel_baseline_torch.json"]) == 0


# ------------------------------------------------ parity with the reference
def _to_port(src: Path, dst: Path) -> Path:
    """Copy a reference fixture (file or tree) under `dst`, `repro`
    rewritten to `repro_torch` in its paths and its text."""
    files = [src] if src.is_file() else sorted(src.rglob("*.py"))
    for f in files:
        rel = Path(*["repro_torch" if part == "repro" else part
                     for part in f.relative_to(src.parent).parts])
        out = dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(re.sub(r"\brepro\.", "repro_torch.", f.read_text()))
    return dst / src.name


@pytest.mark.parametrize("code", sorted(SHARED))
def test_shared_rules_match_reference_on_its_fixtures(code, tmp_path):
    src = REF_FIX / SHARED[code]
    want = ref_analysis.analyze_paths([str(src)], select=[code],
                                      root=str(REPO))
    got = analyze_paths([str(_to_port(src, tmp_path))], select=[code],
                        root=str(tmp_path))
    assert want
    assert sorted(f.key for f in got) == sorted(f.key for f in want)
    assert [f.line for f in sorted(got, key=lambda f: f.key)] == \
        [f.line for f in sorted(want, key=lambda f: f.key)]


def test_suppressions_parse_alike_in_both_engines():
    src = "\n".join([
        "a = 1  # sentinel: ignore[RPR006]",
        "b = 2  # sentinel: ignore[RPR001, RPR009] a reason",
        "c = 3  # sentinel: ignore",
        "d = 4  # sentinel: ignored? no: ignore[rpr001]",
        "e = 5  # a comment that mentions the sentinel",
        "f = 6  #sentinel:ignore[RPR011]",
    ]) + "\n"
    port = FileContext.parse("<mem>", "src/repro_torch/m.py", source=src)
    ref = ref_engine.FileContext.parse("<mem>", "src/repro/m.py",
                                       source=src)
    assert port.suppressions == ref.suppressions
    assert port.suppressions[2] == {"RPR001", "RPR009"}


def test_baseline_reads_alike_in_both_engines(tmp_path):
    ours = analyze_paths([str(GOLDEN["RPR010"][0])], root=str(REPO))
    theirs = ref_analysis.analyze_paths([str(REF_FIX / "rpr009")],
                                        root=str(REPO))
    Baseline.from_findings(ours).save(str(tmp_path / "port.json"))
    ref_analysis.Baseline.from_findings(theirs).save(
        str(tmp_path / "ref.json"))
    assert ref_analysis.Baseline.load(str(tmp_path / "port.json")).ids() \
        == Baseline.from_findings(ours).ids()
    assert Baseline.load(str(tmp_path / "ref.json")).ids() == \
        ref_analysis.Baseline.from_findings(theirs).ids()
    # the two writers emit the same bytes for the same entries
    shutil.copy(tmp_path / "port.json", tmp_path / "copy.json")
    ref_analysis.Baseline.load(str(tmp_path / "copy.json")).save(
        str(tmp_path / "copy.json"))
    assert (tmp_path / "copy.json").read_text() == \
        (tmp_path / "port.json").read_text()
