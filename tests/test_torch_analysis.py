"""The port's analyzer (`repro_torch.analysis`): the fixture corpus, the
suppression grammar against the reference's, the CLI, and the port's own
tree under `--strict`.

Every bad fixture under tests/torch_analysis_fixtures/ carries
`# EXPECT-Rn` on the exact lines the rule must flag; the analyzer must
report precisely those (rule, line) pairs. The good twins (the patterns
the port ships) pass clean. The rules' tables are data (`LAYERS`, `ROOTS`,
`DONORS`), and the C side of R2/R3 is held to the port's own CUDA
sources: the three accumulated arguments of the port, and all five
libraries' declarations.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro.analysis.findings import Suppressions as RefSuppressions
from repro_torch.analysis import donation, kernel_rules, tracer_rules
from repro_torch.analysis.cli import RULE_FAMILIES, analyze, main
from repro_torch.analysis.findings import Suppressions
from repro_torch.analysis.layering import LAYERS
from repro_torch.analysis.modindex import PackageIndex

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
SRC = os.path.join(ROOT, "src", "repro_torch")

_EXPECT_RE = re.compile(r"#\s*EXPECT-(R\d)\b")
BAD = ["bad_r1", "bad_r2", "bad_r3", "bad_r4", "bad_r5"]
GOOD = ["good_r1", "good_r2", "good_r3", "good_r4", "good_r5"]


def _expected(fixture_dir):
    """All (rule, path, line) sentinels in a fixture package."""
    out = set()
    for dirpath, _dirs, files in os.walk(fixture_dir):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                for i, line in enumerate(f, start=1):
                    for m in _EXPECT_RE.finditer(line):
                        out.add((m.group(1), path, i))
    return out


def test_no_fixture_is_a_test_module():
    for _dirpath, _dirs, files in os.walk(FIXTURES):
        assert not [f for f in files if f.startswith("test_")]


@pytest.mark.parametrize("fixture", BAD)
def test_bad_fixture_flagged_at_the_right_lines(fixture):
    root = os.path.join(FIXTURES, fixture)
    active, suppressed, _s1, n = analyze(root)
    assert n > 0
    assert not suppressed
    got = {(f.rule, f.path, f.line) for f in active}
    want = _expected(root)
    assert want, f"{fixture} has no EXPECT sentinels"
    assert {r for r, _, _ in want} == {fixture[-2:].upper()}
    missing = want - got
    extra = got - want
    assert not missing, f"expected findings not raised: {sorted(missing)}"
    assert not extra, f"unexpected findings: {sorted(extra)}"


@pytest.mark.parametrize("fixture", GOOD)
def test_good_twin_passes_clean(fixture):
    root = os.path.join(FIXTURES, fixture)
    active, suppressed, s1, n = analyze(root)
    assert n > 0
    assert active == [], [f.format() for f in active]
    assert suppressed == [] and s1 == []


def test_every_rule_family_fires_in_the_corpus():
    got = set()
    for fixture in BAD:
        active, *_ = analyze(os.path.join(FIXTURES, fixture))
        got |= {f.rule for f in active}
    assert got == set(RULE_FAMILIES) == {"R1", "R2", "R3", "R4", "R5"}


def test_rule_tables():
    """R1 keeps the reference's four contracts and adds the port's own;
    R4's roots start at the DFS step; R5's donors are the reference's
    donation sites."""
    assert [r.name for r in LAYERS] == [
        "kernel-privates", "graph-purity", "engine-no-upward",
        "driver-no-launch", "no-jax-no-reference"]
    assert ("core/engine/loop.py", "dfs_step") in {
        (r.path, r.func) for r in tracer_rules.ROOTS}
    donors = {(d.path, d.func): d.argnums for d in donation.DONORS}
    assert donors[("models/transformer.py", "decode_step")] == (2,)
    assert donors[("models/lm_steps.py", "make_train_step")] == (0, 1)
    assert donors[("core/driver.py", "_shard_counts")] == (0, 1, 2, 3, 4)


# ---------------------------------------------------------------------------
# R2/R3 on the port's CUDA sources
# ---------------------------------------------------------------------------

def test_accumulators_of_the_port_found_in_its_sources():
    """The three arguments the port's kernels add into with atomics, each
    traced to its entry point (through aliases and launches), and each
    entry point's own initialisation."""
    index = PackageIndex.build(SRC)
    acc = {}
    for lib in kernel_rules.find_libraries(index):
        for name, fn in lib.source.entries().items():
            for i, line in fn.acc.items():
                acc[(os.path.basename(lib.source.path), name,
                     fn.params[i].name)] = (line, i in fn.init)
    assert acc == {
        ("embedding_bag.cu", "embedding_bag_sum_bwd", "grad_table"):
            (138, False),
        ("common_neighbor.cu", "common_neighbor_has_common", "queued"):
            (355, True),
        ("common_neighbor.cu", "common_neighbor_edges", "status"):
            (449, False),
    }


def test_signatures_cover_all_five_libraries():
    index = PackageIndex.build(SRC)
    libs = {os.path.basename(lib.source.path): lib
            for lib in kernel_rules.find_libraries(index)}
    assert sorted(libs) == ["bitset_ops.cu", "common_neighbor.cu",
                            "embedding_bag.cu", "flash_attention.cu",
                            "segment_spmm.cu"]
    for name, lib in libs.items():
        entries = lib.source.entries()
        for entry, (_key, kinds) in lib.signatures.items():
            assert kinds is not None, (name, entry)
            assert entry in entries, (name, entry)
            assert kinds == [p.kind for p in entries[entry].params], entry


# ---------------------------------------------------------------------------
# suppression mechanics: the reference's grammar
# ---------------------------------------------------------------------------

GRAMMAR = [
    "x = 1  # mce-lint: disable=R1,R4 -- two rules, one comment\n",
    "x = 1  # mce-lint: disable=R2\n",
    "# mce-lint: disable=R4 -- the next line\ny = 2\n",
    "# mce-lint: disable-file=R3 — whole module, em dash\n",
    "z = 3  #mce-lint:disable = R5 ,R1--tight spacing\n",
    "w = 4  # mce-lint: disable=R4 --   \n",
    "v = 5  # mce-lint: enable=R4 -- not a suppression\n",
    "a = 1\nb = 2  # mce-lint: disable=S1 -- any id\n",
]


@pytest.mark.parametrize("source", GRAMMAR)
def test_suppression_grammar_matches_the_reference(source):
    got, want = Suppressions(source), RefSuppressions(source)
    assert [vars(e) for e in got.entries] == \
        [vars(e) for e in want.entries]
    for rule in ("R1", "R2", "R3", "R4", "R5", "S1"):
        for line in range(1, 4):
            g, w = got.match(rule, line), want.match(rule, line)
            assert (g is None) == (w is None)


def test_suppression_inline_and_next_line(tmp_path):
    pkg = tmp_path / "suppkg" / "core" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "loop.py").write_text(
        "def dfs_step(cfg, ctx, depth, stack, carry, live):\n"
        "    a = int(live.sum())  # mce-lint: disable=R4 -- test: inline\n"
        "    # mce-lint: disable=R4 -- test: next-line form\n"
        "    b = int(live.sum())\n"
        "    c = int(live.sum())\n"
        "    return a + b + c\n")
    active, suppressed, s1, _ = analyze(str(tmp_path / "suppkg"))
    assert len(suppressed) == 2
    assert [f.line for f in active] == [5]
    assert s1 == []


def test_suppression_file_level_and_s1(tmp_path):
    pkg = tmp_path / "suppkg" / "core" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "loop.py").write_text(
        "# mce-lint: disable-file=R4\n"
        "def dfs_step(cfg, ctx, depth, stack, carry, live):\n"
        "    return live.any().item()\n")
    active, suppressed, s1, _ = analyze(str(tmp_path / "suppkg"))
    assert active == [] and len(suppressed) == 1
    assert len(s1) == 1 and s1[0].rule == "S1" and s1[0].line == 1
    assert main([str(tmp_path / "suppkg")]) == 0
    assert main([str(tmp_path / "suppkg"), "--strict"]) == 1


# ---------------------------------------------------------------------------
# the CLI and the port's tree
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_report(tmp_path):
    report = tmp_path / "lint_report.json"
    rc = main([os.path.join(FIXTURES, "bad_r2"), "--report", str(report),
               "--format", "json"])
    assert rc == 1
    data = json.loads(report.read_text())
    assert data["counts"]["active"] == 2
    assert {f["rule"] for f in data["findings"]} == {"R2"}
    assert main([os.path.join(FIXTURES, "good_r2"), "--strict"]) == 0
    assert main([os.path.join(FIXTURES, "does_not_exist")]) == 2
    assert main([os.path.join(FIXTURES, "bad_r3"), "--rules", "R2"]) == 0
    assert main([os.path.join(FIXTURES, "bad_r3"), "--rules", "R3"]) == 1


def test_port_is_clean_under_strict_without_torch_or_jax():
    """The gate `python -m repro_torch.analysis src/repro_torch --strict`:
    exit 0, every module of the port read, and neither torch nor jax
    imported on the way."""
    code = (
        "import sys, json\n"
        "from repro_torch.analysis.cli import analyze, main\n"
        "rc = main(['" + SRC + "', '--strict'])\n"
        "active, suppressed, s1, n = analyze('" + SRC + "')\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'numpy'))\n"
        "print(json.dumps(dict(rc=rc, n=n, s1=len(s1), heavy=heavy)))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0, proc.stdout
    assert out["n"] >= 95 and out["s1"] == 0
    assert out["heavy"] == []


def test_package_index_resolves_reexports():
    index = PackageIndex.build(SRC)
    resolved = index.resolve_symbol("repro_torch.core.engine.run_root")
    assert resolved is not None
    mod, node = resolved
    assert mod.name == "repro_torch.core.engine.loop"
    assert getattr(node, "name", None) == "run_root"
