"""``BENCHMARK.json`` against the contract's characters and limits, every
workload's files found by name, and what the harness may import."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, bench
from perfbench.harness import readers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_texts_use_the_allowed_characters():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert all(one_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
    names = [x["name"] for x in metrics]
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for cell in cells:
        def has(m):
            return cell in m.get("workloads", [cell])
        reported = [n for n, m in e2e.items() if has(m)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in b["per_layer"] if has(m)]
        assert layer
        for m in layer:
            assert has(e2e[m["moves"]])
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_every_workload_finds_its_files_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    pb = ROOT / "perfbench"
    for w in b["workloads"]:
        cfg_file = ROOT / configs[w["config"]]["file"]
        assert cfg_file.is_file() and cfg_file.is_relative_to(pb)
        cfg = json.loads(cfg_file.read_text())
        assert cfg["name"] == w["config"]
        assert (pb / "drivers" / f"{cfg['driver']}.py").is_file()
        mix_file = pb / "traffic" / f"{w['traffic']}.json"
        assert mix_file.is_file()
        gen = json.loads(mix_file.read_text())["generator"]
        assert (pb / "traffic" / "generators" / f"{gen}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert readers.reader_file(pb / "metrics", m["name"]).is_file(), \
            m["name"]
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))


PROBE = """
import sys
sys.path[:0] = [{root!r}]
{imports}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {forbidden!r})
print(bad)
"""


@pytest.mark.parametrize("what,imports,forbidden", [
    ("harness",
     "import perfbench.harness.data, perfbench.harness.trace, "
     "perfbench.harness.work, perfbench.harness.readers, "
     "perfbench.harness.loop, perfbench.harness.host, "
     "perfbench.reference.search\n"
     "import importlib.util as u\n"
     "s = u.spec_from_file_location('d', {driver!r})\n"
     "m = u.module_from_spec(s); sys.modules['d'] = m; s.loader.exec_module(m)",
     {"jax", "jaxlib", "flax", "repro"}),
    ("reference", "import perfbench.reference.search",
     {"jax", "jaxlib", "flax", "repro", "repro_torch"}),
])
def test_imports_load_neither_jax_nor_the_jax_package(what, imports,
                                                      forbidden):
    code = PROBE.format(
        root=str(ROOT), forbidden=forbidden,
        imports=imports.format(
            driver=str(ROOT / "perfbench" / "drivers" / "db_search.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", (what, out.stdout)


def test_the_harness_refuses_to_run_without_the_program(tmp_path):
    # a checkout holding only BENCHMARK.json and perfbench/ (no card here
    # either): no result line, and another exit code than 0
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "iprg2012_db.backlog", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_forbidden_name_check_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        import run as harness_run
    finally:
        sys.path.remove(str(ROOT / "perfbench"))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys
        assert "repro" not in harness_run.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert harness_run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    assert Path(harness_run.__file__).parent == ROOT / "perfbench"
