"""BENCHMARK.json and the files it names: structure, names, resolution by
name, and the imports of the harness and of its reference."""

import ast
import json
import re
from pathlib import Path

import pytest

from conftest import ROOT
from port_bench import harness

HERE = ROOT / "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
YEAR = re.compile(r"\b(19|20)[0-9]{2}\b")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_structure(bench):
    assert set(bench) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert set(entry) - {"workloads"} == KEYS[section], entry
            if "workloads" in entry:
                assert section in ("end_to_end", "per_layer")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in bench["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_names_and_units(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
            if section == "configs":
                # a public URL, or a paper cited with its year
                assert _line(entry["source"]) and (entry["source"].startswith("https://")
                                                   or YEAR.search(entry["source"]))
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for word in bench["command"]:
        assert _line(word)


def test_paths(bench):
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in Path(p).parts and (ROOT / p).is_dir()
        assert not p.rstrip("/").endswith("_torch")
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in Path(word).parts
        if (ROOT / word).exists():
            assert any(Path(word).parts[:len(Path(p).parts)] == Path(p).parts
                       for p in bench["paths"])


def test_every_cell_resolves_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        cfg = configs[w["config"]]
        used.add(w["config"])
        assert cfg["file"].startswith("port_bench/") and (ROOT / cfg["file"]).is_file()
        cell = harness.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == cfg["reduced"]
        assert (ROOT / cell.config["reference"]).is_file()
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "entries" / f"{cell.traffic['entry']}.py").is_file()
        assert callable(harness.entry_class(cell.traffic))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
        assert cell.end_to_end and cell.per_layer
        assert set(cell.traffic["limits"]) == {"rel_err"}
    assert used == set(configs)
    assert len({c["file"] for c in bench["configs"]}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


SOURCES_PY = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    """Compared by whole top-level name: the port's name begins with the JAX
    package's."""
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "hisstools_library_tpu"}, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert top <= {"__future__", "torch", "numpy", "math"}, top


def test_forbidden_modules_by_whole_name():
    from port_bench.run import forbidden_modules
    mods = ["hisstools_library_tpu_torch", "hisstools_library_tpu_torch.fft", "jaxtyping",
            "torch", "jax.numpy", "hisstools_library_tpu.ops", "flax"]
    assert forbidden_modules(mods) == ["flax", "hisstools_library_tpu.ops", "jax.numpy"]


def test_config_files_state_the_deployment(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["dtype"] == "float32"
        assert cfg["assumed"] and cfg["guarantees"] and cfg["deployment"]
