"""BENCHMARK.json against the rules it is held to: its keys, names,
units and limits, and every cell, configuration, traffic mix, limit
file, driver, reference, metric reader and kernel list resolving to its
file under the benchmark's folder."""
import json
import re

import pytest

from port_bench import harness

BENCH_FILE = harness.ROOT / "BENCHMARK.json"
BENCH = json.loads(BENCH_FILE.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head", "expand", "experts_per", "d_model", "d_ff")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH_FILE.stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (harness.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        if "/" in w and (harness.ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16,
              "per_layer": 128}
    assert 1 <= len(entries) <= limits[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        required = KEYS[section] - {"workloads"}
        assert required <= set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if "workloads" in e and section != "workloads":
            assert set(e["workloads"]) <= set(CELLS), e["name"]


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
            assert not any(w in k for w in WIDTH_WORDS), k
            assert k in cfg, k
        assert (harness.BENCH_DIR / cfg["reference"]).is_file()
        assert (harness.BENCH_DIR / "drivers" /
                f"{cfg['driver']}.py").is_file()


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (harness.BENCH_DIR / "traffic" /
                f"{w['traffic']}.json").is_file()
        assert (harness.BENCH_DIR / "limits" /
                f"{w['name']}.json").is_file()


def test_end_to_end():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def test_per_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        reader = harness.BENCH_DIR / "metrics" / f"{m['name']}.py"
        assert reader.is_file(), reader
        assert callable(harness.load_module(f"metrics/{m['name']}.py").read)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    c = harness.resolve(BENCH, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for name in ("k1", "cg_matvec"):
        assert harness.load_json(harness.BENCH_DIR / "kernels" /
                                 f"{name}.json")


def test_file_names_under_paths():
    for p in BENCH["paths"]:
        for f in (harness.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(harness.ROOT).as_posix()
            assert PATH.match(rel), rel
