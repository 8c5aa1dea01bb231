"""BENCHMARK.json keeps the contract's form, and every name it gives is
found by the harness's lookup, also for cells, mixes and metrics that a
later change adds as new files."""

from __future__ import annotations

import json
import shutil

import pytest

from qbench import manifest
from qbench.window import Context, Window

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
LINE_KEYS = ("why", "layer", "source")


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_has_the_contract_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(_line_ok(w) for w in M["command"])
    assert M["paths"] == ["qbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert len(json.dumps(M)) <= 64 * 1024
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("qbench/") and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in M["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_use_the_allowed_characters():
    groups = [M["configs"], M["workloads"], M["end_to_end"], M["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        for x in group:
            assert manifest.NAME_RE.fullmatch(x["name"]), x["name"]
            assert all(_line_ok(x[key]) for key in LINE_KEYS if key in x)
            if "unit" in x:
                assert manifest.UNIT_RE.fullmatch(x["unit"]), x["unit"]
            if "better" in x:
                assert x["better"] in ("lower", "higher")
    assert not {m["name"] for m in M["end_to_end"]} & {m["name"] for m in M["per_layer"]}
    for w in M["workloads"]:
        assert manifest.NAME_RE.fullmatch(w["config"]) and manifest.NAME_RE.fullmatch(w["traffic"])
    for c in M["configs"]:
        assert all(manifest.NAME_RE.fullmatch(k) for k in c["reduced"])


def test_a_full_check_of_24_cells_fits_in_twelve_hours():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_configuration_mix_and_readers(name):
    cell = manifest.cell(name)
    assert cell.config["name"] == next(w["config"] for w in M["workloads"] if w["name"] == name)
    assert {"n", "d", "metric", "data", "serving", "check", "control", "reduced"} <= set(cell.config)
    manifest.family(cell.config["data"]["family"])
    manifest.system(cell.config["serving"]["system"])
    entry = manifest.entry(cell.traffic["entry"])
    assert entry.pool_size(cell.traffic) > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.layer_reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_each_layer_metric_is_in_cells_that_report_what_it_moves(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    moves = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert manifest.reports(moves, cell), (metric, cell)


def test_a_new_cell_config_mix_and_metric_are_new_files_alone(tmp_path):
    """A dummy configuration, mix, entry and metric added as new files in a
    copy: the lookup finds them and the reader reads a trace."""
    shutil.copytree(manifest.ROOT, tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tmp_path / "qbench"
    m = json.loads((manifest.ROOT.parent / "BENCHMARK.json").read_text())
    cfg = dict(json.loads((root / "configs" / "sift1m-ivf-bf16.json").read_text()),
               name="dummy-cfg", n=512)
    (root / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (root / "traffic" / "dummy-mix.json").write_text(json.dumps({"entry": "dummy_entry", "k": 3}))
    (root / "entries" / "dummy_entry.py").write_text(
        "def pool_size(traffic):\n    return 7\n")
    (root / "layers" / "dummy.layer_metric.py").write_text(
        "def read(t):\n    return 42.0 if t.spans else None\n")
    m["configs"].append({"name": "dummy-cfg", "source": "https://example.org/dummy",
                         "file": "qbench/configs/dummy-cfg.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg",
                           "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "dummy.layer_metric", "unit": "%", "better": "lower",
                           "source": "program_span", "layer": "a test", "moves": "setup_s",
                           "workloads": ["dummy-cfg.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.cell("dummy-cfg.dummy-mix", root)
    assert cell.config["n"] == 512 and cell.traffic["k"] == 3
    assert [x["name"] for x in cell.per_layer] == ["dummy.layer_metric"]
    assert manifest.entry(cell.traffic["entry"], root).pool_size(cell.traffic) == 7
    from qbench.trace import Trace

    reader = manifest.layer_reader("dummy.layer_metric", root)
    assert reader.read(Trace(spans=[("x", 0.0, 1.0, 0, 1)])) == 42.0
    assert reader.read(Trace()) is None
    assert manifest.cell("sift1m-ivf-bf16.batch64k", root).config["name"] == "sift1m-ivf-bf16"


def test_sub_seeds_are_stable_and_distinct():
    big = 2**31 + 12345
    assert manifest.sub_seed(big, "data") == manifest.sub_seed(big, "data")
    assert manifest.sub_seed(big, "data") != manifest.sub_seed(big, "judge")
    assert 0 <= manifest.sub_seed(big, "data") < 2**63


def test_window_and_context_carry_what_the_harness_reads():
    fields = set(Window.__dataclass_fields__)
    assert {"t0", "t1", "attempted", "failed", "metrics", "judged", "answers"} <= fields
    assert {"seed", "seconds", "trace", "system", "queries", "rec"} <= set(
        Context.__dataclass_fields__)
