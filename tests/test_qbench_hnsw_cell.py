"""The cell ``sift1m-hnsw.batch2k`` through the benchmark on the CPU, its
configuration cut to 4,096 rows (64 centres, build rounds of 1,024, so
the build runs the bootstrap and three connect rounds) and its traffic to
two batches of 256: a sound run comes out correct, with the cell's
end-to-end metrics, and a traced one with the engine's per-layer metrics
(the roofline needs the card's peaks, so it reads nothing here); with the
timed path broken underneath (half of each batch answered as the other
half; another row in each answer's last place) and for the control (the
reference in TF32) it comes out not correct."""

from __future__ import annotations

import json

import pytest
import torch

from qbench import manifest
from qbench.control import readings
from qbench.run import run_cell
from qbench.tests import small
from qbench.tests.test_qbench_faults import _Broken

CELL = "sift1m-hnsw.batch2k"
SEED = 2**31 + 2121


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = small.copy(tmp_path_factory.mktemp("small"))
    path = root / "configs" / "sift1m-hnsw.json"
    cfg = json.loads(path.read_text())
    cfg["n"] = 4096
    cfg["data"]["n_centers"] = 64
    cfg["serving"]["hnsw"]["build_batch"] = 1024
    path.write_text(json.dumps(cfg))
    path = manifest.traffic_path("batch2k", root)
    path.write_text(json.dumps(dict(json.loads(path.read_text()), batch=256, pool_batches=2,
                                    judge=64, warm_calls=1)))
    return root


def _run(root, trace=False):
    return run_cell(manifest.cell(CELL, root), SEED, small.SECONDS, trace, torch.device("cpu"),
                    root=root)


def test_a_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in manifest.cell(CELL, root).end_to_end}
    assert out["notes"]["system"]["ef_search"] >= 100


def test_a_traced_run_reads_the_engines_spans(root):
    out = _run(root, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    want = {"hnsw.descent_ms", "hnsw.beam_ms", "hnsw.beam_loops", "hnsw.build_s",
            "hnsw.build_scan_s", "hnsw.build_connect_s", "engine.call_ms"}
    assert want <= set(got) and "hnsw.beam.roofline" not in got
    assert got["hnsw.beam_loops"]["value"] >= 1
    assert 0 < got["hnsw.build_scan_s"]["value"] < got["hnsw.build_s"]["value"]
    assert got["hnsw.beam_ms"]["value"] < got["engine.call_ms"]["value"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    real = manifest.system
    monkeypatch.setattr(manifest, "system", lambda name, r: _Broken(real(name, r), fault))
    out = _run(root)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(root):
    r = readings(manifest.cell(CELL, root), SEED, torch.device("cpu"), root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["recall"]["value"] >= 0.95  # it fails by the distances alone
