"""A whole run, past the look for a card, at CPU sizes: sound, it comes
out correct; with the timed path broken underneath it comes out not
correct, for each fault a cell can have (half of each batch left out,
answered as the other half; an answer altered where it is produced); the
control (the reference one precision below the configuration's) comes
out not correct too. The cells have no training state and no exchange
between chips, so those faults do not apply."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qbench import manifest
from qbench.control import readings
from qbench.run import run_cell
from qbench.tests import small

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.copy(tmp_path_factory.mktemp("small"))


def _break(system, how: str):
    """Wrap the engine's ``search_slots`` (every entry's answers pass
    through it) with ``how``: "half_batch" answers the second half of each
    batch with the first half's answers; "altered" puts another row in
    each answer's last place, its distance kept."""
    eng = system.engine
    inner = eng.search_slots

    def broken(queries, k, **kw):
        dist, slots = inner(queries, k, **kw)
        dist, slots = dist.copy(), slots.copy()
        if how == "half_batch":
            h = len(slots) // 2
            dist[h:2 * h], slots[h:2 * h] = dist[:h], slots[:h]
        elif how == "altered":
            n = system.engine.store.size
            slots[:, -1] = np.where(slots[:, -1] >= 0, (slots[:, -1] + 1) % n, slots[:, -1])
        return dist, slots

    eng.search_slots = broken


class _Broken:
    """A system module whose ``build`` breaks the timed path of what the
    real module builds."""

    def __init__(self, module, how: str):
        self.module, self.how = module, how

    def build(self, *args):
        system = self.module.build(*args)
        _break(system, self.how)
        return system


def _run(root, cell: str, monkeypatch=None, fault=None):
    if fault is not None:
        real = manifest.system
        monkeypatch.setattr(manifest, "system", lambda name, r: _Broken(real(name, r), fault))
    return run_cell(manifest.cell(cell, root), SEED, small.SECONDS, False, torch.device("cpu"),
                    root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in manifest.cell(cell, root).end_to_end}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    out = _run(root, cell, monkeypatch, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    r = readings(manifest.cell(cell, root), SEED, torch.device("cpu"), root)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_a_small_cell_runs_correct_on_the_card(root, card):
    out = run_cell(manifest.cell("sift1m-ivf-bf16.batch64k", root), SEED, small.SECONDS, True,
                   card, root=root)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
