"""``BENCHMARK.json`` and the files it names, found by name.

A cell is ``<config>.<traffic>``: its configuration is the file the
manifest gives, its traffic mix ``traffic/<traffic>.json``, each of its
per-layer metrics' readers ``layers/<metric>.py``. The corpus family, the
system and the entry that the configuration and the mix name are
``families/<name>.py``, ``systems/<name>.py`` and ``entries/<name>.py``.
Adding any of them is adding a file and, for cells and metrics, a manifest
entry: nothing here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

#: the benchmark's own folder; every lookup takes it as ``root``
ROOT = Path(__file__).resolve().parent
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclass
class Cell:
    """One workload of the manifest, with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    #: the end-to-end metrics this cell reports, manifest entries
    end_to_end: list = field(default_factory=list)
    #: the per-layer metrics this cell reports, manifest entries
    per_layer: list = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    """The manifest at the repository root above ``root``."""
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those its
    ``workloads`` list names."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration and traffic read; raises
    KeyError for a name the manifest lacks."""
    m = manifest if manifest is not None else load(root)
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    e2e = [x for x in m["end_to_end"] if reports(x, name)]
    e2e_names = {x["name"] for x in e2e}
    layers = [x for x in m["per_layer"]
              if (reports(x, name) if "workloads" in x else x["moves"] in e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root.parent / conf["file"]).read_text()),
        traffic=json.loads(traffic_path(w["traffic"], root).read_text()),
        end_to_end=e2e, per_layer=layers,
    )


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "traffic" / f"{name}.json"


def load_module(path: Path):
    """The Python file at ``path`` as a module (layer readers' names hold
    dots, so they are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    key = "qbench._by_path." + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def layer_reader(metric: str, root: Path = ROOT):
    """The reader of per-layer metric ``metric``: a module with
    ``read(trace) -> float | None``."""
    return load_module(root / "layers" / f"{metric}.py")


def family(name: str, root: Path = ROOT):
    """Corpus family ``name``: ``make(params, n, d, m, corpus_gen, query_gen)``."""
    return load_module(root / "families" / f"{name}.py")


def system(name: str, root: Path = ROOT):
    """System ``name``: ``build(config, corpus, device, recorder)``."""
    return load_module(root / "systems" / f"{name}.py")


def entry(name: str, root: Path = ROOT):
    """Entry ``name``: ``run(ctx) -> Window``."""
    return load_module(root / "entries" / f"{name}.py")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run (corpus, queries, judged
    sample), from the run's ``--seed`` and the stream's tag."""
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generators(config: dict, seed: int, device):
    """(corpus generator, query generator) on ``device``: the corpus is the
    configuration's (its ``corpus_seed``), the same in every run, so every
    seed measures the same work; the queries are the run's ``seed``'s."""
    import torch

    g_c = torch.Generator(device=device)
    g_c.manual_seed(sub_seed(config["data"]["corpus_seed"], "corpus"))
    g_q = torch.Generator(device=device)
    g_q.manual_seed(sub_seed(seed, "queries"))
    return g_c, g_q
