"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from this module's first line to the
window's first request): the corpus and the queries are made on the card
from the seed, the system is built through its own entry points, and the
entry warms up the cell's shapes. The window runs for ``--seconds``. Then
the peak of device memory is read, the program's state is freed, and the
plain reference (``qbench/reference``) judges a sample of the window's
answers from a corpus it makes again from the seed.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, from a profiled slice of the
window), ``device``, ``breakdown`` in a traced run, and ``checks``: each
number compared with its limit, also the last lines of standard error.
Without the cards the cell needs it prints no result and exits 2; if JAX
or the JAX package is loaded once the window has closed it prints no
result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from qbench import manifest  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "quiver_tpu")
REPO = Path(__file__).resolve().parents[1]
#: caches of anything that compiles kernels, at fixed paths in the checkout
#: (the program's own nvcc build lives in ``quiver_tpu_torch/_build``): the
#: CUDA driver's JIT cache, PyTorch's NVRTC kernel cache, Triton's
CACHE = REPO / ".qbench_cache"
CACHE_VARS = {"CUDA_CACHE_PATH": "nv", "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def set_cache_dirs() -> None:
    """Point every kernel cache at its directory in the checkout, before
    anything touches the card; keep transformers-style JAX imports off."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _topology_sizes(ivf):
    import numpy as np

    topo = ivf.export_topology()
    assign = topo["assign"]
    sizes = np.bincount(assign[assign >= 0], minlength=len(topo["centroids"]))
    return topo["centroids"], sizes


def _launch_counts():
    from quiver_tpu_torch.ops import ivf_cuda

    return dict(ivf_cuda.launch_counts)


def _work(system, rec, metric: str, device) -> dict:
    """{kernel family: {"bytes", "flops", "peak"}} of the IVF engine's
    ``block_topw`` calls in the slice (``qbench/roofline.py``)."""
    from qbench.roofline import call_work

    calls = rec.calls.get(system.ivf_span) if system.ivf is not None else None
    if not calls or len(rec.snaps) < 2:
        return {}
    before, after = rec.snaps[0], rec.snaps[1]
    launched = {key: after[key] - before.get(key, 0) for key in after
                if after[key] > before.get(key, 0)}
    if not launched:
        return {}
    key = max(launched, key=launched.get)
    f32 = key[0] == "f32"
    variant = key[1] if f32 else key
    cents, sizes = _topology_sizes(system.ivf)
    nbytes = flops = 0.0
    for queries, _k in calls:
        b, f = call_work(queries, cents, sizes, metric=metric, n_probe=system.ivf.config.n_probe,
                         block_bytes=4 if f32 else 2, variant=variant, device=device)
        nbytes += b
        flops += f
    return {"block_topw_f32" if f32 else "block_topw":
            {"bytes": nbytes, "flops": flops, "peak": "tf32" if f32 else "bf16"}}


class GcWatch:
    """The interpreter's garbage collections while a window runs (count
    and seconds by generation), for the run's log."""

    def __enter__(self):
        self.t0 = 0.0
        self.by_gen = [[0, 0.0] for _ in range(3)]
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            g = self.by_gen[info["generation"]]
            g[0] += 1
            g[1] += time.perf_counter() - self.t0

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> list:
        return [[n, round(s, 4)] for n, s in self.by_gen]


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, *,
             t_start: float = T_START, root: Path = manifest.ROOT) -> dict:
    """One run of ``cell`` on ``device``: the result line's dict, with
    ``checks`` last."""
    import torch

    from qbench.device import peaks
    from qbench.reference import judge
    from qbench.trace import Recorder, Trace, breakdown, busy_s, port_kernel_names
    from qbench.window import Context

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    rec = Recorder(trace)
    fam = manifest.family(cfg["data"]["family"], root)
    ent = manifest.entry(tr["entry"], root)
    n, d, k = cfg["n"], cfg["d"], tr["k"]

    def corpus_and_queries(m: int):
        return fam.make(cfg["data"], n, d, m, *manifest.generators(cfg, seed, device))

    corpus, queries = corpus_and_queries(ent.pool_size(tr))
    check_sum = float(corpus.double().sum())
    corpus_np = corpus.cpu().numpy()
    queries = queries.cpu()  # host arrays in, as callers hand them over
    del corpus
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    system = manifest.system(cfg["serving"]["system"], root).build(cfg, corpus_np, device, rec)
    del corpus_np
    if trace and system.ivf is not None and cuda:
        rec.watch = _launch_counts
    rec.warm_up()
    with GcWatch() as gcw:
        win = ent.run(Context(seed=seed, seconds=seconds, trace=trace, config=cfg, traffic=tr,
                              system=system, queries=queries, rec=rec, device=device))
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": mem_peak}
    bd = None
    if trace:
        import quiver_tpu_torch

        t = Trace(spans=list(rec.spans), window=(win.t0, win.t1), system=system,
                  slice=rec.slice if rec.slice and rec.slice[1] else None,
                  peaks=peaks(torch.cuda.get_device_name(device)) if cuda else None,
                  port_kernels=port_kernel_names(Path(quiver_tpu_torch.__file__).parent / "csrc"))
        if t.slice:
            lo, hi = t.slice
            t.device = [e for e in rec.events() if e[2] > lo and e[1] < hi]
            t.work = _work(system, rec, cfg["metric"], device)
            dev.update(busy_s=busy_s(t), window_s=hi - lo)
        for m in cell.per_layer:
            v = manifest.layer_reader(m["name"], root).read(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        bd = breakdown(t)
        del t

    info = system.info
    del system, queries
    rec.calls.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    corpus, _ = corpus_and_queries(0)
    if abs(float(corpus.double().sum()) - check_sum) > 1e-9 * abs(check_sum) + 1e-6:
        raise RuntimeError("the corpus made again from the seed differs from the run's")
    nums = judge.numbers(corpus, torch.as_tensor(win.judged, device=device), win.answers, k,
                         cfg["metric"])
    ok, checks = judge.verdict(nums, cfg["check"])
    del corpus

    values = dict(win.metrics, recall_at_k=nums["recall"], setup_s=win.t0 - t_start)
    if not trace:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    out = {"correct": ok, "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if bd:
        out["breakdown"] = bd
    # for the log: a traced run's end-to-end readings give the tracing's
    # overhead against an untraced run's
    out["notes"] = dict(win.notes, system=info, e2e=values, dist_gap_max=nums["dist_gap_max"],
                        gc=gcw.summary())
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = manifest.cell(args.workload)

    import torch

    from qbench.device import cards_missing, power_limit

    why = cards_missing(cell.chips)
    if why:
        print(f"qbench: {why}; no result", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"qbench: loaded in this process: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    out["notes"]["power_limit"] = power_limit()
    checks = out.pop("checks")
    print("qbench notes: " + json.dumps(out.pop("notes")), file=sys.stderr)
    for name, c in checks.items():
        lim = " ".join(f"{key} {val!r}" for key, val in c.items() if key != "value")
        print(f"qbench check {name} {c['value']!r} {lim}", file=sys.stderr)
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
