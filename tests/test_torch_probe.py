"""The probe kernels of the port against ``benches/probe_pallas.py``.

``probe_pallas.main()`` runs in this process on the CPU in Pallas
interpret mode (its ``INTERPRET`` switched on), with
``jax.experimental.pallas.pallas_call`` wrapped to record each call's
inputs and output. The port's plain versions, and its wrappers on CPU
tensors, must reproduce both recorded outputs exactly from the recorded
inputs (the kernels copy and double floats, and add one int to a float:
no rounding differs). Nothing in the JAX package changes.

The rest holds the plain versions to the semantics the CUDA kernels keep
(empty clusters, rows outside every range left at -1, targets outside the
chunk skipped) and runs ``quiver_tpu_torch.benches.probe`` small on the
CPU.
"""

import numpy as np
import pytest
import torch

from quiver_tpu_torch.benches import probe
from quiver_tpu_torch.ops.probe_cuda import (
    index_read,
    index_read_reference,
    launch_counts,
    scatter_rows,
    scatter_rows_reference,
)


@pytest.fixture(scope="module")
def pallas_calls():
    """[(grid, inputs, output)] of the two pallas_calls of probe_pallas.main,
    run in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    import benches.probe_pallas as pp

    calls = []
    real = pl.pallas_call

    def recording(kernel, **kw):
        fn = real(kernel, **kw)

        def run(*args):
            out = fn(*args)
            calls.append((tuple(kw["grid_spec"].grid),
                          [np.array(a) for a in args], np.array(out)))
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(pp, "INTERPRET", True)
    mp.setattr(pl, "pallas_call", recording)
    try:
        pp.main()
    finally:
        mp.undo()
    assert len(calls) == 2
    return calls


@pytest.mark.parametrize("fn", [scatter_rows_reference, scatter_rows])
def test_scatter_rows_reproduces_pallas(pallas_calls, fn):
    (nchunks, K), (starts, pos, vals), out = pallas_calls[0]
    before = dict(launch_counts)
    got = fn(torch.from_numpy(vals), torch.from_numpy(starts), torch.from_numpy(pos), K=K)
    np.testing.assert_array_equal(got.numpy(), out)
    assert launch_counts == before  # the CPU runs the plain version


@pytest.mark.parametrize("fn", [index_read_reference, index_read])
def test_index_read_reproduces_pallas(pallas_calls, fn):
    (grid,), (big, x), out = pallas_calls[1]
    # probe_pallas.py:103 reads big[i * 1000]
    got = fn(torch.from_numpy(big), torch.from_numpy(x), grid=grid, stride=1000)
    np.testing.assert_array_equal(got.numpy(), out)
    assert out.shape == (1, 1) and out[0, 0] == 3000.0


def test_scatter_rows_edges():
    """An empty cluster, rows before the first and after the last range
    (left at -1), a decreasing range (empty), targets outside the chunk
    (skipped), two chunks with their own starts."""
    rng = np.random.default_rng(0)
    nchunks, BPc, K, L = 2, 40, 5, 8
    vals = torch.from_numpy(rng.normal(size=(nchunks, BPc, L)).astype(np.float32))
    starts = torch.tensor([[2, 9, 9, 20, 31, 35],       # cluster 1 empty
                           [0, 10, 5, 25, 30, 40]],     # cluster 1 decreasing
                          dtype=torch.int32).reshape(-1)
    pos = torch.from_numpy(np.stack([rng.permutation(BPc) for _ in range(nchunks)])
                           .astype(np.int32)).reshape(-1).clone()
    pos[3] = BPc + 7  # chunk 0, row 3: target outside the chunk
    got = scatter_rows(vals, starts, pos, K=K)
    want = np.full((nchunks, BPc, L), -1.0, np.float32)
    st = starts.numpy().reshape(nchunks, K + 1)
    ps = pos.numpy().reshape(nchunks, BPc)
    for c in range(nchunks):
        for k in range(K):
            for r in range(st[c, k], st[c, k + 1]):
                if 0 <= ps[c, r] < BPc:
                    want[c, ps[c, r]] = 2.0 * vals[c, r].numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    unwritten = np.setdiff1d(np.arange(BPc), ps[0, list(range(2, 35))])
    assert (got.numpy()[0, unwritten] == -1.0).all() and len(unwritten) >= 7


def _per_row(vals, starts, pos, K):
    """The scatter row by row in numpy: every row of every range, in range
    order, copied to its target when the target lies in the chunk."""
    nchunks, BPc, L = vals.shape
    want = np.full((nchunks, BPc, L), -1.0, np.float32)
    st = starts.reshape(nchunks, K + 1)
    ps = pos.reshape(nchunks, BPc)
    for c in range(nchunks):
        for k in range(K):
            for r in range(max(st[c, k], 0), min(st[c, k + 1], BPc)):
                if 0 <= ps[c, r] < BPc:
                    want[c, ps[c, r]] = 2.0 * vals[c, r]
    return want


def test_scatter_rows_skewed_layout():
    """One cluster holds 90% of the chunk's rows (the layout the card's
    kernel splits by rows, not by cluster), beside an overlapping range, a
    decreasing one and rows in no range, against the per-row loop."""
    rng = np.random.default_rng(3)
    nchunks, BPc, K, L = 2, 5000, 6, 8
    big = 9 * BPc // 10
    starts = np.array([[0, big, big - 300, big + 100, big + 300, BPc - 40, BPc - 20],
                       [20, 20, big + 20, big - 500, big + 200, BPc, BPc]],
                      dtype=np.int32).reshape(-1)  # chunk 1: its first 20 rows in no range
    pos = np.stack([rng.permutation(BPc) for _ in range(nchunks)]).astype(np.int32).reshape(-1)
    vals = rng.normal(size=(nchunks, BPc, L)).astype(np.float32)
    got = scatter_rows_reference(torch.from_numpy(vals), torch.from_numpy(starts),
                                 torch.from_numpy(pos), K=K)
    want = _per_row(vals, starts, pos, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1.0).all(axis=2).sum() == 20 + 20  # chunk 0's tail, chunk 1's head
    counts = np.diff(starts.reshape(nchunks, K + 1), axis=1)
    assert counts.max() >= 0.9 * BPc and (counts < 0).any()


def test_wrappers_check_operands():
    v = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="starts shape"):
        scatter_rows(v, torch.zeros(3, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), K=3)
    with pytest.raises(TypeError, match="pos must be torch.int32"):
        scatter_rows(v, torch.zeros(4, dtype=torch.int32), torch.zeros(8, dtype=torch.int64), K=3)
    big = torch.arange(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="reads past big"):
        index_read(big, torch.zeros(1, 1), grid=4, stride=34)
    with pytest.raises(ValueError, match="unsupported device"):
        index_read(big.to("meta"), torch.zeros(1, 1, device="meta"), grid=2, stride=1)


def test_probe_bench_runs_on_cpu():
    """quiver_tpu_torch.benches.probe at both shapes on the CPU, with the
    main path's probe ids from a small synthetic probe selection."""
    pid = probe.synthetic_probe("cpu", B=2048, P=3, K=300)
    lines = []
    rec = probe.run_probes("cpu", probe=pid, K=300, log=lines.append)
    assert lines[0] == "probe scatter: OK"
    assert lines[1] == "probe index-read: 3000.0 (expect 3000.0)"
    assert rec["scatter_rows"]["max_abs_err"] == 0.0 == rec["index_read"]["max_abs_err"]
    scatter, read = rec["main"]
    assert scatter["vals"].shape == (1, 2048 * 3, probe.LANES)
    assert read["grid"] == 2048 * 3 // probe.TILE
    times = probe.time_probes("cpu", rec["main"], reps=1, log=lines.append)
    assert set(times) == {"scatter_rows", "index_read"}


def test_time_probes_records():
    """time_probes' records: scatter_rows at the slice's layout and at
    uniform clusters beside PyTorch's own scatter; index_read's device time
    beside its one-step floor and its host cost per call (host clock on the
    CPU); each printed."""
    pid = probe.synthetic_probe("cpu", B=512, P=3, K=64)
    scatter, read = probe.main_inputs(pid, 64)
    lines = []
    times = probe.time_probes("cpu", (scatter, read), reps=2, log=lines.append)
    assert set(times["scatter_rows"]) == {"ms", "uniform_ms", "torch_scatter_ms", "plain_ms"}
    assert set(times["index_read"]) == {"ms", "floor_ms", "host_us", "plain_ms"}
    for rec in times.values():
        assert all(v > 0 and np.isfinite(v) for v in rec.values())
    assert any("floor_ms=" in ln and "device_ms=" in ln for ln in lines)
    assert any("us_per_call=" in ln for ln in lines)
    assert any("uniform_clusters_ms=" in ln for ln in lines)
    uni = probe.uniform_starts(scatter["starts"], 512 * 3)
    assert uni.dtype == torch.int32 and uni.tolist() == [i * (1536 // 64) for i in range(65)]
