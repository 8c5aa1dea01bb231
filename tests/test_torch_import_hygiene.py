"""The port imports neither jax nor quiver_tpu.

Checked in a fresh interpreter: this test process already imported jax
(tests/conftest.py does), so ``sys.modules`` here proves nothing.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "quiver_tpu_torch",
    "quiver_tpu_torch.types",
    "quiver_tpu_torch.ops.distance",
    "quiver_tpu_torch.ops.scan",
    "quiver_tpu_torch.ops.ivf_cuda",
    "quiver_tpu_torch.ops.ivf_kernels",
    "quiver_tpu_torch.core.store",
    "quiver_tpu_torch.index.exact",
    "quiver_tpu_torch.index.ivf",
    "quiver_tpu_torch.convert",
    "quiver_tpu_torch._build",
    "quiver_tpu_torch.ops.probe_cuda",
    "quiver_tpu_torch.utils.memory",
    "quiver_tpu_torch.bench",
    "quiver_tpu_torch.benches.common",
    "quiver_tpu_torch.benches.truth",
    "quiver_tpu_torch.benches.bench_latency",
    "quiver_tpu_torch.benches.probe",
    "quiver_tpu_torch.benches.streaming",
    "quiver_tpu_torch.benches.churn",
    "quiver_tpu_torch.benches.topw_f32_ab",
    "quiver_tpu_torch.benches.sharded_ab",
    "quiver_tpu_torch.benches.row_topr_ab",
    "quiver_tpu_torch.index",
    "quiver_tpu_torch.core.collection",
    "quiver_tpu_torch.facets.filters",
    "quiver_tpu_torch.facets.columns",
    "quiver_tpu_torch.observability.metrics",
    "quiver_tpu_torch.observability.logging",
    "quiver_tpu_torch.utils.profiling",
    "quiver_tpu_torch.ops.vector_utils",
    "quiver_tpu_torch.index.hybrid",
    "quiver_tpu_torch.native",
    "quiver_tpu_torch.persistence.parquet_io",
    "quiver_tpu_torch.persistence.arrow_io",
    "quiver_tpu_torch.persistence.manager",
    "quiver_tpu_torch.observability.collector",
    "quiver_tpu_torch.core.db",
    "quiver_tpu_torch.api",
    "quiver_tpu_torch.api.auth",
    "quiver_tpu_torch.api.server",
    "quiver_tpu_torch.cli",
    "quiver_tpu_torch.benches.bench_api",
    "quiver_tpu_torch.benches.bench_filtered",
    "quiver_tpu_torch.benches.bench_persistence",
    "quiver_tpu_torch.benches.profile_api",
    "quiver_tpu_torch.ops.hnsw_kernels",
    "quiver_tpu_torch.ops.hnsw_cuda",
    "quiver_tpu_torch.index.hnsw",
    "quiver_tpu_torch.benches.bench_hnsw",
    "quiver_tpu_torch.benches.exp_hnsw_recall",
    "quiver_tpu_torch.benches.bench_hybrid",
    "quiver_tpu_torch.parallel",
    "quiver_tpu_torch.parallel.sharded",
    "quiver_tpu_torch.parallel.sharded_ivf",
    "quiver_tpu_torch.parallel.sharded_graph",
    "quiver_tpu_torch.parallel.distributed",
    "quiver_tpu_torch.parallel.dryrun",
    "quiver_tpu_torch.benches.bench_skew",
    "quiver_tpu_torch.benches.bench_memory",
    "quiver_tpu_torch.benches.bench_ivf",
    "quiver_tpu_torch.benches.bench_ivf_mega",
    "quiver_tpu_torch.benches.bench_roofline",
    "quiver_tpu_torch.benches.bench_corpus_matrix",
    "quiver_tpu_torch.benches.bench_10m",
    "quiver_tpu_torch.benches.run_all",
]


def test_port_modules_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'quiver_tpu' or m.startswith('quiver_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_db_imports_and_runs_without_pyarrow(tmp_path):
    """pyarrow may be missing where the port runs: the database and its
    persistence import without it (it is imported inside the Parquet
    functions), and a flush writes the reference's JSON fallback."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pyarrow.parquet'] = None\n"
        "import numpy as np\n"
        "import quiver_tpu_torch.core.db as db_mod\n"
        "assert 'pyarrow' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        f"db = db_mod.DB(db_mod.DBOptions(storage_path={str(tmp_path / 'd')!r}, "
        "flush_interval_s=0, default_engine='exact', device='cpu'))\n"
        "c = db.create_collection('c', 4, 'euclidean')\n"
        "c.add_batch(['a', 'b'], np.eye(2, 4, dtype=np.float32))\n"
        "db.close()\n"
        "import os\n"
        f"print(sorted(os.listdir({str(tmp_path / 'd' / 'c')!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "vectors.json" in proc.stdout and "vectors.parquet" not in proc.stdout
