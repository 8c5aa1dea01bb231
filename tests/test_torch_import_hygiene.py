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
    "quiver_tpu_torch.index",
    "quiver_tpu_torch.core.collection",
    "quiver_tpu_torch.facets.filters",
    "quiver_tpu_torch.facets.columns",
    "quiver_tpu_torch.observability.metrics",
    "quiver_tpu_torch.observability.logging",
    "quiver_tpu_torch.utils.profiling",
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
