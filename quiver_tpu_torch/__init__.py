"""quiver-tpu on PyTorch and CUDA: the port of ``quiver_tpu`` to an NVIDIA
H100.

Its top is the database: ``DB(DBOptions(...))`` creates collections on the
card (``DBOptions.device``, "cuda" by default), journals their writes to a
native WAL and flushes and reloads them (``persistence/``), with the
reference's defaults: the ``hybrid`` engine over an IVF engine with f32
blocks; in front of it the REST server (``api.server``) and the CLI
(``python -m quiver_tpu_torch.cli serve``). Below it, the IVF-Flat batched query end to end: ``VectorStore`` ->
``IVFIndex.build()`` (with the n_probe tuner when ``recall_target`` is set)
-> ``IVFIndex.search_slots`` / ``search_slots_device`` ->
``ops.ivf_kernels.ivf_query``, whose candidate stage is the hand-written
CUDA kernel ``ops.ivf_cuda.block_topw`` (``csrc/ivf_block_topw.cu`` for bf16 blocks,
``csrc/ivf_block_topw_f32.cu`` for f32 ones), plus the exact engine it
falls back on; and the benchmark entry points
(``bench``, ``benches.bench_latency``, ``benches.probe``, the last with the
probe kernels of ``ops.probe_cuda`` / ``csrc/probe_kernels.cu``).

The package imports ``torch`` and never ``jax`` or ``quiver_tpu``. Every
tensor lives on the device the store was created with; kernels build at
first use (``_build.py``).
"""

from quiver_tpu_torch.core.collection import Collection
from quiver_tpu_torch.core.db import DB, DBOptions
from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index import make_engine
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex
from quiver_tpu_torch.types import DistanceType

__all__ = [
    "DB", "Collection", "DBOptions", "DistanceType", "ExactIndex", "IVFConfig",
    "IVFIndex", "VectorStore", "make_engine",
]
__version__ = "0.1.0"
