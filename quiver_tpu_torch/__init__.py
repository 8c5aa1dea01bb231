"""quiver-tpu on PyTorch and CUDA: the port of ``quiver_tpu`` to an NVIDIA
H100.

This slice carries the IVF-Flat batched query end to end: ``VectorStore``
-> ``IVFIndex.build()`` -> ``IVFIndex.search_slots`` /
``search_slots_device`` -> ``ops.ivf_kernels.ivf_query``, whose candidate
stage is the hand-written CUDA kernel ``ops.ivf_cuda.block_topw``
(``csrc/ivf_block_topw.cu``), plus the exact engine it falls back on.

The package imports ``torch`` and never ``jax`` or ``quiver_tpu``. Every
tensor lives on the device the store was created with; kernels build at
first use (``_build.py``).
"""

from quiver_tpu_torch.core.store import VectorStore
from quiver_tpu_torch.index.exact import ExactIndex
from quiver_tpu_torch.index.ivf import IVFConfig, IVFIndex
from quiver_tpu_torch.types import DistanceType

__all__ = ["DistanceType", "ExactIndex", "IVFConfig", "IVFIndex", "VectorStore"]
__version__ = "0.1.0"
