"""``block_topw`` over bf16 blocks (``csrc/ivf_block_topw.cu``: the query
gather and the scoring kernel, pairs or row mode): the least time its
work, counted from the inputs, takes at the card's published peaks, over
its profiled time."""

from qbench.trace import Trace, roofline

KERNELS = ("block_topw_kernel", "gather_queries")


def read(t: Trace) -> float | None:
    return roofline(t, "block_topw", KERNELS)
