"""One closed-loop caller of an engine's ``search_slots``: host queries
in, host distances and slots out, as an offline batch job calls it.

Traffic keys: ``batch`` queries a call, ``k``, ``pool_batches`` distinct
batches made from the seed and sent in turn, ``warm_calls`` calls before
the window, ``judge`` queries whose answers are kept from every call
(drawn from the seed, the same rows of a batch each time it is sent).
"""

from __future__ import annotations

import numpy as np

from qbench.manifest import sub_seed
from qbench.window import Context, Window, closed_loop, host_batches, judge_rows


def pool_size(traffic: dict) -> int:
    return traffic["batch"] * traffic["pool_batches"]


def run(ctx: Context) -> Window:
    tr = ctx.traffic
    B, NB, k = tr["batch"], tr["pool_batches"], tr["k"]
    pool = host_batches(ctx.queries, B, NB)
    rng = np.random.default_rng(sub_seed(ctx.seed, "judge"))
    rows = [judge_rows(rng, B, max(1, tr["judge"] // NB)) for _ in range(NB)]
    eng = ctx.system.engine

    def call(b: int):
        dist, slots = eng.search_slots(pool[b], k)
        return slots[rows[b]], dist[rows[b]]

    return closed_loop(ctx, rows, np.concatenate([pool[i][rows[i]] for i in range(NB)]), call)
