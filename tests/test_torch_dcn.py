"""The port's multi-process sharded scan: two OS processes, one gloo group
(the port of tests/test_dcn.py).

Each process owns 4 of the corpus's 8 shards on the CPU; the sharded
exact scan's merge crosses the process boundary as a ``torch.distributed``
``all_gather`` plus a re-top-k (``quiver_tpu_torch/parallel/distributed.py``).
Each worker checks the merged result against an f32 oracle
(tests/torch_dcn_worker.py). It takes a few seconds here, so unlike the
reference's it is not marked slow.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dcn_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_scan():
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")  # two small ranks beside other workers
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, init_method, str(rank), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed (rc={p.returncode}):\n{out}"
        assert "seeded_ok=True" in out


def test_init_defaults_to_the_card(monkeypatch):
    """``init`` without a device joins as a card rank: with no card it
    raises before any process group is made, and never falls back to gloo."""
    import torch

    from quiver_tpu_torch.parallel import distributed as qd

    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(qd.dist, "init_process_group", lambda *a, **kw: joined.append((a, kw)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qd.init(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    assert joined == []
    qd.init("tcp://127.0.0.1:1", 1, 0, device="cpu")  # the CPU only when asked
    assert joined[0][0] == ("gloo",)
