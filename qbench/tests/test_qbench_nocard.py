"""Without a card, and in a directory holding only the benchmark, the
command exits non-zero and prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from qbench.manifest import ROOT, load

ARGS = ["--workload", "sift1m-ivf-bf16.batch64k", "--seed", "4294967311", "--seconds", "1",
        "--trace", "0"]


def _result_lines(stdout: str) -> list:
    out = []
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "correct" in obj:
            out.append(obj)
    return out


def test_the_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = load()["command"]
    out = subprocess.run([sys.executable, *cmd[1:], *ARGS], capture_output=True, text=True,
                         cwd=ROOT.parent, env=env, timeout=300)
    assert out.returncode != 0
    assert not _result_lines(out.stdout)


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT, tmp_path / "qbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "qbench.run", *ARGS], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert not _result_lines(out.stdout)
