"""The port's CLI (``quiver_tpu_torch/cli.py``) on the CPU.

The scenarios of tests/test_cli.py on the port's ``cli`` (every command
given ``--device cpu``), then what the port adds: ``device`` in the
layered config (flag > ``QUIVER_DEVICE`` > file > "cuda"); a backup that one
package's CLI writes and the other's restores and reports (the two share
the directory format); a CUDA device with no card failing ``info`` and
``serve`` with the store's error; and ``serve`` as its own process on the
CPU, stopped by SIGTERM after REST writes that ``info`` then counts.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import requests
from click.testing import CliRunner

from quiver_tpu.cli import cli as jcli
from quiver_tpu_torch.api.auth import jwt_decode
from quiver_tpu_torch.benches.bench_api import free_port
from quiver_tpu_torch.cli import cli, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def runner():
    return CliRunner()


def _seed(data_dir: str) -> None:
    from quiver_tpu_torch.core.db import DB, DBOptions

    db = DB(DBOptions(storage_path=data_dir, device="cpu"))
    c = db.create_collection("docs", dim=8, metric="euclidean")
    vecs = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    c.add_batch([f"d{i}" for i in range(32)], vecs)
    db.close()


def _info(runner, command, data_dir, *extra) -> dict:
    res = runner.invoke(command, ["--log-level", "error", "--data-dir", data_dir, *extra, "info"])
    assert res.exit_code == 0, res.output
    return json.loads(res.output)


# --------------------------------------------- the scenarios of test_cli.py


def test_load_config_layering(tmp_path, monkeypatch):
    cfg_file = tmp_path / "quiver.yaml"
    cfg_file.write_text("port: 1234\nlog_level: debug\nunknown_key: 7\n")
    monkeypatch.setenv("QUIVER_PORT", "4321")
    cfg = load_config(str(cfg_file))
    assert cfg["port"] == 4321
    assert cfg["log_level"] == "debug"
    assert "unknown_key" not in cfg
    monkeypatch.delenv("QUIVER_PORT")
    assert load_config(str(cfg_file))["port"] == 1234


def test_load_config_bool_env(monkeypatch):
    monkeypatch.setenv("QUIVER_ENABLE_AUTH", "true")
    assert load_config("/nonexistent.yaml")["enable_auth"] is True
    monkeypatch.setenv("QUIVER_ENABLE_AUTH", "0")
    assert load_config("/nonexistent.yaml")["enable_auth"] is False


def test_info_reports_collections(tmp_path, runner):
    data = str(tmp_path / "data")
    _seed(data)
    out = _info(runner, cli, data, *CPU)
    assert out["collections"]["docs"]["vectors"] == 32
    assert out["collections"]["docs"]["dimension"] == 8


def test_backup_restore_roundtrip(tmp_path, runner):
    data = str(tmp_path / "data")
    backup_dir = str(tmp_path / "bak")
    _seed(data)
    res = runner.invoke(cli, ["--data-dir", data, *CPU, "backup", backup_dir])
    assert res.exit_code == 0, res.output
    assert os.path.isdir(backup_dir)

    data2 = str(tmp_path / "data2")
    res = runner.invoke(cli, ["--data-dir", data2, *CPU, "restore", backup_dir])
    assert res.exit_code == 0, res.output
    assert "docs" in res.output
    assert _info(runner, cli, data2, *CPU)["collections"]["docs"]["vectors"] == 32


def test_token_mints_verifiable_jwt(runner):
    res = runner.invoke(cli, ["token", "--secret", "s3cret", "--sub", "alice", "--ttl", "60"])
    assert res.exit_code == 0, res.output
    assert jwt_decode(res.output.strip(), "s3cret")["sub"] == "alice"


# ------------------------------------------------------- what the port adds


def test_device_layering(tmp_path, monkeypatch, runner):
    monkeypatch.delenv("QUIVER_DEVICE", raising=False)
    assert load_config("/nonexistent.yaml")["device"] == "cuda"  # default
    cfg_file = tmp_path / "quiver.yaml"
    cfg_file.write_text("device: cpu\n")
    assert load_config(str(cfg_file))["device"] == "cpu"  # file beats default
    monkeypatch.setenv("QUIVER_DEVICE", "cuda:1")
    assert load_config(str(cfg_file))["device"] == "cuda:1"  # env beats file
    data = str(tmp_path / "data")
    _seed(data)
    # the flag beats the environment ("cuda:1" would fail here)
    assert _info(runner, cli, data, "--device", "cpu")["collections"]["docs"]["vectors"] == 32
    monkeypatch.setenv("QUIVER_DEVICE", "cpu")
    assert _info(runner, cli, data)["collections"]["docs"]["vectors"] == 32


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_backup_crosses_packages(tmp_path, runner, writer):
    """A backup written by one package's CLI is restored and reported by
    the other's."""
    from quiver_tpu.core.db import DB as JDB
    from quiver_tpu.core.db import DBOptions as JDBOptions

    data, bak, data2 = (str(tmp_path / p) for p in ("data", "bak", "data2"))
    if writer == "jax":
        db = JDB(JDBOptions(storage_path=data))
        db.create_collection("docs", dim=8, metric="euclidean").add_batch(
            [f"d{i}" for i in range(32)],
            np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32))
        db.close()
    else:
        _seed(data)
    w_cli, w_extra, r_cli, r_extra = ((jcli, [], cli, CPU) if writer == "jax"
                                      else (cli, CPU, jcli, []))
    res = runner.invoke(w_cli, ["--data-dir", data, *w_extra, "backup", bak])
    assert res.exit_code == 0, res.output
    res = runner.invoke(r_cli, ["--data-dir", data2, *r_extra, "restore", bak])
    assert res.exit_code == 0, res.output
    a = _info(runner, w_cli, data, *w_extra)["collections"]["docs"]
    b = _info(runner, r_cli, data2, *r_extra)["collections"]["docs"]
    assert a["vectors"] == b["vectors"] == 32
    assert (a["dimension"], a["metric"]) == (b["dimension"], b["metric"]) == (8, "euclidean")


def _cli_proc(*args, env=None, **kw):
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO)
    env.pop("QUIVER_DEVICE", None)
    return subprocess.Popen([sys.executable, "-m", "quiver_tpu_torch.cli", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            **kw)


def test_cuda_without_a_card_fails(tmp_path):
    """With the default device ("cuda") and no card, ``info`` and ``serve``
    exit non-zero with the store's error and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    data = str(tmp_path / "data")
    procs = [_cli_proc("--data-dir", data, "info", env=env),
             _cli_proc("--data-dir", data, "serve", "--port", "0", env=env)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode != 0
        assert "CUDA is not available" in err
        assert "{" not in out
    assert not os.path.exists(os.path.join(data, "docs"))


def test_serve_process_survives_sigterm(tmp_path, runner):
    """``serve`` as its own process: REST writes, then SIGTERM; the process
    exits 0 after its flush, and ``info`` counts every acknowledged row."""
    data = str(tmp_path / "data")
    _seed(data)
    port, mport = free_port(), free_port()
    proc = _cli_proc("--data-dir", data, "--device", "cpu", "serve", "--port", str(port),
                     "--metrics-port", str(mport), "--host", "127.0.0.1")
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                if requests.get(f"{base}/health", timeout=1).status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert time.monotonic() < deadline, "serve did not answer /health"
            time.sleep(0.1)
        vecs = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
        r = requests.post(f"{base}/api/v1/collections/docs/vectors/batch", json={
            "vectors": [{"id": f"n{i}", "vector": v.tolist()} for i, v in enumerate(vecs)]})
        assert r.status_code == 201, r.text
        r = requests.post(f"{base}/api/v1/collections/docs/search",
                          json={"vector": vecs[3].tolist(), "top_k": 1})
        assert r.json()["results"][0]["id"] == "n3"
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert '"server stopped"' in err
    assert _info(runner, cli, data, *CPU)["collections"]["docs"]["vectors"] == 32 + 64
