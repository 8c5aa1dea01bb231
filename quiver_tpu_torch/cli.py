"""CLI — serve / backup / restore / info.

Parity with the reference's Cobra CLI (reference: cmd/quiver/main.go:23-306):
layered config — flags > QUIVER_* env > .quiver.yaml (cwd then home) >
defaults — and the same four commands.

PyTorch port of ``quiver_tpu/cli.py``, run as ``python -m
quiver_tpu_torch.cli`` or the ``quiver-tpu-torch`` script. The layered
config gains ``device`` (``QUIVER_DEVICE``, the file's ``device``; default
"cuda"), passed to ``DBOptions.device``: every collection lives there. A
CUDA device with no card fails the command with the store's error
(``core/store.py::resolve_device``); nothing falls back to the CPU. It
also gains ``mesh`` (``--mesh``, ``QUIVER_MESH``, the file's ``mesh``):
the sharded engines' devices, passed as ``DBOptions.engine_config["mesh"]``
(:func:`parse_mesh`; empty: every visible card, ``parallel/sharded.py``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import click
import yaml

ENV_PREFIX = "QUIVER_"
CONFIG_BASENAME = ".quiver.yaml"

DEFAULTS = {
    "data_dir": "./data",
    "log_level": "info",
    "host": "0.0.0.0",
    "port": 8080,
    "metrics_port": 9090,
    "enable_auth": False,
    "jwt_secret": "",
    "rate_limit": 0.0,
    "coalesce_window_ms": 2.0,
    "search_backlog": 1024,
    "flush_interval_s": 300.0,
    "default_engine": "hybrid",
    "compute_dtype": "float32",
    #: where the collections live: "cuda", "cuda:N" or "cpu"
    "device": "cuda",
    #: the sharded engines' mesh: "" (every visible card), "N" (N shards)
    #: or comma-separated devices ("cuda:0,cuda:1", "cuda:0,cpu")
    "mesh": "",
}


def parse_mesh(text) -> Optional[object]:
    """The ``mesh`` setting as an engine's ``mesh`` argument: None for
    empty, an int for digits, else a list of device names."""
    text = str(text or "").strip()
    if not text:
        return None
    if text.isdigit():
        return int(text)
    return [part.strip() for part in text.split(",") if part.strip()]


def load_config(config_path: Optional[str] = None) -> dict:
    """Layered config (reference initConfig, main.go:53-88)."""
    cfg = dict(DEFAULTS)
    paths = [config_path] if config_path else [
        CONFIG_BASENAME,
        str(Path.home() / CONFIG_BASENAME),
    ]
    for p in paths:
        if p and os.path.isfile(p):
            with open(p) as f:
                file_cfg = yaml.safe_load(f) or {}
            for k, v in file_cfg.items():
                if k in cfg:
                    cfg[k] = v
            break
    for key in cfg:
        env = os.environ.get(ENV_PREFIX + key.upper())
        if env is not None:
            cur = cfg[key]
            if isinstance(cur, bool):
                cfg[key] = env.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                cfg[key] = int(env)
            elif isinstance(cur, float):
                cfg[key] = float(env)
            else:
                cfg[key] = env
    return cfg


def _make_db(cfg: dict, *, persistence: bool = True):
    from quiver_tpu_torch.core.db import DB, DBOptions
    from quiver_tpu_torch.core.store import resolve_device

    try:
        resolve_device(cfg["device"])
    except RuntimeError as e:  # a CUDA device with no card
        raise click.ClickException(str(e)) from e
    mesh = parse_mesh(cfg.get("mesh"))
    return DB(
        DBOptions(
            storage_path=cfg["data_dir"],
            enable_persistence=persistence,
            flush_interval_s=float(cfg["flush_interval_s"]),
            default_engine=cfg["default_engine"],
            compute_dtype=cfg["compute_dtype"],
            device=cfg["device"],
            engine_config={} if mesh is None else {"mesh": mesh},
        )
    )


@click.group()
@click.option("--config", "config_path", default=None, help="config file path")
@click.option("--data-dir", default=None, help="storage directory")
@click.option("--log-level", default=None, help="debug|info|warning|error")
@click.option("--device", default=None, help="cuda | cuda:N | cpu")
@click.option("--mesh", default=None,
              help="sharded engines' devices: N shards, or e.g. cuda:0,cuda:1 (default: every card)")
@click.pass_context
def cli(ctx: click.Context, config_path, data_dir, log_level, device, mesh) -> None:
    """quiver-tpu on PyTorch and CUDA — the vector search engine on the GPU."""
    cfg = load_config(config_path)
    if data_dir:
        cfg["data_dir"] = data_dir
    if log_level:
        cfg["log_level"] = log_level
    if device:
        cfg["device"] = device
    if mesh:
        cfg["mesh"] = mesh
    from quiver_tpu_torch.observability import logging as qlog

    qlog.set_level(cfg["log_level"])
    ctx.obj = cfg


@cli.command()
@click.option("--host", default=None)
@click.option("--port", type=int, default=None)
@click.option("--metrics-port", type=int, default=None)
@click.option("--auth/--no-auth", "enable_auth", default=None)
@click.option("--jwt-secret", default=None)
@click.option("--rate-limit", type=float, default=None)
@click.option("--coalesce-window-ms", type=float, default=None,
              help="micro-batch window for concurrent searches; 0 disables")
@click.option("--search-backlog", type=int, default=None,
              help="max queued searches per collection before 429s; 0 disables")
@click.pass_obj
def serve(cfg, host, port, metrics_port, enable_auth, jwt_secret, rate_limit,
          coalesce_window_ms, search_backlog) -> None:
    """Start the REST API server (reference serveCmd, main.go:91-143)."""
    for key, val in (
        ("host", host), ("port", port), ("metrics_port", metrics_port),
        ("enable_auth", enable_auth), ("jwt_secret", jwt_secret),
        ("rate_limit", rate_limit),
        ("coalesce_window_ms", coalesce_window_ms),
        ("search_backlog", search_backlog),
    ):
        if val is not None:
            cfg[key] = val
    from quiver_tpu_torch.api.server import Server, ServerConfig

    db = _make_db(cfg)
    server = Server(
        db,
        ServerConfig(
            host=cfg["host"],
            port=int(cfg["port"]),
            metrics_port=int(cfg["metrics_port"]),
            enable_auth=bool(cfg["enable_auth"]),
            jwt_secret=cfg["jwt_secret"],
            rate_limit=float(cfg["rate_limit"]),
            coalesce_window_ms=float(cfg["coalesce_window_ms"]),
            search_backlog=int(cfg["search_backlog"]),
        ),
    )
    server.run()


@cli.command()
@click.argument("path")
@click.pass_obj
def backup(cfg, path) -> None:
    """Back up all collections to PATH (main.go:146-184)."""
    db = _make_db(cfg)
    try:
        db.backup(path)
        click.echo(f"backup written to {path}")
    finally:
        db.close()


@cli.command()
@click.argument("path")
@click.pass_obj
def restore(cfg, path) -> None:
    """Restore collections from a backup at PATH (main.go:187-225)."""
    db = _make_db(cfg)
    try:
        db.restore(path)
        click.echo(f"restored from {path}; collections: {db.list_collections()}")
    finally:
        db.close()


@cli.command()
@click.pass_obj
def info(cfg) -> None:
    """Print database info (main.go:228-280)."""
    db = _make_db(cfg)
    try:
        stats = db.stats()
        out = {
            "data_dir": cfg["data_dir"],
            "collections": {
                name: {
                    "vectors": s["vector_count"],
                    "dimension": s["dimension"],
                    "metric": s["metric"],
                    "index": s["index"],
                }
                for name, s in stats["collections"].items()
            },
        }
        click.echo(json.dumps(out, indent=2))
    finally:
        db.close()


@cli.command("token")
@click.option("--secret", required=True)
@click.option("--sub", default="quiver")
@click.option("--ttl", type=int, default=3600)
def token(secret, sub, ttl) -> None:
    """Mint a JWT for --auth deployments."""
    import time

    from quiver_tpu_torch.api.auth import jwt_encode

    click.echo(jwt_encode({"sub": sub, "exp": time.time() + ttl}, secret))


def main() -> None:
    cli()


if __name__ == "__main__":
    main()
