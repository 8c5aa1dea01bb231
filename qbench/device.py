"""The card: presence, name, power limit, published peaks, memory.

The peaks are NVIDIA's data sheets' dense rates without sparsity, at the
part's full power limit (a copy of
``quiver_tpu_torch/benches/common.py::PEAKS``); the key is matched inside
``torch.cuda.get_device_name()``. A roofline share is stated against them
with the card's power limit beside it.
"""

from __future__ import annotations

import subprocess

import torch

PEAKS = {
    "H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "hbm": 3.35e12},
    "H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "hbm": 2.0e12},
    "H100 NVL": {"bf16": 835e12, "tf32": 417.5e12, "hbm": 3.9e12},
}


def cards_missing(chips: int) -> str | None:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}"
    return None


def peaks(name: str) -> dict | None:
    """Published peaks of the card named ``name``, None for a card not in
    :data:`PEAKS` (its rooflines are then not reported)."""
    hits = [v for k, v in PEAKS.items() if k in name]
    return hits[0] if len(hits) == 1 else None


def power_limit() -> str | None:
    """The first card's power limit as ``nvidia-smi`` prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
