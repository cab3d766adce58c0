"""Published peaks of the card the benchmark runs on, and the card's power limit.

NVIDIA H100 SXM data sheet, dense rates without sparsity; they assume the
full 700 W power limit, so every roofline share is printed beside the
card's ``power.limit``. The HBM figure is the one ``chip_smoke.py`` uses
(``HBM_BYTES_PER_S``).
"""

from __future__ import annotations

import subprocess

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,  # outside the tensor cores
}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or ``"unknown"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
