"""The card: its published peaks, the roofline bound, and its name and power.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at the
full 700 W power limit; a card set lower runs slower, so every reading
carries the card's name and limit (``name_and_power``).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 FMA outside the tensor cores
BF16_FLOP_PER_S = 989e12        # bf16 tensor cores, dense


def bound_s(nbytes: float = 0.0, flop: float = 0.0,
            flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the given peak."""
    return max(nbytes / HBM_BYTES_PER_S, flop / flop_per_s)


def name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or the
    reason it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out.stdout.strip().splitlines()[0]
