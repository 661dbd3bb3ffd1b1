"""The chip's published peaks, by the name ``torch.cuda.get_device_name``
gives: NVIDIA's data sheet for the H100 SXM part, dense rates without
sparsity, at its 700 W power limit.  A device not listed has no peak, and
the metrics that divide by one read nothing."""
from __future__ import annotations

import subprocess
from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(key)


def power_limit_w() -> Optional[float]:
    """The card's power limit, as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
