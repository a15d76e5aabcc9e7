"""Operation and byte counts of the kernels, and the card's peaks.

Each kernel's count is a function of the work its inputs need, counted by
hand from the algorithm, the same whatever implements it; a roofline
share is the least time the card could take (the larger of operations
over the float32 peak and bytes over the HBM peak) over the kernel's
measured device time.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def bound_s(ops: float = 0.0, nbytes: float = 0.0) -> float:
    """Least seconds for ``ops`` float32 operations and ``nbytes`` of HBM
    traffic at the H100 SXM data-sheet peaks."""
    p = PEAKS["H100_SXM"]
    return max(ops / p["fp32_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
