"""Hand-written Hopper kernels of the coded-serving path, their plain-torch
twins (:mod:`.ref`) and the padding/dispatch layer (:mod:`.ops`).

Each wrapper counts its launches in a plain integer;
:func:`launch_counts` / :func:`reset_launch_counts` read and clear them, so
a run can show that its path really went through the kernels.
"""
from typing import Dict

from . import coded_matvec, matmul, mds_encode

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {"matmul": matmul.LAUNCHES,
            "coded_matvec": coded_matvec.LAUNCHES,
            "counter_parity_rows": mds_encode.ROWS_LAUNCHES,
            "gen_parity_matvec": mds_encode.GEN_LAUNCHES}


def reset_launch_counts() -> None:
    matmul.LAUNCHES = 0
    coded_matvec.LAUNCHES = 0
    mds_encode.ROWS_LAUNCHES = 0
    mds_encode.GEN_LAUNCHES = 0
