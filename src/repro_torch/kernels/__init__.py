"""Hand-written Hopper kernels of the port (coded serving, the static
executor, the streaming verify, the RWKV-6 WKV recurrence and its
backward, the blockwise attention and its backward), their plain-torch twins (:mod:`.ref`) and the padding/dispatch
layer (:mod:`.ops`).

Each wrapper counts its launches in a plain integer (the attention
forward also its calls on either kernel, ``attention.LAUNCHES``);
:func:`launch_counts` / :func:`reset_launch_counts` read and clear them, so
a run can show that its path really went through the kernels.
"""
from typing import Dict

from . import attention, coded_matvec, matmul, mds_encode, wkv6

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {"matmul": matmul.LAUNCHES,
            "coded_matvec": coded_matvec.LAUNCHES,
            "mds_encode": mds_encode.ENCODE_LAUNCHES,
            "counter_parity_rows": mds_encode.ROWS_LAUNCHES,
            "gen_parity_matvec": mds_encode.GEN_LAUNCHES,
            "parity_contract": mds_encode.CONTRACT_LAUNCHES,
            "parity_contract_wide": mds_encode.WIDE_CONTRACT_LAUNCHES,
            "wkv6": wkv6.WKV6_LAUNCHES,
            "wkv6_bwd": wkv6.WKV6_BWD_LAUNCHES,
            "attention": attention.SIMT_LAUNCHES,
            "attention_mma": attention.MMA_LAUNCHES,
            "attention_bwd": attention.BWD_LAUNCHES}


def reset_launch_counts() -> None:
    matmul.LAUNCHES = 0
    coded_matvec.LAUNCHES = 0
    mds_encode.ENCODE_LAUNCHES = 0
    mds_encode.ROWS_LAUNCHES = 0
    mds_encode.GEN_LAUNCHES = 0
    mds_encode.CONTRACT_LAUNCHES = 0
    mds_encode.WIDE_CONTRACT_LAUNCHES = 0
    wkv6.WKV6_LAUNCHES = 0
    wkv6.WKV6_BWD_LAUNCHES = 0
    attention.LAUNCHES = 0
    attention.MMA_LAUNCHES = 0
    attention.SIMT_LAUNCHES = 0
    attention.BWD_LAUNCHES = 0
