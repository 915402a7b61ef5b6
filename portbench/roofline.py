"""The least time the card could take for SHA-256 work, counted by the
algorithm and not by any build of it.

Each row of ``n`` bytes is ``ceil((n + 9) / 64)`` compressions (the padding
adds a 0x80 byte and the 8-byte length). A compression is the 64 rounds,
the 48 schedule steps and the byte swap of the 16 input words: 1,040
operations that only the integer ALU can issue, and 360 adds that the ALU
or the FMA pipe can (``SHA_ROUNDS``, ``SHA_SCHEDULE``, ``SHA_BSWAP``, as
counted for the port's kernels). With as many FMA lanes as ALU lanes the
ALU-only operations bind. Each input byte is read once and each row's 32
digest bytes written once.

Peaks: the published figures of the H100 SXM part at its 700 W limit
(132 SMs, 64 INT32 lanes an SM, 1.98 GHz boost clock; 3.35 TB/s of HBM3).
"""

from __future__ import annotations

SHA_ROUNDS = {"alu": 64 * (6 + 4), "either": 64 * 4 + 8}
SHA_SCHEDULE = {"alu": 48 * (6 + 2), "either": 48 * 2}
SHA_BSWAP = {"alu": 16, "either": 0}
ALU_OPS_PER_BLOCK = SHA_ROUNDS["alu"] + SHA_SCHEDULE["alu"] + SHA_BSWAP["alu"]  # 1,040
EITHER_OPS_PER_BLOCK = SHA_ROUNDS["either"] + SHA_SCHEDULE["either"] + SHA_BSWAP["either"]  # 360
DIGEST_BYTES = 32

SMS = 132
ALU_LANES_PER_SM = 64
FMA_LANES_PER_SM = 64
CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = SMS * ALU_LANES_PER_SM * CLOCK_HZ  # 16.73e12


def blocks(length: int) -> int:
    """Compressions SHA-256 makes of ``length`` bytes."""
    return (length + 9 + 63) // 64


def least_seconds(total_blocks: float, in_bytes: float, rows: float) -> float:
    """The larger of the operation bound and the byte bound."""
    alu = total_blocks * ALU_OPS_PER_BLOCK / ALU_OPS_PER_S
    mixed = (total_blocks * (ALU_OPS_PER_BLOCK + EITHER_OPS_PER_BLOCK)
             / (SMS * (ALU_LANES_PER_SM + FMA_LANES_PER_SM) * CLOCK_HZ))
    moved = (in_bytes + DIGEST_BYTES * rows) / HBM_BYTES_PER_S
    return max(alu, mixed, moved)


def least_seconds_rows(lengths) -> float:
    lengths = list(lengths)
    return least_seconds(sum(blocks(n) for n in lengths), sum(lengths), len(lengths))


def blocks_lower(in_bytes: float, rows: float) -> float:
    """Compressions of ``rows`` rows that hold ``in_bytes`` in all, when only
    the totals are known: under the exact count by less than one a row, so
    a share of the roofline read from it is never counted high."""
    return (in_bytes + 9 * rows) / 64
