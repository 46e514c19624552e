"""The card's peaks and the bytes each measured kernel needs, from a
cell's shapes.

Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W: 3.35 TB/s of HBM
and 67 TFLOP/s of float32 outside the tensor cores.  A share of a peak is
stated with the card's power limit beside it.

The byte counts are a copy of chip_smoke.py's bound arithmetic
(`candidates_bound_bytes`, the apply_moves count of `check_kernels`),
each input byte read once and each output byte written once, with the
counts that chip_smoke takes from one step's data replaced by what the
shapes give: of n draws from a table of N rows, the number of distinct
rows that n uniform draws are expected to hit, N (1 - (1 - 1/N)^n), and a
partition's members at the cluster's mean replication factor.  The count
is the same whatever implements the kernel.  The search draws some rows
more often than others (importance sampling, the skew), which makes fewer
of its draws distinct than uniform draws would: the count is an upper one
by that much, and the share it gives an upper reading.  apply_moves' work
depends on how many moves survive a step; the count takes the survivors
the run reports (its rounds' `accepted`), each at the smaller of the two
row kinds, a lower count.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: bytes of one sampled replica row (placement, partition, topic, flags,
#: position, both load rows), of a member-only row (broker, leader flag),
#: of a broker row (and a logdir's), of a host row
ROW_B, MEMBER_B, BROKER_B, DISK_B, HOST_B = 59, 5, 64, 9, 33
#: bytes written a candidate (the bundle), a relocation row, a
#: leadership row
BUNDLE_B, REL_ROW_B, LEAD_ROW_B = 22, 53, 64
#: apply_moves: a survivor's payload and the placement and aggregate words
#: it reads and writes, by kind (relocation 53 + 264, leadership 64 + 186)
APPLY_REL_B, APPLY_LEAD_B = 53 + 264, 64 + 186


def split(search: dict) -> tuple[int, int, int]:
    """(K_r, K_s, K_l): relocations, swaps and leadership moves a step."""
    k, k_l = int(search["num_candidates"]), int(search["leadership_candidates"])
    k_s = int(search.get("swap_candidates", 512))
    k_s = max(0, min(k_s, (k - k_l) // 2))
    return k - k_l - k_s, k_s, k_l


def distinct(table: int, draws: int) -> float:
    """The number of distinct rows that `draws` uniform draws from a table
    of `table` rows are expected to hit."""
    return table * -math.expm1(draws * math.log1p(-1.0 / table)) if table > 1 else min(table, draws)


def candidates_bytes(dims: dict, search: dict) -> float:
    """Bytes one launch of the candidates kernel needs: the sampled
    replica rows (a relocation's row, a swap's two, a leadership move's
    two), the member rows of the partitions drawn beyond those, each drawn
    partition's member ids, the rack cells each move reads on both sides,
    the rows of the brokers and hosts at either end (with their logdirs),
    the plan's CDF, the draws' destinations and the globals, then the
    outputs."""
    k_r, k_s, k_l = split(search)
    K = k_r + k_s + k_l
    R, P, B = dims["num_replicas"], dims["num_partitions"], dims["num_brokers"]
    D, T, H = dims["max_disks_per_broker"], dims["num_topics"], dims["num_hosts"]
    rf = R / P
    rows = distinct(R, k_r + 2 * k_s + 2 * k_l)
    parts = distinct(P, K + k_s)
    members = max(0.0, parts * rf - rows)
    cells = distinct(P * dims["num_racks"], 2 * (K + k_s))
    brokers = distinct(B, 2 * K)
    return (ROW_B * rows + MEMBER_B * members + 4 * parts * rf + 4 * cells
            + (BROKER_B + DISK_B * D) * brokers + HOST_B * distinct(H, 2 * K)
            + 4 * B + 4 * k_r + 4 * (22 + T)
            + BUNDLE_B * K + REL_ROW_B * (k_r + 2 * k_s) + LEAD_ROW_B * k_l)


def apply_moves_bytes(search: dict, survivors_per_launch: float) -> float:
    """Bytes one launch of apply_moves needs: every slot's survivor flag,
    and each survivor's payload and words."""
    k_r, k_s, k_l = split(search)
    return (k_r + 2 * k_s + k_l) + APPLY_LEAD_B * survivors_per_launch


def share(bound_bytes: float, seconds: float, launches: int) -> float | None:
    """Percent of the HBM roofline: the bytes' least time over the
    measured device time per launch; None without a measured launch."""
    if not launches or seconds <= 0:
        return None
    return 100.0 * (bound_bytes / HBM_BYTES_PER_S) / (seconds / launches)
