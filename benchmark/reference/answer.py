"""The reference's reading of a proposal: is the placement the program
answered a valid placement of the input cluster, and do its proposals say
exactly how to get there from the input?

Plain numpy over the harness's columns; imports nothing of the program.
A proposal answers for one partition: its replica brokers before and
after (leader first), its leader before and after, and the logdir moves of
replicas that stay on their broker (upstream AnalyzerUtils.getDiff and
ExecutionProposal).
"""

from __future__ import annotations

import numpy as np


def placement_faults(cols: dict, dims: dict, after: dict) -> int:
    """Replica rows of the answered placement that no valid placement has:
    a broker or logdir out of range, a second replica of a partition on
    one broker, and partitions without exactly one leader."""
    v = cols["replica_valid"]
    b, lead, d = after["replica_broker"][v], after["replica_is_leader"][v], after["replica_disk"][v]
    part = cols["replica_partition"][v]
    B, D, P = dims["num_brokers"], dims["max_disks_per_broker"], dims["num_partitions"]
    bad = int(((b < 0) | (b >= B) | (d < 0) | (d >= D)).sum())
    key = np.sort(part.astype(np.int64) * B + np.clip(b, 0, B - 1))
    bad += int((key[1:] == key[:-1]).sum())
    leaders = np.bincount(part, weights=lead.astype(np.float64), minlength=P)
    present = np.bincount(part, minlength=P) > 0
    bad += int((present & (leaders != 1)).sum())
    return bad


def expected_diff(cols: dict, after: dict) -> dict:
    """The reference's own diff of the input placement and the answered
    one: partition -> (sorted old brokers, sorted new brokers, old leader,
    new leader, sorted logdir moves (broker, old, new))."""
    v = cols["replica_valid"]
    part = cols["replica_partition"]
    b0, l0, d0 = cols["replica_broker"], cols["replica_is_leader"], cols["replica_disk"]
    b1, l1, d1 = after["replica_broker"], after["replica_is_leader"], after["replica_disk"]
    changed = v & ((b0 != b1) | (l0 != l1) | (d0 != d1))
    touched = np.unique(part[changed])
    if touched.size == 0:
        return {}
    rows = np.nonzero(v & np.isin(part, touched))[0]
    rows = rows[np.argsort(part[rows], kind="stable")]
    k = np.searchsorted(touched, part[rows])          # partition slot of each row
    start = np.searchsorted(k, np.arange(touched.size))
    j = np.arange(rows.size) - start[k]                # row's column in its slot
    m = int(j.max()) + 1
    big = np.iinfo(np.int64).max

    def table(values, fill):
        t = np.full((touched.size, m), fill, np.int64)
        t[k, j] = values
        return t

    old_b, new_b = table(b0[rows], big), table(b1[rows], big)
    old_l = table(np.where(l0[rows], b0[rows], -1), -1).max(1)
    new_l = table(np.where(l1[rows], b1[rows], -1), -1).max(1)
    stay = (b0[rows] == b1[rows]) & (d0[rows] != d1[rows])
    mv = np.full((touched.size, m, 3), big, np.int64)
    mv[k[stay], j[stay]] = np.stack([b1[rows][stay], d0[rows][stay], d1[rows][stay]], 1)
    mv = np.take_along_axis(mv, np.argsort(mv[:, :, 0], axis=1, kind="stable")[:, :, None], 1)
    old_b.sort(1)
    new_b.sort(1)
    out = {}
    for p, ob, nb, ol, nl, dm in zip(touched.tolist(), old_b.tolist(), new_b.tolist(),
                                     old_l.tolist(), new_l.tolist(), mv.tolist()):
        out[p] = (tuple(x for x in ob if x != big), tuple(x for x in nb if x != big), ol, nl,
                  tuple(tuple(t) for t in dm if t[0] != big))
    return out


def proposal_faults(cols: dict, after: dict, proposals) -> int:
    """Partitions where the program's proposals and the reference's diff
    disagree: missing, extra, or saying other brokers, leaders or logdir
    moves; a proposal whose new replica list does not start with its new
    leader counts too."""
    want = expected_diff(cols, after)
    seen = set()
    bad = 0
    for pr in proposals:
        p = int(pr.partition)
        if p in seen:
            bad += 1
            continue
        seen.add(p)
        got = (tuple(sorted(int(x) for x in pr.old_replicas)),
               tuple(sorted(int(x) for x in pr.new_replicas)),
               int(pr.old_leader), int(pr.new_leader),
               tuple(sorted((int(x), int(y), int(z)) for x, y, z in pr.disk_moves)))
        lead_first = len(pr.new_replicas) > 0 and int(pr.new_replicas[0]) == int(pr.new_leader)
        if want.get(p) != got or not lead_first:
            bad += 1
    bad += len(set(want) - seen)
    return bad
