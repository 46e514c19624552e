"""The reference's application of a what-if scenario to a cluster's
columns, in plain numpy, from upstream Cruise Control's semantics of a
lost broker (dead, its replicas offline), a lost rack (every broker on
it lost), an added broker (alive, new, on a named rack, on a host of its
own, with the live brokers' median capacity and one logdir holding it)
and a topic's load scaled (every replica's leader and follower load).
Losses come first, then additions, then load, as an operator would read
the scenario.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

DISK = 3


def apply(cols: dict, dims: dict, sc: dict) -> tuple[dict, dict]:
    """(columns, dims) of `cols` under scenario `sc`, a dict with any of
    "kill_racks", "remove_brokers", "add_brokers" ([count, rack] pairs) and
    "topic_factors" ({topic: factor})."""
    c = {k: v.copy() for k, v in cols.items()}
    d = dict(dims)
    dead = [int(b) for b in np.nonzero(c["broker_valid"]
                                       & np.isin(c["broker_rack"], sc.get("kill_racks", [])))[0]]
    dead += [int(b) for b in sc.get("remove_brokers", [])]
    if dead:
        c["broker_alive"][dead] = False
        c["replica_offline"] = (c["replica_offline"] | np.isin(c["replica_broker"], dead)) \
            & c["replica_valid"]
    for count, rack in sc.get("add_brokers", []):
        for _ in range(int(count)):
            alive = c["broker_valid"] & c["broker_alive"]
            cap = np.median(c["broker_capacity"][alive], axis=0).astype(np.float32)
            host = int(c["broker_host"][c["broker_valid"]].max()) + 1
            D = c["disk_capacity"].shape[1]
            disk_cap = np.zeros(D, np.float32)
            disk_cap[0] = cap[DISK]
            disk_alive = np.zeros(D, bool)
            disk_alive[0] = True
            for f, val in (("broker_capacity", cap), ("broker_rack", rack), ("broker_host", host),
                           ("broker_alive", True), ("broker_new", True), ("broker_valid", True),
                           ("disk_capacity", disk_cap), ("disk_alive", disk_alive)):
                c[f] = np.concatenate([c[f], np.asarray([val], c[f].dtype)])
            d["num_brokers"] += 1
            d["num_hosts"] = max(d["num_hosts"], host + 1)
    for topic, factor in sc.get("topic_factors", {}).items():
        rows = c["replica_valid"] & (c["replica_topic"] == int(topic))
        f = np.float32(factor)
        c["replica_load_leader"][rows] *= f
        c["replica_load_follower"][rows] *= f
    return c, d
