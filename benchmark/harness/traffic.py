"""The one general generator of the benchmark's requests.

A traffic mix is a JSON file of parameters (benchmark/traffic/*.json);
this module turns it, a configuration's spec and a seed into the run's
inputs: the base cluster's host columns and a ring of request inputs,
made in set-up so that the window draws nothing.  Request i of the window
takes ring item i mod ring.

Parameters:
  entry         "optimize" (a proposal: /proposals, /rebalance,
                /remove_broker) or "simulate" (a /simulate batch)
  ring          how many distinct request inputs set-up makes
  loads         "redraw": each ring item is a new load generation (every
                partition's leader load drawn anew around the spec's
                means, the placement the seed's); "seed": the seed's loads
  dead_fraction the share of brokers each ring item marks dead, a new
                seeded set each item (0: none)
  scenarios     (simulate) the batch: a list of {"kind", "count", ...}
                with kind "kill_rack", "remove_broker", "add_brokers"
                ("sizes": the brokers each of its scenarios adds, in
                turn) or "scale_topic" ("factor": [low, high])
  sample        how many of the window's answers (simulate: scenarios)
                the reference checks, drawn from the seed
  base_seed     (optional) the cluster and the ring are drawn from this
                seed, and the run's seed orders the ring: every run does
                the same requests in its own order, for a mix whose work
                would otherwise change with the seed (an anneal that stops
                early, a batch whose scenarios differ in size)
  assumed       what the mix assumes where no public source gives it
                (read by people, not by the generator)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import generator


@dataclasses.dataclass
class Traffic:
    entry: str
    cols: dict
    dims: dict
    ring: list
    sample: int


def build(config: dict, traffic: dict, seed: int) -> Traffic:
    spec = config["spec"]
    base = int(traffic.get("base_seed", seed))
    cols, dims = generator.generate(spec, base)
    n = int(traffic["ring"])
    entry = traffic["entry"]
    if entry == "optimize":
        ring = [_cluster(spec, cols, dims, traffic, base, i) for i in range(n)]
    elif entry == "simulate":
        ring = [_batch(dims, traffic["scenarios"], base, i) for i in range(n)]
    else:
        raise ValueError(f"unknown entry {entry!r}")
    if "base_seed" in traffic:
        ring = [ring[k] for k in generator.rng(seed, 5).permutation(n)]
    return Traffic(entry=entry, cols=cols, dims=dims, ring=ring, sample=int(traffic["sample"]))


def _cluster(spec, cols, dims, traffic, seed, i) -> dict:
    """Ring item i of a proposal mix: the request's host columns."""
    out = dict(cols)
    if traffic.get("loads", "seed") == "redraw":
        out["replica_load_leader"], out["replica_load_follower"] = generator.draw_loads(
            spec, seed, i + 1, cols["replica_partition"])
    k = int(round(float(traffic.get("dead_fraction", 0.0)) * dims["num_brokers"]))
    if k:
        dead = generator.rng(seed, 3, i).choice(dims["num_brokers"], size=k, replace=False)
        out = generator.kill(out, np.sort(dead))
    return out


def _batch(dims, kinds, seed, i) -> list[dict]:
    """Ring item i of a what-if mix: the batch's scenarios."""
    g = generator.rng(seed, 2, i)
    out = []
    for kind in kinds:
        for j in range(int(kind["count"])):
            name = f"{kind['kind']}-{j}"
            if kind["kind"] == "kill_rack":
                out.append(dict(name=name, kill_racks=[int(g.integers(dims["num_racks"]))]))
            elif kind["kind"] == "remove_broker":
                out.append(dict(name=name, remove_brokers=[int(g.integers(dims["num_brokers"]))]))
            elif kind["kind"] == "add_brokers":
                size = kind["sizes"][j % len(kind["sizes"])]
                out.append(dict(name=name,
                                add_brokers=[[int(size), int(g.integers(dims["num_racks"]))]]))
            elif kind["kind"] == "scale_topic":
                lo, hi = kind["factor"]
                out.append(dict(name=name, topic_factors={
                    int(g.integers(dims["num_topics"])): float(g.uniform(lo, hi))}))
            else:
                raise ValueError(f"unknown scenario kind {kind['kind']!r}")
    return out
