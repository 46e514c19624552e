"""Learned per-topic-pair move-acceptance prior.

The annealer's destination draws are uniform over the allowed broker
list; near a converged placement almost every drawn candidate is
rejected, so the candidate budget is spent re-discovering the same few
productive (topic, destination) pairs each run.  The RL-tuned scorer of
"Learning to Score" (arxiv 2603.10545) and the reinforced-GA proposal
policy of arxiv 1905.02494 both show that a learned move distribution
cuts search rounds dramatically; this module is the simplest honest
instance of that idea: an exponentially-decayed count of ACCEPTED moves,
keyed by (source topic, destination broker) pairs, fitted online from

  * past anneal trajectories — every published proposal set's replica
    moves (ProposalSet.destination_pairs), and
  * executed proposals — moves the executor actually applied, weighted
    higher (they survived operator/execution scrutiny, the strongest
    acceptance signal available).

Keys are TOPIC NAMES (stable across model generations and shape-bucket
churn) + broker ids; materialization back onto a generation's dense
topic-id axis rides the build catalog.  A cold prior (fewer than
`min_observations` decayed observations) materializes with mix 0.0 —
the engine then reproduces the uniform draw stream byte-for-byte
(kernels/candidates.py, the relocation kind's destination draw).

The JAX package's controller/prior.py, kept here as its own copy: it is
numpy only, and the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class PriorTable:
    """One model generation's materialized prior (build_statics input).

    weights[t, b]: decayed acceptance mass of moves of topic t's replicas
    onto broker b, on the generation's padded (T, B) axes.  mix: fraction
    of destination draws taken from the prior (0.0 = cold = uniform
    byte-parity)."""

    weights: np.ndarray  # f32[T, B]
    mix: float
    observations: float  # decayed total behind the table (observability)


class MoveAcceptancePrior:
    """Online-fitted move-acceptance distribution (thread-safe).

    `decay` applies once per observation batch (one anneal's proposals, or
    one execution), so ancient traffic patterns fade; entries below a
    floor are pruned so the table never accretes unboundedly under topic
    churn.  `observe_executed` weighs a pair `executed_weight` times an
    anneal observation.
    """

    PRUNE_FLOOR = 1e-3

    def __init__(
        self,
        *,
        mix: float = 0.5,
        decay: float = 0.9,
        min_observations: int = 64,
        executed_weight: float = 4.0,
    ):
        if not 0.0 <= mix <= 1.0:
            raise ValueError(f"mix must be in [0, 1], got {mix}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.mix = mix
        self.decay = decay
        self.min_observations = min_observations
        self.executed_weight = executed_weight
        self._lock = threading.Lock()
        self._w: dict[tuple[str, int], float] = {}
        self._observations = 0.0  # decayed total

    # ------------------------------------------------------------- fitting

    def _pairs(self, proposals, catalog):
        """(topic_name, dst_broker) move pairs from a proposal container
        (columnar ProposalSet or a plain ExecutionProposal list)."""
        topics = catalog.topics if catalog is not None else ()
        pairs: list[tuple[str, int]] = []
        dest = getattr(proposals, "destination_pairs", None)
        if dest is not None:
            tids, brokers = dest()
            for t, b in zip(tids.tolist(), brokers.tolist()):
                if 0 <= t < len(topics):
                    pairs.append((topics[t], int(b)))
            return pairs
        for p in proposals:
            old = set(p.old_replicas)
            t = int(p.topic)
            if not 0 <= t < len(topics):
                continue
            for b in p.new_replicas:
                if b not in old:
                    pairs.append((topics[t], int(b)))
        return pairs

    def _observe(self, pairs, weight: float) -> int:
        if not pairs:
            return 0
        with self._lock:
            d = self.decay
            if d < 1.0:
                self._observations *= d
                w = self._w
                for k in [k for k, v in w.items() if v * d < self.PRUNE_FLOOR]:
                    del w[k]
                for k in self._w:
                    self._w[k] *= d
            for k in pairs:
                self._w[k] = self._w.get(k, 0.0) + weight
            self._observations += weight * len(pairs)
        return len(pairs)

    def observe_proposals(self, proposals, catalog) -> int:
        """Fit from one anneal's published proposal set; returns the
        number of (topic, destination) pairs observed."""
        return self._observe(self._pairs(proposals, catalog), 1.0)

    def observe_executed(self, proposals, catalog) -> int:
        """Fit from proposals the executor actually applied (weighted
        `executed_weight`)."""
        return self._observe(
            self._pairs(proposals, catalog), self.executed_weight
        )

    # ------------------------------------------------------------ reading

    @property
    def observations(self) -> float:
        with self._lock:
            return self._observations

    @property
    def ready(self) -> bool:
        """Enough decayed observations to justify a non-zero mix."""
        return self.observations >= self.min_observations

    def table(self, catalog, shape) -> PriorTable:
        """Materialize onto one generation's padded (T, B) axes.

        Topics absent from this generation's catalog (deleted mid-stream)
        simply contribute nothing; brokers beyond the padded axis are
        dropped (they cannot be destinations).  A not-ready prior returns
        mix 0.0 — the byte-parity cold path."""
        T, B = shape.num_topics, shape.B
        w = np.zeros((T, B), np.float32)
        with self._lock:
            obs = self._observations
            if self._w and catalog is not None:
                tid = {t: i for i, t in enumerate(catalog.topics)}
                for (tname, b), v in self._w.items():
                    t = tid.get(tname)
                    if t is not None and 0 <= b < B:
                        w[t, b] += v
        mix = self.mix if obs >= self.min_observations else 0.0
        return PriorTable(weights=w, mix=mix, observations=obs)

    def state_json(self) -> dict:
        with self._lock:
            return {
                "observations": round(self._observations, 3),
                "pairs": len(self._w),
                "ready": self._observations >= self.min_observations,
                "mix": self.mix,
                "decay": self.decay,
            }
