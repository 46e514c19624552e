"""Two-step verification purgatory for POST requests.

Reference: servlet/purgatory/Purgatory.java:43,117 (maybeAddToPurgatory),
RequestInfo.java / ReviewStatus (PENDING_REVIEW -> APPROVED -> SUBMITTED,
or DISCARDED), surfaced via the REVIEW + REVIEW_BOARD endpoints.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time


class PurgatoryFullError(ValueError):
    """Parked-request cap reached (two.step.purgatory.max.requests) — a
    client error (429/400 class), not a server fault."""


class ReviewStatus(enum.Enum):
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


_VALID = {
    ReviewStatus.PENDING_REVIEW: {ReviewStatus.APPROVED, ReviewStatus.DISCARDED},
    ReviewStatus.APPROVED: {ReviewStatus.SUBMITTED, ReviewStatus.DISCARDED},
    ReviewStatus.SUBMITTED: set(),
    ReviewStatus.DISCARDED: set(),
}


@dataclasses.dataclass
class RequestInfo:
    review_id: int
    endpoint: str
    params: dict
    submitter: str
    status: ReviewStatus = ReviewStatus.PENDING_REVIEW
    reason: str = ""
    #: wall clock, for DISPLAY only (SubmissionTimeMs in the board JSON)
    submitted_ms: int = dataclasses.field(default_factory=lambda: int(time.time() * 1000))
    #: monotonic stamp driving retention — a backwards NTP step must not
    #: immortalize a parked request (or expire a fresh one), same clock-skew
    #: class the facade proposal cache fixed
    submitted_mono: float = dataclasses.field(default_factory=time.monotonic)

    def to_json(self) -> dict:
        return {
            "Id": self.review_id,
            "EndPoint": self.endpoint,
            "Status": self.status.value,
            "SubmitterAddress": self.submitter,
            "Reason": self.reason,
            "SubmissionTimeMs": self.submitted_ms,
        }


class Purgatory:
    def __init__(self, retention_ms: int = 7 * 86_400_000, max_requests: int = 25):
        """max_requests: cap on parked PENDING_REVIEW requests (reference
        WebServerConfig two.step.purgatory.max.requests)."""
        self._requests: dict[int, RequestInfo] = {}
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self.retention_ms = retention_ms
        self.max_requests = max_requests

    def _prune_expired(self):
        now = time.monotonic()
        for rid in [
            r.review_id
            for r in self._requests.values()
            if (now - r.submitted_mono) * 1000.0 > self.retention_ms
        ]:
            del self._requests[rid]

    def add(self, endpoint: str, params: dict, submitter: str = "") -> RequestInfo:
        with self._lock:
            # expired parked requests must not count toward the cap (nobody
            # polling review_board must not wedge the purgatory shut)
            self._prune_expired()
            pending = sum(
                1 for r in self._requests.values()
                if r.status == ReviewStatus.PENDING_REVIEW
            )
            if pending >= self.max_requests:
                raise PurgatoryFullError(
                    f"purgatory holds {pending} pending requests "
                    f"(two.step.purgatory.max.requests={self.max_requests}); "
                    "review or discard some first"
                )
            info = RequestInfo(next(self._ids), endpoint, params, submitter)
            self._requests[info.review_id] = info
            return info

    def review(self, review_id: int, approve: bool, reason: str = "") -> RequestInfo:
        with self._lock:
            info = self._requests[review_id]
            target = ReviewStatus.APPROVED if approve else ReviewStatus.DISCARDED
            if target not in _VALID[info.status]:
                raise ValueError(f"cannot {target.value} a {info.status.value} request")
            info.status = target
            info.reason = reason
            return info

    def take_approved(self, endpoint: str, review_id: int) -> RequestInfo:
        """Claim an APPROVED request for execution (-> SUBMITTED)."""
        with self._lock:
            info = self._requests[review_id]
            if info.endpoint != endpoint:
                raise ValueError(
                    f"review {review_id} is for {info.endpoint}, not {endpoint}"
                )
            if info.status != ReviewStatus.APPROVED:
                raise ValueError(f"review {review_id} is {info.status.value}, not APPROVED")
            info.status = ReviewStatus.SUBMITTED
            return info

    def board(self) -> list[dict]:
        with self._lock:
            self._prune_expired()
            return [r.to_json() for r in self._requests.values()]
