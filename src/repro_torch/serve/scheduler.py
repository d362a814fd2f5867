"""Admission/preemption policy for the serve engine.

With LAZY page growth the engine reserves only the pages covering a
request's prompt plus its first decode write at admission and grows the
reservation on page-boundary crossings; the pool can therefore run dry MID-DECODE, which the worst-case
up-front reservation made impossible. Recovering is a policy decision,
factored out of the engine mechanics:

  * admission stays FIFO head-of-line (``next_index``): when the head
    cannot get pages the engine waits for retirements/evictions rather
    than admitting around it, so no request starves behind lucky late
    arrivals;
  * when ``extend``/``cow`` fails mid-decode, the engine first evicts
    unreferenced prefix-cache pages, then asks ``pick_victim`` for an
    active slot to PREEMPT: least-progress-first (fewest generated
    tokens — the cheapest re-prefill, and the newest admissions yield to
    requests that are nearly done), slot index as the deterministic
    tie-break;
  * a victim's pages are released (shared prefix pages merely drop one
    reference and usually stay resident in the prefix cache), and the
    request is requeued at the FRONT of the FIFO (``requeue``) with its
    partial output intact: re-prefill over prompt+output resumes decoding
    exactly where it stopped (greedy decode is bit-identical to the
    uninterrupted run), and a prefix hit on the still-resident pages makes
    that re-prefill cheap.

Liveness: every reclaim round either evicts a cache page or preempts a
slot, both finite; once every other slot is preempted and the cache is
flushed, the survivor's worst-case context fits the pool by the submit()
bound, so its extend succeeds — a pool sized below aggregate demand
serializes the workload instead of deadlocking (tested in
tests/test_serve_prefix.py::test_preemption_liveness_*).

Two policies ship:

  * ``FifoLeastProgress`` (default) — FIFO admission, fewest-generated-
    tokens victim;
  * ``Priority`` — ``submit(..., priority=N)`` requests with a HIGHER
    priority admit first (FIFO within a priority class, so equal-priority
    traffic cannot starve each other), and under pool pressure the
    LOWEST-priority active slot is preempted first (least progress, then
    slot index, as tie-breaks) — background traffic yields its pages to
    latency-sensitive requests. The head-of-line contract moves with the
    policy: when the top-priority request cannot be placed, nothing is.

Victim candidates are ``(slot, progress, priority)`` triples; policies
that ignore priority just read the first two fields.

Under SPECULATIVE decode (``ServeEngine(spec=...)``) every decoding
slot's drafted rows count against the mixed step's ``chunk_tokens``
budget ahead of any prefill chunk — the engine reserves ``1 + k_s`` rows
per slot (base decode row plus its drafts) before ``prefill_key``
ordering shares out what remains, so speculation can narrow prefill
chunks but never displace a decode row (the same decode-first contract
``serve/step.pack_token_budget`` enforces, now with per-slot row
counts).
"""
from __future__ import annotations

from typing import Deque, Dict, List, Optional, Sequence, Tuple


class FifoLeastProgress:
    """FIFO admission + least-progress preemption (the default policy).

    Requests carrying a DEADLINE (``submit(..., deadline_s=)``, an
    absolute monotonic time on ``Request.deadline``) jump the FIFO:
    admission is earliest-deadline-first with submission order breaking
    ties, and deadline-free requests sort as infinitely late — with no
    deadlines anywhere this is exactly the old FIFO. ``prefill_key``
    orders the mixed step's prefill-budget sharing the same way
    (nearest deadline drains its prompt first)."""

    name = "fifo+least-progress"

    @staticmethod
    def _deadline(req) -> float:
        d = getattr(req, "deadline", None)
        return float("inf") if d is None else d

    def next_index(self, queue: Sequence) -> Optional[int]:
        """Index into ``queue`` of the next admission candidate (EDF,
        then FIFO; None when empty). Head-of-line blocking is the
        engine's contract: if this request cannot be placed, nothing is."""
        if not queue:
            return None
        return min(range(len(queue)),
                   key=lambda i: (self._deadline(queue[i]), i))

    def prefill_key(self, req) -> Tuple:
        """Sort key for sharing the mixed step's prefill token budget
        between mid-prefill slots (ascending; ties broken by admission
        order in the engine): nearest deadline first."""
        return (self._deadline(req),)

    def pick_victim(self, candidates: List[Tuple[int, int, int]]) -> int:
        """Choose the slot to preempt from ``(slot, progress, priority)``
        triples, where progress counts generated tokens. Least progress
        first — cheapest to re-prefill — with the slot index as a
        deterministic tie-break (priority is ignored by this policy)."""
        if not candidates:
            raise ValueError("pick_victim needs at least one candidate")
        return min(candidates, key=lambda sp: (sp[1], sp[0]))[0]

    def requeue(self, queue: Deque, req) -> None:
        """Return a preempted request to the queue: at the FRONT, so FIFO
        order is preserved (it was admitted before anything now queued)."""
        queue.appendleft(req)

    def explain(self, req) -> Dict:
        """Admission-ordering fields for the request's trace (the engine
        stamps them onto the ``submitted`` span event): which policy saw
        the request and what key will order it."""
        d = self._deadline(req)
        out = {"policy": self.name}
        if d != float("inf"):
            out["deadline"] = d
        return out


class Priority(FifoLeastProgress):
    """Priority admission + lowest-priority preemption.

    Higher ``Request.priority`` admits first; within a priority class the
    earliest submission wins (stable FIFO). Preemption inverts it: the
    victim is the LOWEST-priority active slot, least-progress then slot
    index breaking ties — so pool pressure evicts background work before
    anything latency-sensitive, the first step toward the ROADMAP's
    gang/priority scheduling item."""

    name = "priority"

    def next_index(self, queue: Sequence) -> Optional[int]:
        if not queue:
            return None
        return min(range(len(queue)),
                   key=lambda i: (-queue[i].priority,
                                  self._deadline(queue[i]), i))

    def prefill_key(self, req) -> Tuple:
        """Priority class first, nearest deadline within it."""
        return (-req.priority, self._deadline(req))

    def pick_victim(self, candidates: List[Tuple[int, int, int]]) -> int:
        if not candidates:
            raise ValueError("pick_victim needs at least one candidate")
        return min(candidates, key=lambda c: (c[2], c[1], c[0]))[0]

    def requeue(self, queue: Deque, req) -> None:
        """Front of the queue: among equal priorities the preempted
        request was admitted first, and ``next_index`` already lets any
        higher-priority arrival jump it."""
        queue.appendleft(req)

    def explain(self, req) -> Dict:
        out = super().explain(req)
        out["priority"] = int(getattr(req, "priority", 0))
        return out
