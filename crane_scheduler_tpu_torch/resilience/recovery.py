"""Crash-safe placement plane: the bind-intent journal, restart
reconciliation and warm-standby scheduler failover.

Counterpart of ``crane_scheduler_tpu/resilience/recovery.py`` (stdlib
only there too; the port keeps its own copy). Every process survives its
own death through three pieces:

- ``IntentJournal`` — a durable JSONL segment ring (``intent-<n>.jsonl``,
  rotation, torn-tail skip) recording every non-idempotent POST *before*
  it reaches the wire: an ``intent`` line (pod key, node, window id,
  traceparent) ahead of each bind/eviction POST, an ``ack`` on a 2xx, a
  ``nack`` on a durable server error (answered, not applied: safe to
  re-drive), an ``unresolved`` mark for transport loss and the pipelined
  write path's indeterminate outcomes, and a ``tombstone`` once the
  watch confirms the placement. Every line is one write+flush (opt-in
  ``fsync``); a crash can lose at most the torn tail. Lines are byte for
  byte the reference's apart from ``ts``, so either package replays the
  other's directory.
- ``Reconciler`` — restart replay: classify each unresolved intent by
  GETting the live object (bound as intended -> ack; bound elsewhere ->
  drop; unbound -> safe to re-schedule; eviction with the pod still
  present -> re-arm the node cooldown, never a second eviction POST),
  re-arm lifecycle traces on the same trace id, and journal a
  ``resolved`` line per intent so a second restart replays nothing.
- ``WarmStandby`` — a second scheduler process holding the file-lock
  ``LeaderElector`` (``service/leader.py``) in standby; on lease
  acquisition it reconciles the dead leader's journal directory before
  its first bind and reports ``crane_failover_seconds``.

``KillSwitch`` is the deterministic SIGKILL-at-offset injector: it
truncates the journal mid-line at an exact byte offset and fires its
action (SIGKILL by default, a ``SimulatedCrash`` in-process), so "kill at
any byte offset" is a sweepable test axis.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

SCHEMA_VERSION = 1

_JSON_SEP = (",", ":")

# reconciliation outcomes (the crane_recovery_reconciled_total label set)
OUTCOME_BOUND_AS_INTENDED = "bound_as_intended"
OUTCOME_BOUND_ELSEWHERE = "bound_elsewhere"
OUTCOME_UNBOUND = "unbound_reschedulable"
OUTCOME_POD_GONE = "pod_gone"
OUTCOME_EVICTED = "evicted"
OUTCOME_EVICT_UNAPPLIED = "evict_unapplied"


class SimulatedCrash(BaseException):
    """In-process stand-in for SIGKILL: raised by a ``KillSwitch`` whose
    action is to abandon the process mid-write. Derives from
    BaseException so no library-level ``except Exception`` in the write
    path can swallow the "process died here" semantics."""


class KillSwitch:
    """SIGKILL-at-offset injection for the intent journal.

    Arms at an absolute journal byte offset. When a record write would
    cross the offset, only the bytes up to it are written (a torn tail,
    exactly what a real SIGKILL mid-``write(2)`` leaves) and ``action``
    fires — ``os.kill(getpid(), SIGKILL)`` by default, or any callable
    (tests raise ``SimulatedCrash`` and abandon the client without
    teardown)."""

    def __init__(self, at_bytes: int, action=None):
        self.at_bytes = int(at_bytes)
        self.tripped = False
        if action is None:
            import signal

            def action():
                os.kill(os.getpid(), signal.SIGKILL)

        self.action = action

    def cut(self, total_bytes: int, line_len: int) -> int | None:
        """How many bytes of the next ``line_len``-byte record may be
        written before the switch fires; None = the whole line fits.
        Once tripped the answer is always 0 — a dead process writes
        nothing, even when the test action didn't exit the interpreter."""
        if self.tripped:
            return 0
        if total_bytes >= self.at_bytes:
            return 0
        if total_bytes + line_len > self.at_bytes:
            return self.at_bytes - total_bytes
        return None

    def trip(self):
        self.tripped = True
        self.action()


class IntentJournal:
    """Durable placement-intent journal: a crash-safe JSONL segment ring
    (``intent-<n>.jsonl``) with the FlightRecorder's write/rotate/
    torn-tail discipline, plus per-line ``fsync`` opt-in (power loss,
    not just process death). Thread-safe; one instance per process."""

    def __init__(self, directory: str, max_segment_bytes: int = 4 << 20,
                 max_segments: int = 16, fsync: bool = False,
                 telemetry=None):
        self.directory = directory
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segments = int(max_segments)
        self.fsync = bool(fsync)
        self.kill_switch: KillSwitch | None = None
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        indices = self._segment_indices()
        self._index = indices[-1] if indices else 1
        self._file = open(self._segment_path(self._index), "a")
        self._size = self._file.tell()
        # total bytes ever appended by this process — the KillSwitch
        # offset axis (restart-stable offsets would need the on-disk
        # size folded in; the harness arms fresh journals)
        self.bytes_written = 0
        # monotonic ids continue across restarts so a reconciler's
        # ``resolved`` lines can never collide with replayed intents
        self._seq = 0
        self._window = 0
        for rec in self.read(directory):
            if isinstance(rec.get("id"), int):
                self._seq = max(self._seq, rec["id"])
            if isinstance(rec.get("window"), int):
                self._window = max(self._window, rec["window"])
        # open intents awaiting their watch-confirm tombstone, bounded
        self._open_binds: dict[str, tuple[int, str]] = {}
        self._open_evicts: dict[str, int] = {}
        self._open_cap = 65536
        self._m_bytes = None
        if telemetry is not None:
            self._m_bytes = telemetry.registry.gauge(
                "crane_recovery_journal_bytes",
                "Bytes appended to the placement-intent journal",
            )

    # -- segment ring (FlightRecorder discipline) -------------------------

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, f"intent-{index:06d}.jsonl")

    def _segment_indices(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("intent-") and name.endswith(".jsonl"):
                try:
                    out.append(int(name[len("intent-"):-len(".jsonl")]))
                except ValueError:
                    continue
        return sorted(out)

    def _append(self, obj: dict) -> None:
        line = json.dumps(obj, separators=_JSON_SEP, default=str) + "\n"
        with self._lock:
            ks = self.kill_switch
            if ks is not None:
                cut = ks.cut(self.bytes_written, len(line))
                if cut is not None:
                    # a real SIGKILL mid-write leaves exactly this torn
                    # prefix on disk
                    if cut:
                        self._file.write(line[:cut])
                        self._file.flush()
                        if self.fsync:
                            os.fsync(self._file.fileno())
                        self.bytes_written += cut
                        self._size += cut
                    ks.trip()
                    return  # only reachable with a non-exiting action
            self._file.write(line)
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._size += len(line)
            self.bytes_written += len(line)
            if self._m_bytes is not None:
                self._m_bytes.set(self.bytes_written)
            if self._size >= self.max_segment_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._file.close()
        self._index += 1
        self._file = open(self._segment_path(self._index), "a")
        self._size = 0
        indices = self._segment_indices()
        while len(indices) > self.max_segments:
            oldest = indices.pop(0)
            try:
                os.unlink(self._segment_path(oldest))
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            try:
                self._file.close()
            except OSError:
                pass

    # -- record API --------------------------------------------------------

    def begin_window(self) -> int:
        """A fresh window id for one POST batch / drip dispatch window;
        every intent of the batch carries it."""
        with self._lock:
            self._window += 1
            return self._window

    def intent(self, op: str, pod: str, node: str | None,
               trace: str | None = None, window: int | None = None) -> int:
        """Journal the intent to POST. MUST be called before the request
        reaches the wire — the crash-safety contract."""
        with self._lock:
            self._seq += 1
            iid = self._seq
        self._append({
            "v": SCHEMA_VERSION, "t": "intent", "id": iid, "op": op,
            "pod": pod, "node": node,
            "window": self._window if window is None else window,
            "trace": trace, "ts": time.time(),
        })
        with self._lock:
            if op == "bind":
                self._open_binds[pod] = (iid, node or "")
                while len(self._open_binds) > self._open_cap:
                    self._open_binds.pop(next(iter(self._open_binds)))
            elif op == "evict":
                self._open_evicts[pod] = iid
                while len(self._open_evicts) > self._open_cap:
                    self._open_evicts.pop(next(iter(self._open_evicts)))
        return iid

    def ack(self, intent_id: int) -> None:
        """The server confirmed the POST (2xx) — the write applied. The
        intent stays open in memory until the watch tombstones it."""
        self._append({"v": SCHEMA_VERSION, "t": "ack", "id": intent_id})

    def nack(self, intent_id: int, status: int) -> None:
        """The server answered a durable error (404/409/422/...): the
        POST was NOT applied and the caller may re-drive it."""
        self._append({"v": SCHEMA_VERSION, "t": "nack", "id": intent_id,
                      "status": int(status)})
        self._drop_open(intent_id)

    def unresolved(self, intent_id: int) -> None:
        """Transport loss / pipelined indeterminate: the server may or
        may not have processed the POST. Recorded explicitly (not just
        as an absent ack) so the journal reads as a decision log; the
        intent replays as unresolved either way."""
        self._append({"v": SCHEMA_VERSION, "t": "unresolved",
                      "id": intent_id})

    def resolved(self, intent_id: int, outcome: str) -> None:
        """Reconciliation verdict for a replayed intent — terminal, so a
        second restart replays nothing."""
        self._append({"v": SCHEMA_VERSION, "t": "resolved",
                      "id": intent_id, "outcome": outcome})
        self._drop_open(intent_id)

    def tombstone_batch(self, pairs) -> int:
        """Watch-confirm hook: ``(pod, node)`` placements the watch
        delivered. Pods without an open bind intent cost one dict miss."""
        n = 0
        for pod, node in pairs:
            with self._lock:
                open_intent = self._open_binds.get(pod)
                if open_intent is None:
                    continue
                del self._open_binds[pod]
            self._append({"v": SCHEMA_VERSION, "t": "tombstone",
                          "id": open_intent[0], "pod": pod, "node": node})
            n += 1
        return n

    def tombstone_deleted(self, pod: str) -> None:
        """Watch DELETED hook: confirms an open eviction intent."""
        with self._lock:
            iid = self._open_evicts.pop(pod, None)
        if iid is not None:
            self._append({"v": SCHEMA_VERSION, "t": "tombstone",
                          "id": iid, "pod": pod, "node": None})

    def _drop_open(self, intent_id: int) -> None:
        with self._lock:
            for d in (self._open_binds, self._open_evicts):
                for pod, val in list(d.items()):
                    iid = val[0] if isinstance(val, tuple) else val
                    if iid == intent_id:
                        del d[pod]

    # -- replay ------------------------------------------------------------

    @staticmethod
    def read(directory: str):
        """Yield records oldest-first across all segments, skipping torn
        or foreign lines (the FlightRecorder reader contract)."""
        if not os.path.isdir(directory):
            return
        names = sorted(
            n for n in os.listdir(directory)
            if n.startswith("intent-") and n.endswith(".jsonl")
        )
        for name in names:
            try:
                with open(os.path.join(directory, name)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue  # torn tail from a crash
                        if isinstance(obj, dict):
                            yield obj
            except OSError:
                continue


@dataclass
class JournalReplay:
    """Classified journal tail: what a restart must reconcile."""

    intents: dict = field(default_factory=dict)  # id -> intent record
    resolved_ids: set = field(default_factory=set)
    records_replayed: int = 0
    skipped_newer_schema: int = 0
    orphan_resolutions: int = 0  # ack/nack/tombstone with no intent line

    def unresolved(self) -> list[dict]:
        """Intent records with no terminal resolution, journal order."""
        return [
            rec for iid, rec in sorted(self.intents.items())
            if iid not in self.resolved_ids
        ]


def replay_journal(directory: str) -> JournalReplay:
    """Walk the journal ring and classify every intent. Records from a
    NEWER schema version are skipped and counted — an old binary must
    never misread a new journal as "nothing unresolved is mine"."""
    out = JournalReplay()
    for rec in IntentJournal.read(directory):
        t = rec.get("t")
        if t not in ("intent", "ack", "nack", "unresolved", "resolved",
                     "tombstone"):
            continue
        out.records_replayed += 1
        if int(rec.get("v", 0)) > SCHEMA_VERSION:
            out.skipped_newer_schema += 1
            continue
        iid = rec.get("id")
        if t == "intent":
            out.intents[iid] = rec
        elif t in ("ack", "nack", "resolved", "tombstone"):
            # ack/nack/resolved/tombstone are all terminal: the outcome
            # is known (applied / not applied / reconciled / confirmed)
            if iid not in out.intents:
                # the intent line rotated out of the ring, or this is a
                # foreign journal tail — nothing to reconcile, count it
                out.orphan_resolutions += 1
            out.resolved_ids.add(iid)
        # "unresolved" is an annotation, not a resolution: the intent
        # stays in the replay set
    return out


@dataclass
class ReconcileReport:
    """What reconciliation found and did. ``reschedule`` carries
    ``(pod_key, intended_node, trace_id, attempt)`` for pods that are
    provably unbound (safe to re-schedule, same trace, attempt+1);
    ``rearm_cooldowns`` carries node names whose eviction intent could
    not be confirmed (the descheduler must cool down, never re-POST)."""

    outcomes: dict = field(default_factory=dict)
    reschedule: list = field(default_factory=list)
    rearm_cooldowns: list = field(default_factory=list)
    intents_replayed: int = 0
    records_replayed: int = 0
    skipped_newer_schema: int = 0
    orphan_resolutions: int = 0
    elapsed_s: float = 0.0

    def total(self) -> int:
        return sum(self.outcomes.values())

    def as_dict(self) -> dict:
        return {
            "outcomes": dict(self.outcomes),
            "reschedule": [list(r) for r in self.reschedule],
            "rearm_cooldowns": list(self.rearm_cooldowns),
            "intents_replayed": self.intents_replayed,
            "records_replayed": self.records_replayed,
            "skipped_newer_schema": self.skipped_newer_schema,
            "orphan_resolutions": self.orphan_resolutions,
            "elapsed_s": round(self.elapsed_s, 4),
        }


def _trace_id_of(traceparent: str | None) -> str | None:
    """trace-id field of a W3C ``00-<trace>-<span>-01`` header value."""
    if not traceparent:
        return None
    parts = traceparent.split("-")
    return parts[1] if len(parts) >= 3 and parts[1] else None


class Reconciler:
    """Restart reconciliation: classify every unresolved intent against
    the LIVE object (``lookup(pod_key)`` must GET the apiserver, not a
    cold mirror), journal a terminal ``resolved`` line each, and hand
    the caller the re-schedulable set. Run this to completion BEFORE
    opening the scheduler for new work."""

    def __init__(self, journal: IntentJournal, lookup, lifecycle=None,
                 telemetry=None):
        self.journal = journal
        self.lookup = lookup
        self.lifecycle = lifecycle
        self._m_replayed = None
        self._m_outcomes = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_replayed = reg.counter(
                "crane_recovery_intents_replayed",
                "Journal intent records replayed at restart",
            )
            self._m_outcomes = reg.counter(
                "crane_recovery_reconciled_total",
                "Reconciled intents by classification",
                ("outcome",),
            )

    def reconcile(self, directory: str | None = None) -> ReconcileReport:
        t0 = time.perf_counter()
        replay = replay_journal(directory or self.journal.directory)
        report = ReconcileReport(
            intents_replayed=len(replay.intents),
            records_replayed=replay.records_replayed,
            skipped_newer_schema=replay.skipped_newer_schema,
            orphan_resolutions=replay.orphan_resolutions,
        )
        if self._m_replayed is not None:
            self._m_replayed.inc(len(replay.intents))
        for rec in replay.unresolved():
            outcome = self._classify(rec, report)
            report.outcomes[outcome] = report.outcomes.get(outcome, 0) + 1
            self.journal.resolved(rec["id"], outcome)
            if self._m_outcomes is not None:
                self._m_outcomes.labels(outcome=outcome).inc()
        report.elapsed_s = time.perf_counter() - t0
        return report

    def _classify(self, rec: dict, report: ReconcileReport) -> str:
        pod_key = rec.get("pod", "")
        intended = rec.get("node")
        pod = self.lookup(pod_key)
        if rec.get("op") == "evict":
            if pod is None:
                # the eviction landed (or the pod died another way):
                # either way it is gone — done
                return OUTCOME_EVICTED
            # the pod survives: the POST may still be racing through the
            # old apiserver queue. NEVER a second eviction POST — re-arm
            # the node cooldown and let the next sweep re-evaluate.
            node = intended or pod.node_name or ""
            if node:
                report.rearm_cooldowns.append(node)
            return OUTCOME_EVICT_UNAPPLIED
        # bind intent
        if pod is None:
            return OUTCOME_POD_GONE
        bound_node = getattr(pod, "node_name", None)
        if bound_node and bound_node == intended:
            return OUTCOME_BOUND_AS_INTENDED
        if bound_node:
            # another writer (or a prior life of this scheduler) bound
            # it elsewhere — drop our stale intent
            return OUTCOME_BOUND_ELSEWHERE
        # provably unbound: the POST never applied — safe to re-schedule
        trace = _trace_id_of(rec.get("trace"))
        attempt = int(rec.get("attempt") or 1)
        report.reschedule.append((pod_key, intended, trace, attempt))
        if self.lifecycle is not None and trace:
            # the re-placement continues the pod's trace at attempt+1
            self.lifecycle.rearm(pod_key, trace, attempt)
        return OUTCOME_UNBOUND


class WarmStandby:
    """Warm-standby failover coordinator for a second scheduler process.

    Holds the file-lock ``LeaderElector`` in standby while the caller's
    mirror watch-follows the live cluster (columns pre-built, kernels
    pre-jitted — the caller owns that client). On lease acquisition it
    reconciles the dead leader's journal directory FIRST, then invokes
    ``on_promote(report)`` and only after that flips ``ready`` — the
    caller must not bind before ``ready``, and once ``wait_ready``
    returns the promotion (journal attach, first bind) has completed.
    ``failover_seconds`` measures lease acquisition to
    reconciliation-complete (the bind path opening)."""

    def __init__(self, lock_path: str, identity: str, journal_dir: str,
                 lookup, lifecycle=None, telemetry=None, on_promote=None,
                 journal: IntentJournal | None = None,
                 lease_duration: float | None = None,
                 renew_deadline: float | None = None,
                 retry_period: float | None = None):
        from ..service.leader import (
            DEFAULT_LEASE_DURATION,
            DEFAULT_RENEW_DEADLINE,
            DEFAULT_RETRY_PERIOD,
            LeaderElector,
        )

        self.journal_dir = journal_dir
        self.lookup = lookup
        self.lifecycle = lifecycle
        self.telemetry = telemetry
        self.on_promote = on_promote
        self._journal = journal
        self.ready = threading.Event()
        self.report: ReconcileReport | None = None
        self.failover_seconds: float | None = None
        self._m_failover = None
        if telemetry is not None:
            self._m_failover = telemetry.registry.histogram(
                "crane_failover_seconds",
                "Standby lease acquisition to reconciled-and-ready",
                buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
            )
        self.elector = LeaderElector(
            lock_path,
            identity=identity,
            on_started_leading=self._lead,
            lease_duration=(
                DEFAULT_LEASE_DURATION if lease_duration is None
                else lease_duration),
            renew_deadline=(
                DEFAULT_RENEW_DEADLINE if renew_deadline is None
                else renew_deadline),
            retry_period=(
                DEFAULT_RETRY_PERIOD if retry_period is None
                else retry_period),
        )
        self._thread: threading.Thread | None = None

    def start(self) -> "WarmStandby":
        self._thread = threading.Thread(
            target=self.elector.run, name="crane-standby", daemon=True
        )
        self._thread.start()
        return self

    def _lead(self, stop_event) -> None:
        t0 = time.perf_counter()
        journal = self._journal
        if journal is None:
            # take over the dead leader's ring: new lines (resolved
            # verdicts, our own intents) append to the same directory
            journal = self._journal = IntentJournal(
                self.journal_dir, telemetry=self.telemetry
            )
        self.report = Reconciler(
            journal, self.lookup,
            lifecycle=self.lifecycle, telemetry=self.telemetry,
        ).reconcile(self.journal_dir)
        self.failover_seconds = time.perf_counter() - t0
        if self._m_failover is not None:
            self._m_failover.observe(self.failover_seconds)
        # on_promote runs BEFORE ready flips: a caller returning from
        # wait_ready() may immediately tear things down, so anything
        # the promotion does (first bind, journal attach) must already
        # have happened
        try:
            if self.on_promote is not None:
                self.on_promote(self.report)
        finally:
            self.ready.set()
        stop_event.wait()

    @property
    def journal(self) -> IntentJournal | None:
        """The promoted leader's journal (None while still in standby)."""
        return self._journal

    def wait_ready(self, timeout: float | None = None) -> bool:
        return self.ready.wait(timeout)

    def stop(self) -> None:
        self.elector.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._journal is not None:
            self._journal.close()
