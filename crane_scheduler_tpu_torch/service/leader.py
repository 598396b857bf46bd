"""Single-writer guard: the leader-election equivalent.

Copy of ``crane_scheduler_tpu/service/leader.py``. The lease against a
kube apiserver is ``service/kube_leader.py``.

The reference elects an annotator leader through a ``leases`` lock with
15s lease / 10s renew deadline / 2s retry
(ref: cmd/controller/app/server.go:86-126, options.go:45-53), and panics
when leadership is lost (server.go:119-121). Without a kube API we use an
exclusive file lock with a heartbeat file carrying the lease: the holder
re-writes the expiry every retry period; a candidate acquires when the
lock is free. ``on_stopped_leading`` mirrors the reference's
crash-on-lost-lease contract (the caller decides whether to panic).
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time

DEFAULT_LEASE_DURATION = 15.0  # ref: options.go LeaseDuration
DEFAULT_RENEW_DEADLINE = 10.0  # ref: options.go RenewDeadline
DEFAULT_RETRY_PERIOD = 2.0  # ref: options.go RetryPeriod


class LeaderElector:
    def __init__(
        self,
        lock_path: str,
        identity: str,
        on_started_leading,
        on_stopped_leading=None,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
    ):
        self.lock_path = lock_path
        self.identity = identity
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.is_leader = False
        self._stop = threading.Event()
        self._fd = None

    def run(self) -> None:
        """Block until leadership is acquired, run the callback, renew
        until stopped; on lost lease invoke on_stopped_leading."""
        while not self._stop.is_set():
            if self._try_acquire():
                self.is_leader = True
                started = threading.Thread(
                    target=self.on_started_leading, args=(self._stop,), daemon=True
                )
                started.start()
                self._renew_loop()
                self.is_leader = False
                if self.on_stopped_leading is not None:
                    self.on_stopped_leading()
                return
            self._stop.wait(timeout=self.retry_period)

    def stop(self) -> None:
        self._stop.set()
        self._release()

    def _try_acquire(self) -> bool:
        fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._fd = fd
        self._write_lease()
        return True

    def _write_lease(self) -> None:
        lease = {
            "holderIdentity": self.identity,
            "renewTime": time.time(),
            "leaseDurationSeconds": self.lease_duration,
        }
        os.lseek(self._fd, 0, os.SEEK_SET)
        os.ftruncate(self._fd, 0)
        os.write(self._fd, json.dumps(lease).encode())

    def _renew_loop(self) -> None:
        deadline = time.time() + self.renew_deadline
        while not self._stop.wait(timeout=self.retry_period):
            try:
                self._write_lease()
                deadline = time.time() + self.renew_deadline
            except OSError:
                if time.time() > deadline:
                    return  # lease lost
        # stopped deliberately

    def _release(self) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
