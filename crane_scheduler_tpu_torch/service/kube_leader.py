"""Lease-based leader election over the Kubernetes coordination API.

Copy of ``crane_scheduler_tpu/service/kube_leader.py``, on the port's
``service/leader.py`` timings and ``cluster/kube.py`` HTTP plumbing.

The reference elects the annotator leader through a ``leases`` resource
lock with 15s lease / 10s renew deadline / 2s retry and panics when
leadership is lost (ref: cmd/controller/app/server.go:86-126,
options/options.go:45-53). This is that elector against a real
apiserver (``cluster.kube.KubeClusterClient`` carries the HTTP
plumbing): candidates race to create/update the Lease object's
``holderIdentity`` + ``renewTime``; the holder renews every retry
period; a candidate steals only an expired lease. The file-lock elector
(``service.leader``) remains the no-apiserver fallback with the same
timings and the same crash-on-lost-lease contract.
"""

from __future__ import annotations

import datetime
import threading
import urllib.error

from .leader import (
    DEFAULT_LEASE_DURATION,
    DEFAULT_RENEW_DEADLINE,
    DEFAULT_RETRY_PERIOD,
)

LEASE_API = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}"
LEASES_API = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"


def _now_rfc3339() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def _parse_rfc3339(s: str | None) -> float:
    if not s:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(
            str(s).replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return 0.0


class KubeLeaderElector:
    """Single-winner election on a Lease object.

    ``client`` is a ``KubeClusterClient`` (only its ``_request`` /
    ``_get_json`` HTTP plumbing is used — election must work before the
    informer mirror is started). Callbacks match ``LeaderElector``:
    ``on_started_leading(stop_event)`` runs in a thread while leading;
    ``on_stopped_leading()`` fires when the lease is lost (the caller
    decides whether to crash, like the reference's panic).
    """

    def __init__(
        self,
        client,
        lease_name: str,
        identity: str,
        on_started_leading,
        on_stopped_leading=None,
        namespace: str | None = None,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
    ):
        from ..utils import system_namespace

        self.client = client
        self.lease_name = lease_name
        self.identity = identity
        # default resolves CRANE_SYSTEM_NAMESPACE -> "crane-system"
        # (ref: utils.go:47-55, consumed at options.go:52)
        self.namespace = namespace if namespace else system_namespace()
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.is_leader = False
        self._stop = threading.Event()
        # clock-skew-safe expiry: (holder, renewTime string, local time
        # first observed). A lease is expired only when its renewTime has
        # not CHANGED for > duration on OUR clock — never by comparing
        # our clock to the holder's timestamp (client-go's contract).
        self._observed: tuple | None = None
        self._last_error_code: int | None = None

    # -- lease HTTP --------------------------------------------------------

    def _lease_path(self) -> str:
        return LEASE_API.format(ns=self.namespace, name=self.lease_name)

    def _read(self) -> dict | None:
        try:
            return self.client._get_json(self._lease_path())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _spec(self) -> dict:
        import math

        return {
            "holderIdentity": self.identity,
            # never serialize 0 (readers treat it as absent; apiserver
            # validation rejects it) — sub-second test configs round up
            "leaseDurationSeconds": max(1, math.ceil(self.lease_duration)),
            "renewTime": _now_rfc3339(),
        }

    def _log_http_error(self, e) -> None:
        """One line per distinct status code: an RBAC 403 spinning
        silently forever is the failure this prevents; 404/409 are
        normal protocol traffic and stay quiet."""
        code = getattr(e, "code", None)
        if code in (404, 409) or code == self._last_error_code:
            return
        self._last_error_code = code
        import sys

        print(
            f"lease {self.lease_name}: apiserver error {code or e}; retrying",
            file=sys.stderr,
            flush=True,
        )

    def _create(self) -> bool:
        body = {
            "metadata": {"name": self.lease_name, "namespace": self.namespace},
            "spec": self._spec(),
        }
        try:
            with self.client._request(
                "POST", LEASES_API.format(ns=self.namespace), body
            ) as resp:
                import json as _json

                obj = _json.loads(resp.read() or b"{}")
                self._rv = str(obj.get("metadata", {}).get("resourceVersion", ""))
                return True
        except (urllib.error.URLError, OSError):
            return False

    def _update(self, expected_rv: str | None) -> bool:
        """Compare-and-swap on metadata.resourceVersion: two candidates
        racing an expired lease must not both win (client-go's resource
        lock has the same optimistic-concurrency contract); the server
        answers 409 on a stale version."""
        body = {"spec": self._spec()}
        if expected_rv:
            body["metadata"] = {"resourceVersion": expected_rv}
        try:
            with self.client._request(
                "PATCH",
                self._lease_path(),
                body,
                content_type="application/merge-patch+json",
            ) as resp:
                import json as _json

                obj = _json.loads(resp.read() or b"{}")
                self._rv = str(obj.get("metadata", {}).get("resourceVersion", ""))
                return True
        except (urllib.error.URLError, OSError):
            return False

    # -- election loop -----------------------------------------------------

    def _try_acquire(self) -> bool:
        import time as _time

        try:
            lease = self._read()
        except urllib.error.HTTPError as e:
            self._log_http_error(e)
            return False
        except (urllib.error.URLError, OSError) as e:
            self._log_http_error(e)
            return False
        if lease is None:
            return self._create()
        spec = lease.get("spec", {}) or {}
        holder = spec.get("holderIdentity")
        renew_str = str(spec.get("renewTime") or "")
        duration = float(spec.get("leaseDurationSeconds") or self.lease_duration)

        # expiry on OUR clock from when we first observed this renewTime
        # value — trusting the holder's wall-clock timestamp would let a
        # skewed candidate steal a live lease
        key = (holder, renew_str)
        if self._observed is None or self._observed[:2] != key:
            self._observed = (holder, renew_str, _time.time())
        expired = _time.time() - self._observed[2] > duration

        if holder in (None, "", self.identity) or expired:
            rv = str(lease.get("metadata", {}).get("resourceVersion", ""))
            return self._update(rv)
        return False

    def run(self) -> None:
        """Block until leadership is acquired, run the callback, renew
        until stopped; when the lease is lost, invoke
        ``on_stopped_leading`` and RETURN — never re-acquire in the same
        run (the lease still names this identity, so an immediate retry
        would win instantly and race a second callback thread against
        the first's teardown; the reference's contract is
        crash-on-lost-lease, server.go:119-121 — restart to re-enter)."""
        while not self._stop.is_set():
            if self._try_acquire():
                self.is_leader = True
                leading_stop = threading.Event()
                thread = threading.Thread(
                    target=self.on_started_leading,
                    args=(leading_stop,),
                    daemon=True,
                )
                thread.start()
                self._renew_loop()
                self.is_leader = False
                leading_stop.set()
                if self.on_stopped_leading is not None:
                    self.on_stopped_leading()
                return
            self._stop.wait(timeout=self.retry_period)

    def _renew_loop(self) -> None:
        import time as _time

        last_renew = _time.time()
        while not self._stop.wait(timeout=self.retry_period):
            if self._update(getattr(self, "_rv", None)):
                last_renew = _time.time()
            elif _time.time() - last_renew > self.renew_deadline:
                return  # lease lost (ref: panic on lost lease)

    def stop(self) -> None:
        self._stop.set()
