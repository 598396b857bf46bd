"""Shared-nothing serving replica.

Copy of ``crane_scheduler_tpu/service/replica.py`` over the port's
``ScoringService``: ``device=`` picks the card (``None`` means the GPU and
raises without one) and the scorer follows ``dtype``, so the reference's
``backend`` switch has no counterpart. Its ``scorer_wrap`` hook, which the
reference's benchmark uses to pace each replica with a simulated
accelerator dispatch, is left out: on the H100 every replica in the
process dispatches to the one real card.

One ``ServingReplica`` is a complete serving stack over a delta-fed
mirror instead of the authoritative cluster: a ``ReplicaMirror`` +
``DeltaStreamClient`` keep a private ``ClusterState`` at the primary's
published version fence, and a ``ScoringService`` in replica mode
(``version_source`` = the mirror's applied fence, deterministic render)
serves from it with ALL of the existing per-process machinery intact —
version-gated single-flight refresh, version-keyed response cache,
device breaker, admission + brownout. Nothing is shared
between replicas: each has its own mirror, store, cache, breaker,
admission limits, and telemetry registry, so a wedged or lagging
replica degrades itself, never its peers.

Byte-identity contract: two replicas whose mirrors are at the same
applied version render byte-identical verdicts for the same ``now``
(deterministic render sorts keys and stamps the version instead of
local wall-clock staleness) — asserted in tests and in-run by bench
config 19.

The replica's ``/v1/replica/status`` surface is the router's gating
input: ``appliedVersion``, lag vs the published hint, and feed
connectivity. It answers on the IO thread (inline), so gating stays
live while the replica's workers are saturated.
"""

from __future__ import annotations

import time

import torch

from ..cluster.replication import DeltaStreamClient, ReplicaMirror
from ..resilience.breaker import CircuitBreaker
from ..telemetry import Telemetry
from .http import ScoringHTTPServer
from .overload import (
    AdmissionController,
    BrownoutController,
    GradientLimiter,
    TenantQueues,
)
from .scoring import ScoringService


class ServingReplica:
    """One replica process-equivalent: mirror + feed + scoring stack +
    HTTP server. ``feed`` is the primary's ``(host, port)``; pass
    ``feed=None`` to run feedless (tests drive ``mirror.apply_frame``
    directly)."""

    def __init__(
        self,
        policy,
        *,
        name: str = "replica-0",
        feed: tuple[str, int] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 4,
        dtype=torch.float64,
        device=None,
        clock=time.time,
        mono_clock=time.monotonic,
        now_bucket_s: float = 0.25,
        admission: AdmissionController | None = None,
        brownout: BrownoutController | None = None,
        breaker: CircuitBreaker | None = None,
        idle_timeout_s: float | None = 30.0,
    ):
        self.name = name
        self.telemetry = Telemetry()
        self.mirror = ReplicaMirror(telemetry=self.telemetry)
        self.feed_client = (
            DeltaStreamClient(
                feed[0], feed[1], self.mirror, telemetry=self.telemetry
            )
            if feed is not None
            else None
        )
        # per-replica resilience: defaults mirror the single
        # process wiring; callers override for bench/smoke tuning
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            "device", telemetry=self.telemetry
        )
        self.brownout = (
            brownout if brownout is not None
            else BrownoutController(telemetry=self.telemetry)
        )
        self.admission = admission if admission is not None else (
            AdmissionController(
                limiter=GradientLimiter(),
                queues=TenantQueues(),
                brownout=self.brownout,
                telemetry=self.telemetry,
            )
        )
        self.service = ScoringService(
            self.mirror.cluster,
            policy,
            dtype=dtype,
            clock=clock,
            mono_clock=mono_clock,
            device=device,
            telemetry=self.telemetry,
            now_bucket_s=now_bucket_s,
            device_breaker=self.breaker,
            version_source=lambda: self.mirror.applied_version,
        )
        self.server = ScoringHTTPServer(
            self.service,
            host=host,
            port=port,
            frontend="async",
            workers=workers,
            admission=self.admission,
            brownout=self.brownout,
            idle_timeout_s=idle_timeout_s,
            replica=self,
        )

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def applied_version(self) -> int:
        return self.mirror.applied_version

    def start(self) -> None:
        self.server.start()
        if self.feed_client is not None:
            self.feed_client.start()

    def stop(self) -> None:
        if self.feed_client is not None:
            self.feed_client.stop()
        self.server.stop()

    def wait_caught_up(self, version: int, timeout_s: float = 10.0) -> bool:
        """Block until the mirror's fence reaches ``version`` (feedless
        replicas are 'caught up' iff already at it)."""
        if self.feed_client is not None:
            return self.feed_client.wait_caught_up(version, timeout_s)
        return self.mirror.applied_version >= version

    def status(self) -> dict:
        """The router's gating surface (served inline on the IO
        thread)."""
        s = self.mirror.status()
        s["name"] = self.name
        s["feedConnected"] = (
            self.feed_client.connected if self.feed_client is not None
            else False
        )
        s["expiredAtDispatch"] = self.service.stats.expired_at_dispatch
        s["brownoutTier"] = self.brownout.tier
        return s
