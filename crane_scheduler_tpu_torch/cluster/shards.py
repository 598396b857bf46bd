"""Deterministic node-shard ownership, shared by every layer.

Counterpart of ``crane_scheduler_tpu/cluster/shards.py`` (stdlib only;
the port keeps its own copy, so both packages assign every name to the
same shards).

The sharded placement plane (doc/sharding.md) needs ONE answer to
"which shard(s) observe node X" that the cluster mirror (per-shard
watch fences), the shard views (column membership), and the bench/smoke
drivers all agree on — a disagreement would silently desync a shard's
version fence from the columns built over it. Ownership is a pure
function of the node *name* (stable across relists, restarts, and
processes): primary shard = ``crc32(name) % count``, matching the
reference annotator's worker-pool hashing (ref:
pkg/controller/annotator/node.go:148-177) and Agon's partitioned
scheduler assignment (arxiv 2109.00665).

Overlap is opt-in competition: with ``overlap > 0`` a deterministic
fraction of each shard's nodes is *also* observed by the next shard
(ring order), so two schedulers can race for the same capacity and the
optimistic conflict protocol gets exercised instead of proven dead by
construction. ``overlap`` is a fraction in [0, 1): 0 = disjoint
partition, 0.25 = a quarter of the keyspace co-owned. Derived from a
second independent slice of the same CRC so the co-owned set is not
correlated with the primary assignment.
"""

from __future__ import annotations

import bisect
import zlib
from dataclasses import dataclass, field

__all__ = [
    "shard_of", "shard_owners", "name_point", "ShardSpec",
    "HashRing", "RingRebalancer",
]

# overlap is quantized to 1/1024ths of the keyspace: coarse enough to
# stay deterministic across platforms, fine enough for a 5% gate
_OVERLAP_QUANTA = 1024


def _crc(name: str) -> int:
    return zlib.crc32(name.encode("utf-8"))


def name_point(name: str) -> int:
    """A node name's position on the 32-bit hash ring (the same CRC the
    static modulo layout uses, so both keyspaces agree on the draw
    bits)."""
    return _crc(name)


def shard_of(name: str, count: int) -> int:
    """Primary owner shard for ``name`` under a ``count``-way layout."""
    if count <= 1:
        return 0
    return _crc(name) % count


def shard_owners(name: str, count: int, overlap: float = 0.0) -> tuple[int, ...]:
    """Every shard that observes ``name`` (primary first).

    With ``overlap`` > 0, a deterministic ``overlap`` fraction of names
    is co-owned by the ring successor of the primary shard. The
    co-ownership draw uses bits of the CRC independent of the modulus,
    so overlap membership is uncorrelated with primary assignment.
    """
    if count <= 1:
        return (0,)
    c = _crc(name)
    primary = c % count
    if overlap <= 0.0:
        return (primary,)
    draw = (c >> 12) % _OVERLAP_QUANTA
    if draw < int(overlap * _OVERLAP_QUANTA):
        return (primary, (primary + 1) % count)
    return (primary,)


@dataclass(frozen=True)
class ShardSpec:
    """One scheduler's slice of the node keyspace.

    ``index`` observes its primary partition plus (under overlap) the
    co-owned spill from its ring predecessor — i.e. ``observes(name)``
    iff ``index in shard_owners(name, count, overlap)``.
    """

    index: int
    count: int
    overlap: float = 0.0
    # optional dynamic keyspace (a HashRing shared with the cluster
    # mirror): when set, ownership follows the ring's CURRENT token
    # assignment — a reshard moves this spec's membership without
    # rebuilding the spec. Excluded from equality: two specs over the
    # same live ring object compare by slice, not ring state.
    layout: object | None = field(default=None, compare=False)

    def __post_init__(self):
        if not (0 <= self.index < self.count):
            raise ValueError(f"shard index {self.index} not in [0, {self.count})")
        if not (0.0 <= self.overlap < 1.0):
            raise ValueError(f"overlap {self.overlap} not in [0, 1)")
        if self.layout is not None and self.layout.count != self.count:
            raise ValueError(
                f"layout has {self.layout.count} shards, spec expects "
                f"{self.count}"
            )

    def observes(self, name: str) -> bool:
        return self.index in self.owners(name)

    def owners(self, name: str) -> tuple[int, ...]:
        if self.layout is not None:
            return self.layout.owners(name)
        return shard_owners(name, self.count, self.overlap)


_RING_SPACE = 1 << 32


class HashRing:
    """Consistent-hash node keyspace: ``count`` shards x ``vnodes``
    virtual tokens on the 32-bit CRC ring; a name is owned by the first
    token clockwise of ``name_point(name)``. Unlike the static modulo,
    ownership can MOVE: reassigning a token hands exactly that token's
    arc to another shard, so ``ClusterState.reshard`` migrates only the
    names hashed into the moved arcs (doc/sharding.md "Dynamic
    resharding").

    The live ring is mutable by ATOMIC STATE SWAP only (``adopt``):
    readers snapshot ``_state`` once per query, so ShardSpec/ShardView
    lookups racing a reshard see either the old or the new layout,
    never a torn one. Token positions are a pure function of (count,
    vnodes), and an explicit assignment vector captures moves — two
    processes given the same spec dict rebuild identical rings.

    Overlap keeps the static layout's semantics: the same independent
    CRC draw picks co-owned names, and the co-owner is the next
    DISTINCT shard clockwise of the owning token.
    """

    def __init__(
        self,
        count: int,
        vnodes: int = 64,
        overlap: float = 0.0,
        assignments: list[int] | None = None,
    ):
        if count < 1:
            raise ValueError(f"shard count must be >= 1, got {count}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        if not (0.0 <= overlap < 1.0):
            raise ValueError(f"overlap {overlap} not in [0, 1)")
        self.count = int(count)
        self.vnodes = int(vnodes)
        self.overlap = float(overlap)
        taken: dict[int, int] = {}
        for s in range(count):
            for j in range(vnodes):
                k = 0
                while True:
                    point = _crc(f"ring/{s}/{j}/{k}")
                    if point not in taken:
                        break
                    k += 1  # deterministic collision rehash
                taken[point] = s
        points = sorted(taken)
        owners = [taken[p] for p in points]
        if assignments is not None:
            if len(assignments) != len(points):
                raise ValueError(
                    f"{len(assignments)} assignments for {len(points)} tokens"
                )
            for s in assignments:
                if not (0 <= s < count):
                    raise ValueError(f"assignment {s} not in [0, {count})")
            owners = [int(s) for s in assignments]
        self._state = (tuple(points), tuple(owners), 0)

    # -- queries (lock-free: one atomic state snapshot per call) ---------

    @property
    def version(self) -> int:
        return self._state[2]

    def tokens(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(points, owners) — sorted ring tokens and their shard."""
        points, owners, _ = self._state
        return points, owners

    def _owner_index(self, points, point: int) -> int:
        i = bisect.bisect_left(points, point)
        return 0 if i == len(points) else i

    def _pair_at(self, points, owners, point: int) -> tuple[int, int]:
        """(primary, next-distinct) owner for a hash position — the
        full observation fingerprint a name at ``point`` can have."""
        i = self._owner_index(points, point)
        primary = owners[i]
        n = len(owners)
        for step in range(1, n):
            nxt = owners[(i + step) % n]
            if nxt != primary:
                return primary, nxt
        return primary, primary

    def owner(self, name: str) -> int:
        points, owners, _ = self._state
        return owners[self._owner_index(points, name_point(name))]

    def owners(self, name: str) -> tuple[int, ...]:
        points, owners, _ = self._state
        c = name_point(name)
        primary, nxt = self._pair_at(points, owners, c)
        if self.overlap <= 0.0 or nxt == primary:
            return (primary,)
        draw = (c >> 12) % _OVERLAP_QUANTA
        if draw < int(self.overlap * _OVERLAP_QUANTA):
            return (primary, nxt)
        return (primary,)

    def spec_dict(self) -> dict:
        """Serializable ring spec — a peer process rebuilds the exact
        ring with ``HashRing.from_spec`` (the cross-process reshard
        handshake in tools/reshard_smoke.py)."""
        points, owners, version = self._state
        return {
            "count": self.count,
            "vnodes": self.vnodes,
            "overlap": self.overlap,
            "assignments": list(owners),
            "version": version,
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "HashRing":
        ring = cls(
            int(spec["count"]),
            int(spec.get("vnodes", 64)),
            float(spec.get("overlap", 0.0)),
            assignments=spec.get("assignments"),
        )
        points, owners, _ = ring._state
        ring._state = (points, owners, int(spec.get("version", 0)))
        return ring

    # -- moves (functional: each returns a DETACHED ring) ----------------

    def with_moves(self, moves) -> "HashRing":
        """New ring with tokens reassigned: ``moves`` is ``[(token_idx,
        new_shard), ...]`` over the sorted token order."""
        points, owners, version = self._state
        new_owners = list(owners)
        for idx, shard in moves:
            if not (0 <= idx < len(points)):
                raise ValueError(f"token index {idx} out of range")
            if not (0 <= shard < self.count):
                raise ValueError(f"shard {shard} not in [0, {self.count})")
            new_owners[idx] = int(shard)
        ring = HashRing.__new__(HashRing)
        ring.count, ring.vnodes, ring.overlap = (
            self.count, self.vnodes, self.overlap,
        )
        ring._state = (points, tuple(new_owners), version + 1)
        return ring

    def split(self, shard: int, into: int) -> "HashRing":
        """Hand every other of ``shard``'s tokens to ``into`` — the
        classic hot-shard split (both indices must already exist; a
        COUNT change is a plane reconfigure, not a move)."""
        points, owners, _ = self._state
        mine = [i for i, s in enumerate(owners) if s == shard]
        return self.with_moves([(i, into) for i in mine[1::2]])

    def merge(self, src: int, dst: int) -> "HashRing":
        """Hand ALL of ``src``'s tokens to ``dst`` (drain a shard)."""
        points, owners, _ = self._state
        return self.with_moves(
            [(i, dst) for i, s in enumerate(owners) if s == src]
        )

    def moved_arcs(self, other: "HashRing"):
        """Half-open arcs ``(lo, hi]`` (lo > hi wraps) where the
        (primary, next-distinct) observation fingerprint differs
        between this ring and ``other`` — the ONLY hash positions whose
        owners can change, so a reshard touches just the names inside
        them. A token owns the arc ENDING at it (first token clockwise
        of the key), so each segment between adjacent boundaries is
        evaluated at its upper end."""
        pa, oa, _ = self._state
        pb, ob, _ = other._state
        boundaries = sorted(set(pa) | set(pb))
        arcs: list[tuple[int, int]] = []
        n = len(boundaries)
        for i, lo in enumerate(boundaries):
            hi = boundaries[(i + 1) % n]
            if self._pair_at(pa, oa, hi) != other._pair_at(pb, ob, hi):
                # merge with the previous arc when contiguous
                if arcs and arcs[-1][1] == lo:
                    arcs[-1] = (arcs[-1][0], hi)
                else:
                    arcs.append((lo, hi))
        return arcs

    def adopt(self, other: "HashRing") -> None:
        """Atomically swap this live ring's state for ``other``'s (the
        commit step of ``ClusterState.reshard``; every ShardSpec /
        ShardView holding this object re-reads the new ownership on
        its next query)."""
        if other.count != self.count:
            raise ValueError(
                f"adopt cannot change the shard count "
                f"({self.count} -> {other.count})"
            )
        self._state = other._state

    def load_shares(self) -> list[float]:
        """Fraction of the 32-bit keyspace each shard owns (arc-length
        weighted) — the skew signal the rebalancer reacts to."""
        points, owners, _ = self._state
        shares = [0.0] * self.count
        n = len(points)
        for i, p in enumerate(points):
            prev = points[i - 1] if i else points[-1] - _RING_SPACE
            shares[owners[i]] += (p - prev) / _RING_SPACE
        return shares


class RingRebalancer:
    """Reacts to node churn and hot-shard skew: given a per-shard load
    signal (node counts, dirty rates, bind rates — anything additive),
    proposes token moves from the most- to the least-loaded shard until
    the max/mean ratio drops under ``1 + skew`` or ``max_moves`` tokens
    have moved. Returns a detached ring for ``ClusterState.reshard``,
    or None when the plane is already balanced."""

    def __init__(self, skew: float = 0.25, max_moves: int = 8):
        if skew <= 0:
            raise ValueError(f"skew must be > 0, got {skew}")
        self.skew = float(skew)
        self.max_moves = int(max_moves)

    def plan(self, ring: HashRing, load) -> HashRing | None:
        count = ring.count
        loads = [float(load.get(s, 0.0)) for s in range(count)] \
            if hasattr(load, "get") else [float(x) for x in load]
        if len(loads) != count:
            raise ValueError(f"{len(loads)} loads for {count} shards")
        total = sum(loads)
        if total <= 0 or count < 2:
            return None
        mean = total / count
        points, owners = ring.tokens()
        owners = list(owners)
        # per-token load estimate: the owner's measured load distributed
        # by ARC share, not split evenly — crc token spacing is
        # exponential, so the uniform estimate picks half-ring arcs and
        # overshoots the cold shard past the hot one
        arc = [0.0] * len(points)
        for i, p in enumerate(points):
            prev = points[i - 1] if i else points[-1] - _RING_SPACE
            arc[i] = (p - prev) / _RING_SPACE
        shard_arc = [0.0] * count
        for i, s in enumerate(owners):
            shard_arc[s] += arc[i]
        moves: list[tuple[int, int]] = []
        for _ in range(self.max_moves):
            hot = max(range(count), key=lambda s: loads[s])
            cold = min(range(count), key=lambda s: loads[s])
            if loads[hot] <= mean * (1.0 + self.skew):
                break
            hot_tokens = [i for i, s in enumerate(owners) if s == hot]
            if len(hot_tokens) <= 1:
                break  # never strand a shard with zero tokens

            def tok_load(i):
                if shard_arc[hot] <= 0:
                    return loads[hot] / len(hot_tokens)
                return loads[hot] * arc[i] / shard_arc[hot]

            # the ideal transfer closes both gaps at once; take the
            # token nearest it (ties: lowest index, deterministic)
            want = min(loads[hot] - mean, mean - loads[cold])
            token = min(
                hot_tokens, key=lambda i: (abs(tok_load(i) - want), i))
            delta = tok_load(token)
            if max(loads[hot] - delta, loads[cold] + delta) >= loads[hot]:
                break  # best available move no longer shrinks the spread
            owners[token] = cold
            loads[hot] -= delta
            loads[cold] += delta
            shard_arc[hot] -= arc[token]
            shard_arc[cold] += arc[token]
            moves.append((token, cold))
        if not moves:
            return None
        return ring.with_moves(moves)
