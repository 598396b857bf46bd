"""Columnar LIST decode: the read-side page decoder of the kube mirror.

Copy of the pure-Python twin in ``crane_scheduler_tpu/native/listdecode.py``
(``DecodedPage``, ``_classify_node``, ``_classify_pod``, ``_decode_python``,
``decode_list_page``). A kube LIST page carries thousands of node/pod JSON
objects of which the client consumes a handful of string fields
(``node_from_json`` / ``pod_from_json``). ``decode_list_page`` parses the
page once and lays the plain-string shape out as columns: names,
annotation/label key-value pairs, addresses/ownerReferences. Items outside
that shape (non-string annotation values, lone surrogates, containers on a
pod, allocatable on a node) are flagged and keep their parsed object, so the
result is identical per entry to the per-object path on every input.

This module has one route, the Python twin. ``ROADMAP.md`` Queue 1 item 8.4
adds the native decoders of the committed C++ library here (the columnar
scanner and the object builder with resourceVersion reuse) and the watch-line
decoder beside them.

String layout: entry 0 = list resourceVersion, entry 1 = the ``continue``
token, then per fast-path item:

- nodes: name, anno k/v pairs, label k/v pairs, address type/address pairs
  (pair counts per item in ``counts[i] = (anno, label, addr)``);
- pods: name, namespace, nodeName, anno k/v pairs, ownerReference kind/name
  pairs (``counts[i] = (anno, owner)``).

Fallback items emit no strings and decode from their retained object.
"""

from __future__ import annotations

import json

import numpy as np

NODE_KIND = 0
POD_KIND = 1

_SURROGATE_LO = 0xD800
_SURROGATE_HI = 0xDFFF


def _has_lone_surrogate(s: str) -> bool:
    """json.loads keeps lone ``\\uD800``-style escapes as surrogate code
    points, which UTF-8 cannot round-trip: such items take the fallback."""
    return any(_SURROGATE_LO <= ord(ch) <= _SURROGATE_HI for ch in s)


class DecodedPage:
    """One decoded LIST page: columnar strings + per-item structure."""

    __slots__ = ("kind", "n", "strings", "flags", "counts", "rv", "cont",
                 "backend", "_objs")

    def __init__(self, kind, n, strings, flags, counts, rv, cont, backend,
                 objs=None):
        self.kind = kind
        self.n = n
        self.strings = strings
        self.flags = flags
        self.counts = counts
        self.rv = rv
        self.cont = cont
        self.backend = backend
        self._objs = objs

    @property
    def fallback_rows(self) -> list[int]:
        return np.nonzero(self.flags & 1)[0].tolist()

    def _string_bases(self) -> np.ndarray:
        """Index of each item's first string in ``strings`` (fast items
        consume a fixed header plus two entries per pair; fallback items
        consume none)."""
        fixed = 1 if self.kind == NODE_KIND else 3
        per_item = np.where(self.flags & 1, 0, fixed + 2 * self.counts.sum(axis=1))
        bases = np.empty(self.n + 1, dtype=np.int64)
        bases[0] = 2  # entries 0/1 are the list rv + continue token
        np.cumsum(per_item, out=bases[1:])
        bases[1:] += 2
        return bases

    def materialize(self) -> list:
        """Real ``Node``/``Pod`` objects, identical per entry to
        ``node_from_json``/``pod_from_json`` over ``json.loads`` of the
        same page."""
        from ..cluster.kube_wire import node_from_json, pod_from_json
        from ..cluster.state import Node, NodeAddress, OwnerReference, Pod

        strings = self.strings
        counts = self.counts
        flags = self.flags
        bases = self._string_bases().tolist()
        out = []
        if self.kind == NODE_KIND:
            for i in range(self.n):
                if flags[i] & 1:
                    out.append(node_from_json(self._objs[i]))
                    continue
                base = bases[i]
                an, ln, addr_n = counts[i]
                p = base + 1
                anno = dict(zip(strings[p:p + 2 * an:2], strings[p + 1:p + 2 * an:2]))
                p += 2 * an
                labels = dict(zip(strings[p:p + 2 * ln:2], strings[p + 1:p + 2 * ln:2]))
                p += 2 * ln
                addrs = tuple(
                    NodeAddress(strings[p + 2 * j], strings[p + 2 * j + 1])
                    for j in range(addr_n)
                )
                # raw construction: field-identical to Node(...) without the
                # frozen-dataclass __init__ (allocatable keeps its class
                # default, the empty map the fast path implies)
                node = object.__new__(Node)
                node.__dict__.update(name=strings[base], annotations=anno,
                                     labels=labels, addresses=addrs)
                out.append(node)
            return out
        for i in range(self.n):
            if flags[i] & 1:
                out.append(pod_from_json(self._objs[i]))
                continue
            base = bases[i]
            an, on = counts[i]
            p = base + 3
            anno = dict(zip(strings[p:p + 2 * an:2], strings[p + 1:p + 2 * an:2]))
            p += 2 * an
            owners = tuple(
                OwnerReference(kind=strings[p + 2 * j], name=strings[p + 2 * j + 1])
                for j in range(on)
            )
            pod = object.__new__(Pod)
            pod.__dict__.update(name=strings[base], namespace=strings[base + 1],
                                annotations=anno, owner_references=owners,
                                containers=(), node_name=strings[base + 2])
            out.append(pod)
        return out

    def node_annotation_columns(self):
        """Flat annotation columns for ``NodeLoadStore``'s columnar
        ingest: ``(names, keys, values, offsets)`` where row ``i`` owns
        ``keys[offsets[i]:offsets[i+1]]``, with no per-node dict for
        fast-path items."""
        if self.kind != NODE_KIND:
            raise ValueError("annotation columns are a node-page view")
        strings = self.strings
        counts = self.counts
        flags = self.flags
        bases = self._string_bases().tolist()
        names: list[str] = []
        keys: list[str] = []
        values: list[str] = []
        offsets = np.zeros(self.n + 1, dtype=np.int64)
        for i in range(self.n):
            if flags[i] & 1:
                meta = self._objs[i].get("metadata", {})
                names.append(meta.get("name", ""))
                for k, v in (meta.get("annotations") or {}).items():
                    keys.append(k)
                    values.append(v)
            else:
                base = bases[i]
                an = int(counts[i, 0])
                names.append(strings[base])
                keys.extend(strings[base + 1:base + 1 + 2 * an:2])
                values.extend(strings[base + 2:base + 1 + 2 * an:2])
            offsets[i + 1] = len(keys)
        return names, keys, values, offsets


def _all_str(d: dict) -> bool:
    return all(
        isinstance(v, str) and not _has_lone_surrogate(v)
        for kv in d.items() for v in kv
    )


def _classify_node(obj):
    """Fast-path columns for one node object, or None => fallback (the
    reference native scanner's rules)."""
    if not isinstance(obj, dict):
        return None
    meta = obj.get("metadata", {})
    status = obj.get("status", {})
    if not isinstance(meta, dict) or not isinstance(status, dict):
        return None
    name = meta.get("name", "")
    if not isinstance(name, str) or _has_lone_surrogate(name):
        return None
    anno = meta.get("annotations")
    labels = meta.get("labels")
    if anno is not None and not (isinstance(anno, dict) and _all_str(anno)):
        return None
    if labels is not None and not (isinstance(labels, dict) and _all_str(labels)):
        return None
    if status.get("allocatable"):
        # allocatable quantities are resource maps the string layout
        # cannot hold: per-object path
        return None
    addrs = status.get("addresses")
    pairs: list[str] = []
    if addrs is not None:
        if not isinstance(addrs, list):
            return None
        for a in addrs:
            if not isinstance(a, dict):
                return None
            t = a.get("type", "")
            ad = a.get("address", "")
            if not (isinstance(t, str) and isinstance(ad, str)):
                return None
            if _has_lone_surrogate(t) or _has_lone_surrogate(ad):
                return None
            pairs.extend((t, ad))
    strings = [name]
    anno = anno or {}
    labels = labels or {}
    for k, v in anno.items():
        strings.extend((k, v))
    for k, v in labels.items():
        strings.extend((k, v))
    strings.extend(pairs)
    return strings, (len(anno), len(labels), len(pairs) // 2)


def _classify_pod(obj):
    if not isinstance(obj, dict):
        return None
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    if not isinstance(meta, dict) or not isinstance(spec, dict):
        return None
    name = meta.get("name", "")
    ns = meta.get("namespace", "default")
    if not isinstance(name, str) or not isinstance(ns, str):
        return None
    if _has_lone_surrogate(name) or _has_lone_surrogate(ns):
        return None
    anno = meta.get("annotations")
    if anno is not None and not (isinstance(anno, dict) and _all_str(anno)):
        return None
    owners = meta.get("ownerReferences")
    pairs: list[str] = []
    if owners is not None:
        if not isinstance(owners, list):
            return None
        for r in owners:
            if not isinstance(r, dict):
                return None
            k = r.get("kind", "")
            n = r.get("name", "")
            if not (isinstance(k, str) and isinstance(n, str)):
                return None
            if _has_lone_surrogate(k) or _has_lone_surrogate(n):
                return None
            pairs.extend((k, n))
    node_name = spec.get("nodeName", "")
    if node_name is None:
        node_name = ""
    if not isinstance(node_name, str) or _has_lone_surrogate(node_name):
        return None
    if spec.get("containers") or spec.get("initContainers") or spec.get("overhead"):
        return None  # nested resource maps: always the per-object path
    strings = [name, ns, node_name]
    anno = anno or {}
    for k, v in anno.items():
        strings.extend((k, v))
    strings.extend(pairs)
    return strings, (len(anno), len(pairs) // 2)


def _decode_python(body, kind: int) -> DecodedPage:
    payload = json.loads(body)
    meta = payload.get("metadata", {}) or {}
    rv = meta.get("resourceVersion") or None
    cont = meta.get("continue") or None
    items = payload.get("items") or []
    groups = 3 if kind == NODE_KIND else 2
    classify = _classify_node if kind == NODE_KIND else _classify_pod
    n = len(items)
    strings: list[str] = [
        rv if isinstance(rv, str) else "",
        cont if isinstance(cont, str) else "",
    ]
    flags = np.zeros(n, dtype=np.uint8)
    counts = np.zeros((n, groups), dtype=np.int64)
    objs: dict[int, dict] = {}
    for i, obj in enumerate(items):
        fast = classify(obj)
        if fast is None:
            flags[i] = 1
            objs[i] = obj
            continue
        s, c = fast
        strings.extend(s)
        counts[i] = c
    return DecodedPage(kind, n, strings, flags, counts, rv, cont, "python", objs=objs)


def decode_list_page(body, kind: int) -> DecodedPage:
    """Decode one LIST page's bytes (or str) through the Python twin. A
    malformed body raises the ``json.loads`` error the object path
    would raise."""
    if isinstance(body, str):
        body = body.encode("utf-8")
    return _decode_python(body, kind)
