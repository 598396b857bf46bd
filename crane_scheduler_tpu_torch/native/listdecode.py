"""Columnar LIST decode: the read-side page decoders of the kube mirror.

Copy of ``crane_scheduler_tpu/native/listdecode.py``. A kube LIST page
carries thousands of node/pod JSON objects of which the client consumes a
handful of string fields (``node_from_json`` / ``pod_from_json``).
``decode_list_page`` scans each page once, by one of three routes:

- the CPython-API object decoder (``_decode_pylist``,
  ``csrc/crane_pylist.cpp``), which builds the final ``Node``/``Pod``
  instances in C and, given ``known_rvs``, returns a bare name (a reuse
  marker) for a node whose resourceVersion the caller already holds;
- the ctypes columnar scanner (``_decode_native``, ``crane_list_decode`` in
  ``csrc/crane_native.cpp``);
- the Python twin (``_decode_python``).

The production route is the object decoder where this interpreter's
``Python.h`` exists (``python_headers_present``), else the scanner; the
twin takes only a page that decoder declines (returns None): a malformed
page, or one over the scanner's capacity, where the twin's ``json.loads``
raises the error the per-object path would raise. (The reference tries
the scanner after the object decoder too; no page that the object
decoder declines passes the scanner, which shares its parser.) Items
outside the plain-string shape (non-string annotation values, lone
surrogates, containers on a pod, allocatable on a node) are flagged and
decode through the ordinary per-object path, so every route is identical
per entry to ``node_from_json``/``pod_from_json`` over ``json.loads`` of
the same page. ``decode_watch_lines`` decodes a drained batch of watch lines
the same way.

Columnar string layout: entry 0 = list resourceVersion, entry 1 = the
``continue`` token, then per fast-path item:

- nodes: name, anno k/v pairs, label k/v pairs, address type/address pairs
  (pair counts per item in ``counts[i] = (anno, label, addr)``);
- pods: name, namespace, nodeName, anno k/v pairs, ownerReference kind/name
  pairs (``counts[i] = (anno, owner)``).

Fallback items emit no strings and decode from their recorded byte span
(scanner) or retained parsed object (twin).
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

from .lib import load_native, load_pylist, python_headers_present

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
                 "backend", "_body", "_spans", "_objs")

    def __init__(self, kind, n, strings, flags, counts, rv, cont, backend,
                 body=None, spans=None, objs=None):
        self.kind = kind
        self.n = n
        self.strings = strings
        self.flags = flags
        self.counts = counts
        self.rv = rv
        self.cont = cont
        self.backend = backend
        self._body = body
        self._spans = spans
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

    def _fallback_obj(self, row: int) -> dict:
        if self._objs is not None:
            return self._objs[row]
        a, b = int(self._spans[row, 0]), int(self._spans[row, 1])
        return json.loads(self._body[a:b])

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
                    out.append(node_from_json(self._fallback_obj(i)))
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
                out.append(pod_from_json(self._fallback_obj(i)))
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
                meta = self._fallback_obj(i).get("metadata", {})
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


def _decode_native(body: bytes, kind: int) -> DecodedPage | None:
    """The ctypes columnar scanner; None for a malformed or over-capacity
    page."""
    lib = load_native()
    n = len(body)
    item_cap = body.count(b"{") + 1
    # every fast-path string but the per-item defaults maps to a quoted
    # input string; the +4/item covers name/namespace/nodeName/rv slots
    # emitted for absent fields
    str_cap = body.count(b'"') // 2 + 4 * item_cap + 4
    sb_cap = n + 8 * item_cap + 1
    str_buf = ctypes.create_string_buffer(sb_cap)
    s_start = np.empty(str_cap, dtype=np.int64)
    s_end = np.empty(str_cap, dtype=np.int64)
    item_start = np.empty(item_cap, dtype=np.int64)
    item_end = np.empty(item_cap, dtype=np.int64)
    flags = np.empty(item_cap, dtype=np.uint8)
    groups = 3 if kind == NODE_KIND else 2
    counts = np.empty(item_cap * groups, dtype=np.int64)
    n_str = np.zeros(1, dtype=np.int64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    n_items = lib.crane_list_decode(
        body, n, kind,
        str_buf, sb_cap,
        s_start.ctypes.data_as(p_i64), s_end.ctypes.data_as(p_i64), str_cap,
        item_start.ctypes.data_as(p_i64), item_end.ctypes.data_as(p_i64),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts.ctypes.data_as(p_i64), item_cap,
        n_str.ctypes.data_as(p_i64),
    )
    if n_items < 0:
        return None  # malformed / capacity: the twin's json.loads decides
    ns = int(n_str[0])
    ends = s_end[:ns]
    used = int(ends.max()) if ns else 0
    blob = str_buf.raw[:used]
    sl, el = s_start[:ns].tolist(), ends.tolist()
    text = blob.decode("utf-8")  # the scanner emits UTF-8
    if len(text) == used:
        # pure-ASCII buffer: byte offsets are char offsets, slice once
        strings = [text[a:b] if a >= 0 else "default" for a, b in zip(sl, el)]
    else:
        strings = [blob[a:b].decode("utf-8") if a >= 0 else "default"
                   for a, b in zip(sl, el)]
    spans = np.stack([item_start[:n_items], item_end[:n_items]], axis=1)
    return DecodedPage(
        kind, int(n_items), strings, flags[:n_items],
        counts[: n_items * groups].reshape(n_items, groups),
        strings[0] or None, strings[1] or None, "native", body=body, spans=spans,
    )


class ObjectPage:
    """One decoded LIST page as final objects: the CPython-API decoder
    builds the ``Node``/``Pod`` instances in C, so ``materialize`` only
    re-decodes the flagged fallback rows through the per-object path. Rows
    whose resourceVersion matched the caller's ``known_rvs`` come back as
    bare name strings (reuse markers): the caller substitutes its existing
    instances (``KubeClusterClient._relist_nodes`` does). Its public
    surface is ``DecodedPage``'s where consumers share code."""

    __slots__ = ("kind", "n", "rv", "cont", "rvs", "backend", "_objects",
                 "_fallbacks", "_reused", "_body", "_materialized")

    def __init__(self, kind, body, rv, cont, objects, rvs, fallbacks, reused=()):
        self.kind = kind
        self.n = len(objects)
        self.rv = rv
        self.cont = cont
        self.rvs = rvs  # per-row resourceVersion (None: absent or marker)
        self.backend = "pylist"
        self._objects = objects
        self._fallbacks = fallbacks  # (row, start, end) byte spans
        self._reused = reused  # (row, start, end) spans of marker rows
        self._body = body
        self._materialized = False

    @property
    def fallback_rows(self) -> list[int]:
        return [row for row, _, _ in self._fallbacks]

    def reused_span(self, row: int):
        """The byte span of marker row ``row`` (to rebuild it when the
        caller no longer holds the instance), or None."""
        for r, a, b in self._reused:
            if r == row:
                return self._body[a:b]
        return None

    def materialize(self) -> list:
        if not self._materialized:
            from ..cluster.kube_wire import node_from_json, pod_from_json

            loader = node_from_json if self.kind == NODE_KIND else pod_from_json
            for row, a, b in self._fallbacks:
                self._objects[row] = loader(json.loads(self._body[a:b]))
            self._materialized = True
        return self._objects

    def node_annotation_columns(self):
        if self.kind != NODE_KIND:
            raise ValueError("annotation columns are a node-page view")
        names: list[str] = []
        keys: list[str] = []
        values: list[str] = []
        offsets = np.zeros(self.n + 1, dtype=np.int64)
        for i, node in enumerate(self.materialize()):
            names.append(node.name)
            for k, v in node.annotations.items():
                keys.append(k)
                values.append(v)
            offsets[i + 1] = len(keys)
        return names, keys, values, offsets


def _model_classes():
    from ..cluster.state import Node, NodeAddress, OwnerReference, Pod

    return Node, NodeAddress, Pod, OwnerReference


def _decode_pylist(body: bytes, kind: int, known_rvs: dict | None = None) -> ObjectPage | None:
    """The CPython-API object decoder; None for a malformed page."""
    lib = load_pylist()
    res = lib.crane_pylist_decode(body, len(body), kind, *_model_classes(), known_rvs)
    if res is None:
        return None  # malformed: the twin's json.loads raises properly
    rv, cont, objects, rvs, fallbacks, reused = res
    return ObjectPage(kind, body, rv, cont, objects, rvs, fallbacks, reused)


def decode_watch_lines(buf: bytes, kind: int):
    """Parse a drained batch of newline-delimited watch lines in one
    CPython-API call: ``(types, objects, rvs, fallbacks)`` where
    ``objects[i]`` is the final Node/Pod (None for BOOKMARK and fallback
    lines), ``rvs[i]`` the line's resourceVersion string or None, and
    ``fallbacks`` the ``(idx, start, end)`` byte spans the caller must
    re-decode with ``json.loads`` (ERROR lines included: their Status
    payload is read by the consumer). Returns None for a malformed batch;
    the caller's per-line path then raises the identical error."""
    lib = load_pylist()
    return lib.crane_pylist_decode_watch(buf, len(buf), kind, *_model_classes())


def decode_list_page(body, kind: int, native=None, known_rvs=None):
    """Decode one LIST page's bytes (or str). ``native=None`` (the
    production path) takes the object decoder where ``Python.h`` exists,
    else the columnar scanner, and the Python twin for a page that decoder
    declines: the twin's ``json.loads`` then raises the error the object
    path would raise. ``native="pylist"`` forces the object decoder,
    ``True`` the scanner, ``False`` the twin; the forced native forms
    return None where that decoder declines the input. ``known_rvs``
    (object decoder only) turns on resourceVersion instance reuse
    (``ObjectPage``)."""
    if isinstance(body, str):
        body = body.encode("utf-8")
    if native is None:
        if python_headers_present():
            page = _decode_pylist(body, kind, known_rvs)
        else:
            page = _decode_native(body, kind)
        return page if page is not None else _decode_python(body, kind)
    if native == "pylist":
        return _decode_pylist(body, kind, known_rvs)
    if native:
        return _decode_native(body, kind)
    return _decode_python(body, kind)
