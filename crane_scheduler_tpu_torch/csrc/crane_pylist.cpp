// Copy of native/crane_pylist.cpp (the JAX package's host library), built by
// crane_scheduler_tpu_torch/native/lib.py. The port keeps its own copy.

// crane_pylist: CPython-API LIST decoder — the scanner from listscan.h
// driving DIRECT construction of the mirror's Python objects.
//
// The ctypes columnar decoder (crane_list_decode) still pays Python-level
// assembly: slicing ~27 strings per node out of the string buffer and
// packing them into dicts costs more than json.loads' optimized C object
// builder, so the scan win was being given back. This decoder builds the
// final per-item objects IN C — name/annotation/label strings via
// PyUnicode_DecodeUTF8 straight off the unescape buffer, dicts via
// PyDict_SetItem, and the frozen-dataclass instances (Node, NodeAddress,
// Pod, OwnerReference) via object.__new__ + installing a prebuilt
// instance __dict__ (bitwise what `object.__new__(cls)` +
// `inst.__dict__.update(...)` does from Python, minus the interpreter).
//
// Exactness contract: identical to crane_list_decode — items outside the
// plain-string shape build as None and are re-decoded by the caller from
// their byte span through the ordinary per-object path, so the combined
// result is bit-identical to node_from_json/pod_from_json on every
// input; malformed JSON returns Py_None and the caller falls back
// wholesale.
//
// Must be loaded with ctypes.PyDLL (the GIL stays held: every call here
// runs CPython API). Built separately from libcrane_native.so so the
// core library keeps building on hosts without Python headers.

#include <Python.h>

#include "listscan.h"

using namespace listdec;

namespace {

struct Keys {
  PyObject* name;
  PyObject* annotations;
  PyObject* labels;
  PyObject* addresses;
  PyObject* ns;  // "namespace"
  PyObject* owner_references;
  PyObject* containers;
  PyObject* node_name;
  PyObject* type;
  PyObject* address;
  PyObject* kind;
  PyObject* default_ns;  // the "default" value
  PyObject* empty_tuple;
  // common watch change types, interned once
  PyObject* t_added;
  PyObject* t_modified;
  PyObject* t_deleted;
  PyObject* t_bookmark;
  bool ready = false;
};

Keys g_keys;

bool init_keys() {
  if (g_keys.ready) return true;
  g_keys.name = PyUnicode_InternFromString("name");
  g_keys.annotations = PyUnicode_InternFromString("annotations");
  g_keys.labels = PyUnicode_InternFromString("labels");
  g_keys.addresses = PyUnicode_InternFromString("addresses");
  g_keys.ns = PyUnicode_InternFromString("namespace");
  g_keys.owner_references = PyUnicode_InternFromString("owner_references");
  g_keys.containers = PyUnicode_InternFromString("containers");
  g_keys.node_name = PyUnicode_InternFromString("node_name");
  g_keys.type = PyUnicode_InternFromString("type");
  g_keys.address = PyUnicode_InternFromString("address");
  g_keys.kind = PyUnicode_InternFromString("kind");
  g_keys.default_ns = PyUnicode_InternFromString("default");
  g_keys.empty_tuple = PyTuple_New(0);
  g_keys.t_added = PyUnicode_InternFromString("ADDED");
  g_keys.t_modified = PyUnicode_InternFromString("MODIFIED");
  g_keys.t_deleted = PyUnicode_InternFromString("DELETED");
  g_keys.t_bookmark = PyUnicode_InternFromString("BOOKMARK");
  g_keys.ready = g_keys.name && g_keys.annotations && g_keys.labels &&
                 g_keys.addresses && g_keys.ns && g_keys.owner_references &&
                 g_keys.containers && g_keys.node_name && g_keys.type &&
                 g_keys.address && g_keys.kind && g_keys.default_ns &&
                 g_keys.empty_tuple && g_keys.t_added && g_keys.t_modified &&
                 g_keys.t_deleted && g_keys.t_bookmark;
  return g_keys.ready;
}

PyObject* type_str(const Ctx& c, const Span& s) {
  const char* p = c.sb + s.a;
  const int64_t n = s.b - s.a;
  if (n == 5 && std::memcmp(p, "ADDED", 5) == 0) {
    Py_INCREF(g_keys.t_added);
    return g_keys.t_added;
  }
  if (n == 8 && std::memcmp(p, "MODIFIED", 8) == 0) {
    Py_INCREF(g_keys.t_modified);
    return g_keys.t_modified;
  }
  if (n == 7 && std::memcmp(p, "DELETED", 7) == 0) {
    Py_INCREF(g_keys.t_deleted);
    return g_keys.t_deleted;
  }
  if (n == 8 && std::memcmp(p, "BOOKMARK", 8) == 0) {
    Py_INCREF(g_keys.t_bookmark);
    return g_keys.t_bookmark;
  }
  return PyUnicode_DecodeUTF8(p, static_cast<Py_ssize_t>(n), nullptr);
}

PyObject* span_str(const Ctx& c, const Span& s) {
  return PyUnicode_DecodeUTF8(c.sb + s.a,
                              static_cast<Py_ssize_t>(s.b - s.a), nullptr);
}

// dict from interleaved (key, value) spans; json.loads' last-wins
// duplicate semantics fall out of PyDict_SetItem order.
PyObject* pairs_dict(const Ctx& c, const std::vector<Span>& pairs) {
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  for (size_t j = 0; j + 1 < pairs.size(); j += 2) {
    PyObject* k = span_str(c, pairs[j]);
    PyObject* v = span_str(c, pairs[j + 1]);
    const int rc = (k && v) ? PyDict_SetItem(d, k, v) : -1;
    Py_XDECREF(k);
    Py_XDECREF(v);
    if (rc < 0) {
      Py_DECREF(d);
      return nullptr;
    }
  }
  return d;
}

// object.__new__(cls) with `dict` (reference STOLEN) installed as the
// instance __dict__ — how the Python hot paths build frozen dataclass
// instances, done natively.
PyObject* new_instance(PyObject* cls, PyObject* dict) {
  PyTypeObject* tp = reinterpret_cast<PyTypeObject*>(cls);
  PyObject* inst = tp->tp_new(tp, g_keys.empty_tuple, nullptr);
  if (!inst) {
    Py_DECREF(dict);
    return nullptr;
  }
  PyObject** dictptr = _PyObject_GetDictPtr(inst);
  if (!dictptr) {
    Py_DECREF(dict);
    Py_DECREF(inst);
    PyErr_SetString(PyExc_TypeError, "class has no instance dict");
    return nullptr;
  }
  Py_XDECREF(*dictptr);
  *dictptr = dict;
  return inst;
}

// tuple of two-field dataclass instances (NodeAddress / OwnerReference)
PyObject* two_field_tuple(const Ctx& c, const std::vector<Span>& pairs,
                          PyObject* cls, PyObject* key0, PyObject* key1) {
  const Py_ssize_t n = static_cast<Py_ssize_t>(pairs.size() / 2);
  PyObject* out = PyTuple_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t j = 0; j < n; ++j) {
    PyObject* d = PyDict_New();
    if (!d) {
      Py_DECREF(out);
      return nullptr;
    }
    PyObject* v0 = span_str(c, pairs[2 * j]);
    PyObject* v1 = span_str(c, pairs[2 * j + 1]);
    int rc = (v0 && v1 && PyDict_SetItem(d, key0, v0) == 0 &&
              PyDict_SetItem(d, key1, v1) == 0)
                 ? 0
                 : -1;
    Py_XDECREF(v0);
    Py_XDECREF(v1);
    if (rc < 0) {
      Py_DECREF(d);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject* inst = new_instance(cls, d);  // steals d
    if (!inst) {
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, j, inst);
  }
  return out;
}

PyObject* build_node(const Ctx& c, const ItemOut& item, PyObject* node_cls,
                     PyObject* addr_cls) {
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  PyObject* name = span_str(c, item.name);
  PyObject* anno = pairs_dict(c, item.annos);
  PyObject* labels = pairs_dict(c, item.labels);
  PyObject* addrs =
      two_field_tuple(c, item.addrs, addr_cls, g_keys.type, g_keys.address);
  int rc = (name && anno && labels && addrs &&
            PyDict_SetItem(d, g_keys.name, name) == 0 &&
            PyDict_SetItem(d, g_keys.annotations, anno) == 0 &&
            PyDict_SetItem(d, g_keys.labels, labels) == 0 &&
            PyDict_SetItem(d, g_keys.addresses, addrs) == 0)
               ? 0
               : -1;
  Py_XDECREF(name);
  Py_XDECREF(anno);
  Py_XDECREF(labels);
  Py_XDECREF(addrs);
  if (rc < 0) {
    Py_DECREF(d);
    return nullptr;
  }
  return new_instance(node_cls, d);  // steals d
}

PyObject* build_pod(const Ctx& c, const ItemOut& item, PyObject* pod_cls,
                    PyObject* owner_cls) {
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  PyObject* name = span_str(c, item.name);
  PyObject* ns;
  if (item.ns.a == kNsDefault) {
    ns = g_keys.default_ns;
    Py_INCREF(ns);
  } else {
    ns = span_str(c, item.ns);
  }
  PyObject* node_name = span_str(c, item.node_name);
  PyObject* anno = pairs_dict(c, item.annos);
  PyObject* owners =
      two_field_tuple(c, item.addrs, owner_cls, g_keys.kind, g_keys.name);
  int rc = (name && ns && node_name && anno && owners &&
            PyDict_SetItem(d, g_keys.name, name) == 0 &&
            PyDict_SetItem(d, g_keys.ns, ns) == 0 &&
            PyDict_SetItem(d, g_keys.annotations, anno) == 0 &&
            PyDict_SetItem(d, g_keys.owner_references, owners) == 0 &&
            PyDict_SetItem(d, g_keys.containers, g_keys.empty_tuple) == 0 &&
            PyDict_SetItem(d, g_keys.node_name, node_name) == 0)
               ? 0
               : -1;
  Py_XDECREF(name);
  Py_XDECREF(ns);
  Py_XDECREF(node_name);
  Py_XDECREF(anno);
  Py_XDECREF(owners);
  if (rc < 0) {
    Py_DECREF(d);
    return nullptr;
  }
  return new_instance(pod_cls, d);  // steals d
}

}  // namespace

extern "C" {

// Decode one LIST page into final Python objects. Returns a NEW
// reference to (rv_or_None, continue_or_None, objects_list, rvs_list,
// fallback_list) where objects_list[i] is the built Node/Pod, the bare
// NAME string (reuse marker — see below), or None for fallback rows;
// rvs_list[i] is the item's metadata.resourceVersion (None when absent
// or the row is a marker/fallback); fallback_list holds (idx, start,
// end) byte spans for the caller to re-decode. Returns Py_None for
// malformed input (wholesale fallback); NULL with an exception set on
// allocation failure.
//
// known_rvs (a dict name -> resourceVersion, or None) enables
// rv-based object reuse: an item whose rv EQUALS the caller's known rv
// is unchanged by the apiserver's own contract (every object change
// bumps its resourceVersion — the invariant client-go's informers are
// built on), so no object is constructed; the bare name comes back and
// the caller keeps its existing instance. A steady-state 50k-node
// relist then allocates 50k name strings instead of ~1.4M objects.
PyObject* crane_pylist_decode(const char* buf, int64_t len, int32_t kind,
                              PyObject* node_cls, PyObject* addr_cls,
                              PyObject* pod_cls, PyObject* owner_cls,
                              PyObject* known_rvs) {
  if (!init_keys()) return nullptr;
  std::vector<char> sb(static_cast<size_t>(len > 0 ? len : 1));
  Ctx c;
  c.base = buf;
  c.p = buf;
  c.e = buf + len;
  c.sb = sb.data();
  c.sb_pos = 0;
  c.sb_cap = len;
  c.s_start = nullptr;
  c.s_end = nullptr;
  c.s_cap = 0;
  c.s_n = 0;
  c.malformed = false;

  PyObject* rv = Py_None;
  Py_INCREF(rv);
  PyObject* cont = Py_None;
  Py_INCREF(cont);
  PyObject* objects = PyList_New(0);
  PyObject* item_rvs = PyList_New(0);
  PyObject* fallbacks = PyList_New(0);
  PyObject* reused = PyList_New(0);
  ItemOut item;
  int64_t n_items = 0;

  auto fail = [&](bool malformed) -> PyObject* {
    Py_XDECREF(rv);
    Py_XDECREF(cont);
    Py_XDECREF(objects);
    Py_XDECREF(item_rvs);
    Py_XDECREF(fallbacks);
    Py_XDECREF(reused);
    if (malformed) Py_RETURN_NONE;
    return nullptr;  // exception already set
  };
  if (!objects || !item_rvs || !fallbacks || !reused) return fail(false);

  ws(c);
  if (c.p >= c.e || *c.p != '{') return fail(true);
  ++c.p;
  ws(c);
  bool done = c.p < c.e && *c.p == '}';
  if (done) ++c.p;
  while (!done) {
    ws(c);
    Span k;
    bool clean = true;
    if (!parse_string(c, &k, &clean)) return fail(true);
    ws(c);
    if (c.p >= c.e || *c.p != ':') return fail(true);
    ++c.p;
    if (key_eq(c, k, "metadata")) {
      ws(c);
      if (c.p >= c.e || *c.p != '{') {
        if (!skip_value(c, 0)) return fail(true);
      } else {
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == '}') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            Span mk;
            if (!parse_string(c, &mk, &clean)) return fail(true);
            ws(c);
            if (c.p >= c.e || *c.p != ':') return fail(true);
            ++c.p;
            ws(c);
            const bool is_rv = key_eq(c, mk, "resourceVersion");
            const bool is_cont = key_eq(c, mk, "continue");
            if ((is_rv || is_cont) && c.p < c.e && *c.p == '"') {
              Span v;
              if (!parse_string(c, &v, &clean)) return fail(true);
              PyObject* s = span_str(c, v);
              if (!s) return fail(false);
              if (is_rv) {
                Py_DECREF(rv);
                rv = s;
              } else {
                Py_DECREF(cont);
                cont = s;
              }
            } else if ((is_rv || is_cont) && is_null_ahead(c)) {
              c.p += 4;
            } else if (is_rv || is_cont) {
              return fail(true);  // non-string list metadata
            } else {
              if (!skip_value(c, 0)) return fail(true);
            }
            ws(c);
            if (c.p < c.e && *c.p == ',') {
              ++c.p;
              continue;
            }
            if (c.p < c.e && *c.p == '}') {
              ++c.p;
              break;
            }
            return fail(true);
          }
        }
      }
    } else if (key_eq(c, k, "items")) {
      ws(c);
      if (is_null_ahead(c)) {
        c.p += 4;
      } else {
        if (c.p >= c.e || *c.p != '[') return fail(true);
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == ']') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            const int64_t span_a = c.p - c.base;
            const int64_t sb_keep = c.sb_pos;
            item.reset();
            if (!parse_item(c, kind, &item)) return fail(true);
            const int64_t span_b = c.p - c.base;
            PyObject* obj = nullptr;
            PyObject* item_rv = nullptr;
            if (item.fb) {
              c.sb_pos = sb_keep;
              obj = Py_None;
              Py_INCREF(obj);
              PyObject* fb = Py_BuildValue("(LLL)",
                                           static_cast<long long>(n_items),
                                           static_cast<long long>(span_a),
                                           static_cast<long long>(span_b));
              if (!fb || PyList_Append(fallbacks, fb) < 0) {
                Py_XDECREF(fb);
                Py_DECREF(obj);
                return fail(false);
              }
              Py_DECREF(fb);
            } else {
              if (known_rvs != Py_None && item.rv_present && !item.rv_bad) {
                // rv-based reuse: unchanged rv == unchanged object
                PyObject* name_obj = span_str(c, item.name);
                if (!name_obj) return fail(false);
                PyObject* prev_rv = PyDict_GetItem(known_rvs, name_obj);
                if (prev_rv != nullptr && PyUnicode_Check(prev_rv)) {
                  Py_ssize_t plen;
                  const char* pdata =
                      PyUnicode_AsUTF8AndSize(prev_rv, &plen);
                  if (pdata != nullptr &&
                      plen == static_cast<Py_ssize_t>(
                                  item.rv.b - item.rv.a) &&
                      std::memcmp(pdata, c.sb + item.rv.a,
                                  static_cast<size_t>(plen)) == 0) {
                    obj = name_obj;  // marker: caller keeps its instance
                    PyObject* ru = Py_BuildValue(
                        "(LLL)", static_cast<long long>(n_items),
                        static_cast<long long>(span_a),
                        static_cast<long long>(span_b));
                    if (!ru || PyList_Append(reused, ru) < 0) {
                      Py_XDECREF(ru);
                      Py_DECREF(obj);
                      return fail(false);
                    }
                    Py_DECREF(ru);
                  }
                }
                if (obj == nullptr) Py_DECREF(name_obj);
                PyErr_Clear();  // a failed AsUTF8 must not leak out
              }
              if (obj == nullptr) {
                if (kind == 0) {
                  obj = build_node(c, item, node_cls, addr_cls);
                } else {
                  obj = build_pod(c, item, pod_cls, owner_cls);
                }
                if (obj != nullptr && item.rv_present && !item.rv_bad) {
                  item_rv = span_str(c, item.rv);
                  if (!item_rv) {
                    Py_DECREF(obj);
                    return fail(false);
                  }
                }
              }
            }
            if (!obj) return fail(false);
            if (item_rv == nullptr) {
              item_rv = Py_None;
              Py_INCREF(item_rv);
            }
            const bool append_ok = PyList_Append(objects, obj) == 0 &&
                                   PyList_Append(item_rvs, item_rv) == 0;
            Py_DECREF(obj);
            Py_DECREF(item_rv);
            if (!append_ok) return fail(false);
            ++n_items;
            ws(c);
            if (c.p < c.e && *c.p == ',') {
              ++c.p;
              continue;
            }
            if (c.p < c.e && *c.p == ']') {
              ++c.p;
              break;
            }
            return fail(true);
          }
        }
      }
    } else {
      if (!skip_value(c, 0)) return fail(true);
    }
    ws(c);
    if (c.p < c.e && *c.p == ',') {
      ++c.p;
      continue;
    }
    if (c.p < c.e && *c.p == '}') {
      ++c.p;
      break;
    }
    return fail(true);
  }
  if (c.malformed) return fail(true);
  PyObject* result =
      PyTuple_Pack(6, rv, cont, objects, item_rvs, fallbacks, reused);
  Py_DECREF(rv);
  Py_DECREF(cont);
  Py_DECREF(objects);
  Py_DECREF(item_rvs);
  Py_DECREF(fallbacks);
  Py_DECREF(reused);
  return result;
}

// Decode a batch of newline-delimited WATCH lines
// ('{"type": T, "object": {...}}' each) in one call — the coalesced
// watch apply's parse stage. Returns a NEW reference to
// (types_list, objects_list, rvs_list, fallback_list):
//   types_list[i]   — the change type string (interned for the common
//                     four), or None for fallback lines;
//   objects_list[i] — the built Node/Pod (None for BOOKMARK and
//                     fallback lines);
//   rvs_list[i]     — metadata.resourceVersion string or None;
//   fallback_list   — (idx, start, end) byte spans of lines the caller
//                     must re-decode with json.loads (ERROR lines,
//                     non-string rvs, items outside the fast shape).
// Returns Py_None when any line is structurally malformed (the caller
// re-runs the whole batch through the per-line path, which raises the
// identical error); NULL with an exception set on allocation failure.
PyObject* crane_pylist_decode_watch(const char* buf, int64_t len,
                                    int32_t kind, PyObject* node_cls,
                                    PyObject* addr_cls, PyObject* pod_cls,
                                    PyObject* owner_cls) {
  if (!init_keys()) return nullptr;
  std::vector<char> sb(static_cast<size_t>(len > 0 ? len : 1));
  Ctx c;
  c.base = buf;
  c.p = buf;
  c.e = buf + len;
  c.sb = sb.data();
  c.sb_pos = 0;
  c.sb_cap = len;
  c.s_start = nullptr;
  c.s_end = nullptr;
  c.s_cap = 0;
  c.s_n = 0;
  c.malformed = false;

  PyObject* types = PyList_New(0);
  PyObject* objects = PyList_New(0);
  PyObject* rvs = PyList_New(0);
  PyObject* fallbacks = PyList_New(0);
  ItemOut item;
  int64_t n_lines = 0;

  auto fail = [&](bool malformed) -> PyObject* {
    Py_XDECREF(types);
    Py_XDECREF(objects);
    Py_XDECREF(rvs);
    Py_XDECREF(fallbacks);
    if (malformed) Py_RETURN_NONE;
    return nullptr;
  };
  if (!types || !objects || !rvs || !fallbacks) return fail(false);

  auto append3 = [&](PyObject* t, PyObject* o, PyObject* r) -> bool {
    // steals all three references
    const bool ok = PyList_Append(types, t) == 0 &&
                    PyList_Append(objects, o) == 0 &&
                    PyList_Append(rvs, r) == 0;
    Py_DECREF(t);
    Py_DECREF(o);
    Py_DECREF(r);
    return ok;
  };

  while (true) {
    ws(c);
    if (c.p >= c.e) break;
    const int64_t line_a = c.p - c.base;
    if (*c.p != '{') return fail(true);
    ++c.p;
    Span type_span{0, 0};
    bool type_seen = false, type_bad = false, obj_seen = false;
    bool line_fb = false;
    item.reset();
    ws(c);
    if (c.p < c.e && *c.p == '}') {
      ++c.p;
    } else {
      while (true) {
        ws(c);
        Span k;
        bool clean = true;
        if (!parse_string(c, &k, &clean)) return fail(true);
        ws(c);
        if (c.p >= c.e || *c.p != ':') return fail(true);
        ++c.p;
        if (key_eq(c, k, "type")) {
          ws(c);
          if (type_seen) line_fb = true;  // duplicate key: last wins
          type_seen = true;
          if (c.p < c.e && *c.p == '"') {
            bool tclean = true;
            if (!parse_string(c, &type_span, &tclean)) return fail(true);
            if (!tclean) type_bad = true;
          } else {
            type_bad = true;  // non-string type: json path semantics
            if (!skip_value(c, 0)) return fail(true);
          }
        } else if (key_eq(c, k, "object")) {
          ws(c);
          if (obj_seen) line_fb = true;
          obj_seen = true;
          if (c.p < c.e && *c.p == '{') {
            if (!parse_item(c, kind, &item)) return fail(true);
          } else {
            line_fb = true;  // null/non-object: caller reproduces
            if (!skip_value(c, 0)) return fail(true);
          }
        } else {
          if (!skip_value(c, 0)) return fail(true);
        }
        ws(c);
        if (c.p < c.e && *c.p == ',') {
          ++c.p;
          continue;
        }
        if (c.p < c.e && *c.p == '}') {
          ++c.p;
          break;
        }
        return fail(true);
      }
    }
    // line must end cleanly (whitespace to newline/EOF); anything else
    // is the malformed-batch path
    while (c.p < c.e && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r'))
      ++c.p;
    if (c.p < c.e) {
      if (*c.p != '\n') return fail(true);
      ++c.p;
    }
    const int64_t line_b = c.p - c.base;
    const bool is_bookmark =
        type_seen && !type_bad &&
        (type_span.b - type_span.a) == 8 &&
        std::memcmp(c.sb + type_span.a, "BOOKMARK", 8) == 0;
    const bool is_error =
        type_seen && !type_bad &&
        (type_span.b - type_span.a) == 5 &&
        std::memcmp(c.sb + type_span.a, "ERROR", 5) == 0;
    if (line_fb || type_bad || !type_seen || is_error || item.rv_bad ||
        (!is_bookmark && item.fb)) {
      // ERROR lines carry a Status object (code etc.) the caller
      // inspects — always the json path, like every other odd shape
      PyObject* none1 = Py_None, *none2 = Py_None, *none3 = Py_None;
      Py_INCREF(none1);
      Py_INCREF(none2);
      Py_INCREF(none3);
      if (!append3(none1, none2, none3)) return fail(false);
      PyObject* fb = Py_BuildValue("(LLL)",
                                   static_cast<long long>(n_lines),
                                   static_cast<long long>(line_a),
                                   static_cast<long long>(line_b));
      if (!fb || PyList_Append(fallbacks, fb) < 0) {
        Py_XDECREF(fb);
        return fail(false);
      }
      Py_DECREF(fb);
      ++n_lines;
      continue;
    }
    PyObject* t = type_str(c, type_span);
    if (!t) return fail(false);
    PyObject* o;
    if (is_bookmark) {
      o = Py_None;
      Py_INCREF(o);
    } else if (kind == 0) {
      o = build_node(c, item, node_cls, addr_cls);
    } else {
      o = build_pod(c, item, pod_cls, owner_cls);
    }
    if (!o) {
      Py_DECREF(t);
      return fail(false);
    }
    PyObject* r;
    if (item.rv_present) {
      r = span_str(c, item.rv);
      if (!r) {
        Py_DECREF(t);
        Py_DECREF(o);
        return fail(false);
      }
    } else {
      r = Py_None;
      Py_INCREF(r);
    }
    if (!append3(t, o, r)) return fail(false);
    ++n_lines;
  }
  if (c.malformed) return fail(true);
  PyObject* result = PyTuple_Pack(4, types, objects, rvs, fallbacks);
  Py_DECREF(types);
  Py_DECREF(objects);
  Py_DECREF(rvs);
  Py_DECREF(fallbacks);
  return result;
}

}  // extern "C"
