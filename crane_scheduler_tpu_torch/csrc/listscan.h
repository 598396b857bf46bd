// Copy of native/listscan.h (the JAX package's host library), built by
// crane_scheduler_tpu_torch/native/lib.py. The port keeps its own copy.

// listscan.h: the streaming LIST scanner shared by the ctypes columnar
// decoder (crane_native.cpp: crane_list_decode) and the CPython-API
// object decoder (crane_pylist.cpp: crane_pylist_decode). Header-only;
// see crane_native.cpp for the exactness contract.
#ifndef CRANE_LISTSCAN_H_
#define CRANE_LISTSCAN_H_

#include <cstdint>
#include <cstring>
#include <vector>

namespace listdec {

struct Span {
  int64_t a, b;  // byte offsets into the output string buffer
};

constexpr int64_t kNsDefault = -1;  // Span.a sentinel: pod namespace absent

struct Ctx {
  const char* base;
  const char* p;
  const char* e;
  char* sb;
  int64_t sb_pos, sb_cap;
  int64_t* s_start;
  int64_t* s_end;
  int64_t s_cap, s_n;
  bool malformed;
};

inline void ws(Ctx& c) {
  while (c.p < c.e) {
    char ch = *c.p;
    if (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') ++c.p;
    else break;
  }
}

inline bool put(Ctx& c, char ch) {
  if (c.sb_pos >= c.sb_cap) {
    c.malformed = true;  // output capacity exhausted: wholesale fallback
    return false;
  }
  c.sb[c.sb_pos++] = ch;
  return true;
}

inline bool put_cp(Ctx& c, int cp) {
  if (cp < 0x80) return put(c, static_cast<char>(cp));
  if (cp < 0x800) {
    return put(c, static_cast<char>(0xC0 | (cp >> 6))) &&
           put(c, static_cast<char>(0x80 | (cp & 0x3F)));
  }
  if (cp < 0x10000) {
    return put(c, static_cast<char>(0xE0 | (cp >> 12))) &&
           put(c, static_cast<char>(0x80 | ((cp >> 6) & 0x3F))) &&
           put(c, static_cast<char>(0x80 | (cp & 0x3F)));
  }
  return put(c, static_cast<char>(0xF0 | (cp >> 18))) &&
         put(c, static_cast<char>(0x80 | ((cp >> 12) & 0x3F))) &&
         put(c, static_cast<char>(0x80 | ((cp >> 6) & 0x3F))) &&
         put(c, static_cast<char>(0x80 | (cp & 0x3F)));
}

inline int hex4(Ctx& c, int* out) {
  if (c.e - c.p < 4) return 0;
  int cp = 0;
  for (int k = 0; k < 4; ++k) {
    char h = c.p[k];
    int d;
    if (h >= '0' && h <= '9') d = h - '0';
    else if (h >= 'a' && h <= 'f') d = h - 'a' + 10;
    else if (h >= 'A' && h <= 'F') d = h - 'A' + 10;
    else return 0;
    cp = cp * 16 + d;
  }
  c.p += 4;
  *out = cp;
  return 1;
}

// Parse a JSON string at *p into the output buffer (unescaped,
// UTF-8, surrogate pairs combined like json.loads). A LONE surrogate
// escape decodes to a str Python cannot round-trip through UTF-8 —
// *clean goes false so the item falls back to the per-object path.
bool parse_string(Ctx& c, Span* out, bool* clean) {
  if (c.p >= c.e || *c.p != '"') {
    c.malformed = true;
    return false;
  }
  ++c.p;
  const int64_t start = c.sb_pos;
  while (true) {
    if (c.p >= c.e) {
      c.malformed = true;
      return false;
    }
    unsigned char ch = static_cast<unsigned char>(*c.p);
    if (ch == '"') {
      ++c.p;
      break;
    }
    if (ch < 0x20) {  // raw control char: json.loads (strict) rejects
      c.malformed = true;
      return false;
    }
    if (ch != '\\') {
      if (!put(c, static_cast<char>(ch))) return false;
      ++c.p;
      continue;
    }
    ++c.p;
    if (c.p >= c.e) {
      c.malformed = true;
      return false;
    }
    char esc = *c.p++;
    char plain = 0;
    switch (esc) {
      case '"': plain = '"'; break;
      case '\\': plain = '\\'; break;
      case '/': plain = '/'; break;
      case 'b': plain = '\b'; break;
      case 'f': plain = '\f'; break;
      case 'n': plain = '\n'; break;
      case 'r': plain = '\r'; break;
      case 't': plain = '\t'; break;
      case 'u': {
        int cp;
        if (!hex4(c, &cp)) {
          c.malformed = true;
          return false;
        }
        if (cp >= 0xD800 && cp <= 0xDBFF) {
          // high surrogate: combine with a following \uDC00-\uDFFF
          // (json.loads pairs them into one code point)
          if (c.e - c.p >= 6 && c.p[0] == '\\' && c.p[1] == 'u') {
            const char* save = c.p;
            c.p += 2;
            int lo;
            if (hex4(c, &lo) && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            } else {
              c.p = save;
              *clean = false;  // lone high surrogate
            }
          } else {
            *clean = false;
          }
        } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
          *clean = false;  // lone low surrogate
        }
        if (!put_cp(c, cp)) return false;
        continue;
      }
      default:
        c.malformed = true;
        return false;
    }
    if (!put(c, plain)) return false;
  }
  out->a = start;
  out->b = c.sb_pos;
  return true;
}

bool skip_string(Ctx& c) {
  Span s;
  bool clean = true;
  const int64_t keep = c.sb_pos;
  if (!parse_string(c, &s, &clean)) return false;
  c.sb_pos = keep;  // skipped strings don't consume output budget
  return true;
}

bool skip_value(Ctx& c, int depth) {
  if (depth > 256) {
    c.malformed = true;
    return false;
  }
  ws(c);
  if (c.p >= c.e) {
    c.malformed = true;
    return false;
  }
  char ch = *c.p;
  if (ch == '"') return skip_string(c);
  if (ch == '{') {
    ++c.p;
    ws(c);
    if (c.p < c.e && *c.p == '}') {
      ++c.p;
      return true;
    }
    while (true) {
      ws(c);
      if (!skip_string(c)) return false;
      ws(c);
      if (c.p >= c.e || *c.p != ':') {
        c.malformed = true;
        return false;
      }
      ++c.p;
      if (!skip_value(c, depth + 1)) return false;
      ws(c);
      if (c.p < c.e && *c.p == ',') {
        ++c.p;
        continue;
      }
      if (c.p < c.e && *c.p == '}') {
        ++c.p;
        return true;
      }
      c.malformed = true;
      return false;
    }
  }
  if (ch == '[') {
    ++c.p;
    ws(c);
    if (c.p < c.e && *c.p == ']') {
      ++c.p;
      return true;
    }
    while (true) {
      if (!skip_value(c, depth + 1)) return false;
      ws(c);
      if (c.p < c.e && *c.p == ',') {
        ++c.p;
        continue;
      }
      if (c.p < c.e && *c.p == ']') {
        ++c.p;
        return true;
      }
      c.malformed = true;
      return false;
    }
  }
  // primitive: number / true / false / null
  if (!(ch == '-' || (ch >= '0' && ch <= '9') || ch == 't' || ch == 'f' ||
        ch == 'n')) {
    c.malformed = true;
    return false;
  }
  const char* q = c.p;
  while (q < c.e) {
    char d = *q;
    if (d == ',' || d == '}' || d == ']' || d == ' ' || d == '\t' ||
        d == '\n' || d == '\r')
      break;
    ++q;
  }
  c.p = q;
  return true;
}

inline bool is_null_ahead(Ctx& c) {
  return c.e - c.p >= 4 && c.p[0] == 'n' && c.p[1] == 'u' && c.p[2] == 'l' &&
         c.p[3] == 'l';
}

bool key_eq(Ctx& c, const Span& k, const char* lit) {
  const int64_t n = k.b - k.a;
  if (n != static_cast<int64_t>(std::strlen(lit))) return false;
  return std::memcmp(c.sb + k.a, lit, static_cast<size_t>(n)) == 0;
}

// Parse an object of string->string pairs (annotations / labels) into
// `pairs` in document order (dict(zip(...)) keeps the last duplicate,
// exactly like json.loads' last-wins). null => 0 pairs (the `or {}`
// path); any other non-object value, or a non-string pair value, sets
// *fb and the structure is skipped with nothing recorded.
bool parse_str_map(Ctx& c, std::vector<Span>* pairs, bool* fb) {
  ws(c);
  if (is_null_ahead(c)) {
    c.p += 4;
    return true;
  }
  if (c.p >= c.e || *c.p != '{') {
    *fb = true;
    return skip_value(c, 0);
  }
  ++c.p;
  ws(c);
  if (c.p < c.e && *c.p == '}') {
    ++c.p;
    return true;
  }
  while (true) {
    ws(c);
    Span k, v;
    bool clean = true;
    if (!parse_string(c, &k, &clean)) return false;
    ws(c);
    if (c.p >= c.e || *c.p != ':') {
      c.malformed = true;
      return false;
    }
    ++c.p;
    ws(c);
    if (c.p < c.e && *c.p == '"') {
      if (!parse_string(c, &v, &clean)) return false;
      if (!clean) *fb = true;
      if (!*fb) {
        pairs->push_back(k);
        pairs->push_back(v);
      }
    } else {
      *fb = true;  // non-string value: dict semantics need json.loads
      if (!skip_value(c, 0)) return false;
    }
    ws(c);
    if (c.p < c.e && *c.p == ',') {
      ++c.p;
      continue;
    }
    if (c.p < c.e && *c.p == '}') {
      ++c.p;
      return true;
    }
    c.malformed = true;
    return false;
  }
}

// Parse an array of flat objects extracting two string fields per
// element (addresses: type/address; ownerReferences: kind/name).
// Missing fields emit empty spans (the .get(k, "") default); null or
// non-string fields, duplicate keys, or non-object elements fall back.
bool parse_two_field_array(Ctx& c, const char* f0, const char* f1,
                           std::vector<Span>* pairs, bool* fb) {
  ws(c);
  if (is_null_ahead(c)) {
    c.p += 4;
    return true;
  }
  if (c.p >= c.e || *c.p != '[') {
    *fb = true;
    return skip_value(c, 0);
  }
  ++c.p;
  ws(c);
  if (c.p < c.e && *c.p == ']') {
    ++c.p;
    return true;
  }
  while (true) {
    ws(c);
    if (c.p >= c.e || *c.p != '{') {
      *fb = true;  // non-object element: .get() raises in the object path
      if (!skip_value(c, 0)) return false;
    } else {
      ++c.p;
      Span v0{0, 0}, v1{0, 0};
      bool seen0 = false, seen1 = false;
      ws(c);
      if (c.p < c.e && *c.p == '}') {
        ++c.p;
      } else {
        while (true) {
          ws(c);
          Span k;
          bool clean = true;
          if (!parse_string(c, &k, &clean)) return false;
          ws(c);
          if (c.p >= c.e || *c.p != ':') {
            c.malformed = true;
            return false;
          }
          ++c.p;
          ws(c);
          const bool is0 = key_eq(c, k, f0);
          const bool is1 = key_eq(c, k, f1);
          if (is0 || is1) {
            if ((is0 && seen0) || (is1 && seen1)) *fb = true;
            if (c.p < c.e && *c.p == '"') {
              Span v;
              if (!parse_string(c, &v, &clean)) return false;
              if (!clean) *fb = true;
              if (is0) {
                v0 = v;
                seen0 = true;
              } else {
                v1 = v;
                seen1 = true;
              }
            } else {
              *fb = true;  // null/number: .get returns it as-is, not ""
              if (!skip_value(c, 0)) return false;
            }
          } else {
            if (!skip_value(c, 0)) return false;
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
          c.malformed = true;
          return false;
        }
      }
      if (!*fb) {
        pairs->push_back(v0);
        pairs->push_back(v1);
      }
    }
    ws(c);
    if (c.p < c.e && *c.p == ',') {
      ++c.p;
      continue;
    }
    if (c.p < c.e && *c.p == ']') {
      ++c.p;
      return true;
    }
    c.malformed = true;
    return false;
  }
}

// Parse a value expected to be a plain string; anything else (null
// included — .get() surfaces None, not the default) falls back.
bool parse_plain_string(Ctx& c, Span* out, bool* seen, bool* fb) {
  ws(c);
  if (*seen) *fb = true;  // duplicate key: json.loads keeps the last
  *seen = true;
  if (c.p < c.e && *c.p == '"') {
    bool clean = true;
    if (!parse_string(c, out, &clean)) return false;
    if (!clean) *fb = true;
    return true;
  }
  *fb = true;
  return skip_value(c, 0);
}

struct ItemOut {
  Span name{0, 0};
  Span ns{kNsDefault, kNsDefault};  // pods only; sentinel = absent
  Span node_name{0, 0};             // pods only
  Span rv{0, 0};                    // metadata.resourceVersion (watch)
  std::vector<Span> annos;          // k,v interleaved
  std::vector<Span> labels;         // nodes only
  std::vector<Span> addrs;          // nodes: type,address; pods: kind,name
  bool fb = false;
  bool rv_present = false;
  // rv outside the plain-string shape (number, duplicate, surrogate):
  // the LIST drivers ignore rvs entirely; the WATCH driver — whose
  // caller consumes the rv — treats this as a fallback line
  bool rv_bad = false;

  void reset() {
    name = Span{0, 0};
    ns = Span{kNsDefault, kNsDefault};
    node_name = Span{0, 0};
    rv = Span{0, 0};
    annos.clear();
    labels.clear();
    addrs.clear();
    fb = false;
    rv_present = false;
    rv_bad = false;
  }
};

// Walk one item object. kind 0 = node (name/annotations/labels +
// status.addresses), kind 1 = pod (name/namespace/annotations/
// ownerReferences + spec.nodeName, containers forcing fallback).
bool parse_item(Ctx& c, int kind, ItemOut* out) {
  ws(c);
  if (c.p >= c.e || *c.p != '{') {
    c.malformed = true;
    return false;
  }
  ++c.p;
  bool seen_meta = false, seen_sub = false;
  bool seen_name = false, seen_ns = false, seen_nodename = false;
  bool seen_annos = false, seen_labels = false, seen_arr = false,
       seen_containers = false, seen_initc = false, seen_resmap = false;
  ws(c);
  if (c.p < c.e && *c.p == '}') {
    ++c.p;
    return true;
  }
  while (true) {
    ws(c);
    Span k;
    bool clean = true;
    if (!parse_string(c, &k, &clean)) return false;
    ws(c);
    if (c.p >= c.e || *c.p != ':') {
      c.malformed = true;
      return false;
    }
    ++c.p;
    if (key_eq(c, k, "metadata")) {
      if (seen_meta) out->fb = true;
      seen_meta = true;
      ws(c);
      if (c.p >= c.e || *c.p != '{') {
        // null/non-object metadata: the object path raises or defaults —
        // either way, not the fast shape
        out->fb = true;
        if (!skip_value(c, 0)) return false;
      } else {
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == '}') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            Span mk;
            if (!parse_string(c, &mk, &clean)) return false;
            ws(c);
            if (c.p >= c.e || *c.p != ':') {
              c.malformed = true;
              return false;
            }
            ++c.p;
            if (key_eq(c, mk, "name")) {
              if (!parse_plain_string(c, &out->name, &seen_name, &out->fb))
                return false;
            } else if (key_eq(c, mk, "resourceVersion")) {
              ws(c);
              if (out->rv_present) out->rv_bad = true;  // duplicate key
              if (c.p < c.e && *c.p == '"') {
                bool rv_clean = true;
                if (!parse_string(c, &out->rv, &rv_clean)) return false;
                if (!rv_clean) out->rv_bad = true;
                out->rv_present = true;
              } else if (is_null_ahead(c)) {
                c.p += 4;  // null rv: same as absent (.get -> None)
              } else {
                out->rv_bad = true;  // numeric rv: watch driver falls back
                if (!skip_value(c, 0)) return false;
              }
            } else if (kind == 1 && key_eq(c, mk, "namespace")) {
              if (!parse_plain_string(c, &out->ns, &seen_ns, &out->fb))
                return false;
            } else if (key_eq(c, mk, "annotations")) {
              if (seen_annos) out->fb = true;
              seen_annos = true;
              if (!parse_str_map(c, &out->annos, &out->fb)) return false;
            } else if (kind == 0 && key_eq(c, mk, "labels")) {
              if (seen_labels) out->fb = true;
              seen_labels = true;
              if (!parse_str_map(c, &out->labels, &out->fb)) return false;
            } else if (kind == 1 && key_eq(c, mk, "ownerReferences")) {
              if (seen_arr) out->fb = true;
              seen_arr = true;
              if (!parse_two_field_array(c, "kind", "name", &out->addrs,
                                         &out->fb))
                return false;
            } else {
              if (!skip_value(c, 0)) return false;
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
            c.malformed = true;
            return false;
          }
        }
      }
    } else if ((kind == 0 && key_eq(c, k, "status")) ||
               (kind == 1 && key_eq(c, k, "spec"))) {
      if (seen_sub) out->fb = true;
      seen_sub = true;
      ws(c);
      if (c.p >= c.e || *c.p != '{') {
        out->fb = true;
        if (!skip_value(c, 0)) return false;
      } else {
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == '}') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            Span sk;
            if (!parse_string(c, &sk, &clean)) return false;
            ws(c);
            if (c.p >= c.e || *c.p != ':') {
              c.malformed = true;
              return false;
            }
            ++c.p;
            if (kind == 0 && key_eq(c, sk, "addresses")) {
              if (seen_arr) out->fb = true;
              seen_arr = true;
              if (!parse_two_field_array(c, "type", "address", &out->addrs,
                                         &out->fb))
                return false;
            } else if (kind == 1 && key_eq(c, sk, "nodeName")) {
              ws(c);
              if (seen_nodename) out->fb = true;
              seen_nodename = true;
              if (c.p < c.e && *c.p == '"') {
                if (!parse_string(c, &out->node_name, &clean)) return false;
                if (!clean) out->fb = true;
              } else if (is_null_ahead(c)) {
                c.p += 4;  // null `or ""` => "" — the empty default span
              } else {
                out->fb = true;  // truthy non-string survives the `or ""`
                if (!skip_value(c, 0)) return false;
              }
            } else if (kind == 1 && (key_eq(c, sk, "containers") ||
                                     key_eq(c, sk, "initContainers"))) {
              bool* seen =
                  key_eq(c, sk, "containers") ? &seen_containers : &seen_initc;
              if (*seen) out->fb = true;
              *seen = true;
              ws(c);
              if (is_null_ahead(c)) {
                c.p += 4;
              } else if (c.p < c.e && *c.p == '[') {
                const char* open = c.p;
                ++c.p;
                ws(c);
                if (c.p < c.e && *c.p == ']') {
                  ++c.p;  // empty: no containers, still the fast shape
                } else {
                  // non-empty containers carry nested resource maps with
                  // number-typed values: always the per-object path
                  out->fb = true;
                  c.p = open;
                  if (!skip_value(c, 0)) return false;
                }
              } else {
                out->fb = true;
                if (!skip_value(c, 0)) return false;
              }
            } else if ((kind == 0 && key_eq(c, sk, "allocatable")) ||
                       (kind == 1 && key_eq(c, sk, "overhead"))) {
              // resource maps (number-or-string quantities) the columnar
              // string layout cannot hold: non-empty => per-object path
              if (seen_resmap) out->fb = true;
              seen_resmap = true;
              ws(c);
              if (is_null_ahead(c)) {
                c.p += 4;
              } else if (c.p < c.e && *c.p == '{') {
                const char* open = c.p;
                ++c.p;
                ws(c);
                if (c.p < c.e && *c.p == '}') {
                  ++c.p;  // empty map: still the fast shape
                } else {
                  out->fb = true;
                  c.p = open;
                  if (!skip_value(c, 0)) return false;
                }
              } else {
                out->fb = true;
                if (!skip_value(c, 0)) return false;
              }
            } else {
              if (!skip_value(c, 0)) return false;
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
            c.malformed = true;
            return false;
          }
        }
      }
    } else {
      if (!skip_value(c, 0)) return false;
    }
    ws(c);
    if (c.p < c.e && *c.p == ',') {
      ++c.p;
      continue;
    }
    if (c.p < c.e && *c.p == '}') {
      ++c.p;
      return true;
    }
    c.malformed = true;
    return false;
  }
}

inline bool emit(Ctx& c, const Span& s) {
  if (c.s_n >= c.s_cap) {
    c.malformed = true;
    return false;
  }
  c.s_start[c.s_n] = s.a;
  c.s_end[c.s_n] = s.b;
  ++c.s_n;
  return true;
}

}  // namespace listdec

#endif  // CRANE_LISTSCAN_H_
