// Copy of native/crane_native.cpp (the JAX package's host library), built by
// crane_scheduler_tpu_torch/native/lib.py. The port keeps its own copy.

// crane_native: native runtime pieces for crane-scheduler-tpu.
//
// The reference's runtime is compiled Go; the performance-relevant host
// pieces here are implemented in C++ with a C ABI for ctypes:
//
//  1. Binding records — the bounded min-heap behind hot values
//     (ref: pkg/controller/annotator/binding.go). The Go version scans the
//     whole heap per (node, window) query; the batch API here computes the
//     counts for EVERY node and window in one pass over the heap.
//
//  2. Bulk annotation codec — parse "value,2006-01-02T15:04:05Z" wire
//     strings (ref: node.go:142, stats.go:51-76) into value/timestamp
//     arrays. The timestamp's trailing Z is a literal; the string is local
//     time in a fixed-offset zone (utc_offset_seconds parameter; zones
//     with DST must use the Python codec).
//
// Build: make -C native   (produces libcrane_native.so)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cctype>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Binding records
// ---------------------------------------------------------------------------

struct Binding {
  int64_t timestamp;
  uint64_t seq;
  int32_t node_id;
};

struct BindingHeap {
  std::vector<Binding> heap;  // min-heap by (timestamp, seq)
  int64_t size_cap;
  int64_t gc_range_seconds;
  uint64_t seq;
};

static bool binding_greater(const Binding& a, const Binding& b) {
  // std::push_heap builds a max-heap; invert for min-heap semantics.
  if (a.timestamp != b.timestamp) return a.timestamp > b.timestamp;
  return a.seq > b.seq;
}

void* crane_bindings_new(int64_t size_cap, int64_t gc_range_seconds) {
  auto* h = new BindingHeap();
  h->size_cap = size_cap;
  h->gc_range_seconds = gc_range_seconds;
  h->seq = 0;
  h->heap.reserve(static_cast<size_t>(size_cap > 0 ? size_cap : 16));
  return h;
}

void crane_bindings_free(void* handle) {
  delete static_cast<BindingHeap*>(handle);
}

int64_t crane_bindings_len(void* handle) {
  return static_cast<int64_t>(static_cast<BindingHeap*>(handle)->heap.size());
}

// Push; evict the oldest first when full (ref: binding.go:69-78).
void crane_bindings_add(void* handle, int32_t node_id, int64_t timestamp) {
  auto* h = static_cast<BindingHeap*>(handle);
  if (static_cast<int64_t>(h->heap.size()) == h->size_cap) {
    std::pop_heap(h->heap.begin(), h->heap.end(), binding_greater);
    h->heap.pop_back();
  }
  h->heap.push_back(Binding{timestamp, h->seq++, node_id});
  std::push_heap(h->heap.begin(), h->heap.end(), binding_greater);
}

// Batch push (event-burst ingestion): one FFI crossing per burst; the
// evict+push invariant lives only in crane_bindings_add.
void crane_bindings_add_batch(void* handle, const int32_t* node_ids,
                              const int64_t* timestamps, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    crane_bindings_add(handle, node_ids[i], timestamps[i]);
  }
}

// Count bindings for one node strictly newer than now - window
// (ref: binding.go:81-97).
int64_t crane_bindings_count(void* handle, int32_t node_id,
                             int64_t window_seconds, int64_t now_seconds) {
  auto* h = static_cast<BindingHeap*>(handle);
  const int64_t timeline = now_seconds - window_seconds;
  int64_t count = 0;
  for (const auto& b : h->heap) {
    if (b.timestamp > timeline && b.node_id == node_id) ++count;
  }
  return count;
}

// One pass over the heap, all nodes x all windows:
// out[w * n_nodes + node_id] = count of bindings newer than now - window_w.
// node_id must be in [0, n_nodes).
void crane_bindings_counts_batch(void* handle, int64_t n_nodes,
                                 const int64_t* window_seconds,
                                 int64_t n_windows, int64_t now_seconds,
                                 int64_t* out) {
  auto* h = static_cast<BindingHeap*>(handle);
  std::memset(out, 0, sizeof(int64_t) * static_cast<size_t>(n_nodes * n_windows));
  std::vector<int64_t> timelines(static_cast<size_t>(n_windows));
  for (int64_t w = 0; w < n_windows; ++w) {
    timelines[static_cast<size_t>(w)] = now_seconds - window_seconds[w];
  }
  for (const auto& b : h->heap) {
    if (b.node_id < 0 || b.node_id >= n_nodes) continue;
    for (int64_t w = 0; w < n_windows; ++w) {
      if (b.timestamp > timelines[static_cast<size_t>(w)]) {
        ++out[w * n_nodes + b.node_id];
      }
    }
  }
}

// Pop expired records, stopping at the first live one (ref: binding.go:100-123).
void crane_bindings_gc(void* handle, int64_t now_seconds) {
  auto* h = static_cast<BindingHeap*>(handle);
  if (h->gc_range_seconds == 0) return;
  const int64_t timeline = now_seconds - h->gc_range_seconds;
  while (!h->heap.empty()) {
    const Binding& top = h->heap.front();
    if (top.timestamp > timeline) return;
    std::pop_heap(h->heap.begin(), h->heap.end(), binding_greater);
    h->heap.pop_back();
  }
}

// ---------------------------------------------------------------------------
// Bulk annotation codec
// ---------------------------------------------------------------------------

// Howard Hinnant's days-from-civil: days since 1970-01-01 for y/m/d.
static int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

static bool parse_2digits(const char* p, int* out) {
  if (p[0] < '0' || p[0] > '9' || p[1] < '0' || p[1] > '9') return false;
  *out = (p[0] - '0') * 10 + (p[1] - '0');
  return true;
}

// Parse "YYYY-MM-DDTHH:MM:SSZ" (literal Z) as a local time at a fixed UTC
// offset. Returns epoch seconds or INT64_MIN on failure.
static int64_t parse_local_timestamp(const char* s, int64_t len,
                                     int64_t utc_offset_seconds) {
  if (len != 20) return INT64_MIN;
  if (s[4] != '-' || s[7] != '-' || s[10] != 'T' || s[13] != ':' ||
      s[16] != ':' || s[19] != 'Z') {
    return INT64_MIN;
  }
  int year_hi, year_lo, month, day, hour, minute, second;
  if (!parse_2digits(s, &year_hi) || !parse_2digits(s + 2, &year_lo) ||
      !parse_2digits(s + 5, &month) || !parse_2digits(s + 8, &day) ||
      !parse_2digits(s + 11, &hour) || !parse_2digits(s + 14, &minute) ||
      !parse_2digits(s + 17, &second)) {
    return INT64_MIN;
  }
  const int year = year_hi * 100 + year_lo;
  if (month < 1 || month > 12 || day < 1 || day > 31 || hour > 23 ||
      minute > 59 || second > 60) {
    return INT64_MIN;
  }
  const int64_t days = days_from_civil(year, month, day);
  return days * 86400 + hour * 3600 + minute * 60 + second - utc_offset_seconds;
}

// strconv.ParseFloat(s, 64) equivalent over a non-terminated slice:
// strtod accepts a superset of Go (hex floats, inf/nan); reject leading
// whitespace, trailing garbage, and misplaced grouping underscores.
static bool parse_go_float(const char* start, int64_t vlen, double* out) {
  if (vlen == 0 || start[0] == ' ' || start[0] == '\t') return false;
  char tmp[64];
  if (vlen >= static_cast<int64_t>(sizeof(tmp))) return false;
  std::memcpy(tmp, start, static_cast<size_t>(vlen));
  tmp[vlen] = '\0';
  // Go rejects underscores except between digits; strtod treats them as
  // terminators. Strip valid grouping underscores first.
  char cleaned[64];
  int64_t ci = 0;
  for (int64_t j = 0; j < vlen; ++j) {
    if (tmp[j] == '_') {
      const bool prev_digit = j > 0 && tmp[j - 1] >= '0' && tmp[j - 1] <= '9';
      const bool next_digit =
          j + 1 < vlen && tmp[j + 1] >= '0' && tmp[j + 1] <= '9';
      if (!prev_digit || !next_digit) return false;
      continue;  // drop grouping underscore
    }
    cleaned[ci++] = tmp[j];
  }
  cleaned[ci] = '\0';
  char* end = nullptr;
  const double v = std::strtod(cleaned, &end);
  if (end == cleaned || (end != nullptr && *end != '\0')) return false;
  *out = v;
  return true;
}

// Parse n annotation strings packed into one buffer with offsets
// (offsets[i]..offsets[i+1] delimit string i). Outputs per entry:
//   values[i] = parsed float (NaN when the value part is invalid/missing)
//   ts[i]     = epoch seconds, or -inf when the entry is structurally
//               invalid (wrong comma count / bad timestamp) => fail-open.
// Mirrors decode_annotation + the Go getResourceUsage split semantics.
void crane_parse_annotations(const char* buffer, const int64_t* offsets,
                             int64_t n, int64_t utc_offset_seconds,
                             double* values, double* ts) {
  const double neg_inf = -1.0 / 0.0;
  const double nan = 0.0 / 0.0;
  for (int64_t i = 0; i < n; ++i) {
    values[i] = nan;
    ts[i] = neg_inf;
    const char* start = buffer + offsets[i];
    const int64_t len = offsets[i + 1] - offsets[i];
    // exactly one comma (split must yield 2 parts; ref: stats.go:57-60)
    const char* comma = nullptr;
    int comma_count = 0;
    for (int64_t j = 0; j < len; ++j) {
      if (start[j] == ',') {
        if (comma_count++ == 0) comma = start + j;
      }
    }
    if (comma_count != 1) continue;
    const int64_t ts_len = (start + len) - (comma + 1);
    const int64_t parsed = parse_local_timestamp(comma + 1, ts_len, utc_offset_seconds);
    if (parsed == INT64_MIN) continue;
    ts[i] = static_cast<double>(parsed);
    // value part: strtod accepts a superset of Go (hex floats, inf/nan);
    // reject trailing garbage and leading whitespace to match ParseFloat.
    const int64_t vlen = comma - start;
    double v;
    if (!parse_go_float(start, vlen, &v)) {
      ts[i] = neg_inf;  // unparseable value == structurally invalid
      continue;
    }
    values[i] = v;
  }
}

// Parse n bare value strings (metric samples) with Go ParseFloat
// semantics: values[i] = parsed float, ok[i] = 1 on success, else
// (NaN, 0). One C call replaces a per-string Python parse in the
// annotator's bulk sweep (|nodes| x |metrics| strings per cycle).
void crane_parse_values(const char* buffer, const int64_t* offsets, int64_t n,
                        double* values, uint8_t* ok) {
  const double nan = 0.0 / 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const char* start = buffer + offsets[i];
    const int64_t len = offsets[i + 1] - offsets[i];
    double v;
    if (parse_go_float(start, len, &v)) {
      values[i] = v;
      ok[i] = 1;
    } else {
      values[i] = nan;
      ok[i] = 0;
    }
  }
}

// Render n doubles with the Prometheus client's 5-decimal fixed
// contract (ref: prometheus.go:124 FormatFloat(v, 'f', 5, 64); negative
// and NaN clamp to 0 is the CALLER's job when modeling _render).
// out buffer must hold >= n * 32 bytes; offsets[n+1] delimit entries.
void crane_render_f5(const double* vals, int64_t n, char* out,
                     int64_t* offsets) {
  int64_t pos = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double v = vals[i];
    int wrote;
    if (v != v) {
      std::memcpy(out + pos, "NaN", 3);
      wrote = 3;
    } else if (v > 1.7976931348623157e308) {
      std::memcpy(out + pos, "+Inf", 4);
      wrote = 4;
    } else if (v < -1.7976931348623157e308) {
      std::memcpy(out + pos, "-Inf", 4);
      wrote = 4;
    } else if (!std::signbit(v) && v < 1.0e4) {
      // fast fixed-point path (annotation loads are small nonnegative
      // reals; snprintf's general double->decimal dominated 50k-column
      // render profiles). signbit (not v >= 0.0) so -0.0 keeps the
      // snprintf path: FormatFloat renders it "-0.00000". For v < 1e4, scaled < 1e9 so the multiply
      // error is <= 0.5 ulp ~ 1.1e-7; when the fractional part is
      // further than 1e-5 from the .5 rounding boundary the round
      // direction is provably identical to %.5f's exact rounding.
      // Anything nearer the boundary (and anything >= 1e4) takes the
      // snprintf path, so output can never diverge.
      double scaled = v * 100000.0;
      double fl = std::floor(scaled);
      double frac = scaled - fl;
      if (frac > 0.5 - 1e-5 && frac < 0.5 + 1e-5) {
        char scratch[352];
        wrote = std::snprintf(scratch, sizeof(scratch), "%.5f", v);
        if (wrote < 0 || wrote > 31) {
          wrote = 0;
        } else {
          std::memcpy(out + pos, scratch, static_cast<size_t>(wrote));
        }
      } else {
        uint64_t q =
            static_cast<uint64_t>(fl) + (frac > 0.5 ? 1u : 0u);
        uint64_t ipart = q / 100000u;
        uint64_t fpart = q % 100000u;
        char tmp[20];
        int ni = 0;
        do {
          tmp[ni++] = static_cast<char>('0' + ipart % 10u);
          ipart /= 10u;
        } while (ipart);
        char* w = out + pos;
        for (int k = ni - 1; k >= 0; --k) *w++ = tmp[k];
        *w++ = '.';
        w[4] = static_cast<char>('0' + fpart % 10u); fpart /= 10u;
        w[3] = static_cast<char>('0' + fpart % 10u); fpart /= 10u;
        w[2] = static_cast<char>('0' + fpart % 10u); fpart /= 10u;
        w[1] = static_cast<char>('0' + fpart % 10u); fpart /= 10u;
        w[0] = static_cast<char>('0' + fpart % 10u);
        wrote = ni + 6;
      }
    } else {
      // render to a scratch sized for the %.5f worst case (~317 chars
      // for DBL_MAX); entries that exceed the caller's 32-byte budget
      // are emitted EMPTY (offsets[i] == offsets[i+1]) — "%.5f" never
      // legitimately renders "" — so the caller can re-render those
      // few rows itself instead of this function corrupting the heap.
      char scratch[352];
      wrote = std::snprintf(scratch, sizeof(scratch), "%.5f", v);
      if (wrote < 0 || wrote > 31) {
        wrote = 0;
      } else {
        std::memcpy(out + pos, scratch, static_cast<size_t>(wrote));
      }
    }
    pos += wrote;
    offsets[i + 1] = pos;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bulk HTTP flush engine
// ---------------------------------------------------------------------------
//
// The reference writes annotations through client-go's HTTP/2 transport
// from compiled Go (node.go:123-146): request framing, response parsing
// and connection handling all run outside any interpreter lock. The
// Python pooled writer tops out where the GIL serializes per-request
// work (~80us x one core). This engine is the native equivalent:
// pre-rendered HTTP/1.1 requests are fanned over `workers` keep-alive
// connections by worker threads that send, parse and drain entirely in
// C++ — the ctypes call releases the GIL, so the whole flush costs
// Python one call. Plain-http only (in-cluster apiserver sidecars /
// benches); TLS rides the Python pool.

#include <atomic>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct BufConn {
  int fd = -1;
  char buf[16384];
  size_t pos = 0, len = 0;

  bool is_open() const { return fd >= 0; }

  void close_conn() {
    if (fd >= 0) {
      ::close(fd);
      fd = -1;
    }
    pos = len = 0;
  }

  bool fill() {
    if (pos < len) return true;
    pos = 0;
    ssize_t n = ::recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) {
      len = 0;
      return false;
    }
    len = static_cast<size_t>(n);
    return true;
  }

  // read one CRLF/LF-terminated line into out (NUL-terminated,
  // terminator stripped); false on EOF/error or overlong line
  bool read_line(char* out, size_t cap) {
    size_t w = 0;
    while (true) {
      if (!fill()) return false;
      while (pos < len) {
        char c = buf[pos++];
        if (c == '\n') {
          while (w > 0 && out[w - 1] == '\r') --w;
          out[w] = 0;
          return true;
        }
        if (w + 1 >= cap) return false;
        out[w++] = c;
      }
    }
  }

  // skip exactly n body bytes
  bool skip(int64_t n) {
    while (n > 0) {
      if (!fill()) return false;
      size_t take = len - pos;
      if (static_cast<int64_t>(take) > n) take = static_cast<size_t>(n);
      pos += take;
      n -= static_cast<int64_t>(take);
    }
    return true;
  }
};

bool send_all(int fd, const uint8_t* data, int64_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, data, static_cast<size_t>(n), MSG_NOSIGNAL);
    if (w <= 0) return false;
    data += w;
    n -= w;
  }
  return true;
}

int connect_nodelay(const char* ip, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // bound every phase (connect honors SO_SNDTIMEO on Linux): a wedged
  // apiserver must surface as status 0, not hang the flush forever —
  // the Python pool path this replaces enforces the client timeout
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, ip, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

bool ieq(const char* a, const char* b) {  // ASCII case-insensitive
  for (; *a && *b; ++a, ++b) {
    if (std::tolower(static_cast<unsigned char>(*a)) !=
        std::tolower(static_cast<unsigned char>(*b)))
      return false;
  }
  return *a == 0 && *b == 0;
}

// parse + drain one response; returns HTTP status (0 on transport/parse
// failure); sets *close_after when the connection must not be reused
int read_response(BufConn& c, bool* close_after) {
  char line[8192];
  if (!c.read_line(line, sizeof(line))) return 0;
  // "HTTP/1.1 200 OK"
  const char* sp = std::strchr(line, ' ');
  if (!sp) return 0;
  int status = std::atoi(sp + 1);
  if (status < 100 || status > 599) return 0;
  int64_t content_length = -1;
  bool chunked = false;
  *close_after = false;
  while (true) {
    if (!c.read_line(line, sizeof(line))) return 0;
    if (line[0] == 0) break;  // blank line: end of headers
    char* colon = std::strchr(line, ':');
    if (!colon) continue;
    *colon = 0;
    char* val = colon + 1;
    while (*val == ' ' || *val == '\t') ++val;
    if (ieq(line, "content-length")) {
      content_length = std::atoll(val);
    } else if (ieq(line, "transfer-encoding")) {
      for (char* p = val; *p; ++p)
        *p = static_cast<char>(std::tolower(static_cast<unsigned char>(*p)));
      if (std::strstr(val, "chunked")) chunked = true;
    } else if (ieq(line, "connection")) {
      if (ieq(val, "close")) *close_after = true;
    }
  }
  if (chunked) {
    while (true) {
      if (!c.read_line(line, sizeof(line))) return 0;
      char* semi = std::strchr(line, ';');  // chunk extensions: ignore
      if (semi) *semi = 0;
      int64_t size = std::strtoll(line, nullptr, 16);
      if (size == 0) {
        // trailer section: consume lines until the blank line — a
        // single read would desync the keep-alive parse when the
        // server emits trailer fields after the terminal chunk
        while (true) {
          if (!c.read_line(line, sizeof(line))) return 0;
          if (line[0] == 0) break;  // blank line: end of trailers
        }
        break;
      }
      if (!c.skip(size)) return 0;
      if (!c.read_line(line, sizeof(line))) return 0;  // chunk CRLF
    }
  } else if (content_length >= 0) {
    if (!c.skip(content_length)) return 0;
  } else {
    // read-to-EOF body: drain and mark dead
    while (c.fill()) c.pos = c.len;
    *close_after = true;
  }
  return status;
}

// send up to n bytes, returning how many were written before a failure
// (callers delimit which pipelined requests fully reached the wire)
int64_t send_some(int fd, const uint8_t* data, int64_t n) {
  int64_t sent = 0;
  while (sent < n) {
    ssize_t w = ::send(fd, data + sent, static_cast<size_t>(n - sent),
                       MSG_NOSIGNAL);
    if (w <= 0) return sent;
    sent += w;
  }
  return sent;
}

struct FlushCtx {
  const char* ip;
  int port;
  int timeout_ms;
  const uint8_t* blob;
  const int64_t* offsets;
  int64_t n;
  int idempotent;
  std::atomic<int64_t> next{0};
  int32_t* statuses;
};

void flush_worker(FlushCtx* ctx) {
  BufConn c;
  while (true) {
    int64_t i = ctx->next.fetch_add(1, std::memory_order_relaxed);
    if (i >= ctx->n) break;
    const uint8_t* req = ctx->blob + ctx->offsets[i];
    int64_t req_len = ctx->offsets[i + 1] - ctx->offsets[i];
    int32_t status = 0;
    for (int attempt = 0; attempt < 2; ++attempt) {
      if (!c.is_open()) {
        c.fd = connect_nodelay(ctx->ip, ctx->port, ctx->timeout_ms);
        if (!c.is_open()) break;
      }
      if (!send_all(c.fd, req, req_len)) {
        // send-phase failure (stale keep-alive): always retriable
        c.close_conn();
        continue;
      }
      bool close_after = false;
      status = read_response(c, &close_after);
      if (status == 0) {
        // response-phase failure: the request may have been processed —
        // only idempotent batches (merge-patches) retry
        c.close_conn();
        if (ctx->idempotent) continue;
        break;
      }
      if (close_after) c.close_conn();
      break;
    }
    ctx->statuses[i] = status;
  }
  c.close_conn();
}

// ---------------------------------------------------------------------------
// Pipelined flush engine
// ---------------------------------------------------------------------------
//
// The serial engine above pays one full client<->server turn per request
// per connection: send, wait, parse, send the next. The pipelined engine
// keeps up to `depth` requests in flight per keep-alive connection
// (HTTP/1.1 pipelining: responses arrive strictly in request order), and
// coalesces the fill phase into ONE send() syscall for everything it can
// batch — on a loopback stub the syscall + context-switch ping-pong is a
// large share of per-request cost, so batching depth-k requests per
// write is most of the win.
//
// POST-safety contract (the binding subresource is not idempotent): a
// response-phase transport failure marks the awaited request AND every
// request already sent behind it on that connection indeterminate —
// they are never re-POSTed (statuses 0; the server may have processed
// any prefix). Only requests that provably never reached the wire
// (claimed but unsent, or sent partially so the server cannot have
// parsed a complete request) reroute to a fresh connection. Idempotent
// merge-patch batches retry the indeterminate set too (one transport
// retry per request, like the serial engine).

struct PipeStats {
  std::atomic<int64_t> stalls{0};         // full-depth response waits
  std::atomic<int64_t> indeterminate{0};  // never-retried unknown-outcome
  std::atomic<int64_t> reconnects{0};     // connections (re)opened
  std::atomic<int64_t> sends{0};          // send() syscalls issued
};

struct PipeCtx {
  const char* ip;
  int port;
  int timeout_ms;
  const uint8_t* blob;
  const int64_t* offsets;
  int64_t n;
  int idempotent;
  int depth;
  std::atomic<int64_t> next{0};
  int32_t* statuses;
  PipeStats stats;
};

struct PipeItem {
  int64_t idx;
  int attempt;
};

void pipe_worker(PipeCtx* ctx) {
  BufConn c;
  std::vector<PipeItem> inflight;  // sent, awaiting response (FIFO)
  std::vector<PipeItem> local;     // claimed, not yet sent (retries first)
  std::vector<uint8_t> wire;       // batched send buffer
  inflight.reserve(static_cast<size_t>(ctx->depth));

  auto claim = [&](PipeItem* out) -> bool {
    if (!local.empty()) {
      *out = local.front();
      local.erase(local.begin());
      return true;
    }
    int64_t i = ctx->next.fetch_add(1, std::memory_order_relaxed);
    if (i >= ctx->n) return false;
    *out = PipeItem{i, 0};
    return true;
  };

  // a transport failure makes every in-flight request indeterminate:
  // idempotent batches re-drive them (budget: one transport retry per
  // request), non-idempotent batches must leave them status 0
  auto fail_inflight = [&]() {
    for (const PipeItem& it : inflight) {
      if (ctx->idempotent && it.attempt < 1) {
        local.push_back(PipeItem{it.idx, it.attempt + 1});
      } else {
        ctx->statuses[it.idx] = 0;
        if (!ctx->idempotent) {
          ctx->stats.indeterminate.fetch_add(1, std::memory_order_relaxed);
        }
      }
    }
    inflight.clear();
  };

  while (true) {
    // fill: claim up to depth, coalesce into one send
    if (static_cast<int>(inflight.size()) < ctx->depth) {
      wire.clear();
      std::vector<PipeItem> batch;
      std::vector<int64_t> ends;  // wire offset after each batched request
      PipeItem it;
      while (static_cast<int>(inflight.size() + batch.size()) < ctx->depth &&
             claim(&it)) {
        const uint8_t* req = ctx->blob + ctx->offsets[it.idx];
        const int64_t len = ctx->offsets[it.idx + 1] - ctx->offsets[it.idx];
        wire.insert(wire.end(), req, req + len);
        ends.push_back(static_cast<int64_t>(wire.size()));
        batch.push_back(it);
      }
      if (!batch.empty()) {
        if (!c.is_open()) {
          c.fd = connect_nodelay(ctx->ip, ctx->port, ctx->timeout_ms);
          if (!c.is_open()) {
            // connect failure: nothing reached the wire — but a dead
            // server must not spin; fail this batch like the serial
            // engine fails its per-request connect
            for (const PipeItem& b : batch) ctx->statuses[b.idx] = 0;
            if (inflight.empty() && local.empty()) break;
            continue;
          }
          ctx->stats.reconnects.fetch_add(1, std::memory_order_relaxed);
        }
        ctx->stats.sends.fetch_add(1, std::memory_order_relaxed);
        int64_t sent = send_some(c.fd, wire.data(),
                                 static_cast<int64_t>(wire.size()));
        if (sent == static_cast<int64_t>(wire.size())) {
          for (const PipeItem& b : batch) inflight.push_back(b);
        } else {
          // partial send: requests fully written are on the wire (they
          // join inflight, then fail as indeterminate with it); the
          // partially-written one and everything after never formed a
          // complete request server-side — always safe to reroute
          c.close_conn();
          size_t k = 0;
          while (k < batch.size() && ends[k] <= sent) {
            inflight.push_back(batch[k]);
            ++k;
          }
          fail_inflight();
          for (size_t j = k; j < batch.size(); ++j) {
            if (batch[j].attempt < 1) {
              local.push_back(PipeItem{batch[j].idx, batch[j].attempt + 1});
            } else {
              ctx->statuses[batch[j].idx] = 0;
            }
          }
          continue;
        }
      }
    }
    if (inflight.empty()) {
      if (local.empty()) break;
      continue;
    }
    // drain responses, strictly in request order: one blocking read,
    // then keep going while response bytes are already buffered — a
    // deep drain refills the pipeline in ONE batched send instead of
    // degenerating into send-one/read-one lockstep
    if (static_cast<int>(inflight.size()) >= ctx->depth) {
      ctx->stats.stalls.fetch_add(1, std::memory_order_relaxed);
    }
    while (!inflight.empty()) {
      bool close_after = false;
      int status = read_response(c, &close_after);
      if (status == 0) {
        // response-phase failure: the awaited request and everything
        // already pipelined behind it are indeterminate
        c.close_conn();
        fail_inflight();
        break;
      }
      ctx->statuses[inflight.front().idx] = status;
      inflight.erase(inflight.begin());
      if (close_after) {
        // server ends the connection here: responses for the requests
        // already sent behind this one will never arrive
        c.close_conn();
        fail_inflight();
        break;
      }
      if (c.pos >= c.len) break;  // nothing buffered: go refill
    }
  }
  c.close_conn();
}

}  // namespace

extern "C" {

// Flush n pre-rendered HTTP requests (concatenated in blob, delimited
// by offsets[0..n]) to ip:port over `workers` keep-alive connections.
// statuses[i] receives the final HTTP status (0 = transport failure;
// no status-based retry here — callers route failures through their
// slow path, which owns backoff/Retry-After semantics). Returns the
// number of 2xx responses.
int64_t crane_http_flush(const char* ip, int32_t port, const uint8_t* blob,
                         const int64_t* offsets, int64_t n, int32_t workers,
                         int32_t idempotent, int32_t timeout_ms,
                         int32_t* statuses) {
  if (n <= 0) return 0;
  FlushCtx ctx;
  ctx.ip = ip;
  ctx.port = port;
  ctx.timeout_ms = timeout_ms > 0 ? timeout_ms : 30000;
  ctx.blob = blob;
  ctx.offsets = offsets;
  ctx.n = n;
  ctx.idempotent = idempotent;
  ctx.statuses = statuses;
  std::memset(statuses, 0, sizeof(int32_t) * static_cast<size_t>(n));
  int nw = workers < 1 ? 1 : workers;
  if (static_cast<int64_t>(nw) > n) nw = static_cast<int>(n);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nw));
  for (int w = 0; w < nw; ++w) threads.emplace_back(flush_worker, &ctx);
  for (auto& t : threads) t.join();
  int64_t ok = 0;
  for (int64_t i = 0; i < n; ++i)
    if (statuses[i] >= 200 && statuses[i] < 300) ++ok;
  return ok;
}

// Pipelined flush: `conns` keep-alive connections, up to `depth`
// requests in flight per connection with strict in-order response
// accounting, fill phases coalesced into single send() calls. statuses
// as in crane_http_flush (0 = transport failure / indeterminate; no
// status-based retry here). stats_out (nullable) receives 4 int64
// counters: [0] pipeline stalls (full-depth response waits),
// [1] indeterminate non-idempotent requests (never re-POSTed),
// [2] connections opened, [3] send() syscalls. Returns 2xx count.
int64_t crane_http_flush_pipelined(const char* ip, int32_t port,
                                   const uint8_t* blob,
                                   const int64_t* offsets, int64_t n,
                                   int32_t conns, int32_t depth,
                                   int32_t idempotent, int32_t timeout_ms,
                                   int32_t* statuses, int64_t* stats_out) {
  if (n <= 0) return 0;
  PipeCtx ctx;
  ctx.ip = ip;
  ctx.port = port;
  ctx.timeout_ms = timeout_ms > 0 ? timeout_ms : 30000;
  ctx.blob = blob;
  ctx.offsets = offsets;
  ctx.n = n;
  ctx.idempotent = idempotent;
  ctx.depth = depth < 1 ? 1 : depth;
  ctx.statuses = statuses;
  std::memset(statuses, 0, sizeof(int32_t) * static_cast<size_t>(n));
  int nw = conns < 1 ? 1 : conns;
  if (static_cast<int64_t>(nw) > n) nw = static_cast<int>(n);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nw));
  for (int w = 0; w < nw; ++w) threads.emplace_back(pipe_worker, &ctx);
  for (auto& t : threads) t.join();
  if (stats_out != nullptr) {
    stats_out[0] = ctx.stats.stalls.load();
    stats_out[1] = ctx.stats.indeterminate.load();
    stats_out[2] = ctx.stats.reconnects.load();
    stats_out[3] = ctx.stats.sends.load();
  }
  int64_t ok = 0;
  for (int64_t i = 0; i < n; ++i)
    if (statuses[i] >= 200 && statuses[i] < 300) ++ok;
  return ok;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming LIST decode
// ---------------------------------------------------------------------------
//
// The read-side twin of the flush engines above: a kube LIST page is a
// JSON object whose "items" array carries thousands of node/pod objects,
// and the client only ever reads a handful of fields from each
// (node_from_json / pod_from_json in cluster/kube.py). json.loads
// materializes the full tree — metadata.managedFields and all — as
// Python dicts, which at 50k nodes is seconds of allocator work per
// relist. This scanner walks the page bytes ONCE and copies just the
// consumed fields (unescaped) into columnar string arrays; everything
// else is skipped structurally without allocation.
//
// Exactness contract: an item whose consumed fields are all plain
// strings (the only shape a real apiserver emits) decodes on the fast
// path, byte-identical to json.loads' strings (full escape handling,
// surrogate pairs included). Any item outside that shape — a non-string
// annotation value, a lone surrogate escape, duplicate metadata keys,
// containers on a pod — gets flag bit 0 set and emits NO strings; the
// caller re-decodes that item's byte span (item_start/item_end) with the
// ordinary per-object path, so the combined result is bit-identical to
// node_from_json/pod_from_json on EVERY input. Malformed JSON or
// exhausted output capacity returns -1 and the caller falls back
// wholesale.

#include "listscan.h"

extern "C" {

// Decode one LIST page. kind: 0 = nodes, 1 = pods. Outputs:
//   str_buf/str_start/str_end — extracted strings (unescaped UTF-8
//     bytes; spans index str_buf). Entry 0 is the list's
//     metadata.resourceVersion, entry 1 its metadata.continue (empty
//     spans when absent). Then, per fast-path item, in canonical order:
//       nodes: name, anno k/v pairs, label k/v pairs,
//              address type/address pairs
//       pods:  name, namespace, nodeName, anno k/v pairs,
//              ownerReference kind/name pairs
//     (a pod namespace span of (-1,-1) means "absent": the caller
//     substitutes the "default" literal). Fallback items emit nothing.
//   item_start/item_end — each item's byte span in `buf` (fallback
//     items re-decode from it).
//   item_flags — bit 0: fallback (emit nothing; re-decode the span).
//   pair_counts — per item: nodes 3 entries (anno, label, address pair
//     counts), pods 2 entries (anno, ownerReference pair counts).
//   n_str_out — total string entries emitted (incl. the 2 meta slots).
// Returns the item count, or -1 on malformed JSON / exhausted output
// capacity (caller decodes the page with the ordinary JSON parser).
int64_t crane_list_decode(const char* buf, int64_t len, int32_t kind,
                          char* str_buf, int64_t str_buf_cap,
                          int64_t* str_start, int64_t* str_end,
                          int64_t str_cap, int64_t* item_start,
                          int64_t* item_end, uint8_t* item_flags,
                          int64_t* pair_counts, int64_t item_cap,
                          int64_t* n_str_out) {
  using namespace listdec;
  Ctx c;
  c.base = buf;
  c.p = buf;
  c.e = buf + len;
  c.sb = str_buf;
  c.sb_pos = 0;
  c.sb_cap = str_buf_cap;
  c.s_start = str_start;
  c.s_end = str_end;
  c.s_cap = str_cap;
  c.s_n = 0;
  c.malformed = false;
  if (c.s_cap < 2) return -1;
  // slots 0/1: list resourceVersion + continue (filled when metadata
  // is seen; the apiserver puts it first, but order is not assumed)
  c.s_start[0] = c.s_end[0] = 0;
  c.s_start[1] = c.s_end[1] = 0;
  c.s_n = 2;

  int64_t n_items = 0;
  ItemOut item;
  ws(c);
  if (c.p >= c.e || *c.p != '{') return -1;
  ++c.p;
  ws(c);
  bool done = c.p < c.e && *c.p == '}';
  if (done) ++c.p;
  while (!done) {
    ws(c);
    Span k;
    bool clean = true;
    if (!parse_string(c, &k, &clean)) return -1;
    ws(c);
    if (c.p >= c.e || *c.p != ':') return -1;
    ++c.p;
    if (key_eq(c, k, "metadata")) {
      ws(c);
      if (c.p >= c.e || *c.p != '{') {
        if (!skip_value(c, 0)) return -1;
      } else {
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == '}') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            Span mk;
            if (!parse_string(c, &mk, &clean)) return -1;
            ws(c);
            if (c.p >= c.e || *c.p != ':') return -1;
            ++c.p;
            ws(c);
            const bool is_rv = key_eq(c, mk, "resourceVersion");
            const bool is_cont = key_eq(c, mk, "continue");
            if ((is_rv || is_cont) && c.p < c.e && *c.p == '"') {
              Span v;
              if (!parse_string(c, &v, &clean)) return -1;
              const int slot = is_rv ? 0 : 1;
              c.s_start[slot] = v.a;
              c.s_end[slot] = v.b;
            } else if ((is_rv || is_cont) && is_null_ahead(c)) {
              c.p += 4;  // null continue/rv: same as absent
            } else if (is_rv || is_cont) {
              return -1;  // non-string list metadata: wholesale fallback
            } else {
              if (!skip_value(c, 0)) return -1;
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
            return -1;
          }
        }
      }
    } else if (key_eq(c, k, "items")) {
      ws(c);
      if (is_null_ahead(c)) {
        c.p += 4;  // "items": null => no items (the .get(..., []) path)
      } else {
        if (c.p >= c.e || *c.p != '[') return -1;
        ++c.p;
        ws(c);
        if (c.p < c.e && *c.p == ']') {
          ++c.p;
        } else {
          while (true) {
            ws(c);
            if (n_items >= item_cap) return -1;
            const int64_t span_a = c.p - c.base;
            const int64_t sb_keep = c.sb_pos;
            item.reset();
            if (!parse_item(c, kind, &item)) return -1;
            item_start[n_items] = span_a;
            item_end[n_items] = c.p - c.base;
            const int64_t pc_base =
                n_items * (kind == 0 ? 3 : 2);
            if (item.fb) {
              c.sb_pos = sb_keep;  // reclaim this item's string bytes
              item_flags[n_items] = 1;
              pair_counts[pc_base] = 0;
              pair_counts[pc_base + 1] = 0;
              if (kind == 0) pair_counts[pc_base + 2] = 0;
            } else {
              item_flags[n_items] = 0;
              if (!emit(c, item.name)) return -1;
              if (kind == 1) {
                if (!emit(c, item.ns)) return -1;
                if (!emit(c, item.node_name)) return -1;
              }
              for (const Span& s : item.annos)
                if (!emit(c, s)) return -1;
              if (kind == 0) {
                for (const Span& s : item.labels)
                  if (!emit(c, s)) return -1;
              }
              for (const Span& s : item.addrs)
                if (!emit(c, s)) return -1;
              pair_counts[pc_base] =
                  static_cast<int64_t>(item.annos.size()) / 2;
              if (kind == 0) {
                pair_counts[pc_base + 1] =
                    static_cast<int64_t>(item.labels.size()) / 2;
                pair_counts[pc_base + 2] =
                    static_cast<int64_t>(item.addrs.size()) / 2;
              } else {
                pair_counts[pc_base + 1] =
                    static_cast<int64_t>(item.addrs.size()) / 2;
              }
            }
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
            return -1;
          }
        }
      }
    } else {
      if (!skip_value(c, 0)) return -1;
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
    return -1;
  }
  if (c.malformed) return -1;
  *n_str_out = c.s_n;
  return n_items;
}

}  // extern "C"
