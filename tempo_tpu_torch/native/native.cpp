// Native host-side hot paths (ctypes shared library).
//
// The reference spends its write-path CPU in Go loops: per-span regrouping
// with fnv token hashing (`requestsByTraceID` modules/distributor/
// distributor.go:694-801, `TokenFor` pkg/util/hash.go:8) and protobuf
// unmarshalling of OTLP pushes. Here the same loops are C++: batched token
// hashing over a trace-id matrix, and a single-pass OTLP
// ExportTraceServiceRequest scanner that emits fixed-width span columns,
// a flattened attribute table, and byte ranges for the variable fields, so
// Python touches each span O(1) times instead of O(fields).
//
// The port's copy of `tempo_tpu/native/native.cpp`: the same C ABI and
// record layouts, so both packages stage the same bytes into the same
// records. Built by tempo_tpu_torch/native/__init__.py with g++ when that
// module is imported; no entry point has a Python fallback. The scanner's
// output contract matches the python decoder exactly (id lengths
// preserved, malformed input rejected, field order independent).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// --- crc32c (Castagnoli; kafka record batches) ------------------------------

static uint32_t kCrcTab[256];
static bool kCrcInit = [] {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        kCrcTab[i] = c;
    }
    return true;
}();

uint32_t crc32c(const uint8_t* data, int64_t n) {
    uint32_t crc = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++)
        crc = kCrcTab[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// --- fnv1 32 token hashing -------------------------------------------------

// out[i] = fnv1_32(tenant || tids[i*16..+16])  (hash.go TokenFor semantics)
void fnv1_tokens(const uint8_t* tenant, int64_t tenant_len,
                 const uint8_t* tids, int64_t n, int64_t width,
                 uint32_t* out) {
    uint32_t seed = 2166136261u;
    for (int64_t j = 0; j < tenant_len; j++) {
        seed = (seed * 16777619u) ^ (uint32_t)tenant[j];
    }
    for (int64_t i = 0; i < n; i++) {
        uint32_t h = seed;
        const uint8_t* row = tids + i * width;
        for (int64_t j = 0; j < width; j++) {
            h = (h * 16777619u) ^ (uint32_t)row[j];
        }
        out[i] = h;
    }
}

// --- protobuf wire scanning ------------------------------------------------

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok;
};

static inline uint64_t read_varint(Cursor& c) {
    uint64_t v = 0;
    int shift = 0;
    while (c.p < c.end && shift < 64) {
        uint8_t b = *c.p++;
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) return v;
        shift += 7;
    }
    c.ok = false;
    return 0;
}

// Skips a field payload; for wiretype 2 returns (start,len) via refs.
static inline bool read_field(Cursor& c, uint32_t& fnum, uint32_t& wt,
                              uint64_t& val, const uint8_t*& start,
                              uint64_t& len) {
    if (c.p >= c.end) return false;
    uint64_t tag = read_varint(c);
    if (!c.ok) return false;
    fnum = (uint32_t)(tag >> 3);
    wt = (uint32_t)(tag & 7);
    start = nullptr; len = 0; val = 0;
    switch (wt) {
        case 0: val = read_varint(c); return c.ok;
        case 1: if (c.end - c.p < 8) { c.ok = false; return false; }
                memcpy(&val, c.p, 8); c.p += 8; return true;
        case 2: len = read_varint(c);
                if (!c.ok || (uint64_t)(c.end - c.p) < len) { c.ok = false; return false; }
                start = c.p; c.p += len; return true;
        case 5: if (c.end - c.p < 4) { c.ok = false; return false; }
                { uint32_t v32; memcpy(&v32, c.p, 4); val = v32; }
                c.p += 4; return true;
        default: c.ok = false; return false;
    }
}

// Per-span output records. Offsets are into the original buffer. Layout is
// padding-free by construction (descending alignment) so numpy mirrors it
// with a packed structured dtype. Id *_len fields preserve the wire length
// (0 = absent; >16/8 = oversized, bytes not copied) so python can apply the
// exact python-decoder contract including invalid-id validation.
struct SpanRec {
    uint8_t  trace_id[16];
    uint8_t  span_id[8];
    uint8_t  parent_span_id[8];
    uint64_t start_ns, end_ns;
    int64_t  name_off;        // variable fields: byte ranges into the buffer
    int64_t  status_msg_off;
    int64_t  res_off;         // resource attr region (shared per batch)
    int64_t  span_off;        // full span message range
    int32_t  name_len, status_msg_len, res_len, span_len;
    int32_t  kind, status_code;
    int32_t  tid_len, sid_len, pid_len;
    int32_t  _pad;
};

// One span attribute (flattened across all spans). typ follows the AnyValue
// kinds: 1=string (sval range) 2=bool 3=int64 (exact, in ival) 4=double,
// 0=other (raw AnyValue bytes at sval range; python decodes).
struct AttrRec {
    int64_t key_off;
    int64_t sval_off;
    int64_t ival;
    double  fval;
    int32_t key_len, sval_len, typ, span_idx;
};

// Extracts one KeyValue message. Returns false on MALFORMED bytes (caller
// aborts the scan, matching the python decoder's ValueError); an absent key
// or value is valid and yields key_off/sval_off = -1.
static inline bool parse_keyvalue(const uint8_t* buf, const uint8_t* kv,
                                  uint64_t kvlen, int32_t span_idx,
                                  AttrRec& a) {
    Cursor c{kv, kv + kvlen, true};
    uint32_t f, w; uint64_t v, l; const uint8_t* s;
    a.key_off = -1; a.sval_off = -1; a.ival = 0; a.fval = 0;
    a.key_len = 0; a.sval_len = 0; a.typ = 0; a.span_idx = span_idx;
    const uint8_t* val_start = nullptr; uint64_t val_len = 0;
    while (read_field(c, f, w, v, s, l)) {
        if (f == 1 && w == 2) { a.key_off = s - buf; a.key_len = (int32_t)l; }
        else if (f == 2 && w == 2) { val_start = s; val_len = l; }
    }
    if (!c.ok) return false;
    if (val_start) {
        Cursor av{val_start, val_start + val_len, true};
        while (read_field(av, f, w, v, s, l)) {
            switch (f) {
                case 1: if (w == 2) { a.typ = 1; a.sval_off = s - buf; a.sval_len = (int32_t)l; } break;
                case 2: a.typ = 2; a.fval = v ? 1.0 : 0.0; break;
                case 3: a.typ = 3; a.ival = (int64_t)v; break;
                case 4: { a.typ = 4; double d; memcpy(&d, &v, 8); a.fval = d; } break;
                default:  // array/kvlist/bytes: raw AnyValue range for python
                    if (a.typ == 0) { a.sval_off = val_start - buf; a.sval_len = (int32_t)val_len; }
                    break;
            }
        }
        if (!av.ok) return false;
    }
    return true;
}

// Scans one Span message into r (+ appends attrs). Returns false on
// malformed input.
static bool scan_span(const uint8_t* buf, const uint8_t* s3, uint64_t l3,
                      const uint8_t* res_off, uint64_t res_len,
                      int64_t span_idx, SpanRec& r,
                      AttrRec* attrs_out, int64_t attr_cap,
                      int64_t& attr_count) {
    memset(&r, 0, sizeof(SpanRec));
    r.span_off = s3 - buf; r.span_len = (int32_t)l3;
    r.res_off = res_off ? res_off - buf : -1;
    r.res_len = (int32_t)res_len;
    Cursor sp{s3, s3 + l3, true};
    uint32_t f4, w4; uint64_t v4, l4; const uint8_t* s4;
    while (read_field(sp, f4, w4, v4, s4, l4)) {
        if ((f4 <= 5 || f4 == 9 || f4 == 15) && w4 != 2) continue;
        switch (f4) {
            case 1: r.tid_len = (int32_t)l4;
                    if (l4 <= 16) memcpy(r.trace_id, s4, l4); break;
            case 2: r.sid_len = (int32_t)l4;
                    if (l4 <= 8) memcpy(r.span_id, s4, l4); break;
            case 4: r.pid_len = (int32_t)l4;
                    if (l4 <= 8) memcpy(r.parent_span_id, s4, l4); break;
            case 5: r.name_off = s4 - buf; r.name_len = (int32_t)l4; break;
            case 6: r.kind = (int32_t)v4; break;
            case 7: r.start_ns = v4; break;
            case 8: r.end_ns = v4; break;
            case 9: {
                AttrRec a;  // always validate, store only if room
                if (!parse_keyvalue(buf, s4, l4, (int32_t)span_idx, a))
                    return false;
                if (attr_count < attr_cap)
                    attrs_out[attr_count] = a;
                attr_count++;
                break;
            }
            case 15: {            // Status{message=2,code=3}
                Cursor st{s4, s4 + l4, true};
                uint32_t f5, w5; uint64_t v5, l5; const uint8_t* s5;
                while (read_field(st, f5, w5, v5, s5, l5)) {
                    if (f5 == 2 && w5 == 2) { r.status_msg_off = s5 - buf; r.status_msg_len = (int32_t)l5; }
                    else if (f5 == 3) r.status_code = (int32_t)v5;
                }
                if (!st.ok) return false;
                break;
            }
            default: break;
        }
    }
    return sp.ok;
}

// Scans an ExportTraceServiceRequest. Fills up to cap SpanRec entries and
// up to attr_cap AttrRec entries. n_attrs_out receives the total attr
// count (may exceed attr_cap). Returns the total span count (may exceed
// cap; caller re-calls with bigger buffers), or -1 on malformed input.
// Field order independent: each ResourceSpans is scanned twice, first for
// the Resource, then for its ScopeSpans.
int64_t otlp_scan2(const uint8_t* buf, int64_t buflen,
                   SpanRec* out, int64_t cap,
                   AttrRec* attrs_out, int64_t attr_cap,
                   int64_t* n_attrs_out) {
    Cursor top{buf, buf + buflen, true};
    int64_t count = 0, attr_count = 0;
    uint32_t fnum, wt; uint64_t val, len; const uint8_t* start;
    while (read_field(top, fnum, wt, val, start, len)) {
        if (fnum != 1 || wt != 2) continue;          // ResourceSpans
        // pass 1: locate the Resource (it may come after the spans)
        const uint8_t* res_off = nullptr; uint64_t res_len = 0;
        uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
        Cursor rs1{start, start + len, true};
        while (read_field(rs1, f2, w2, v2, s2, l2)) {
            if (f2 == 1 && w2 == 2) { res_off = s2; res_len = l2; }
        }
        if (!rs1.ok) return -1;
        // pass 2: spans
        Cursor rs{start, start + len, true};
        while (read_field(rs, f2, w2, v2, s2, l2)) {
            if (f2 != 2 || w2 != 2) continue;         // ScopeSpans
            Cursor ss{s2, s2 + l2, true};
            uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
            while (read_field(ss, f3, w3, v3, s3, l3)) {
                if (f3 != 2 || w3 != 2) continue;     // Span
                if (count < cap) {
                    if (!scan_span(buf, s3, l3, res_off, res_len, count,
                                   out[count], attrs_out, attr_cap,
                                   attr_count))
                        return -1;
                }
                count++;
            }
            if (!ss.ok) return -1;
        }
        if (!rs.ok) return -1;
    }
    if (!top.ok) return -1;
    *n_attrs_out = attr_count;
    return count;
}

// Back-compat single-output scan (no attribute extraction).
int64_t otlp_scan(const uint8_t* buf, int64_t buflen,
                  SpanRec* out, int64_t cap) {
    int64_t n_attrs = 0;
    return otlp_scan2(buf, buflen, out, cap, nullptr, 0, &n_attrs);
}

}  // extern "C"

// --- parallel scan -----------------------------------------------------------
//
// The distributor's scan is the serial floor of the tee path (SURVEY §3.1
// hot loop ①). ResourceSpans are independent, so: one cheap sequential
// pass walks ONLY message headers to count spans per ResourceSpans (span
// bodies are skipped by length), then a prefix sum fixes each range's
// output base and worker threads deep-scan their ranges into disjoint
// slices. Output order is identical to the sequential scan.

namespace {

struct RsRange {
    const uint8_t* start; uint64_t len;
    const uint8_t* res_off; uint64_t res_len;
    int64_t out_base; int64_t span_count;
};

// Count spans in one ResourceSpans by walking headers only.
static int64_t count_spans_rs(const uint8_t* start, uint64_t len) {
    Cursor rs{start, start + len, true};
    uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
    int64_t n = 0;
    while (read_field(rs, f2, w2, v2, s2, l2)) {
        if (f2 != 2 || w2 != 2) continue;          // ScopeSpans
        Cursor ss{s2, s2 + l2, true};
        uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
        while (read_field(ss, f3, w3, v3, s3, l3)) {
            if (f3 == 2 && w3 == 2) n++;
        }
        if (!ss.ok) return -1;
    }
    return rs.ok ? n : -1;
}

// Deep-scan one ResourceSpans into out[r.out_base...].
static bool scan_rs_range(const uint8_t* buf, const RsRange& r,
                          SpanRec* out) {
    Cursor rs{r.start, r.start + r.len, true};
    uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
    int64_t k = r.out_base;
    int64_t attr_count = 0;
    while (read_field(rs, f2, w2, v2, s2, l2)) {
        if (f2 != 2 || w2 != 2) continue;
        Cursor ss{s2, s2 + l2, true};
        uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
        while (read_field(ss, f3, w3, v3, s3, l3)) {
            if (f3 != 2 || w3 != 2) continue;
            if (!scan_span(buf, s3, l3, r.res_off, r.res_len, k, out[k],
                           nullptr, 0, attr_count))
                return false;
            k++;
        }
        if (!ss.ok) return false;
    }
    return rs.ok;
}

}  // namespace

extern "C" {

// Parallel variant of otlp_scan (no attribute extraction). Returns the
// total span count (caller re-calls with a bigger buffer when > cap) or
// -1 on malformed input. Falls back to single-threaded scanning when the
// payload has too few ResourceSpans to split.
int64_t otlp_scan_mt(const uint8_t* buf, int64_t buflen,
                     SpanRec* out, int64_t cap, int32_t n_threads) {
    std::vector<RsRange> ranges;
    Cursor top{buf, buf + buflen, true};
    uint32_t fnum, wt; uint64_t val, len; const uint8_t* start;
    int64_t total = 0;
    while (read_field(top, fnum, wt, val, start, len)) {
        if (fnum != 1 || wt != 2) continue;
        RsRange r{start, len, nullptr, 0, 0, 0};
        Cursor rs1{start, start + len, true};
        uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
        while (read_field(rs1, f2, w2, v2, s2, l2)) {
            if (f2 == 1 && w2 == 2) { r.res_off = s2; r.res_len = l2; }
        }
        if (!rs1.ok) return -1;
        r.span_count = count_spans_rs(start, len);
        if (r.span_count < 0) return -1;
        r.out_base = total;
        total += r.span_count;
        ranges.push_back(r);
    }
    if (!top.ok) return -1;
    if (total > cap) return total;                 // caller regrows
    if (n_threads < 2 || ranges.size() < 2 || total < 4096) {
        for (const RsRange& r : ranges)
            if (!scan_rs_range(buf, r, out)) return -1;
        return total;
    }
    int nt = (int)std::min<size_t>(n_threads, ranges.size());
    std::atomic<bool> bad{false};
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; t++) {
        threads.emplace_back([&, t]() {
            for (size_t i = t; i < ranges.size(); i += nt) {
                if (bad.load(std::memory_order_relaxed)) return;
                if (!scan_rs_range(buf, ranges[i], out))
                    bad.store(true, std::memory_order_relaxed);
            }
        });
    }
    for (auto& th : threads) th.join();
    return bad.load() ? -1 : total;
}

// --- span events / links ----------------------------------------------------
// Separate pass extracting Span.events (field 11) and Span.links (field 13)
// keyed by span index (same traversal order as otlp_scan2), so the common
// eventless payload pays nothing on the main scan.

struct EvRec {
    int64_t name_off;
    uint64_t time_ns;
    int32_t name_len;
    int32_t span_idx;
};

struct LinkRec {
    uint8_t trace_id[16];
    uint8_t span_id[8];
    int32_t span_idx;
    int32_t tid_len, sid_len, _pad;
};

// Returns 0 ok / -1 malformed. Counts written to n_out[0]=events,
// n_out[1]=links (may exceed caps; caller re-calls with bigger buffers).
int32_t otlp_events(const uint8_t* buf, int64_t buflen,
                    EvRec* evs, int64_t ecap,
                    LinkRec* links, int64_t lcap, int64_t* n_out) {
    Cursor top{buf, buf + buflen, true};
    uint32_t f, w; uint64_t v, len; const uint8_t* start;
    int64_t span_idx = -1, ne = 0, nl = 0;
    while (read_field(top, f, w, v, start, len)) {
        if (f != 1 || w != 2) continue;            // ResourceSpans
        Cursor rs{start, start + len, true};
        uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
        while (read_field(rs, f2, w2, v2, s2, l2)) {
            if (f2 != 2 || w2 != 2) continue;      // ScopeSpans
            Cursor ss{s2, s2 + l2, true};
            uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
            while (read_field(ss, f3, w3, v3, s3, l3)) {
                if (f3 != 2 || w3 != 2) continue;  // Span
                span_idx++;
                Cursor sp{s3, s3 + l3, true};
                uint32_t f4, w4; uint64_t v4, l4; const uint8_t* s4;
                while (read_field(sp, f4, w4, v4, s4, l4)) {
                    if (f4 == 11 && w4 == 2) {     // Event
                        EvRec e{-1, 0, 0, (int32_t)span_idx};
                        Cursor ev{s4, s4 + l4, true};
                        uint32_t f5, w5; uint64_t v5, l5; const uint8_t* s5;
                        while (read_field(ev, f5, w5, v5, s5, l5)) {
                            if (f5 == 1 && w5 != 2) e.time_ns = v5;
                            else if (f5 == 2 && w5 == 2) {
                                e.name_off = s5 - buf;
                                e.name_len = (int32_t)l5;
                            }
                        }
                        if (!ev.ok) return -1;
                        if (ne < ecap) evs[ne] = e;
                        ne++;
                    } else if (f4 == 13 && w4 == 2) {   // Link
                        LinkRec lk;
                        memset(&lk, 0, sizeof(lk));
                        lk.span_idx = (int32_t)span_idx;
                        Cursor ln{s4, s4 + l4, true};
                        uint32_t f5, w5; uint64_t v5, l5; const uint8_t* s5;
                        while (read_field(ln, f5, w5, v5, s5, l5)) {
                            if (f5 == 1 && w5 == 2) {
                                lk.tid_len = (int32_t)l5;
                                if (l5 <= 16) memcpy(lk.trace_id, s5, l5);
                            } else if (f5 == 2 && w5 == 2) {
                                lk.sid_len = (int32_t)l5;
                                if (l5 <= 8) memcpy(lk.span_id, s5, l5);
                            }
                        }
                        if (!ln.ok) return -1;
                        if (nl < lcap) links[nl] = lk;
                        nl++;
                    }
                }
                if (!sp.ok) return -1;
            }
            if (!ss.ok) return -1;
        }
        if (!rs.ok) return -1;
    }
    if (!top.ok) return -1;
    n_out[0] = ne; n_out[1] = nl;
    return 0;
}

}  // extern "C"

// --- persistent string interner --------------------------------------------
//
// The host-side dictionary behind tempo_tpu.model.interner.StringInterner:
// bytes -> dense int32 id, append-only, with a string arena so Python can
// lazily mirror id -> string. Replaces the per-unique-string Python loops
// of the staging path (VERDICT r2: `_intern_ranges`' per-length passes and
// the registry's per-row dict work dominated e2e ingest). Analog of the
// reference's LabelValueCombo hashing (`registry/hash.go`), but shared by
// every string column.

namespace {

static inline uint64_t fnv1a64(const uint8_t* p, int64_t n) {
    uint64_t h = 0xCBF29CE484222325ull;
    for (int64_t i = 0; i < n; i++) h = (h ^ p[i]) * 0x100000001B3ull;
    return h;
}

struct StrEntry {
    int64_t off;
    int32_t len;
    uint64_t hash;
};

struct Interner {
    std::mutex mu;
    std::vector<uint8_t> arena;
    std::vector<StrEntry> entries;          // id -> entry
    std::vector<int32_t> table;             // open addressing, -1 empty
    uint64_t mask = 0;

    Interner() {
        table.assign(1 << 12, -1);
        mask = table.size() - 1;
    }

    void grow() {
        std::vector<int32_t> nt(table.size() * 2, -1);
        uint64_t nmask = nt.size() - 1;
        for (int32_t id = 0; id < (int32_t)entries.size(); id++) {
            uint64_t i = entries[id].hash & nmask;
            while (nt[i] != -1) i = (i + 1) & nmask;
            nt[i] = id;
        }
        table.swap(nt);
        mask = nmask;
    }

    // lookup-or-insert; lock held by caller
    int32_t intern_locked(const uint8_t* s, int64_t len) {
        uint64_t h = fnv1a64(s, len);
        uint64_t i = h & mask;
        while (true) {
            int32_t id = table[i];
            if (id == -1) break;
            const StrEntry& e = entries[id];
            if (e.hash == h && e.len == len &&
                memcmp(arena.data() + e.off, s, len) == 0)
                return id;
            i = (i + 1) & mask;
        }
        int32_t id = (int32_t)entries.size();
        StrEntry e{(int64_t)arena.size(), (int32_t)len, h};
        arena.insert(arena.end(), s, s + len);
        entries.push_back(e);
        table[i] = id;
        if (entries.size() * 10 > table.size() * 7) grow();
        return id;
    }

    // lookup only; -1 when absent. lock held by caller.
    int32_t find_locked(const uint8_t* s, int64_t len) const {
        uint64_t h = fnv1a64(s, len);
        uint64_t i = h & mask;
        while (true) {
            int32_t id = table[i];
            if (id == -1) return -1;
            const StrEntry& e = entries[id];
            if (e.hash == h && e.len == len &&
                memcmp(arena.data() + e.off, s, len) == 0)
                return id;
            i = (i + 1) & mask;
        }
    }
};

// --- fixed-width key grouping ----------------------------------------------
//
// Group n fixed-width byte keys (e.g. the distributor's padded trace id +
// length byte, `requestsByTraceID` distributor.go:694) into first-occurrence
// order: inverse[i] = dense group id, first_idx[g] = row of g's first
// occurrence. One O(n) hash pass replaces numpy's void-view unique (an
// O(n log n) memcmp argsort that dominated the tee-path profile).

}  // namespace

extern "C" {

int64_t group_keys(const uint8_t* keys, int64_t n, int32_t key_len,
                   int32_t* inverse, int32_t* first_idx) {
    if (n <= 0) return 0;
    uint64_t cap = 64;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int32_t> table(cap, -1);   // slot -> group id
    uint64_t mask = cap - 1;
    int64_t n_groups = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* k = keys + r * key_len;
        uint64_t h = fnv1a64(k, key_len);
        uint64_t i = h & mask;
        while (true) {
            int32_t g = table[i];
            if (g == -1) {
                table[i] = (int32_t)n_groups;
                first_idx[n_groups] = (int32_t)r;
                inverse[r] = (int32_t)n_groups;
                n_groups++;
                break;
            }
            if (memcmp(keys + (int64_t)first_idx[g] * key_len, k,
                       key_len) == 0) {
                inverse[r] = g;
                break;
            }
            i = (i + 1) & mask;
        }
    }
    return n_groups;
}

void* interner_new() { return new Interner(); }
void interner_free(void* h) { delete (Interner*)h; }

int32_t interner_intern(void* h, const uint8_t* s, int64_t len) {
    Interner* it = (Interner*)h;
    std::lock_guard<std::mutex> g(it->mu);
    return it->intern_locked(s, len);
}

int32_t interner_find(void* h, const uint8_t* s, int64_t len) {
    Interner* it = (Interner*)h;
    std::lock_guard<std::mutex> g(it->mu);
    return it->find_locked(s, len);
}

int64_t interner_count(void* h) {
    Interner* it = (Interner*)h;
    std::lock_guard<std::mutex> g(it->mu);
    return (int64_t)it->entries.size();
}

// Copy strings [first, first+n) as concatenated bytes + lengths so Python
// can mirror the id->string table incrementally. Returns total bytes
// copied, or -needed when out_cap is too small (caller re-calls).
int64_t interner_dump(void* h, int32_t first, int32_t n,
                      uint8_t* out, int64_t out_cap, int32_t* lens) {
    Interner* it = (Interner*)h;
    std::lock_guard<std::mutex> g(it->mu);
    if (first < 0 || first + n > (int64_t)it->entries.size()) return -1;
    int64_t need = 0;
    for (int32_t i = 0; i < n; i++) need += it->entries[first + i].len;
    if (need > out_cap) return -need;
    int64_t o = 0;
    for (int32_t i = 0; i < n; i++) {
        const StrEntry& e = it->entries[first + i];
        memcpy(out + o, it->arena.data() + e.off, e.len);
        lens[i] = e.len;
        o += e.len;
    }
    return o;
}

}  // extern "C"

// --- persistent label-row table ---------------------------------------------
//
// [n_labels] int32 rows -> slot id; the series-resolution hot path
// (`registry/series.py lookup_or_create`). Python keeps slot lifecycle
// (free list, budget, staleness); this table only answers "which slot is
// this row" at C speed. Unseen rows are assigned a PENDING marker so each
// distinct new row is reported once; Python either inserts a real slot or
// removes the pending entry (budget rejection).

namespace {

constexpr int32_t kPending = -2;

struct RowTable {
    std::mutex mu;
    int32_t n_labels;
    std::vector<int32_t> rows;       // entry i -> rows[i*n_labels ..]
    std::vector<int32_t> slots;      // entry i -> slot id, kPending, or -3
    std::vector<int32_t> table;      // open addressing over entries
    std::vector<uint64_t> hashes;
    std::vector<int32_t> free_entries;  // tombstoned entry ids for reuse
    uint64_t mask;
    int64_t live = 0;
    int64_t cells = 0;   // occupied index cells (live + stale duplicates)

    explicit RowTable(int32_t nl) : n_labels(nl) {
        table.assign(1 << 10, -1);
        mask = table.size() - 1;
    }

    // Rebuild the index from live entries (dropping stale cells left by
    // tombstone reuse); doubles only when genuinely dense.
    void grow() {
        size_t nsize = table.size();
        if (live * 10 > (int64_t)nsize * 5) nsize *= 2;
        std::vector<int32_t> nt(nsize, -1);
        uint64_t nmask = nt.size() - 1;
        for (int32_t e = 0; e < (int32_t)hashes.size(); e++) {
            if (slots[e] == -3) continue;          // tombstone
            uint64_t i = hashes[e] & nmask;
            while (nt[i] != -1) i = (i + 1) & nmask;
            nt[i] = e;
        }
        table.swap(nt);
        mask = nmask;
        cells = live;
    }

    inline uint64_t rhash(const int32_t* row) const {
        return fnv1a64((const uint8_t*)row, n_labels * 4);
    }

    // find entry index or -1; lock held
    int32_t find_entry(const int32_t* row, uint64_t h) const {
        uint64_t i = h & mask;
        while (true) {
            int32_t e = table[i];
            if (e == -1) return -1;
            if (hashes[e] == h && slots[e] != -3 &&
                memcmp(rows.data() + (int64_t)e * n_labels, row,
                       n_labels * 4) == 0)
                return e;
            i = (i + 1) & mask;
        }
    }

    int32_t add_entry(const int32_t* row, uint64_t h, int32_t slot) {
        int32_t e;
        if (!free_entries.empty()) {
            e = free_entries.back();
            free_entries.pop_back();
            memcpy(rows.data() + (int64_t)e * n_labels, row, n_labels * 4);
            hashes[e] = h;
            slots[e] = slot;
        } else {
            e = (int32_t)hashes.size();
            rows.insert(rows.end(), row, row + n_labels);
            hashes.push_back(h);
            slots.push_back(slot);
        }
        uint64_t i = h & mask;
        while (table[i] != -1) i = (i + 1) & mask;
        table[i] = e;
        live++;
        cells++;
        if (cells * 10 > (int64_t)table.size() * 7) grow();
        return e;
    }
};

}  // namespace

extern "C" {

void* rowtable_new(int32_t n_labels) { return new RowTable(n_labels); }
void rowtable_free(void* h) { delete (RowTable*)h; }

// Resolve n rows to slots. valid may be null (all valid). Rows not in the
// table get PENDING entries (deduped within the call) and out_slots=-1;
// the first-occurrence index of each new distinct row is appended to
// miss_idx. Returns the miss count. CONTRACT: pass miss_cap >= n (misses
// can never exceed n), and resolve every reported miss (rowtable_insert
// or rowtable_remove) before the next lookup — leftover pending entries
// would resolve to -1 forever without being re-reported.
int64_t rowtable_lookup(void* h, const int32_t* rows_in, int64_t n,
                        const uint8_t* valid, int32_t* out_slots,
                        int64_t* miss_idx, int64_t miss_cap) {
    RowTable* t = (RowTable*)h;
    std::lock_guard<std::mutex> g(t->mu);
    int64_t miss = 0;
    for (int64_t i = 0; i < n; i++) {
        if (valid && !valid[i]) { out_slots[i] = -1; continue; }
        const int32_t* row = rows_in + i * t->n_labels;
        uint64_t hh = t->rhash(row);
        int32_t e = t->find_entry(row, hh);
        if (e == -1) {
            t->add_entry(row, hh, kPending);
            if (miss < miss_cap) miss_idx[miss] = i;
            miss++;
            out_slots[i] = -1;
        } else if (t->slots[e] == kPending) {
            // duplicate of a pending row within this batch: already
            // reported; stays -1 until Python assigns the slot
            out_slots[i] = -1;
        } else {
            out_slots[i] = t->slots[e];
        }
    }
    return miss;
}

// Assign a real slot to a row (overwrites pending or inserts fresh).
void rowtable_insert(void* h, const int32_t* row, int32_t slot) {
    RowTable* t = (RowTable*)h;
    std::lock_guard<std::mutex> g(t->mu);
    uint64_t hh = t->rhash(row);
    int32_t e = t->find_entry(row, hh);
    if (e == -1) t->add_entry(row, hh, slot);
    else t->slots[e] = slot;
}

// Remove a row (budget-rejected pending entry, or stale-purged series).
// Tombstones the entry for reuse; its index cell stays until grow()
// (stale cells only add probe steps — lookups check entry liveness).
void rowtable_remove(void* h, const int32_t* row) {
    RowTable* t = (RowTable*)h;
    std::lock_guard<std::mutex> g(t->mu);
    uint64_t hh = t->rhash(row);
    int32_t e = t->find_entry(row, hh);
    if (e != -1) {
        t->slots[e] = -3;
        t->free_entries.push_back(e);
        t->live--;
    }
}

int64_t rowtable_size(void* h) {
    RowTable* t = (RowTable*)h;
    std::lock_guard<std::mutex> g(t->mu);
    return t->live;
}

}  // extern "C"

// --- one-pass OTLP -> interned columns (otlp_stage) --------------------------
//
// The full staging kernel: OTLP ExportTraceServiceRequest bytes in, dense
// intern-id columns out. Combines the wire scan with dictionary encoding so
// Python never touches per-span or per-unique-string data on the generator
// ingest path (`modules/generator/generator.go:275` PushSpans analog; the
// distributor regroup stays on otlp_scan2). Non-scalar AnyValues (arrays,
// kvlists, bytes) keep their byte ranges for a rare Python fixup pass.

// Per-span staged record: fixed columns + intern ids. Padding-free
// (descending alignment); mirrored by STAGE_REC_DTYPE in __init__.py.
struct StageRec {
    uint8_t  trace_id[16];
    uint8_t  span_id[8];
    uint8_t  parent_span_id[8];
    uint64_t start_ns, end_ns;
    int32_t  name_id, status_msg_id;   // status_msg_id = -1 when absent
    int32_t  service_id, res_idx;      // resource of this span
    int32_t  kind, status_code;
    int32_t  span_len;                 // wire size (size_total accounting)
    int32_t  tid_len, sid_len, pid_len;
};

// One staged attribute (span- or resource-scope). typ follows the ATTR_*
// enums of model/span_batch.py: 1=string 2=bool 3=int 4=double; 0=other
// (sval_off/len point at the raw AnyValue; Python stringifies + interns).
struct StageAttr {
    int64_t sval_off;
    int64_t ival;
    double  fval;
    int32_t sval_len;
    int32_t key_id;
    int32_t sval_id;                   // -1 unless typ==1
    int32_t typ;
    int32_t owner;                     // span idx or resource idx
    int32_t _pad;
};

// One distinct Resource (per ResourceSpans entry, position-deduped like the
// Python path): service.name id + its attr range in the res-attr output.
struct StageRes {
    int32_t service_id;                // id of "" when absent
    int32_t attr_start, attr_count;    // range into res attrs (pre-cap)
    int32_t _pad;
};

namespace {

// Thread-local intern memo: payloads repeat a handful of strings (span
// names, service names, status messages) thousands of times; each worker
// resolves repeats from its private table and takes the global interner
// mutex only on a local miss (~|unique strings| times per thread), so the
// parallel stage is not serialized on the interner lock.
struct LocalIntern {
    struct E { uint64_t h; int64_t off; int32_t len; int32_t id; };
    std::vector<E> tab;
    uint64_t mask;
    Interner* it;
    const uint8_t* base;

    LocalIntern(Interner* i, const uint8_t* b) : it(i), base(b) {
        tab.assign(1 << 10, E{0, 0, 0, -1});
        mask = tab.size() - 1;
    }

    int32_t get(const uint8_t* s, int64_t len) {
        uint64_t h = fnv1a64(s, len);
        uint64_t i = h & mask;
        int probes = 0;
        while (probes++ < 32) {
            E& e = tab[i];
            if (e.id == -1) {
                int32_t id;
                {
                    std::lock_guard<std::mutex> g(it->mu);
                    id = it->intern_locked(s, len);
                }
                e = E{h, s - base, (int32_t)len, id};
                return id;
            }
            if (e.h == h && e.len == len &&
                memcmp(base + e.off, s, len) == 0)
                return e.id;
            i = (i + 1) & mask;
        }
        // pathological collision chain: fall back to the global table
        std::lock_guard<std::mutex> g(it->mu);
        return it->intern_locked(s, len);
    }
};

struct StageCtx {
    Interner* it;
    const uint8_t* buf;
    StageRec* spans; int64_t span_cap; int64_t n_spans = 0;
    StageAttr* sattrs; int64_t sattr_cap; int64_t n_sattrs = 0;
    StageAttr* rattrs; int64_t rattr_cap; int64_t n_rattrs = 0;
    StageRes* res; int64_t res_cap; int64_t n_res = 0;
    int32_t empty_id;
    int32_t svc_key_id;                // id of "service.name"
    LocalIntern* local = nullptr;      // set on parallel workers only

    // serial path: caller holds it->mu for the whole pass;
    // parallel path: LocalIntern takes it per local miss
    int32_t intern(const uint8_t* s, int64_t len) {
        return local ? local->get(s, len) : it->intern_locked(s, len);
    }
};

// Parse one KeyValue into a StageAttr (interning key + string value).
// Returns false on malformed bytes.
static bool stage_keyvalue(StageCtx& c, const uint8_t* kv, uint64_t kvlen,
                           int32_t owner, StageAttr& a) {
    Cursor cur{kv, kv + kvlen, true};
    uint32_t f, w; uint64_t v, l; const uint8_t* s;
    a.sval_off = -1; a.ival = 0; a.fval = 0; a.sval_len = 0;
    a.key_id = c.empty_id; a.sval_id = -1; a.typ = 0; a.owner = owner;
    a._pad = 0;
    const uint8_t* val_start = nullptr; uint64_t val_len = 0;
    while (read_field(cur, f, w, v, s, l)) {
        if (f == 1 && w == 2) a.key_id = c.intern(s, l);
        else if (f == 2 && w == 2) { val_start = s; val_len = l; }
    }
    if (!cur.ok) return false;
    if (val_start) {
        Cursor av{val_start, val_start + val_len, true};
        while (read_field(av, f, w, v, s, l)) {
            switch (f) {
                case 1: if (w == 2) {
                            a.typ = 1;
                            a.sval_id = c.intern(s, l);
                            a.sval_off = s - c.buf;
                            a.sval_len = (int32_t)l;
                        } break;
                case 2: a.typ = 2; a.fval = v ? 1.0 : 0.0; break;
                case 3: a.typ = 3; a.ival = (int64_t)v; break;
                case 4: { a.typ = 4; double d; memcpy(&d, &v, 8); a.fval = d; } break;
                default:
                    if (a.typ == 0) {
                        a.sval_off = val_start - c.buf;
                        a.sval_len = (int32_t)val_len;
                    }
                    break;
            }
        }
        if (!av.ok) return false;
    }
    return true;
}

// Parse a Resource message: intern its attrs, find service.name.
static bool stage_resource(StageCtx& c, const uint8_t* rm, uint64_t rmlen,
                           StageRes& r) {
    r.service_id = c.empty_id;
    r.attr_start = (int32_t)c.n_rattrs;
    r.attr_count = 0;
    r._pad = 0;
    if (!rm) return true;
    Cursor cur{rm, rm + rmlen, true};
    uint32_t f, w; uint64_t v, l; const uint8_t* s;
    while (read_field(cur, f, w, v, s, l)) {
        if (f != 1 || w != 2) continue;            // Resource.attributes
        StageAttr a;
        if (!stage_keyvalue(c, s, l, (int32_t)c.n_res, a)) return false;
        if (c.n_rattrs < c.rattr_cap) c.rattrs[c.n_rattrs] = a;
        c.n_rattrs++;
        r.attr_count++;
        if (a.key_id == c.svc_key_id && a.typ == 1)
            r.service_id = a.sval_id;
    }
    return cur.ok;
}

static bool stage_span(StageCtx& c, const uint8_t* sp, uint64_t splen,
                       int32_t res_idx, int32_t service_id,
                       bool skip_attrs, bool trust_attrs) {
    StageRec rec;
    memset(&rec, 0, sizeof(rec));
    rec.name_id = c.empty_id;
    rec.status_msg_id = -1;
    rec.service_id = service_id;
    rec.res_idx = res_idx;
    rec.span_len = (int32_t)splen;
    int32_t span_idx = (int32_t)c.n_spans;
    Cursor cur{sp, sp + splen, true};
    uint32_t f, w; uint64_t v, l; const uint8_t* s;
    while (read_field(cur, f, w, v, s, l)) {
        if ((f <= 5 || f == 9 || f == 15) && w != 2) continue;
        switch (f) {
            case 1: rec.tid_len = (int32_t)l;
                    if (l <= 16) memcpy(rec.trace_id, s, l); break;
            case 2: rec.sid_len = (int32_t)l;
                    if (l <= 8) memcpy(rec.span_id, s, l); break;
            case 4: rec.pid_len = (int32_t)l;
                    if (l <= 8) memcpy(rec.parent_span_id, s, l); break;
            case 5: rec.name_id = c.intern(s, l); break;
            case 6: if (w == 0) rec.kind = (int32_t)v; break;
            case 7: if (w != 2) rec.start_ns = v; break;
            case 8: if (w != 2) rec.end_ns = v; break;
            case 9: {
                if (skip_attrs) {
                    // caller's processors never read span attrs. When the
                    // bytes were already validated upstream in-process
                    // (the distributor's scan — trust_attrs), skip even
                    // the validation walk; else validate without
                    // interning or storing
                    if (!trust_attrs) {
                        AttrRec scratch;
                        if (!parse_keyvalue(c.buf, s, l, span_idx, scratch))
                            return false;
                    }
                    break;
                }
                StageAttr a;
                if (!stage_keyvalue(c, s, l, span_idx, a)) return false;
                if (c.n_sattrs < c.sattr_cap) c.sattrs[c.n_sattrs] = a;
                c.n_sattrs++;
                break;
            }
            case 15: {
                Cursor st{s, s + l, true};
                uint32_t f5, w5; uint64_t v5, l5; const uint8_t* s5;
                while (read_field(st, f5, w5, v5, s5, l5)) {
                    if (f5 == 2 && w5 == 2)
                        rec.status_msg_id = c.intern(s5, l5);
                    else if (f5 == 3) rec.status_code = (int32_t)v5;
                }
                if (!st.ok) return false;
                break;
            }
            default: break;
        }
    }
    if (!cur.ok) return false;
    if (c.n_spans < c.span_cap) c.spans[c.n_spans] = rec;
    c.n_spans++;
    return true;
}

}  // namespace

extern "C" {

// Full staging pass. Returns 0 on success, -1 on malformed input. Counts
// (which may exceed the caps; caller re-calls with bigger buffers and a
// FRESH scan) are written to n_out[0..3] = spans, span_attrs, res_attrs,
// resources. Interning is idempotent so a re-scan is safe.
// flags bit 0: skip span attrs (validate only — no interning, no output;
// the dominant per-span cost when the caller's processors read only
// intrinsic dimensions).
int32_t otlp_stage(void* interner, const uint8_t* buf, int64_t buflen,
                   StageRec* spans, int64_t span_cap,
                   StageAttr* sattrs, int64_t sattr_cap,
                   StageAttr* rattrs, int64_t rattr_cap,
                   StageRes* res, int64_t res_cap,
                   int32_t flags, int64_t* n_out) {
    Interner* it = (Interner*)interner;
    std::lock_guard<std::mutex> g(it->mu);
    StageCtx c;
    c.it = it; c.buf = buf;
    c.spans = spans; c.span_cap = span_cap;
    c.sattrs = sattrs; c.sattr_cap = sattr_cap;
    c.rattrs = rattrs; c.rattr_cap = rattr_cap;
    c.res = res; c.res_cap = res_cap;
    static const uint8_t kEmpty = 0;
    c.empty_id = it->intern_locked(&kEmpty, 0);
    c.svc_key_id = it->intern_locked((const uint8_t*)"service.name", 12);

    Cursor top{buf, buf + buflen, true};
    uint32_t f, w; uint64_t v, len; const uint8_t* start;
    while (read_field(top, f, w, v, start, len)) {
        if (f != 1 || w != 2) continue;            // ResourceSpans
        const uint8_t* rm = nullptr; uint64_t rmlen = 0;
        uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
        Cursor rs1{start, start + len, true};
        while (read_field(rs1, f2, w2, v2, s2, l2)) {
            if (f2 == 1 && w2 == 2) { rm = s2; rmlen = l2; }
        }
        if (!rs1.ok) return -1;
        StageRes r;
        if (!stage_resource(c, rm, rmlen, r)) return -1;
        int32_t res_idx = (int32_t)c.n_res;
        if (c.n_res < c.res_cap) c.res[c.n_res] = r;
        c.n_res++;
        Cursor rs{start, start + len, true};
        while (read_field(rs, f2, w2, v2, s2, l2)) {
            if (f2 != 2 || w2 != 2) continue;      // ScopeSpans
            Cursor ss{s2, s2 + l2, true};
            uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
            while (read_field(ss, f3, w3, v3, s3, l3)) {
                if (f3 != 2 || w3 != 2) continue;  // Span
                if (!stage_span(c, s3, l3, res_idx, r.service_id,
                                (flags & 1) != 0, (flags & 2) != 0))
                    return -1;
            }
            if (!ss.ok) return -1;
        }
        if (!rs.ok) return -1;
    }
    if (!top.ok) return -1;
    n_out[0] = c.n_spans; n_out[1] = c.n_sattrs;
    n_out[2] = c.n_rattrs; n_out[3] = c.n_res;
    return 0;
}

// Parallel staging for the skip-attrs shape (the generator's default:
// processors read only intrinsic dimensions). A sequential prelude stages
// Resources and counts spans per ResourceSpans (header walk only); worker
// threads then deep-stage disjoint output ranges with thread-local intern
// memos (LocalIntern) in front of the shared interner. Output order is
// identical to the sequential stage. Returns -1 malformed, 0 ok; when the
// span count exceeds span_cap only counts are written (caller regrows and
// re-calls — interning is idempotent).
int32_t otlp_stage_mt(void* interner, const uint8_t* buf, int64_t buflen,
                      StageRec* spans, int64_t span_cap,
                      StageAttr* rattrs, int64_t rattr_cap,
                      StageRes* res, int64_t res_cap,
                      int32_t flags, int64_t* n_out, int32_t n_threads) {
    if (!(flags & 1)) return -2;               // skip-attrs shapes only
    Interner* it = (Interner*)interner;
    struct Range {
        const uint8_t* start; uint64_t len;
        int64_t out_base; int64_t count;
        int32_t res_idx; int32_t service_id;
    };
    std::vector<Range> ranges;
    int64_t total = 0, n_res = 0;
    {
        // prelude holds the interner lock: resource staging interns the
        // (few) service names / resource keys exactly like the serial pass
        std::lock_guard<std::mutex> g(it->mu);
        StageCtx c;
        c.it = it; c.buf = buf;
        c.spans = nullptr; c.span_cap = 0;
        c.sattrs = nullptr; c.sattr_cap = 0;
        c.rattrs = rattrs; c.rattr_cap = rattr_cap;
        c.res = res; c.res_cap = res_cap;
        static const uint8_t kEmpty = 0;
        c.empty_id = it->intern_locked(&kEmpty, 0);
        c.svc_key_id = it->intern_locked((const uint8_t*)"service.name", 12);
        Cursor top{buf, buf + buflen, true};
        uint32_t f, w; uint64_t v, len; const uint8_t* start;
        while (read_field(top, f, w, v, start, len)) {
            if (f != 1 || w != 2) continue;    // ResourceSpans
            const uint8_t* rm = nullptr; uint64_t rmlen = 0;
            uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
            Cursor rs1{start, start + len, true};
            while (read_field(rs1, f2, w2, v2, s2, l2)) {
                if (f2 == 1 && w2 == 2) { rm = s2; rmlen = l2; }
            }
            if (!rs1.ok) return -1;
            StageRes r;
            if (!stage_resource(c, rm, rmlen, r)) return -1;
            int32_t res_idx = (int32_t)c.n_res;
            if (c.n_res < c.res_cap) c.res[c.n_res] = r;
            c.n_res++;
            int64_t cnt = count_spans_rs(start, len);
            if (cnt < 0) return -1;
            ranges.push_back(Range{start, len, total, cnt,
                                   res_idx, r.service_id});
            total += cnt;
        }
        if (!top.ok) return -1;
        n_res = c.n_res;
        n_out[0] = total; n_out[1] = 0;
        n_out[2] = c.n_rattrs; n_out[3] = n_res;
        if (total > span_cap || c.n_rattrs > rattr_cap)
            return 0;                          // caller regrows
    }
    static const uint8_t kEmpty2 = 0;
    int32_t empty_id, svc_key_id;
    {
        std::lock_guard<std::mutex> g(it->mu);
        empty_id = it->intern_locked(&kEmpty2, 0);
        svc_key_id = it->intern_locked((const uint8_t*)"service.name", 12);
    }
    bool skip = true, trust = (flags & 2) != 0;
    int nt = (int)std::min<size_t>(std::max(n_threads, 1),
                                   std::max<size_t>(ranges.size(), 1));
    std::atomic<bool> bad{false};

    auto work = [&](int t) {
        LocalIntern local(it, buf);
        StageCtx c;
        c.it = it; c.buf = buf;
        c.spans = spans; c.span_cap = span_cap;
        c.sattrs = nullptr; c.sattr_cap = 0;
        c.rattrs = nullptr; c.rattr_cap = 0;
        c.res = nullptr; c.res_cap = 0;
        c.empty_id = empty_id;
        c.svc_key_id = svc_key_id;
        c.local = &local;
        for (size_t ri = t; ri < ranges.size(); ri += nt) {
            if (bad.load(std::memory_order_relaxed)) return;
            const Range& r = ranges[ri];
            c.n_spans = r.out_base;
            Cursor rs{r.start, r.start + r.len, true};
            uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
            while (read_field(rs, f2, w2, v2, s2, l2)) {
                if (f2 != 2 || w2 != 2) continue;      // ScopeSpans
                Cursor ss{s2, s2 + l2, true};
                uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
                while (read_field(ss, f3, w3, v3, s3, l3)) {
                    if (f3 != 2 || w3 != 2) continue;  // Span
                    if (!stage_span(c, s3, l3, r.res_idx, r.service_id,
                                    skip, trust)) {
                        bad.store(true, std::memory_order_relaxed);
                        return;
                    }
                }
                if (!ss.ok) { bad.store(true); return; }
            }
            if (!rs.ok) { bad.store(true); return; }
        }
    };

    if (nt < 2 || total < 4096) {
        for (int t = 0; t < nt; t++) work(t);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nt);
        for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    return bad.load() ? -1 : 0;
}

}  // extern "C"

// --- fused spanmetrics resolution (staged records -> device-ready arrays) ----
//
// The generator's dedicated-spanmetrics hot path (the PushSpans shape of
// `modules/generator/generator.go:275` with only the spanmetrics processor
// enabled): one pass over the staged records builds the intrinsic label
// row, resolves it against the persistent RowTable, applies the ingestion
// slack filter, and emits the scatter-ready arrays (slots, duration
// seconds, wire sizes) the fused device update consumes directly. This
// replaces four Python/numpy passes (SpanBatch materialization, label-row
// stacking, separate rowtable lookup, duration math) with one C loop —
// on a 1-core host the Python staging was the e2e throughput bound.
//
// dims: per-label field selector (0=service_id 1=name_id 2=kind->lut
// 3=status_code->lut). kind_lut[6]/status_lut[3] carry the intern ids of
// the SPAN_KIND_* / STATUS_CODE_* strings so rows match the generic
// `_label_rows` path bit-for-bit (same table serves both paths).
// slack_hi == 0 disables the slack filter. last_seen (may be null) is
// stamped with `now` for every resolved slot. Misses get PENDING entries
// (first occurrence appended to miss_idx, rows all emitted to rows_out);
// Python resolves them exactly like rowtable_lookup's contract requires.
// counts_out: [0]=n_valid (post-slack), [1]=n_filtered.

extern "C" {

int64_t spanmetrics_resolve(
    void* rowtable_h, const StageRec* spans, int64_t n,
    const int32_t* dims, int32_t n_dims,
    const int32_t* kind_lut, const int32_t* status_lut,
    int64_t slack_lo, int64_t slack_hi, double now, double* last_seen,
    int32_t* slots_out, float* dur_out, float* size_out,
    int32_t* rows_out, uint8_t* valid_out,
    int64_t* miss_idx, int64_t miss_cap, int64_t* counts_out) {
    RowTable* t = (RowTable*)rowtable_h;
    std::lock_guard<std::mutex> g(t->mu);
    int64_t miss = 0, n_valid = 0, n_filtered = 0;
    // one-entry memo: consecutive spans of one service/op resolve without
    // re-probing (payloads arrive grouped by resource and often by name)
    uint64_t last_h = 0;
    int32_t last_slot = -1;
    bool have_last = false;
    int32_t prev_row[8];
    const bool memo_ok = n_dims <= 8;
    for (int64_t i = 0; i < n; i++) {
        const StageRec& r = spans[i];
        int32_t* row = rows_out + i * n_dims;
        for (int32_t d = 0; d < n_dims; d++) {
            switch (dims[d]) {
                case 0: row[d] = r.service_id; break;
                case 1: row[d] = r.name_id; break;
                case 2: {
                    int32_t k = r.kind;
                    row[d] = kind_lut[k < 0 ? 0 : (k > 5 ? 5 : k)];
                    break;
                }
                default: {
                    int32_t s = r.status_code;
                    row[d] = status_lut[s < 0 ? 0 : (s > 2 ? 2 : s)];
                }
            }
        }
        int64_t end = (int64_t)r.end_ns;
        bool ok = slack_hi == 0 || (end >= slack_lo && end <= slack_hi);
        valid_out[i] = ok ? 1 : 0;
        dur_out[i] = (float)((double)(end - (int64_t)r.start_ns) * 1e-9);
        size_out[i] = (float)r.span_len;
        if (!ok) {
            slots_out[i] = -1;
            n_filtered++;
            continue;
        }
        n_valid++;
        uint64_t hh = t->rhash(row);
        if (memo_ok && have_last && hh == last_h &&
            memcmp(prev_row, row, n_dims * 4) == 0) {
            slots_out[i] = last_slot;
            continue;
        }
        int32_t e = t->find_entry(row, hh);
        int32_t slot;
        if (e == -1) {
            t->add_entry(row, hh, kPending);
            if (miss < miss_cap) miss_idx[miss] = i;
            miss++;
            slot = -1;
        } else if (t->slots[e] == kPending) {
            slot = -1;
        } else {
            slot = t->slots[e];
            if (last_seen) last_seen[slot] = now;
        }
        slots_out[i] = slot;
        last_h = hh;
        last_slot = slot;
        have_last = memo_ok && slot >= 0;
        if (memo_ok) memcpy(prev_row, row, n_dims * 4);
    }
    counts_out[0] = n_valid;
    counts_out[1] = n_filtered;
    return miss;
}

}  // extern "C"

// --- tee-path fusion: distributor scan records -> spanmetrics arrays --------
//
// The in-process generator tee (`modules/distributor/distributor.go:563`
// metrics-generator forwarding) previously re-parsed the OTLP payload the
// distributor had ALREADY scanned: otlp_scan in the distributor, then
// otlp_stage in the generator — two full protobuf walks per push. This
// kernel consumes the distributor's SpanRec offsets directly: names are
// interned by gathering their recorded byte ranges (no varint walking),
// resources resolve service.name once per distinct res_off, and the row
// resolves against the RowTable exactly like spanmetrics_resolve. The
// caller passes any SUBSET of records (ring-sharded tees) while `buf`
// stays the original payload — the re-encode slice disappears entirely.
//
// Returns miss count, -1 on malformed resource bytes, or -2 when the
// LAST service.name occurrence of some resource is non-string (the
// Python stringify fixup owns that case; caller falls back). A -2 bail
// happens BEFORE any row-table mutation (resources are pre-resolved), so
// no pending entries leak.

namespace {

// memo for byte-range interning with the interner lock already held
struct HeldIntern {
    struct E { uint64_t h; int64_t off; int32_t len; int32_t id; };
    std::vector<E> tab;
    uint64_t mask;
    Interner* it;
    const uint8_t* base;

    HeldIntern(Interner* i, const uint8_t* b) : it(i), base(b) {
        tab.assign(1 << 10, E{0, 0, 0, -1});
        mask = tab.size() - 1;
    }

    int32_t get(int64_t off, int32_t len) {
        const uint8_t* s = base + off;
        uint64_t h = fnv1a64(s, len);
        uint64_t i = h & mask;
        int probes = 0;
        while (probes++ < 32) {
            E& e = tab[i];
            if (e.id == -1) {
                e = E{h, off, len, it->intern_locked(s, len)};
                return e.id;
            }
            if (e.h == h && e.len == len &&
                memcmp(base + e.off, s, len) == 0)
                return e.id;
            i = (i + 1) & mask;
        }
        return it->intern_locked(s, len);      // memo full: direct
    }
};

// service.name of one Resource message; 0 ok, -1 malformed, -2 needs the
// Python fixup (last occurrence non-string).
static int resolve_service(const uint8_t* buf, int64_t off, int32_t len,
                           HeldIntern& hi, int32_t empty_id,
                           int32_t* out_id) {
    *out_id = empty_id;
    if (len <= 0) return 0;
    int last_typ = -1;                      // of the last service.name
    int64_t last_off = 0; int32_t last_len = 0;
    Cursor cur{buf + off, buf + off + len, true};
    uint32_t f, w; uint64_t v, l; const uint8_t* s;
    while (read_field(cur, f, w, v, s, l)) {
        if (f != 1 || w != 2) continue;     // Resource.attributes KeyValue
        Cursor kv{s, s + l, true};
        uint32_t f2, w2; uint64_t v2, l2; const uint8_t* s2;
        bool is_svc = false;
        int typ = -1; int64_t voff = 0; int32_t vlen = 0;
        while (read_field(kv, f2, w2, v2, s2, l2)) {
            if (f2 == 1 && w2 == 2) {
                is_svc = (l2 == 12 && memcmp(s2, "service.name", 12) == 0);
            } else if (f2 == 2 && w2 == 2) {
                Cursor av{s2, s2 + l2, true};
                uint32_t f3, w3; uint64_t v3, l3; const uint8_t* s3;
                while (read_field(av, f3, w3, v3, s3, l3)) {
                    if (f3 == 1 && w3 == 2) {
                        typ = 1; voff = s3 - buf; vlen = (int32_t)l3;
                    } else {
                        typ = 0;            // any non-string kind
                    }
                }
                if (!av.ok) return -1;
            }
        }
        if (!kv.ok) return -1;
        if (is_svc) { last_typ = typ; last_off = voff; last_len = vlen; }
    }
    if (!cur.ok) return -1;
    if (last_typ == -1) return 0;
    if (last_typ != 1) return -2;
    *out_id = hi.get(last_off, last_len);
    return 0;
}

}  // namespace

extern "C" {

int64_t spanmetrics_from_recs(
    void* rowtable_h, void* interner_h, const uint8_t* buf, int64_t buflen,
    const SpanRec* recs, int64_t n,
    const int32_t* dims, int32_t n_dims,
    const int32_t* kind_lut, const int32_t* status_lut,
    int64_t slack_lo, int64_t slack_hi, double now, double* last_seen,
    int32_t* slots_out, float* dur_out, float* size_out,
    int32_t* rows_out, uint8_t* valid_out,
    int64_t* miss_idx, int64_t miss_cap, int64_t* counts_out) {
    (void)buflen;
    Interner* it = (Interner*)interner_h;
    std::lock_guard<std::mutex> gi(it->mu);
    static const uint8_t kEmpty = 0;
    int32_t empty_id = it->intern_locked(&kEmpty, 0);
    HeldIntern hi(it, buf);

    // pass 1: resolve every distinct resource's service id (consecutive
    // records share resources, so the last-seen fast path covers almost
    // every record; bail on the fixup case before touching the row table)
    std::vector<int32_t> svc(n);
    std::vector<std::pair<int64_t, int32_t>> seen;   // res_off -> id
    int64_t cur_off = -1; int32_t cur_id = empty_id;
    for (int64_t i = 0; i < n; i++) {
        int64_t ro = recs[i].res_off;
        if (ro != cur_off) {
            cur_off = ro;
            int32_t id = empty_id;
            bool found = false;
            for (auto& p : seen)
                if (p.first == ro) { id = p.second; found = true; break; }
            if (!found) {
                int rc = resolve_service(buf, ro, recs[i].res_len, hi,
                                         empty_id, &id);
                if (rc != 0) return rc;
                seen.emplace_back(ro, id);
            }
            cur_id = id;
        }
        svc[i] = cur_id;
    }

    RowTable* t = (RowTable*)rowtable_h;
    std::lock_guard<std::mutex> g(t->mu);
    int64_t miss = 0, n_valid = 0, n_filtered = 0;
    uint64_t last_h = 0;
    int32_t last_slot = -1;
    bool have_last = false;
    int32_t prev_row[8];
    const bool memo_ok = n_dims <= 8;
    for (int64_t i = 0; i < n; i++) {
        const SpanRec& r = recs[i];
        int32_t* row = rows_out + i * n_dims;
        for (int32_t d = 0; d < n_dims; d++) {
            switch (dims[d]) {
                case 0: row[d] = svc[i]; break;
                case 1: row[d] = hi.get(r.name_off, r.name_len); break;
                case 2: {
                    int32_t k = r.kind;
                    row[d] = kind_lut[k < 0 ? 0 : (k > 5 ? 5 : k)];
                    break;
                }
                default: {
                    int32_t s = r.status_code;
                    row[d] = status_lut[s < 0 ? 0 : (s > 2 ? 2 : s)];
                }
            }
        }
        int64_t end = (int64_t)r.end_ns;
        bool ok = slack_hi == 0 || (end >= slack_lo && end <= slack_hi);
        valid_out[i] = ok ? 1 : 0;
        dur_out[i] = (float)((double)(end - (int64_t)r.start_ns) * 1e-9);
        size_out[i] = (float)r.span_len;
        if (!ok) {
            slots_out[i] = -1;
            n_filtered++;
            continue;
        }
        n_valid++;
        uint64_t hh = t->rhash(row);
        if (memo_ok && have_last && hh == last_h &&
            memcmp(prev_row, row, n_dims * 4) == 0) {
            slots_out[i] = last_slot;
            continue;
        }
        int32_t e = t->find_entry(row, hh);
        int32_t slot;
        if (e == -1) {
            t->add_entry(row, hh, kPending);
            if (miss < miss_cap) miss_idx[miss] = i;
            miss++;
            slot = -1;
        } else if (t->slots[e] == kPending) {
            slot = -1;
        } else {
            slot = t->slots[e];
            if (last_seen) last_seen[slot] = now;
        }
        slots_out[i] = slot;
        last_h = hh;
        last_slot = slot;
        have_last = memo_ok && slot >= 0;
        if (memo_ok) memcpy(prev_row, row, n_dims * 4);
    }
    counts_out[0] = n_valid;
    counts_out[1] = n_filtered;
    return miss;
}

}  // extern "C"

// --- trace grouping straight off the scan records ---------------------------
//
// group_keys over (trace_id ‖ tid_len) WITHOUT materializing the key
// matrix: the tee path previously copied trace ids twice (contiguous
// gather + length-column concat) per push just to feed group_keys. Reads
// SpanRec rows directly, skipping invalid ones; inverse/first index over
// the SEQUENCE of valid rows (the caller's vrows order), preserving
// `requestsByTraceID` semantics (distributor.go:694).

extern "C" {

int64_t group_keys_recs(const void* recs_p, int64_t n, const uint8_t* valid,
                        int32_t* inverse, int32_t* first_idx) {
    const SpanRec* recs = (const SpanRec*)recs_p;
    if (n <= 0) return 0;
    uint64_t cap = 64;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int32_t> table(cap, -1);
    std::vector<int64_t> grec;                     // group -> rec row
    uint64_t mask = cap - 1;
    int64_t n_groups = 0, vi = 0;
    uint8_t key[17];
    for (int64_t r = 0; r < n; r++) {
        if (valid && !valid[r]) continue;
        const SpanRec& rec = recs[r];
        memcpy(key, rec.trace_id, 16);
        key[16] = (uint8_t)rec.tid_len;
        uint64_t h = fnv1a64(key, 17);
        uint64_t i = h & mask;
        while (true) {
            int32_t g = table[i];
            if (g == -1) {
                table[i] = (int32_t)n_groups;
                first_idx[n_groups] = (int32_t)vi;
                grec.push_back(r);
                inverse[vi] = (int32_t)n_groups;
                n_groups++;
                break;
            }
            const SpanRec& fr = recs[grec[g]];
            if (memcmp(fr.trace_id, rec.trace_id, 16) == 0 &&
                fr.tid_len == rec.tid_len) {
                inverse[vi] = g;
                break;
            }
            i = (i + 1) & mask;
        }
        vi++;
    }
    return n_groups;
}

// group_keys_recs over an ARBITRARY record layout: trace_id[16] at
// tid_off, int32 tid_len at tidlen_off, rec_size bytes per row. The
// decode-once staged tee groups StageRec rows with this (StageRec and
// SpanRec share field names but not offsets); semantics identical to
// group_keys_recs.
int64_t group_keys_strided(const void* recs_p, int64_t n, int64_t rec_size,
                           int64_t tid_off, int64_t tidlen_off,
                           const uint8_t* valid,
                           int32_t* inverse, int32_t* first_idx) {
    const uint8_t* base = (const uint8_t*)recs_p;
    if (n <= 0) return 0;
    uint64_t cap = 64;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int32_t> table(cap, -1);
    std::vector<int64_t> grec;                     // group -> rec row
    uint64_t mask = cap - 1;
    int64_t n_groups = 0, vi = 0;
    uint8_t key[17];
    for (int64_t r = 0; r < n; r++) {
        if (valid && !valid[r]) continue;
        const uint8_t* rec = base + r * rec_size;
        const uint8_t* tid = rec + tid_off;
        int32_t tl;
        memcpy(&tl, rec + tidlen_off, 4);
        memcpy(key, tid, 16);
        key[16] = (uint8_t)tl;
        uint64_t h = fnv1a64(key, 17);
        uint64_t i = h & mask;
        while (true) {
            int32_t g = table[i];
            if (g == -1) {
                table[i] = (int32_t)n_groups;
                first_idx[n_groups] = (int32_t)vi;
                grec.push_back(r);
                inverse[vi] = (int32_t)n_groups;
                n_groups++;
                break;
            }
            const uint8_t* fr = base + grec[g] * rec_size;
            int32_t ftl;
            memcpy(&ftl, fr + tidlen_off, 4);
            if (memcmp(fr + tid_off, tid, 16) == 0 && ftl == tl) {
                inverse[vi] = g;
                break;
            }
            i = (i + 1) & mask;
        }
        vi++;
    }
    return n_groups;
}

}  // extern "C"

// --- service-graph edge store -------------------------------------------------
//
// The half-edge store of `generator/processors/servicegraphs.py`
// (`store/store.go:29,78,119` in the reference): a 24-byte key (trace id ‖
// span id for a CLIENT or PRODUCER span, trace id ‖ parent span id for a
// SERVER or CONSUMER span) -> the half-edge waiting for its other side, and
// a FIFO of (expire_at, key) for the TTL sweep. sg_match pairs one batch's
// spans in row order and writes the completed edges as columns; sg_expire
// evicts the half-edges whose time is up. Seconds leave as the int64
// nanoseconds over 1e9 in double, cast to float once, the values the
// processor's former Python loop emitted bit for bit.
//
// The hash mixes all 24 bytes: clients may stamp every trace id of a
// payload with one shared prefix. Deletion shifts later cells of the probe
// run back (no tombstones), so a store that churns keeps short probes.

namespace {

// trace.proto SpanKind and Status.StatusCode
constexpr int32_t kSgServer = 2, kSgClient = 3, kSgProducer = 4,
                  kSgConsumer = 5, kSgStatusError = 2;

static inline uint64_t fmix64(uint64_t h) {
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ull;
    return h ^ (h >> 33);
}

static inline uint64_t sg_hash(const uint8_t* k) {
    uint64_t a, b, c;
    memcpy(&a, k, 8);
    memcpy(&b, k + 8, 8);
    memcpy(&c, k + 16, 8);
    return fmix64(a ^ fmix64(b ^ fmix64(c ^ 0x9E3779B97F4A7C15ull)));
}

struct SgHalf {
    uint8_t key[24];
    uint64_t hash;
    int64_t dur_ns;
    int64_t start_ns;
    double expire_at;
    int32_t service;
    int32_t peer;
    uint8_t failed;
    uint8_t is_client;
    uint8_t is_msg;
};

struct SgTtl {
    double expire_at;
    uint8_t key[24];
};

static inline float sg_seconds(int64_t ns) {
    return (float)((double)ns / 1e9);
}

// Not thread-safe: the caller serialises sg_match and sg_expire. `size`
// publishes `live` at the end of each call, so sg_store_size may read it
// from any thread.
struct EdgeStore {
    std::vector<SgHalf> slab;        // entry id -> half-edge
    std::vector<int32_t> free_ids;   // slab entries to reuse
    std::vector<int32_t> table = std::vector<int32_t>(1 << 10, -1);
                                     // open addressing over entry ids, -1 empty
    uint64_t mask = (1 << 10) - 1;
    int64_t live = 0;
    std::atomic<int64_t> size{0};
    std::deque<SgTtl> fifo;

    // table position of `key`, or -1
    int64_t find(const uint8_t* key, uint64_t h) const {
        uint64_t i = h & mask;
        while (true) {
            int32_t e = table[i];
            if (e == -1) return -1;
            if (slab[e].hash == h && memcmp(slab[e].key, key, 24) == 0)
                return (int64_t)i;
            i = (i + 1) & mask;
        }
    }

    void place(int32_t e) {
        uint64_t i = slab[e].hash & mask;
        while (table[i] != -1) i = (i + 1) & mask;
        table[i] = e;
    }

    SgHalf& insert(const uint8_t* key, uint64_t h) {
        int32_t e;
        if (!free_ids.empty()) {
            e = free_ids.back();
            free_ids.pop_back();
        } else {
            e = (int32_t)slab.size();
            slab.emplace_back();
        }
        memcpy(slab[e].key, key, 24);
        slab[e].hash = h;
        place(e);
        live++;
        if (live * 10 > (int64_t)table.size() * 7) {
            std::vector<int32_t> old(table.size() * 2, -1);
            old.swap(table);
            mask = table.size() - 1;
            for (int32_t f : old)
                if (f != -1) place(f);
        }
        return slab[e];
    }

    // remove the entry at table position i, shifting its run back
    void erase_at(uint64_t i) {
        free_ids.push_back(table[i]);
        live--;
        uint64_t j = i;
        while (true) {
            j = (j + 1) & mask;
            int32_t f = table[j];
            if (f == -1) break;
            uint64_t home = slab[f].hash & mask;
            bool stays = i <= j ? (i < home && home <= j)
                                : (i < home || home <= j);
            if (!stays) {
                table[i] = f;
                i = j;
            }
        }
        table[i] = -1;
    }
};

}  // namespace

extern "C" {

void* sg_store_new() { return new EdgeStore(); }
void sg_store_free(void* h) { delete (EdgeStore*)h; }

int64_t sg_store_size(void* h) {
    return ((EdgeStore*)h)->size.load(std::memory_order_relaxed);
}

// FIFO entries queued, matched keys' included (they leave when due)
int64_t sg_store_pending(void* h) { return (int64_t)((EdgeStore*)h)->fifo.size(); }

// Pair the CLIENT/PRODUCER and SERVER/CONSUMER spans of rows [0, n) in row
// order (rows with valid 0 or another kind are skipped). A span whose key
// holds the other side completes an edge, and that half-edge leaves the
// store. Otherwise the span is stored under its key, replacing a same-side
// half-edge there, with a FIFO entry at `expire_at`, unless the store holds
// `max_items` or more half-edges: then it is dropped and the old one stays.
// Completed edges go to the out columns (capacity n) in completion order:
// client and server service, connection (0 plain, 1 messaging: either side
// a PRODUCER or CONSUMER), client and server seconds, failed (either side
// STATUS_ERROR), messaging delay max(0, server start - client start) in
// seconds. `dropped` gets the spans dropped. Returns the number of edges.
int64_t sg_match(void* h, int64_t n, const uint8_t* trace_id,
                 const uint8_t* span_id, const uint8_t* parent_id,
                 const int32_t* kind, const uint8_t* valid,
                 const int32_t* service, const int64_t* start_ns,
                 const int64_t* end_ns, const int32_t* status,
                 const int32_t* peer, double expire_at, int64_t max_items,
                 int32_t* out_client, int32_t* out_server, uint8_t* out_conn,
                 float* out_client_s, float* out_server_s,
                 uint8_t* out_failed, float* out_delay, int64_t* dropped) {
    EdgeStore* s = (EdgeStore*)h;
    int64_t n_edges = 0, n_dropped = 0;
    uint8_t key[24];
    for (int64_t r = 0; r < n; r++) {
        if (!valid[r]) continue;
        int32_t k = kind[r];
        bool is_client = k == kSgClient || k == kSgProducer;
        if (!is_client && k != kSgServer && k != kSgConsumer) continue;
        bool is_msg = k == kSgProducer || k == kSgConsumer;
        memcpy(key, trace_id + r * 16, 16);
        memcpy(key + 16, (is_client ? span_id : parent_id) + r * 8, 8);
        uint64_t hh = sg_hash(key);
        // the duration as numpy's int64 column holds it (wrapping)
        int64_t dur = (int64_t)((uint64_t)end_ns[r] - (uint64_t)start_ns[r]);
        bool failed = status[r] == kSgStatusError;
        int64_t at = s->find(key, hh);
        if (at >= 0 && (bool)s->slab[s->table[at]].is_client != is_client) {
            SgHalf o = s->slab[s->table[at]];
            s->erase_at((uint64_t)at);
            int64_t cli_dur = is_client ? dur : o.dur_ns;
            int64_t srv_dur = is_client ? o.dur_ns : dur;
            int64_t cli_start = is_client ? start_ns[r] : o.start_ns;
            int64_t srv_start = is_client ? o.start_ns : start_ns[r];
            out_client[n_edges] = is_client ? service[r] : o.service;
            out_server[n_edges] = is_client ? o.service : service[r];
            out_conn[n_edges] = (is_msg || o.is_msg) ? 1 : 0;
            out_client_s[n_edges] = sg_seconds(cli_dur);
            out_server_s[n_edges] = sg_seconds(srv_dur);
            out_failed[n_edges] = (failed || o.failed) ? 1 : 0;
            // the exact difference, rounded once to double
            double delay = (double)((__int128)srv_start - cli_start) / 1e9;
            out_delay[n_edges] = (float)(delay > 0.0 ? delay : 0.0);
            n_edges++;
            continue;
        }
        if (s->live >= max_items) {
            n_dropped++;
            continue;
        }
        SgHalf& e = at >= 0 ? s->slab[s->table[at]] : s->insert(key, hh);
        e.dur_ns = dur;
        e.start_ns = start_ns[r];
        e.expire_at = expire_at;
        e.service = service[r];
        e.peer = peer[r];
        e.failed = failed;
        e.is_client = is_client;
        e.is_msg = is_msg;
        SgTtl t;
        t.expire_at = expire_at;
        memcpy(t.key, key, 24);
        s->fifo.push_back(t);
    }
    s->size.store(s->live, std::memory_order_relaxed);
    *dropped = n_dropped;
    return n_edges;
}

// Sweep the FIFO from its head while its expire_at <= now: a key no longer
// stored (matched) is skipped, a key whose stored half-edge expires later
// (stored again since) is queued again at that time, and the rest leave
// the store and are written, in FIFO order, to the out columns: is_client,
// service, peer, seconds, failed. Each one written leaves the store, so the
// store's size on entry is capacity enough; `cap` only guards the columns.
// Returns the number expired.
int64_t sg_expire(void* h, double now, int64_t cap, uint8_t* out_is_client,
                  int32_t* out_service, int32_t* out_peer, float* out_dur_s,
                  uint8_t* out_failed) {
    EdgeStore* s = (EdgeStore*)h;
    int64_t n_out = 0;
    while (!s->fifo.empty() && s->fifo.front().expire_at <= now) {
        SgTtl t = s->fifo.front();
        s->fifo.pop_front();
        int64_t at = s->find(t.key, sg_hash(t.key));
        if (at < 0) continue;
        const SgHalf& e = s->slab[s->table[at]];
        if (e.expire_at > now) {
            t.expire_at = e.expire_at;
            s->fifo.push_back(t);
            continue;
        }
        if (n_out == cap) {
            s->fifo.push_front(t);
            break;
        }
        out_is_client[n_out] = e.is_client;
        out_service[n_out] = e.service;
        out_peer[n_out] = e.peer;
        out_dur_s[n_out] = sg_seconds(e.dur_ns);
        out_failed[n_out] = e.failed;
        n_out++;
        s->erase_at((uint64_t)at);
    }
    s->size.store(s->live, std::memory_order_relaxed);
    return n_out;
}

}  // extern "C"
