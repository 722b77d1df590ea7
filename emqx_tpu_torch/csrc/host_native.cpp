// Host-side native helpers of the columnar PUBLISH ingress path.
//
// The byte-level work of a read burst runs here instead of in Python:
//
//   mqtt_frame_scan               split a TCP read buffer into complete
//                                 MQTT frames (fixed header + varint)
//   mqtt_publish_decode_columnar  decode every PUBLISH frame's wire fields
//                                 into parallel arrays in one pass
//   intern_table_new/free/add     a word -> id mirror of the engine's
//                                 intern table (word bytes kept, lookups
//                                 confirmed with memcmp)
//   topic_encode_batch            split, hash and id-probe a batch of
//                                 publish topics in one call
//
// A copy of the matching parts of the JAX package's native library, built
// on its own by the host C++ compiler at first use (emqx_tpu_torch/native.py)
// and loaded with ctypes. emqx_tpu_torch/native.py also holds the pure-Python
// mirrors of the scan and the decode, which the tests hold this code to.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <stdlib.h>
#include <shared_mutex>
#include <mutex>

extern "C" {

// ---------------------------------------------------------------------
// MQTT frame scan
// Returns the number of complete frames found (<= n_out); writes their
// (offset, total_length) into out_off/out_len. *consumed = end of the
// last complete frame. Returns -1 on a malformed varint (>4 bytes) and
// -2 on a frame exceeding max_frame.
// ---------------------------------------------------------------------
int mqtt_frame_scan(const uint8_t* buf, size_t len,
                    uint32_t* out_off, uint32_t* out_len, int n_out,
                    uint32_t max_frame, size_t* consumed) {
    size_t pos = 0;
    int found = 0;
    *consumed = 0;
    while (pos + 2 <= len && found < n_out) {
        // fixed header: type/flags byte + varint remaining length
        size_t p = pos + 1;
        uint32_t rem = 0;
        uint32_t mult = 1;
        int nbytes = 0;
        bool complete_varint = false;
        while (p < len && nbytes < 4) {
            uint8_t b = buf[p++];
            rem += (uint32_t)(b & 0x7F) * mult;
            mult <<= 7;
            ++nbytes;
            if ((b & 0x80) == 0) { complete_varint = true; break; }
        }
        if (!complete_varint) {
            if (nbytes >= 4) return -1;   // varint longer than 4 bytes
            break;                        // need more bytes
        }
        size_t total = (p - pos) + rem;
        if (max_frame && total > max_frame) return -2;
        if (pos + total > len) break;     // incomplete body
        out_off[found] = (uint32_t)pos;
        out_len[found] = (uint32_t)total;
        ++found;
        pos += total;
        *consumed = pos;
    }
    return found;
}

// ---------------------------------------------------------------------
// Columnar PUBLISH decode: given the frame boundaries from
// mqtt_frame_scan, decode every PUBLISH frame's wire fields into
// parallel output arrays in one pass. Non-PUBLISH frames — and any
// PUBLISH the strict parser must see for its precise error (qos 3,
// truncated topic/packet-id, packet id 0, malformed property-length
// varint, property span past the body) — stay kind=0 for the
// per-packet parser. UTF-8 topic validation and v5 property CONTENT
// parsing are the python side's job (it owns the string objects).
// All offsets are absolute into buf; flags packs the fixed-header
// nibble (bit0 retain, bits1-2 qos, bit3 dup). Outputs are written
// only for kind=1 rows (kind=0 rows are all-zero), so the pure-python
// fallback can be compared array-for-array. Returns the kind=1 count.
// ---------------------------------------------------------------------
int mqtt_publish_decode_columnar(
        const uint8_t* buf, size_t len,
        const uint32_t* off, const uint32_t* flen, int n, int v5,
        uint8_t* kind, uint8_t* flags,
        uint32_t* topic_off, uint32_t* topic_len, uint32_t* packet_id,
        uint32_t* props_off, uint32_t* props_len,
        uint32_t* payload_off, uint32_t* payload_len) {
    int found = 0;
    for (int i = 0; i < n; ++i) {
        kind[i] = 0; flags[i] = 0;
        topic_off[i] = 0; topic_len[i] = 0; packet_id[i] = 0;
        props_off[i] = 0; props_len[i] = 0;
        payload_off[i] = 0; payload_len[i] = 0;
        size_t s = off[i];
        size_t e = s + flen[i];
        if (e > len || flen[i] < 2) continue;
        uint8_t b0 = buf[s];
        if ((b0 >> 4) != 3) continue;          // not PUBLISH
        uint32_t qos = (b0 >> 1) & 0x3;
        if (qos == 3) continue;                // strict: invalid_qos
        // remaining-length varint (completeness proven by the scan;
        // re-walked only to find the body start)
        size_t p = s + 1;
        int nb = 0;
        while (p < e && nb < 4) {
            uint8_t b = buf[p++];
            ++nb;
            if (!(b & 0x80)) break;
        }
        if (p + 2 > e) continue;               // truncated topic length
        uint32_t tl = ((uint32_t)buf[p] << 8) | buf[p + 1];
        p += 2;
        if (p + tl > e) continue;              // truncated topic
        size_t t_off = p;
        p += tl;
        uint32_t pid = 0;
        if (qos > 0) {
            if (p + 2 > e) continue;           // truncated packet id
            pid = ((uint32_t)buf[p] << 8) | buf[p + 1];
            p += 2;
            if (pid == 0) continue;            // strict: packet id 0
        }
        size_t pr_off = 0, pr_len = 0;
        if (v5) {
            uint32_t pl = 0, mult = 1;
            int k = 0;
            bool done = false;
            while (p < e && k < 4) {
                uint8_t b = buf[p++];
                pl += (uint32_t)(b & 0x7F) * mult;
                mult <<= 7;
                ++k;
                if (!(b & 0x80)) { done = true; break; }
            }
            if (!done) continue;               // malformed props varint
            if (p + pl > e) continue;          // props past body end
            pr_off = p;
            pr_len = pl;
            p += pl;
        }
        topic_off[i] = (uint32_t)t_off;
        topic_len[i] = tl;
        packet_id[i] = pid;
        props_off[i] = (uint32_t)pr_off;
        props_len[i] = (uint32_t)pr_len;
        payload_off[i] = (uint32_t)p;
        payload_len[i] = (uint32_t)(e - p);
        flags[i] = b0 & 0x0F;
        kind[i] = 1;
        ++found;
    }
    return found;
}

// ---------------------------------------------------------------------
// Topic level hashing (FNV-1a 64) — the intern-table key function.
// ---------------------------------------------------------------------
static inline uint64_t fnv1a(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// ---------------------------------------------------------------------
// Interned-word table mirrors + batched topic encoding (the device
// matches dictionary-encoded topic levels): python's InternTable owns word→id
// authoritatively; a mirror here stores hash + THE WORD BYTES (arena)
// so a whole publish batch encodes in one call. Lookups confirm the
// word with memcmp — correctness never touches hash uniqueness; two
// words sharing a 64-bit hash simply occupy different probe slots.
//
// Concurrency: ctypes releases the GIL around these calls and the
// engine's background rebuild thread interns filter words while the
// event loop encodes publish batches — a grow would otherwise free the
// arrays under a concurrent reader. One global shared_mutex guards all
// tables: encode takes it shared (once per BATCH, not per word),
// add/new/free take it exclusive.
// ---------------------------------------------------------------------

struct WTab {
    uint64_t* keys;   // 0 = empty slot (a real hash of 0 is remapped)
    uint32_t* woff;   // word bytes in arena
    uint32_t* wlen;
    int32_t*  ids;
    char*  arena;
    size_t arena_used, arena_cap;
    size_t cap;       // power of two
    size_t used;
};

#define MAX_WTABS 64
static WTab g_wtabs[MAX_WTABS];
static uint8_t g_wtab_live[MAX_WTABS];
static std::shared_mutex g_wtab_mu;

static inline uint64_t nz(uint64_t h) { return h ? h : 1; }

static inline bool word_eq(const WTab* t, size_t i, const char* w,
                           size_t n) {
    return t->wlen[i] == n && memcmp(t->arena + t->woff[i], w, n) == 0;
}

// probe for (hash, word); returns slot index (occupied-and-equal or
// first empty)
static size_t wtab_probe(const WTab* t, uint64_t key, const char* w,
                         size_t n) {
    size_t mask = t->cap - 1;
    size_t i = (size_t)key & mask;
    while (t->keys[i]) {
        if (t->keys[i] == key && word_eq(t, i, w, n)) return i;
        i = (i + 1) & mask;
    }
    return i;
}

static int wtab_grow(WTab* t) {
    size_t ncap = t->cap ? t->cap * 2 : 1024;
    uint64_t* nkeys = (uint64_t*)calloc(ncap, sizeof(uint64_t));
    uint32_t* noff = (uint32_t*)malloc(ncap * sizeof(uint32_t));
    uint32_t* nlen = (uint32_t*)malloc(ncap * sizeof(uint32_t));
    int32_t* nids = (int32_t*)malloc(ncap * sizeof(int32_t));
    if (!nkeys || !noff || !nlen || !nids) {
        free(nkeys); free(noff); free(nlen); free(nids);
        return -1;
    }
    size_t mask = ncap - 1;
    for (size_t i = 0; i < t->cap; ++i) {
        if (!t->keys[i]) continue;
        size_t j = (size_t)t->keys[i] & mask;
        while (nkeys[j]) j = (j + 1) & mask;
        nkeys[j] = t->keys[i]; noff[j] = t->woff[i];
        nlen[j] = t->wlen[i]; nids[j] = t->ids[i];
    }
    free(t->keys); free(t->woff); free(t->wlen); free(t->ids);
    t->keys = nkeys; t->woff = noff; t->wlen = nlen; t->ids = nids;
    t->cap = ncap;
    return 0;
}

int intern_table_new(void) {
    std::unique_lock<std::shared_mutex> lk(g_wtab_mu);
    for (int h = 0; h < MAX_WTABS; ++h) {
        if (!g_wtab_live[h]) {
            WTab* t = &g_wtabs[h];
            memset(t, 0, sizeof(*t));
            if (wtab_grow(t) != 0) return -1;
            t->arena_cap = 1 << 16;
            t->arena = (char*)malloc(t->arena_cap);
            if (!t->arena) {
                free(t->keys); free(t->woff); free(t->wlen);
                free(t->ids); memset(t, 0, sizeof(*t));
                return -1;
            }
            g_wtab_live[h] = 1;
            return h;
        }
    }
    return -1;      // out of handles: caller stays on the python path
}

void intern_table_free(int h) {
    std::unique_lock<std::shared_mutex> lk(g_wtab_mu);
    if (h < 0 || h >= MAX_WTABS || !g_wtab_live[h]) return;
    WTab* t = &g_wtabs[h];
    free(t->keys); free(t->woff); free(t->wlen); free(t->ids);
    free(t->arena);
    memset(t, 0, sizeof(*t));
    g_wtab_live[h] = 0;
}

// 0 ok; -1 same word already present with a DIFFERENT id (caller bug:
// intern ids never change); -2 allocation failure / bad handle
int intern_table_add(int h, const char* word, uint32_t len, int32_t id) {
    std::unique_lock<std::shared_mutex> lk(g_wtab_mu);
    if (h < 0 || h >= MAX_WTABS || !g_wtab_live[h]) return -2;
    WTab* t = &g_wtabs[h];
    if ((t->used + 1) * 4 >= t->cap * 3 && wtab_grow(t) != 0) return -2;
    uint64_t key = nz(fnv1a(word, len));
    size_t i = wtab_probe(t, key, word, len);
    if (t->keys[i])
        return t->ids[i] == id ? 0 : -1;
    if (t->arena_used + len > t->arena_cap) {
        size_t ncap = t->arena_cap;
        while (t->arena_used + len > ncap) ncap *= 2;
        char* na = (char*)realloc(t->arena, ncap);
        if (!na) return -2;
        t->arena = na; t->arena_cap = ncap;
    }
    memcpy(t->arena + t->arena_used, word, len);
    t->keys[i] = key;
    t->woff[i] = (uint32_t)t->arena_used;
    t->wlen[i] = len;
    t->ids[i] = id;
    t->arena_used += len;
    t->used++;
    return 0;
}

// Encode a batch of publish topics: buf holds the topics concatenated,
// offs/tlens index them. Writes out_ids[n*max_levels] (pad_id beyond a
// topic's levels), out_lens, out_dollar, out_toolong. Unknown words get
// unknown_id (they can still match +/# on device). Returns n.
int topic_encode_batch(int h, const char* buf, const uint32_t* offs,
                       const uint32_t* tlens, int n, int max_levels,
                       int32_t unknown_id, int32_t pad_id,
                       int32_t* out_ids, int32_t* out_lens,
                       uint8_t* out_dollar, uint8_t* out_toolong) {
    std::shared_lock<std::shared_mutex> lk(g_wtab_mu);
    if (h < 0 || h >= MAX_WTABS || !g_wtab_live[h]) return -2;
    const WTab* t = &g_wtabs[h];
    for (int i = 0; i < n; ++i) {
        const char* s = buf + offs[i];
        size_t len = tlens[i];
        int32_t* row = out_ids + (size_t)i * max_levels;
        int levels = 0, toolong = 0;
        size_t start = 0;
        for (size_t p = 0; p <= len; ++p) {
            if (p == len || s[p] == '/') {
                if (levels >= max_levels) { toolong = 1; break; }
                size_t wl = p - start;
                size_t slot = wtab_probe(t, nz(fnv1a(s + start, wl)),
                                         s + start, wl);
                row[levels++] = t->keys[slot] ? t->ids[slot] : unknown_id;
                start = p + 1;
            }
        }
        for (int k = levels; k < max_levels; ++k) row[k] = pad_id;
        out_lens[i] = levels;
        out_dollar[i] = (len > 0 && s[0] == '$') ? 1 : 0;
        out_toolong[i] = (uint8_t)toolong;
    }
    return n;
}

}  // extern "C"
