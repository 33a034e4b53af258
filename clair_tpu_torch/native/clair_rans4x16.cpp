// rANS Nx16 decoder (CRAM 3.1 block method 5) — native counterpart of
// clair_tpu/io/rans4x16.py. CRAM 3.1 blocks decode through this at C
// speed; the pure-Python codec remains the reference implementation,
// encoder, and fallback (cross-checked in tests/test_rans4x16.py).
//
// Handles the full stream grammar: order-0/1 entropy (32-bit states,
// 16-bit renormalisation, 4- or 32-way interleave per the X32 flag,
// 12/10-bit tables), the PACK / RLE / STRIPE / CAT transforms (STRIPE
// recurses into NOSZ sub-streams), and compressed order-1 frequency
// tables (nested streams are always 4-way, matching the encoder).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace rans4x16 {

constexpr uint32_t RANS_L16 = 1u << 15;
constexpr int SHIFT_O0 = 12;
constexpr int SHIFT_O1 = 10;

constexpr uint8_t F_ORDER1 = 0x01;
constexpr uint8_t F_X32 = 0x04;
constexpr uint8_t F_STRIPE = 0x08;
constexpr uint8_t F_NOSZ = 0x10;
constexpr uint8_t F_CAT = 0x20;
constexpr uint8_t F_RLE = 0x40;
constexpr uint8_t F_PACK = 0x80;

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint8_t byte() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
    uint8_t peek() {
        if (p >= end) { ok = false; return 0; }
        return *p;
    }
    uint64_t uint7() {
        uint64_t v = 0;
        for (int i = 0; i < 10; i++) {
            uint8_t b = byte();
            v = (v << 7) | (b & 0x7F);
            if (!(b & 0x80)) return v;
        }
        ok = false;
        return 0;
    }
};

// ascending symbols with consecutive-run RLE, zero-terminated
template <typename Visit>
bool walk_alphabet(Reader& r, Visit visit) {
    int rle = 0;
    int j = r.byte();
    while (r.ok) {
        if (!visit(j)) return false;
        if (rle) {
            rle--;
            j++;
        } else if (r.p < r.end && r.peek() == j + 1) {
            j = r.byte();
            rle = r.byte();
        } else {
            j = r.byte();
            if (j == 0) return r.ok;
        }
        if (j > 255) return false;
    }
    return false;
}

struct Table {
    uint16_t freq[256];
    uint16_t cum[256];
    uint8_t* sym_of;   // size 1<<shift
};

bool finish_table(Table& t, int shift) {
    uint32_t total = 1u << shift;
    std::memset(t.sym_of, 0, total);
    uint32_t x = 0;
    for (int j = 0; j < 256; j++) {
        if (!t.freq[j]) continue;
        t.cum[j] = (uint16_t)x;
        uint32_t e = x + t.freq[j];
        if (e > total) return false;
        std::memset(t.sym_of + x, j, t.freq[j]);
        x = e;
    }
    return true;
}

inline bool renorm16(uint32_t& x, const uint8_t*& p, const uint8_t* end) {
    while (x < RANS_L16) {
        if (p + 2 > end) return false;
        x = (x << 16) | (uint32_t)(p[0] | (p[1] << 8));
        p += 2;
    }
    return true;
}

// Decode an order-0 stream in place; advances r.p past the consumed
// bytes (table + NX states + renorm stream).
int decode_o0(Reader& r, uint8_t* out, int64_t out_size, int NX = 4) {
    Table t;
    std::memset(t.freq, 0, sizeof(t.freq));
    uint8_t sym_buf[1 << SHIFT_O0];
    t.sym_of = sym_buf;
    // Nx16 layout: the FULL alphabet first (run-shortened, terminated),
    // then one uint7 frequency per present symbol — unlike 4x8, which
    // interleaves each symbol's frequency into the walk.
    int alphabet[256];
    int n_alpha = 0;
    if (!walk_alphabet(r, [&](int j) {
            if (n_alpha >= 256) return false;
            alphabet[n_alpha++] = j;
            return true;
        }))
        return 1;
    for (int a = 0; a < n_alpha; a++) {
        t.freq[alphabet[a]] = (uint16_t)r.uint7();
        if (!r.ok) return 1;
    }
    if (!finish_table(t, SHIFT_O0)) return 1;
    if (r.end - r.p < 4 * NX) return 1;
    uint32_t states[32];
    for (int k = 0; k < NX; k++) {
        std::memcpy(&states[k], r.p, 4);
        r.p += 4;
    }
    const uint8_t* p = r.p;
    const uint8_t* end = r.end;
    const uint32_t mask = (1u << SHIFT_O0) - 1;
    int64_t main = out_size - out_size % NX;
    for (int64_t i = 0; i < main; i += NX) {
        for (int k = 0; k < NX; k++) {
            uint32_t x = states[k];
            uint32_t m = x & mask;
            uint8_t s = t.sym_of[m];
            out[i + k] = s;
            x = t.freq[s] * (x >> SHIFT_O0) + m - t.cum[s];
            if (!renorm16(x, p, end)) return 1;
            states[k] = x;
        }
    }
    for (int k = 0; k < (int)(out_size % NX); k++)
        out[main + k] = t.sym_of[states[k] & mask];
    r.p = p;
    return 0;
}

int decode_o1(Reader& r, uint8_t* out, int64_t out_size, int NX = 4) {
    uint8_t comp = r.byte();
    if (!r.ok) return 1;

    uint8_t* table_buf = nullptr;
    Reader tr{nullptr, nullptr};
    if (comp == 1) {
        uint64_t raw_size = r.uint7();
        uint64_t comp_size = r.uint7();
        if (!r.ok || raw_size > (1u << 26)) return 1;
        if (comp_size > (uint64_t)(r.end - r.p)) return 1;
        table_buf = (uint8_t*)std::malloc(raw_size);
        if (!table_buf) return 1;
        Reader er{r.p, r.p + comp_size};
        if (decode_o0(er, table_buf, (int64_t)raw_size)) {
            std::free(table_buf);
            return 1;
        }
        r.p += comp_size;
        tr = Reader{table_buf, table_buf + raw_size};
    } else {
        tr = Reader{r.p, r.end};
    }

    int alphabet[256];
    int n_alpha = 0;
    if (!walk_alphabet(tr, [&](int j) {
            if (n_alpha >= 256) return false;
            alphabet[n_alpha++] = j;
            return true;
        })) {
        if (table_buf) std::free(table_buf);
        return 1;
    }

    Table* tables[256] = {nullptr};
    int rc = 1;
    bool tables_ok = true;
    for (int a = 0; a < n_alpha && tables_ok; a++) {
        int ctx = alphabet[a];
        Table* t = (Table*)std::malloc(sizeof(Table));
        uint8_t* syms = (uint8_t*)std::malloc(1 << SHIFT_O1);
        if (!t || !syms) {
            std::free(t);
            std::free(syms);
            tables_ok = false;
            break;
        }
        std::memset(t->freq, 0, sizeof(t->freq));
        t->sym_of = syms;
        tables[ctx] = t;
        int i = 0;
        while (i < n_alpha && tr.ok) {
            uint64_t f = tr.uint7();
            t->freq[alphabet[i]] = (uint16_t)f;
            if (f == 0) {
                int run = tr.byte();
                i += run;
            }
            i++;
        }
        if (!tr.ok || !finish_table(*t, SHIFT_O1)) tables_ok = false;
    }

    if (tables_ok) {
        if (comp != 1) r.p = tr.p;
        if (r.end - r.p >= 4 * NX) {
            uint32_t states[32];
            for (int k = 0; k < NX; k++) {
                std::memcpy(&states[k], r.p, 4);
                r.p += 4;
            }
            const uint8_t* p = r.p;
            const uint8_t* end = r.end;
            const uint32_t mask = (1u << SHIFT_O1) - 1;
            int64_t q = out_size / NX;
            int64_t offs[32];
            uint8_t ctxs[32];
            for (int k = 0; k < NX; k++) {
                offs[k] = k * q;
                ctxs[k] = 0;
            }
            rc = 0;
            for (int64_t i = 0; i < q && rc == 0; i++) {
                for (int k = 0; k < NX; k++) {
                    Table* t = tables[ctxs[k]];
                    if (!t) { rc = 1; break; }
                    uint32_t x = states[k];
                    uint32_t m = x & mask;
                    uint8_t s = t->sym_of[m];
                    out[offs[k] + i] = s;
                    x = t->freq[s] * (x >> SHIFT_O1) + m - t->cum[s];
                    if (!renorm16(x, p, end)) { rc = 1; break; }
                    states[k] = x;
                    ctxs[k] = s;
                }
            }
            if (rc == 0) {
                uint8_t ctx = ctxs[NX - 1];
                uint32_t x = states[NX - 1];
                for (int64_t i = NX * q; i < out_size; i++) {
                    Table* t = tables[ctx];
                    if (!t) { rc = 1; break; }
                    uint32_t m = x & mask;
                    uint8_t s = t->sym_of[m];
                    out[i] = s;
                    x = t->freq[s] * (x >> SHIFT_O1) + m - t->cum[s];
                    if (!renorm16(x, p, end)) { rc = 1; break; }
                    ctx = s;
                }
                r.p = p;
            }
        }
    }

    for (int c = 0; c < 256; c++) {
        if (tables[c]) {
            std::free(tables[c]->sym_of);
            std::free(tables[c]);
        }
    }
    if (table_buf) std::free(table_buf);
    return rc;
}

// Full-stream decode (flags + transforms). out_size is the caller's
// expected raw size (for NOSZ sub-streams it comes from the parent).
int decode_stream(const uint8_t* data, int64_t data_len, uint8_t* out,
                  int64_t out_size) {
    Reader r{data, data + data_len};
    uint8_t flags = r.byte();
    if (!r.ok) return 1;
    const int NX = (flags & F_X32) ? 32 : 4;

    int64_t raw_size = out_size;
    if (!(flags & F_NOSZ)) {
        raw_size = (int64_t)r.uint7();
        if (!r.ok || raw_size != out_size) return 1;
    }
    if (raw_size == 0) return 0;

    if (flags & F_STRIPE) {
        int n = r.byte();
        if (!r.ok || n <= 0) return 1;
        int64_t lens[256];
        for (int j = 0; j < n; j++) {
            uint64_t lj = r.uint7();
            if (!r.ok || lj > (uint64_t)(r.end - r.p)) return 1;
            lens[j] = (int64_t)lj;
        }
        int64_t max_sub = (raw_size + n - 1) / n;
        uint8_t* sub = (uint8_t*)std::malloc(max_sub ? max_sub : 1);
        if (!sub) return 1;
        int rc = 0;
        for (int j = 0; j < n && rc == 0; j++) {
            int64_t sub_size = (raw_size - j + n - 1) / n;
            if ((uint64_t)lens[j] > (uint64_t)(r.end - r.p)) { rc = 1; break; }
            rc = decode_stream(r.p, lens[j], sub, sub_size);
            if (rc == 0) {
                for (int64_t i = 0; i < sub_size; i++)
                    out[j + i * n] = sub[i];
            }
            r.p += lens[j];
        }
        std::free(sub);
        return rc;
    }

    // PACK meta
    const uint8_t* pack_vals = nullptr;
    int pack_nsym = 0;
    int64_t payload_size = raw_size;
    if (flags & F_PACK) {
        pack_nsym = r.byte();
        if (!r.ok || pack_nsym > 16) return 1;
        pack_vals = r.p;
        r.p += pack_nsym;
        if (r.p > r.end) return 1;
        uint64_t packed_raw = r.uint7();
        if (!r.ok || packed_raw > (uint64_t)(1) << 40) return 1;
        payload_size = (int64_t)packed_raw;
    }

    // RLE meta
    uint8_t* rle_meta = nullptr;
    int64_t rle_meta_len = 0;
    bool rle_meta_owned = false;
    int64_t entropy_size = payload_size;
    if (flags & F_RLE) {
        uint64_t meta_word = r.uint7();
        uint64_t lit_raw = r.uint7();
        if (!r.ok || lit_raw > (uint64_t)(1) << 40) return 1;
        int64_t lit_len = (int64_t)lit_raw;
        if ((meta_word >> 1) > (uint64_t)(1) << 30) return 1;
        rle_meta_len = (int64_t)(meta_word >> 1);
        if (meta_word & 1) {
            if ((uint64_t)rle_meta_len > (uint64_t)(r.end - r.p)) return 1;
            rle_meta = (uint8_t*)r.p;
            r.p += rle_meta_len;
        } else {
            int64_t comp_len = (int64_t)r.uint7();
            if (!r.ok || (uint64_t)comp_len > (uint64_t)(r.end - r.p)) return 1;
            rle_meta = (uint8_t*)std::malloc(rle_meta_len ? rle_meta_len : 1);
            if (!rle_meta) return 1;
            rle_meta_owned = true;
            Reader mr{r.p, r.p + comp_len};
            if (decode_o0(mr, rle_meta, rle_meta_len)) {
                std::free(rle_meta);
                return 1;
            }
            r.p += comp_len;
        }
        entropy_size = lit_len;
    }

    // entropy / CAT body -> scratch (or straight to out when no
    // transform remains)
    bool direct = !(flags & (F_RLE | F_PACK));
    uint8_t* body = direct ? out
                           : (uint8_t*)std::malloc(entropy_size ? entropy_size : 1);
    if (!body) {
        if (rle_meta_owned) std::free(rle_meta);
        return 1;
    }
    int rc;
    if (flags & F_CAT) {
        rc = ((uint64_t)entropy_size <= (uint64_t)(r.end - r.p)) ? 0 : 1;
        if (rc == 0) std::memcpy(body, r.p, entropy_size);
    } else if (flags & F_ORDER1) {
        rc = decode_o1(r, body, entropy_size, NX);
    } else {
        rc = decode_o0(r, body, entropy_size, NX);
    }

    // RLE expand
    uint8_t* expanded = body;
    bool expanded_owned = false;
    if (rc == 0 && (flags & F_RLE)) {
        bool flagged[256] = {false};
        Reader mr{rle_meta, rle_meta + rle_meta_len};
        int nsym = mr.byte();
        if (nsym == 0) nsym = 256;
        for (int i = 0; i < nsym && mr.ok; i++) flagged[mr.byte()] = true;
        expanded = (flags & F_PACK)
                       ? (uint8_t*)std::malloc(payload_size ? payload_size : 1)
                       : out;
        expanded_owned = (flags & F_PACK) != 0;
        if (!expanded) {
            rc = 1;
        } else {
            int64_t oi = 0;
            for (int64_t i = 0; i < entropy_size && rc == 0; i++) {
                uint8_t b = body[i];
                if (flagged[b]) {
                    int64_t run = (int64_t)mr.uint7() + 1;
                    if (!mr.ok || oi + run > payload_size) { rc = 1; break; }
                    std::memset(expanded + oi, b, run);
                    oi += run;
                } else {
                    if (oi + 1 > payload_size) { rc = 1; break; }
                    expanded[oi++] = b;
                }
            }
            if (rc == 0 && oi != payload_size) rc = 1;
        }
    }

    // PACK unpack (bounds-checked: a malformed stream can declare a
    // packed length smaller than raw_size requires — indexing past the
    // decoded buffer would be a heap overread returning garbage)
    if (rc == 0 && (flags & F_PACK)) {
        int64_t needed = 0;
        if (pack_nsym == 2) needed = (raw_size + 7) / 8;
        else if (pack_nsym > 2 && pack_nsym <= 4) needed = (raw_size + 3) / 4;
        else if (pack_nsym > 4) needed = (raw_size + 1) / 2;
        if (payload_size < needed) rc = 1;
    }
    if (rc == 0 && (flags & F_PACK)) {
        const uint8_t* packed = expanded;
        if (pack_nsym <= 1) {
            std::memset(out, pack_nsym == 1 ? pack_vals[0] : 0, raw_size);
        } else if (pack_nsym == 2) {
            for (int64_t i = 0; i < raw_size; i++)
                out[i] = pack_vals[(packed[i >> 3] >> (i & 7)) & 1];
        } else if (pack_nsym <= 4) {
            for (int64_t i = 0; i < raw_size; i++)
                out[i] = pack_vals[(packed[i >> 2] >> ((i & 3) * 2)) & 3];
        } else {
            for (int64_t i = 0; i < raw_size; i++)
                out[i] = pack_vals[(packed[i >> 1] >> ((i & 1) * 4)) & 15];
        }
    }

    if (expanded_owned) std::free(expanded);
    if (!direct) std::free(body);
    if (rle_meta_owned) std::free(rle_meta);
    return rc;
}

}  // namespace rans4x16

extern "C" {

// data: full rANS Nx16 stream (flags byte onward). out: raw_size bytes
// (the caller parses the size). Returns 0 on success; nonzero on
// malformed/unsupported input (caller falls back to the Python codec).
int clair_rans4x16_decompress(const uint8_t* data, int64_t data_len,
                              uint8_t* out, int64_t out_size) {
    if (data_len < 1 || out_size < 0) return 1;
    return rans4x16::decode_stream(data, data_len, out, out_size);
}

}  // extern "C"
