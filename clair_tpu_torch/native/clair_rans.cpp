// rANS 4x8 decoder (CRAM 3.0 block method 4) — native counterpart of
// clair_tpu/io/rans.py. CRAM blocks decode through this at C speed; the
// pure-Python decoder remains the reference implementation and fallback
// (they are cross-checked in tests/test_rans.py).
//
// The reference has no CRAM code of its own (samtools handles it,
// reference clair/callVarBam.py:122-181); this exists because the
// framework carries its own alignment IO stack.

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr uint32_t TOTFREQ = 4096;
constexpr uint32_t RANS_L = 1u << 23;

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
    uint32_t freq() {
        uint32_t f = byte();
        if (f >= 128) f = ((f & 0x7F) << 8) | byte();
        return f;
    }
};

struct Table {
    uint16_t freq[256];
    uint16_t cum[256];
    uint8_t sym_of[TOTFREQ];
};

// Shared symbol-walk (ascending symbols with consecutive-run RLE).
// Calls visit(sym) for each symbol; visit reads that symbol's payload.
template <typename Visit>
bool walk_symbols(Reader& r, Visit visit) {
    int rle = 0;
    int j = r.byte();
    while (r.ok) {
        if (!visit(j)) return false;
        if (!rle && r.p < r.end && r.peek() == j + 1) {
            j = r.byte();
            rle = r.byte();
        } else if (rle) {
            rle--;
            j++;
        } else {
            j = r.byte();
            if (j == 0) return r.ok;
        }
        if (j > 255) return false;
    }
    return false;
}

bool read_table(Reader& r, Table& t) {
    std::memset(t.freq, 0, sizeof(t.freq));
    // gap slots (tables summing < 4096) must decode deterministically as
    // symbol 0, exactly like the Python reference's zeroed sym_of
    std::memset(t.sym_of, 0, sizeof(t.sym_of));
    if (!walk_symbols(r, [&](int j) {
            t.freq[j] = (uint16_t)r.freq();
            return r.ok;
        }))
        return false;
    uint32_t x = 0;
    for (int j = 0; j < 256; j++) {
        if (!t.freq[j]) continue;
        t.cum[j] = (uint16_t)x;
        uint32_t end = x + t.freq[j];
        if (end > TOTFREQ) return false;
        std::memset(t.sym_of + x, j, t.freq[j]);
        x = end;
    }
    return true;
}

inline bool renorm(uint32_t& x, const uint8_t*& p, const uint8_t* end) {
    while (x < RANS_L) {
        if (p >= end) return false;
        x = (x << 8) | *p++;
    }
    return true;
}

int decode_o0(Reader& r, uint8_t* out, int64_t out_size) {
    Table t;
    if (!read_table(r, t)) return 1;
    if (r.end - r.p < 16) return 1;
    uint32_t states[4];
    for (int k = 0; k < 4; k++) {
        std::memcpy(&states[k], r.p, 4);
        r.p += 4;
    }
    const uint8_t* p = r.p;
    const uint8_t* end = r.end;
    int64_t main = out_size & ~int64_t(3);
    for (int64_t i = 0; i < main; i += 4) {
        for (int k = 0; k < 4; k++) {
            uint32_t x = states[k];
            uint32_t m = x & 0xFFF;
            uint8_t s = t.sym_of[m];
            out[i + k] = s;
            x = t.freq[s] * (x >> 12) + m - t.cum[s];
            if (!renorm(x, p, end)) return 1;
            states[k] = x;
        }
    }
    for (int k = 0; k < (int)(out_size & 3); k++)
        out[main + k] = t.sym_of[states[k] & 0xFFF];
    return 0;
}

int decode_o1(Reader& r, uint8_t* out, int64_t out_size) {
    // context tables allocated only for present contexts
    Table* tables[256] = {nullptr};
    int rc = 1;
    if (walk_symbols(r, [&](int ctx) {
            tables[ctx] = (Table*)std::malloc(sizeof(Table));
            if (!tables[ctx]) return false;
            return read_table(r, *tables[ctx]);
        })) {
        if (r.end - r.p >= 16) {
            uint32_t states[4];
            for (int k = 0; k < 4; k++) {
                std::memcpy(&states[k], r.p, 4);
                r.p += 4;
            }
            const uint8_t* p = r.p;
            const uint8_t* end = r.end;
            int64_t q = out_size >> 2;
            int64_t offs[4] = {0, q, 2 * q, 3 * q};
            uint8_t ctxs[4] = {0, 0, 0, 0};
            rc = 0;
            for (int64_t i = 0; i < q && rc == 0; i++) {
                for (int k = 0; k < 4; k++) {
                    Table* t = tables[ctxs[k]];
                    if (!t) { rc = 1; break; }
                    uint32_t x = states[k];
                    uint32_t m = x & 0xFFF;
                    uint8_t s = t->sym_of[m];
                    out[offs[k] + i] = s;
                    x = t->freq[s] * (x >> 12) + m - t->cum[s];
                    if (!renorm(x, p, end)) { rc = 1; break; }
                    states[k] = x;
                    ctxs[k] = s;
                }
            }
            if (rc == 0) {
                uint8_t ctx = ctxs[3];
                uint32_t x = states[3];
                for (int64_t i = 4 * q; i < out_size; i++) {
                    Table* t = tables[ctx];
                    if (!t) { rc = 1; break; }
                    uint32_t m = x & 0xFFF;
                    uint8_t s = t->sym_of[m];
                    out[i] = s;
                    x = t->freq[s] * (x >> 12) + m - t->cum[s];
                    if (!renorm(x, p, end)) { rc = 1; break; }
                    ctx = s;
                }
            }
        }
    }
    for (int c = 0; c < 256; c++)
        if (tables[c]) std::free(tables[c]);
    return rc;
}

}  // namespace

extern "C" {

// data: full stream including the 9-byte header. out: raw_size bytes
// (caller reads raw_size from the header and allocates). Returns 0 on
// success, nonzero on malformed input (caller falls back to Python).
int clair_rans_decompress(const uint8_t* data, int64_t data_len,
                          uint8_t* out, int64_t out_size) {
    if (data_len < 9) return 1;
    uint8_t order = data[0];
    uint32_t comp_size, raw_size;
    std::memcpy(&comp_size, data + 1, 4);
    std::memcpy(&raw_size, data + 5, 4);
    if ((int64_t)raw_size != out_size) return 1;
    if (9 + (int64_t)comp_size > data_len) return 1;
    if (out_size == 0) return 0;
    Reader r{data + 9, data + 9 + comp_size};
    if (order == 0) return decode_o0(r, out, out_size);
    if (order == 1) return decode_o1(r, out, out_size);
    return 1;
}

}  // extern "C"
