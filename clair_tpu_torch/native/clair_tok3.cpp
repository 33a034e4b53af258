// tok3 name-tokenizer decoder (CRAM 3.1 block method 8) — native
// counterpart of clair_tpu/io/tok3.py. Read-name blocks in 3.1 files
// decode through this at C speed (the name streams ride the native
// rANS Nx16 / arith decoders in this same library); the pure-Python
// module remains the reference implementation, the encoder, and the
// fallback (cross-checked in tests/test_tok3.py).
//
// Grammar (see io/tok3.py): u32 ulen | u32 nnames | u8 flags, then
// per-(token position, type) streams with descriptor bytes (0x80 new
// position, 0x40 duplicate-of-earlier-stream + uint7 index; else uint7
// compressed length + one rANS Nx16 / arith stream). Names rebuild via
// DUP/DIFF selectors and MATCH/DELTA/DELTA0/ALPHA/CHAR/DIGITS/DIGITS0
// tokens against the reference name.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

extern "C" {
int clair_rans4x16_decompress(const uint8_t* data, int64_t data_len,
                              uint8_t* out, int64_t out_size);
int clair_arith_decompress(const uint8_t* data, int64_t data_len,
                           uint8_t* out, int64_t out_size);
}

namespace tok3 {

enum TokType : uint8_t {
    T_TYPE = 0, T_ALPHA = 1, T_CHAR = 2, T_DIGITS0 = 3, T_DZLEN = 4,
    T_DUP = 5, T_DIFF = 6, T_DIGITS = 7, T_DELTA = 8, T_DELTA0 = 9,
    T_MATCH = 10, T_NOP = 11, T_END = 12, N_TYPES = 13,
};

constexpr uint8_t F_ARITH = 0x01;
constexpr uint8_t F_NEWLINE = 0x02;
constexpr uint8_t F_NO_FINAL_SEP = 0x04;

constexpr uint8_t D_NEW_POS = 0x80;
constexpr uint8_t D_DUP = 0x40;

struct Cursor {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    bool ok = true;

    uint8_t byte() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
    uint32_t u32() {
        if (end - p < 4) { ok = false; return 0; }
        uint32_t v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
    bool cstr(const uint8_t** s, int64_t* n) {
        const uint8_t* z =
            (const uint8_t*)std::memchr(p, 0, (size_t)(end - p));
        if (!z) { ok = false; return false; }
        *s = p;
        *n = z - p;
        p = z + 1;
        return true;
    }
};

static uint64_t read_uint7(Cursor& c) {
    uint64_t v = 0;
    for (int i = 0; i < 10; i++) {
        uint8_t b = c.byte();
        v = (v << 7) | (b & 0x7F);
        if (!(b & 0x80)) return v;
    }
    c.ok = false;
    return 0;
}

// one decompressed (position, type) stream
struct StreamBuf {
    std::vector<uint8_t> data;
    Cursor cur;

    void bind() {
        cur.p = data.data();
        cur.end = data.data() + data.size();
    }
};

struct Key {
    int pos;
    int typ;
};

static bool parse_digits(const std::string& tok, uint64_t* v) {
    if (tok.empty() || tok.size() > 19) return false;
    uint64_t acc = 0;
    for (char ch : tok) {
        if (ch < '0' || ch > '9') return false;
        acc = acc * 10 + (uint64_t)(ch - '0');
    }
    *v = acc;
    return true;
}

static bool decode(const uint8_t* data, int64_t len, uint8_t* out,
                   int64_t out_size) {
    if (len < 9) return false;
    Cursor top{data, data + len};
    uint32_t ulen = top.u32();
    uint32_t nnames = top.u32();
    uint8_t flags = top.byte();
    if (!top.ok || (int64_t)ulen != out_size) return false;
    bool use_arith = flags & F_ARITH;
    uint8_t sep = (flags & F_NEWLINE) ? '\n' : '\0';

    // streams in emission order + (pos, type) lookup
    std::vector<StreamBuf> streams;
    std::vector<Key> keys;
    int token_pos = -1;
    while (top.p < top.end) {
        uint8_t desc = top.byte();
        int typ = desc & 0x3F;
        if (typ >= N_TYPES) return false;
        if (desc & D_NEW_POS) token_pos++;
        // the first stream must open position 0 (else keys[i].pos = -1
        // would index before the dense table below)
        if (token_pos < 0) return false;
        streams.emplace_back();
        StreamBuf& sb = streams.back();
        if (desc & D_DUP) {
            uint64_t idx = read_uint7(top);
            // current stream is at size()-1; a duplicate may only point
            // at a strictly earlier one (no +1 arithmetic: idx is
            // attacker-controlled and may be UINT64_MAX)
            if (!top.ok || idx >= streams.size() - 1) return false;
            sb.data = streams[idx].data;  // copy: independent cursor
        } else {
            uint64_t clen = read_uint7(top);
            if (!top.ok || (int64_t)clen > top.end - top.p) return false;
            // both nested codecs carry their raw size up front
            // (flags byte + uint7), never NOSZ in tok3 streams
            Cursor peek{top.p, top.p + clen};
            peek.byte();  // nested flags
            uint64_t raw = read_uint7(peek);
            if (!peek.ok || raw > (uint64_t)1 << 40) return false;
            sb.data.resize(raw);
            int rc = use_arith
                ? clair_arith_decompress(top.p, clen, sb.data.data(), raw)
                : clair_rans4x16_decompress(top.p, clen, sb.data.data(), raw);
            if (rc != 0) return false;
            top.p += clen;
        }
        sb.bind();
        keys.push_back(Key{token_pos, typ});
    }

    int max_pos = token_pos;
    if (max_pos < 0) return false;
    // dense (pos, type) -> stream table
    std::vector<int> table((size_t)(max_pos + 1) * N_TYPES, -1);
    for (size_t i = 0; i < keys.size(); i++)
        table[(size_t)keys[i].pos * N_TYPES + keys[i].typ] = (int)i;
    auto stream_at = [&](int pos, int typ) -> Cursor* {
        if (pos > max_pos) return nullptr;
        int idx = table[(size_t)pos * N_TYPES + typ];
        return idx < 0 ? nullptr : &streams[idx].cur;
    };

    std::vector<std::vector<std::string>> toks_of(nnames);
    std::string blob;
    blob.reserve(ulen);
    char scratch[32];

    for (uint32_t i = 0; i < nnames; i++) {
        Cursor* sel_c = stream_at(0, T_TYPE);
        if (!sel_c) return false;
        int sel = sel_c->byte();
        if (!sel_c->ok) return false;
        if (sel == T_DUP) {
            Cursor* d = stream_at(0, T_DUP);
            if (!d) return false;
            uint32_t dist = d->u32();
            if (!d->ok) return false;
            int64_t src = dist ? (int64_t)i - dist : (int64_t)i - 1;
            if (src < 0 || src >= (int64_t)i) return false;
            toks_of[i] = toks_of[src];
            for (const std::string& t : toks_of[i]) blob += t;
        } else if (sel == T_DIFF) {
            Cursor* d = stream_at(0, T_DIFF);
            if (!d) return false;
            uint32_t dist = d->u32();
            if (!d->ok) return false;
            const std::vector<std::string>* ref_toks = nullptr;
            if (dist) {
                int64_t src = (int64_t)i - dist;
                if (src < 0 || src >= (int64_t)i) return false;
                ref_toks = &toks_of[src];
            }
            std::vector<std::string>& toks = toks_of[i];
            for (int t = 1;; t++) {
                Cursor* tc = stream_at(t, T_TYPE);
                if (!tc) return false;
                int typ = tc->byte();
                if (!tc->ok) return false;
                if (typ == T_END) break;
                std::string tok;
                switch (typ) {
                    case T_NOP:
                        break;
                    case T_MATCH: {
                        if (!ref_toks || (size_t)(t - 1) >= ref_toks->size())
                            return false;
                        tok = (*ref_toks)[t - 1];
                        break;
                    }
                    case T_ALPHA: {
                        Cursor* c = stream_at(t, T_ALPHA);
                        const uint8_t* s;
                        int64_t n;
                        if (!c || !c->cstr(&s, &n)) return false;
                        tok.assign((const char*)s, n);
                        break;
                    }
                    case T_CHAR: {
                        Cursor* c = stream_at(t, T_CHAR);
                        if (!c) return false;
                        uint8_t b = c->byte();
                        if (!c->ok) return false;
                        tok.assign(1, (char)b);
                        break;
                    }
                    case T_DIGITS: {
                        Cursor* c = stream_at(t, T_DIGITS);
                        if (!c) return false;
                        uint32_t v = c->u32();
                        if (!c->ok) return false;
                        tok.assign(scratch,
                                   (size_t)std::snprintf(scratch, sizeof scratch,
                                                         "%u", v));
                        break;
                    }
                    case T_DIGITS0: {
                        Cursor* c = stream_at(t, T_DIGITS0);
                        Cursor* z = stream_at(t, T_DZLEN);
                        if (!c || !z) return false;
                        uint32_t v = c->u32();
                        int ndig = z->byte();
                        if (!c->ok || !z->ok || ndig <= 0 ||
                            ndig >= (int)sizeof scratch)
                            return false;
                        tok.assign(scratch,
                                   (size_t)std::snprintf(scratch, sizeof scratch,
                                                         "%0*u", ndig, v));
                        break;
                    }
                    case T_DELTA: {
                        Cursor* c = stream_at(t, T_DELTA);
                        if (!c || !ref_toks ||
                            (size_t)(t - 1) >= ref_toks->size())
                            return false;
                        uint8_t delta = c->byte();
                        if (!c->ok) return false;
                        uint64_t base;
                        if (!parse_digits((*ref_toks)[t - 1], &base))
                            return false;
                        tok.assign(scratch,
                                   (size_t)std::snprintf(scratch, sizeof scratch,
                                                         "%llu",
                                                         (unsigned long long)(base + delta)));
                        break;
                    }
                    case T_DELTA0: {
                        Cursor* c = stream_at(t, T_DELTA0);
                        if (!c || !ref_toks ||
                            (size_t)(t - 1) >= ref_toks->size())
                            return false;
                        uint8_t delta = c->byte();
                        if (!c->ok) return false;
                        const std::string& ref_tok = (*ref_toks)[t - 1];
                        uint64_t base;
                        if (!parse_digits(ref_tok, &base)) return false;
                        int width = (int)ref_tok.size();
                        if (width <= 0 || width >= (int)sizeof scratch)
                            return false;
                        int n = std::snprintf(scratch, sizeof scratch, "%0*llu",
                                              width,
                                              (unsigned long long)(base + delta));
                        // Python zfill never truncates: keep any overflow
                        tok.assign(scratch, (size_t)n);
                        break;
                    }
                    default:
                        return false;  // DUP/DIFF/TYPE mid-name
                }
                blob += tok;
                toks.push_back(std::move(tok));
            }
        } else {
            return false;
        }
        if (i + 1 < nnames || !(flags & F_NO_FINAL_SEP))
            blob += (char)sep;
    }
    // Python joins with sep BETWEEN names and appends a trailing one
    // unless F_NO_FINAL_SEP; the loop above does exactly that.
    if ((int64_t)blob.size() != out_size) return false;
    std::memcpy(out, blob.data(), out_size);
    return true;
}

}  // namespace tok3

extern "C" {

// Full-block decode. Returns 0 on success, nonzero when malformed /
// unsupported (callers fall back to the Python codec).
int clair_tok3_decode(const uint8_t* data, int64_t data_len, uint8_t* out,
                      int64_t out_size) {
    if (!data || !out) return 1;
    try {
        return tok3::decode(data, data_len, out, out_size) ? 0 : 1;
    } catch (...) {
        return 1;
    }
}

}  // extern "C"
