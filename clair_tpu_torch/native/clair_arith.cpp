// Adaptive arithmetic decoder (CRAM 3.1 block method 6) — native
// counterpart of clair_tpu/io/arith.py. Archive-profile 3.1 files code
// every data series with this codec, so block decode must run at C
// speed; the pure-Python module remains the reference implementation,
// the encoder, and the fallback (cross-checked in tests/test_arith.py).
//
// Handles the full stream grammar: order-0/1 adaptive byte models over
// the carry-counting range coder, the RLE variant (per-symbol run
// models with 255-chunk chaining), and the PACK / STRIPE / CAT / NOSZ
// transforms (STRIPE recurses into NOSZ sub-streams). EXT (bzip2)
// returns unsupported — the Python path owns it (stdlib bz2), keeping
// this library free of a libbz2 dependency.
//
// The adaptive model must mirror io/arith.py bit-for-bit: +16 per hit,
// halving rescale when the total passes 2^16-16, one bubble-swap toward
// the front per hit. Frequencies are 32-bit here because a single
// frequency can legally reach the rescale bound.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <memory>

namespace arith_codec {

constexpr uint8_t F_ORDER1 = 0x01;
constexpr uint8_t F_EXT = 0x04;
constexpr uint8_t F_STRIPE = 0x08;
constexpr uint8_t F_NOSZ = 0x10;
constexpr uint8_t F_CAT = 0x20;
constexpr uint8_t F_RLE = 0x40;
constexpr uint8_t F_PACK = 0x80;

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t STEP = 16;
constexpr uint32_t MAX_TOTAL = (1u << 16) - STEP;

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint8_t byte() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
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

struct RangeDecoder {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = 0;
    uint32_t r = 0;

    RangeDecoder(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {
        for (int i = 0; i < 5; i++) code = (code << 8) | in();
    }
    uint8_t in() { return p < end ? *p++ : 0; }
    uint32_t get_freq(uint32_t tot) {
        r = range / tot;
        uint32_t f = code / r;
        return f >= tot ? tot - 1 : f;
    }
    void update(uint32_t cum, uint32_t freq) {
        code -= cum * r;
        range = r * freq;
        while (range < TOP) {
            code = (code << 8) | in();
            range <<= 8;
        }
    }
};

struct Model {
    uint32_t freqs[256];
    uint8_t syms[256];
    uint32_t total;

    void init() {
        for (int i = 0; i < 256; i++) {
            freqs[i] = 1;
            syms[i] = (uint8_t)i;
        }
        total = 256;
    }
    void bump(int i) {
        freqs[i] += STEP;
        total += STEP;
        if (i > 0 && freqs[i] > freqs[i - 1]) {
            uint8_t ts = syms[i]; syms[i] = syms[i - 1]; syms[i - 1] = ts;
            uint32_t tf = freqs[i]; freqs[i] = freqs[i - 1]; freqs[i - 1] = tf;
        }
        if (total > MAX_TOTAL) {
            total = 0;
            for (int j = 0; j < 256; j++) {
                freqs[j] -= freqs[j] >> 1;
                total += freqs[j];
            }
        }
    }
    int decode(RangeDecoder& rc) {
        uint32_t f = rc.get_freq(total);
        uint32_t cum = 0;
        int i = 0;
        while (cum + freqs[i] <= f) cum += freqs[i++];
        int sym = syms[i];
        rc.update(cum, freqs[i]);
        bump(i);
        return sym;
    }
};

// lazily-initialised bank of 256 contexts (order-1 / per-symbol runs)
struct ModelBank {
    std::unique_ptr<Model[]> models{new Model[256]};
    bool live[256] = {false};

    Model& ctx(int c) {
        if (!live[c]) {
            models[c].init();
            live[c] = true;
        }
        return models[c];
    }
};

static bool decode_o0(const uint8_t* p, const uint8_t* end, uint8_t* out,
                      int64_t n) {
    RangeDecoder rc(p, end);
    Model m;
    m.init();
    for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)m.decode(rc);
    return true;
}

static bool decode_o1(const uint8_t* p, const uint8_t* end, uint8_t* out,
                      int64_t n) {
    RangeDecoder rc(p, end);
    ModelBank bank;
    int ctx = 0;
    for (int64_t i = 0; i < n; i++)
        ctx = out[i] = (uint8_t)bank.ctx(ctx).decode(rc);
    return true;
}

static bool decode_rle(const uint8_t* p, const uint8_t* end, uint8_t* out,
                       int64_t out_size, int order) {
    RangeDecoder rc(p, end);
    ModelBank lits;
    ModelBank runs;
    Model cont;
    cont.init();
    int ctx = 0;
    int64_t pos = 0;
    while (pos < out_size) {
        int b = lits.ctx(order ? ctx : 0).decode(rc);
        ctx = b;
        int chunk = runs.ctx(b).decode(rc);
        int64_t run = 1 + chunk;
        while (chunk == 255) {
            chunk = cont.decode(rc);
            run += chunk;
        }
        if (pos + run > out_size) return false;
        std::memset(out + pos, b, run);
        pos += run;
    }
    return pos == out_size;
}

static bool decode_stream(const uint8_t* data, int64_t len, uint8_t* out,
                          int64_t out_size);

static bool decode_stripe(Reader& r, uint8_t* out, int64_t raw_size) {
    int n = r.byte();
    if (!r.ok || n <= 0) return false;
    std::vector<uint64_t> lens(n);
    for (int j = 0; j < n; j++) lens[j] = r.uint7();
    if (!r.ok) return false;
    std::vector<uint8_t> sub;
    for (int j = 0; j < n; j++) {
        int64_t sub_size = (raw_size - j + n - 1) / n;
        if ((int64_t)lens[j] > r.end - r.p) return false;
        sub.resize(sub_size);
        if (!decode_stream(r.p, lens[j], sub.data(), sub_size)) return false;
        r.p += lens[j];
        for (int64_t i = 0; i < sub_size; i++) out[j + i * n] = sub[i];
    }
    return true;
}

static bool decode_stream(const uint8_t* data, int64_t len, uint8_t* out,
                          int64_t out_size) {
    if (len <= 0 || out_size < 0) return false;
    Reader r{data, data + len};
    uint8_t flags = r.byte();
    int64_t raw_size;
    if (flags & F_NOSZ) {
        raw_size = out_size;
    } else {
        raw_size = (int64_t)r.uint7();
    }
    if (!r.ok || raw_size != out_size) return false;
    if (raw_size == 0) return out_size == 0;
    if (flags & F_EXT) return false;  // bzip2 body: Python fallback
    if (flags & F_STRIPE) return decode_stripe(r, out, raw_size);

    // PACK meta: nsym, values, uint7 packed length
    const uint8_t* pack_values = nullptr;
    int pack_nsym = -1;
    int64_t payload_size = raw_size;
    if (flags & F_PACK) {
        pack_nsym = r.byte();
        if (!r.ok || pack_nsym > 16) return false;
        pack_values = r.p;
        if (r.end - r.p < pack_nsym) return false;
        r.p += pack_nsym;
        payload_size = (int64_t)r.uint7();
        // packing only shrinks; an attacker-controlled huge length must
        // not reach packed.resize() (bad_alloc would cross the ABI)
        if (!r.ok || payload_size > raw_size) return false;
    }

    // decode the entropy body into `target` (out directly when no PACK)
    std::vector<uint8_t> packed;
    uint8_t* target = out;
    if (flags & F_PACK) {
        packed.resize(payload_size);
        target = packed.data();
    }
    bool body_ok;
    if (flags & F_CAT) {
        if (r.end - r.p < payload_size) return false;
        // n=0 memcpy with a null target (empty PACK buffer) is still UB
        if (payload_size > 0) std::memcpy(target, r.p, payload_size);
        body_ok = true;
    } else if (flags & F_RLE) {
        body_ok = decode_rle(r.p, r.end, target, payload_size,
                             (flags & F_ORDER1) ? 1 : 0);
    } else if (flags & F_ORDER1) {
        body_ok = decode_o1(r.p, r.end, target, payload_size);
    } else {
        body_ok = decode_o0(r.p, r.end, target, payload_size);
    }
    if (!body_ok) return false;

    if (flags & F_PACK) {
        // mirror io/rans4x16.py _pack_decode (arith shares the layout)
        if (pack_nsym <= 1) {
            if (pack_nsym == 1)
                std::memset(out, pack_values[0], raw_size);
            else
                return raw_size == 0;
            return true;
        }
        if (pack_nsym == 2) {
            for (int64_t i = 0; i < raw_size; i++) {
                if ((i >> 3) >= payload_size) return false;
                out[i] = pack_values[(packed[i >> 3] >> (i & 7)) & 1];
            }
        } else if (pack_nsym <= 4) {
            for (int64_t i = 0; i < raw_size; i++) {
                if ((i >> 2) >= payload_size) return false;
                out[i] = pack_values[(packed[i >> 2] >> ((i & 3) * 2)) & 3];
            }
        } else {
            for (int64_t i = 0; i < raw_size; i++) {
                if ((i >> 1) >= payload_size) return false;
                out[i] = pack_values[(packed[i >> 1] >> ((i & 1) * 4)) & 15];
            }
        }
    }
    return true;
}

}  // namespace arith_codec

extern "C" {

// Full-stream decode. Returns 0 on success, nonzero when malformed or
// when the stream needs the Python path (EXT). `out_size` must equal
// the stream's raw size.
int clair_arith_decompress(const uint8_t* data, int64_t data_len,
                           uint8_t* out, int64_t out_size) {
    if (!data || !out) return 1;
    try {
        return arith_codec::decode_stream(data, data_len, out, out_size)
                   ? 0
                   : 1;
    } catch (...) {
        // vector/bad_alloc etc. must not cross the ctypes boundary
        return 1;
    }
}

}  // extern "C"
