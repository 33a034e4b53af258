// Native fqzcomp quality decoder (CRAM 3.1 block compression method 7).
//
// Byte-exact port of io/fqzcomp.py::decompress — same stream grammar
// (version 5, single parameter set, in-stream record lengths), same
// carry-counting range coder and SIMPLE_MODEL adaptive frequency model
// as clair_arith.cpp (the coder fqzcomp builds on), with the model
// generalised to the stream's dense quality alphabet (nsym <= 256).
// Python io/fqzcomp.py remains the reference implementation and the
// fallback: any nonzero return sends the caller back to it, so a stream
// this decoder rejects (unsupported gflags, hostile context geometry)
// decodes identically to a Python-only build.
//
// Context model (mirrors _Ctx in io/fqzcomp.py): 16-bit context from the
// previous QCTX=2 mapped quality values (qbits each), a log2-spaced read
// position bucket (pbits), and a saturating mismatch counter (dbits).
// Contexts are materialised lazily — real streams touch a small fraction
// of the 2^16 possible contexts, and each model is ~1.3 KB.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace fqz {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t STEP = 16;
constexpr uint32_t MAX_TOTAL = (1u << 16) - STEP;
constexpr int QCTX = 2;
constexpr int CTX_BITS = 16;

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

// SIMPLE_MODEL over a variable alphabet (clair_arith.cpp's Model is
// fixed at 256 symbols; quality models here span the mapped alphabet)
struct Model {
    std::vector<uint32_t> freqs;
    std::vector<uint16_t> syms;
    uint32_t total;

    explicit Model(int nsym)
        : freqs((size_t)nsym, 1), syms((size_t)nsym), total((uint32_t)nsym) {
        for (int i = 0; i < nsym; i++) syms[(size_t)i] = (uint16_t)i;
    }
    void bump(size_t i) {
        freqs[i] += STEP;
        total += STEP;
        if (i > 0 && freqs[i] > freqs[i - 1]) {
            std::swap(syms[i], syms[i - 1]);
            std::swap(freqs[i], freqs[i - 1]);
        }
        if (total > MAX_TOTAL) {
            total = 0;
            for (size_t j = 0; j < freqs.size(); j++) {
                freqs[j] -= freqs[j] >> 1;
                total += freqs[j];
            }
        }
    }
    int decode(RangeDecoder& rc) {
        uint32_t f = rc.get_freq(total);
        uint32_t cum = 0;
        size_t i = 0;
        while (cum + freqs[i] <= f) cum += freqs[i++];
        int sym = syms[i];
        rc.update(cum, freqs[i]);
        bump(i);
        return sym;
    }
};

inline int pos_bucket(int64_t i, int pbits) {
    int bl = i > 0 ? 64 - __builtin_clzll((uint64_t)i) : 0;
    int cap = (1 << pbits) - 1;
    return bl < cap ? bl : cap;
}

struct Ctx {
    int qbits, pbits, dbits;
    uint32_t qmask;
    uint32_t hist = 0;
    uint32_t delta = 0;

    Ctx(int qb, int pb, int db)
        : qbits(qb), pbits(pb), dbits(db),
          qmask((1u << (qb * QCTX)) - 1) {}
    void reset() { hist = 0; delta = 0; }
    uint32_t value(int64_t pos) const {
        uint32_t d = delta;
        uint32_t dcap = (1u << dbits) - 1;
        if (d > dcap) d = dcap;
        uint32_t ctx = hist & qmask;
        ctx |= (uint32_t)pos_bucket(pos, pbits) << (qbits * QCTX);
        ctx |= d << (qbits * QCTX + pbits);
        return ctx & ((1u << CTX_BITS) - 1);
    }
    void push(uint32_t mapped) {
        uint32_t prev = hist & ((1u << qbits) - 1);
        uint32_t q = mapped & ((1u << qbits) - 1);
        hist = ((hist << qbits) | q) & qmask;
        if (q != prev) {
            delta = delta < 255 ? delta + 1 : 255;
        } else {
            delta -= delta >> 1;
        }
    }
};

}  // namespace fqz

extern "C" {

// Full-stream decode. Returns 0 on success, nonzero when malformed or
// outside this decoder's support (the caller falls back to Python).
// `out_size` must equal the block's promised raw size.
int clair_fqzcomp_decompress(const uint8_t* data, int64_t data_len,
                             uint8_t* out, int64_t out_size) {
    using namespace fqz;
    if (!data || !out || data_len < 9 || out_size < 0) return 1;
    try {
        const uint8_t* p = data;
        const uint8_t* end = data + data_len;
        uint8_t version = p[0], gflags = p[1];
        int qbits = p[3], qshift = p[4], pbits = p[5], dbits = p[6];
        p += 7;
        if (version != 5 || gflags != 0 || qshift != qbits) return 1;
        // the context geometry must fit the 16-bit context (hostile
        // widths would shift past the accumulator; the encoder emits
        // qbits<=6, pbits=dbits=3)
        if (qbits < 1 || qbits * QCTX + pbits + dbits > CTX_BITS) return 1;

        uint64_t n_records = 0;
        {   // uint7
            bool done = false;
            for (int i = 0; i < 10 && p < end; i++) {
                uint8_t b = *p++;
                n_records = (n_records << 7) | (b & 0x7F);
                if (!(b & 0x80)) { done = true; break; }
            }
            if (!done) return 1;
        }
        if (p >= end) return 1;
        int nsym = *p++ + 1;
        if (end - p < nsym) return 1;
        const uint8_t* alphabet = p;
        p += nsym;

        RangeDecoder rc(p, end);
        std::unique_ptr<Model> len_models[4];
        for (int k = 0; k < 4; k++) len_models[k].reset(new Model(256));
        // lazily-materialised per-context quality models
        std::vector<std::unique_ptr<Model>> qual_models(1u << CTX_BITS);
        Ctx ctx(qbits, pbits, dbits);

        int64_t out_pos = 0;
        for (uint64_t rec = 0; rec < n_records; rec++) {
            uint32_t rec_len = 0;
            for (int k = 0; k < 4; k++)
                rec_len |= (uint32_t)len_models[k]->decode(rc) << (8 * k);
            // bail before decoding a hostile multi-GB record, not after
            if ((int64_t)rec_len > out_size - out_pos) return 1;
            ctx.reset();
            for (uint32_t i = 0; i < rec_len; i++) {
                uint32_t c = ctx.value((int64_t)i);
                if (!qual_models[c])
                    qual_models[c].reset(new Model(nsym));
                int mapped = qual_models[c]->decode(rc);
                out[out_pos++] = alphabet[mapped];
                ctx.push((uint32_t)mapped);
            }
        }
        return out_pos == out_size ? 0 : 1;
    } catch (...) {
        // bad_alloc etc. must not cross the ctypes boundary
        return 1;
    }
}

}  // extern "C"
