// Native CRAM slice-record decoder — the C counterpart of
// clair_tpu/io/cram.py::decode_slice_records. The reference has no CRAM
// code of its own (it shells out to samtools, CreateTensor.py:136); this
// repo's own stack keeps the Python decoder as the reference
// implementation and moves the per-record / per-feature loop — which
// dominates noisy long-read decode (~90 feature ops per 900 bp ONT
// read) — to C.
//
// Protocol: Python serializes the compression-header codecs, tag-line
// dictionary, substitution table, and slice geometry into a compact
// spec blob (see clair_tpu/io/cram.py::_native_spec); streams arrive as
// the core block plus concatenated external blocks. Results come back
// as flat arrays (positions / flags / concatenated seq + cigar + names
// with offset tables) that Python wraps into BamRecords.
//
// Return codes: 0 ok; 1 malformed stream (caller falls back to the
// Python decoder, which raises the precise error); 2 the decode needs
// reference bases outside the provided window (out->need_lo/hi say
// which — the caller re-prefetches and retries); 3 a codec/feature the
// native path does not cover (caller falls back).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <unordered_map>
#include <vector>

namespace cramdec {

// ---------------------------------------------------------------------
// errors (internal control flow; never cross the C boundary)
// ---------------------------------------------------------------------

struct Malformed {};
struct Unsupported {};
struct RefNeeded {
    int64_t lo, hi;
};

// ---------------------------------------------------------------------
// cursors
// ---------------------------------------------------------------------

struct Cursor {
    const uint8_t* data = nullptr;
    int64_t len = 0;
    int64_t pos = 0;

    uint8_t read_byte() {
        if (pos >= len) throw Malformed{};
        return data[pos++];
    }

    const uint8_t* read(int64_t n) {
        if (n < 0 || pos + n > len) throw Malformed{};
        const uint8_t* out = data + pos;
        pos += n;
        return out;
    }

    // bytes up to (not including) the stop byte; consumes the stop
    const uint8_t* read_until(uint8_t stop, int64_t* n_out) {
        int64_t p = pos;
        while (p < len && data[p] != stop) p++;
        if (p >= len) throw Malformed{};
        const uint8_t* out = data + pos;
        *n_out = p - pos;
        pos = p + 1;
        return out;
    }

    // CRAM ITF8 (io/cram.py ByteCursor.read_itf8 semantics, including
    // the signed wraparound of the 5-byte form)
    int64_t read_itf8() {
        uint32_t b0 = read_byte();
        if (b0 < 0x80) return (int64_t)b0;
        if (b0 < 0xC0) {
            uint32_t v = ((b0 << 8) | read_byte()) & 0x3FFF;
            return (int64_t)v;
        }
        if (b0 < 0xE0) {
            uint32_t v = (b0 << 16) | ((uint32_t)read_byte() << 8);
            v |= read_byte();
            return (int64_t)(v & 0x1FFFFF);
        }
        if (b0 < 0xF0) {
            uint32_t v = (b0 << 24) | ((uint32_t)read_byte() << 16);
            v |= (uint32_t)read_byte() << 8;
            v |= read_byte();
            return (int64_t)(v & 0x0FFFFFFF);
        }
        uint32_t v = (b0 & 0x0F) << 28;
        v |= (uint32_t)read_byte() << 20;
        v |= (uint32_t)read_byte() << 12;
        v |= (uint32_t)read_byte() << 4;
        v |= read_byte() & 0x0F;
        return (int64_t)(int32_t)v;  // signed wrap as in Python
    }
};

struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;
    int bit = 7;

    int read_bit() {
        if (pos >= len) throw Malformed{};
        int b = (data[pos] >> bit) & 1;
        if (bit == 0) {
            bit = 7;
            pos++;
        } else {
            bit--;
        }
        return b;
    }

    int64_t read_bits(int n) {
        // unsigned accumulator: n is file-derived, and once a hostile
        // width pushes the top bit in, (v << 1) on a signed value is UB
        uint64_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | (uint64_t)read_bit();
        return (int64_t)v;
    }
};

// ---------------------------------------------------------------------
// codecs (mirrors io/cram.py _build_codec family)
// ---------------------------------------------------------------------

enum CodecType : uint8_t {
    CK_MISSING = 0,
    CK_EXTERNAL = 1,
    CK_HUFFMAN = 2,
    CK_BETA = 3,
    CK_GAMMA = 4,
    CK_SUBEXP = 5,
    CK_BYTE_ARRAY_LEN = 6,
    CK_BYTE_ARRAY_STOP = 7,
    // quality series whose block was left undecompressed (skip_quals):
    // every read is a no-op returning the default qual / empty bytes
    CK_NOOP = 8,
};

struct HuffCode {
    int length;
    int64_t code;
    int64_t symbol;
};

struct Codec {
    uint8_t type = CK_MISSING;
    int32_t cid = 0;           // external / byte_array_stop
    int32_t offset = 0;        // beta / gamma / subexp
    int32_t nbits_or_k = 0;    // beta nbits / subexp k
    uint8_t stop = 0;          // byte_array_stop
    std::vector<HuffCode> huff;  // canonical order (length, code, symbol)
    bool huff_const = false;
    int64_t huff_const_value = 0;
    std::unique_ptr<Codec> len_codec;
    std::unique_ptr<Codec> val_codec;
};

struct SpecCursor {
    const uint8_t* p;
    const uint8_t* end;

    void need(int64_t n) const {
        if (p + n > end) throw Malformed{};
    }
    uint8_t u8() {
        need(1);
        return *p++;
    }
    int32_t i32() {
        need(4);
        int32_t v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
    int64_t i64() {
        need(8);
        int64_t v;
        std::memcpy(&v, p, 8);
        p += 8;
        return v;
    }
};

static void parse_codec(SpecCursor& s, Codec& c) {
    c.type = s.u8();
    switch (c.type) {
        case CK_MISSING:
        case CK_NOOP:
            break;
        case CK_EXTERNAL:
            c.cid = s.i32();
            break;
        case CK_HUFFMAN: {
            int32_t n = s.i32();
            if (n < 0 || n > (1 << 20)) throw Malformed{};
            // entries arrive pre-sorted by (length, symbol) with codes
            // assigned by Python (HuffmanCodec constructor semantics)
            c.huff.resize(n);
            for (int32_t i = 0; i < n; i++) {
                c.huff[i].symbol = s.i64();
                c.huff[i].length = s.u8();
                c.huff[i].code = s.i64();
            }
            if (n == 1 && c.huff[0].length == 0) {
                c.huff_const = true;
                c.huff_const_value = c.huff[0].symbol;
            }
            break;
        }
        case CK_BETA:
            c.offset = s.i32();
            c.nbits_or_k = s.i32();
            break;
        case CK_GAMMA:
            c.offset = s.i32();
            break;
        case CK_SUBEXP:
            c.offset = s.i32();
            c.nbits_or_k = s.i32();
            break;
        case CK_BYTE_ARRAY_LEN:
            c.len_codec = std::make_unique<Codec>();
            c.val_codec = std::make_unique<Codec>();
            parse_codec(s, *c.len_codec);
            parse_codec(s, *c.val_codec);
            break;
        case CK_BYTE_ARRAY_STOP:
            c.stop = s.u8();
            c.cid = s.i32();
            break;
        default:
            throw Unsupported{};
    }
}

// ---------------------------------------------------------------------
// decode context
// ---------------------------------------------------------------------

struct Streams {
    BitReader core;
    std::unordered_map<int32_t, Cursor> ext;

    Cursor& external(int32_t cid) {
        auto it = ext.find(cid);
        if (it == ext.end()) throw Malformed{};
        return it->second;
    }
};

static int64_t read_int(const Codec& c, Streams& s) {
    switch (c.type) {
        case CK_EXTERNAL:
            return s.external(c.cid).read_itf8();
        case CK_HUFFMAN: {
            if (c.huff_const) return c.huff_const_value;
            int length = 0;
            // unsigned accumulator: code lengths are file-derived, and a
            // hostile length walks the top bit in (signed << would be UB)
            uint64_t code = 0;
            for (const HuffCode& h : c.huff) {
                while (length < h.length) {
                    code = (code << 1) | (uint64_t)s.core.read_bit();
                    length++;
                }
                if (code == (uint64_t)h.code) return h.symbol;
            }
            throw Malformed{};
        }
        case CK_BETA:
            return s.core.read_bits(c.nbits_or_k) - c.offset;
        case CK_GAMMA: {
            int n = 0;
            while (s.core.read_bit() == 0) {
                if (++n > 63) throw Malformed{};
            }
            return (int64_t)(((uint64_t)1 << n) | (uint64_t)s.core.read_bits(n))
                   - c.offset;
        }
        case CK_SUBEXP: {
            int count = 0;
            while (s.core.read_bit() == 1) {
                if (++count > 63) throw Malformed{};
            }
            int64_t v;
            if (count == 0) {
                v = s.core.read_bits(c.nbits_or_k);
            } else {
                int n = count + c.nbits_or_k - 1;
                if (n > 62) throw Malformed{};
                v = (int64_t)(((uint64_t)1 << n)
                              | (uint64_t)s.core.read_bits(n));
            }
            return v - c.offset;
        }
        case CK_NOOP:
            return 30;  // skipped qual series: default qual
        case CK_MISSING:
            throw Malformed{};  // series referenced but absent (KeyError)
        default:
            throw Unsupported{};  // byte-array codec asked for an int
    }
}

// Python read_byte is read_int for HUFFMAN/BETA and a raw byte for
// EXTERNAL; GAMMA/SUBEXP have no read_byte (AttributeError there)
static int read_byte(const Codec& c, Streams& s) {
    switch (c.type) {
        case CK_EXTERNAL:
            return s.external(c.cid).read_byte();
        case CK_HUFFMAN:
        case CK_BETA:
            return (int)read_int(c, s);
        case CK_NOOP:
            return 30;
        case CK_MISSING:
            throw Malformed{};
        default:
            throw Unsupported{};
    }
}

// byte-array read; appends to out, returns appended length
static int64_t read_bytes(const Codec& c, Streams& s, std::vector<uint8_t>& out) {
    switch (c.type) {
        case CK_BYTE_ARRAY_LEN: {
            int64_t n = read_int(*c.len_codec, s);
            if (n < 0) throw Malformed{};
            const Codec& v = *c.val_codec;
            if (v.type == CK_EXTERNAL) {
                const uint8_t* src = s.external(v.cid).read(n);
                out.insert(out.end(), src, src + n);
            } else if (v.type == CK_HUFFMAN || v.type == CK_BETA) {
                for (int64_t i = 0; i < n; i++)
                    out.push_back((uint8_t)read_byte(v, s));
            } else {
                throw Unsupported{};
            }
            return n;
        }
        case CK_BYTE_ARRAY_STOP: {
            int64_t n = 0;
            const uint8_t* src = s.external(c.cid).read_until(c.stop, &n);
            out.insert(out.end(), src, src + n);
            return n;
        }
        case CK_NOOP:
            return 0;
        case CK_MISSING:
            throw Malformed{};
        default:
            // EXTERNAL read_bytes without a length raises in Python
            throw Unsupported{};
    }
}

// _read_byte_run: n bytes via raw external read or repeated read_byte
static void skip_byte_run(const Codec& c, Streams& s, int64_t n) {
    if (c.type == CK_NOOP) return;
    if (c.type == CK_EXTERNAL) {
        s.external(c.cid).read(n);
    } else {
        for (int64_t i = 0; i < n; i++) read_byte(c, s);
    }
}

static void read_byte_run_into(const Codec& c, Streams& s, uint8_t* dst,
                               int64_t n) {
    if (c.type == CK_EXTERNAL) {
        const uint8_t* src = s.external(c.cid).read(n);
        std::memcpy(dst, src, n);
    } else {
        for (int64_t i = 0; i < n; i++) dst[i] = (uint8_t)read_byte(c, s);
    }
}

// _consume_tag_value: skip one tag value of SAM type `typ`
static void skip_tag_value(const Codec& c, char typ, Streams& s,
                           std::vector<uint8_t>& scratch) {
    if (c.type == CK_BYTE_ARRAY_LEN || c.type == CK_BYTE_ARRAY_STOP) {
        scratch.clear();
        read_bytes(c, s, scratch);
        return;
    }
    if (c.type != CK_EXTERNAL) throw Unsupported{};
    Cursor& cur = s.external(c.cid);
    switch (typ) {
        case 'A':
        case 'c':
        case 'C':
            cur.read(1);
            break;
        case 's':
        case 'S':
            cur.read(2);
            break;
        case 'i':
        case 'I':
        case 'f':
            cur.read(4);
            break;
        case 'Z':
        case 'H': {
            int64_t n;
            cur.read_until(0, &n);
            break;
        }
        case 'B': {
            char sub = (char)cur.read_byte();
            const uint8_t* cb = cur.read(4);
            uint32_t count;
            std::memcpy(&count, cb, 4);
            int size;
            switch (sub) {
                case 'c':
                case 'C':
                    size = 1;
                    break;
                case 's':
                case 'S':
                    size = 2;
                    break;
                case 'i':
                case 'I':
                case 'f':
                    size = 4;
                    break;
                default:
                    throw Malformed{};
            }
            cur.read((int64_t)count * size);
            break;
        }
        default:
            throw Malformed{};
    }
}

// ---------------------------------------------------------------------
// series table (fixed order shared with io/cram.py::_native_spec)
// ---------------------------------------------------------------------

enum Series {
    S_BF = 0, S_CF, S_RI, S_RL, S_AP, S_RG, S_RN, S_MF, S_NS, S_NP,
    S_TS, S_NF, S_TL, S_FN, S_FC, S_FP, S_BS, S_BA, S_QS, S_IN,
    S_SC, S_BB, S_QQ, S_DL, S_RS, S_HC, S_PD, S_MQ,
    S_COUNT
};

struct TagSpec {
    char typ;
    Codec codec;
};

struct Spec {
    bool ap_delta;
    bool names_included;
    bool ref_pad_mode;  // embedded / no-ref: out-of-window reads give N
    bool want_quals;    // surface per-base qualities (flags & 8)
    int32_t ref_seq_id;
    int64_t ap_start;
    int64_t n_records;
    int64_t ref_buf_start;
    int64_t ref_buf_len;
    int64_t contig_len;  // -1 unknown
    uint8_t sub_table[256][4];
    Codec series[S_COUNT];
    std::vector<std::vector<TagSpec>> tag_lines;
};

static void parse_spec(const uint8_t* data, int64_t len, Spec& spec) {
    SpecCursor s{data, data + len};
    if (s.i32() != 0x43524D31) throw Malformed{};  // "CRM1"
    uint8_t flags = s.u8();
    spec.ap_delta = flags & 1;
    spec.names_included = flags & 2;
    spec.ref_pad_mode = flags & 4;
    spec.want_quals = flags & 8;
    spec.ref_seq_id = s.i32();
    spec.ap_start = s.i64();
    spec.n_records = s.i64();
    spec.ref_buf_start = s.i64();
    spec.ref_buf_len = s.i64();
    spec.contig_len = s.i64();
    s.need(1024);
    std::memcpy(spec.sub_table, s.p, 1024);
    s.p += 1024;
    uint8_t n_series = s.u8();
    if (n_series != S_COUNT) throw Malformed{};
    for (int i = 0; i < S_COUNT; i++) parse_codec(s, spec.series[i]);
    int32_t n_lines = s.i32();
    if (n_lines < 0 || n_lines > (1 << 20)) throw Malformed{};
    spec.tag_lines.resize(n_lines);
    for (int32_t i = 0; i < n_lines; i++) {
        int32_t n_tags = s.i32();
        if (n_tags < 0 || n_tags > (1 << 16)) throw Malformed{};
        spec.tag_lines[i].resize(n_tags);
        for (int32_t j = 0; j < n_tags; j++) {
            spec.tag_lines[i][j].typ = (char)s.u8();
            parse_codec(s, spec.tag_lines[i][j].codec);
        }
    }
}

// ---------------------------------------------------------------------
// result holder
// ---------------------------------------------------------------------

struct Holder {
    std::vector<int64_t> pos;
    std::vector<int32_t> mapq, flag, refid;
    std::vector<uint8_t> seq;
    std::vector<int64_t> seq_off;
    std::vector<uint8_t> cig_ops;
    std::vector<int32_t> cig_lens;
    std::vector<int64_t> cig_off;
    std::vector<char> names;
    std::vector<int64_t> name_off;
    std::vector<uint8_t> qual;  // parallel to seq (seq_off indexes both);
                                // empty unless the spec sets want_quals
    // mate pointers + template length (BAM next_refID/next_pos/tlen):
    // from NS/NP/TS on detached records, computed for downstream pairs
    std::vector<int32_t> next_ref;
    std::vector<int64_t> next_pos;
    std::vector<int64_t> tlen;
};

}  // namespace cramdec

extern "C" {

struct CramSliceOut {
    int64_t n_records;
    int64_t* pos;
    int32_t* mapq;
    int32_t* flag;
    int32_t* refid;
    uint8_t* seq;
    int64_t* seq_off;   // n_records + 1
    uint8_t* cig_ops;
    int32_t* cig_lens;
    int64_t* cig_off;   // n_records + 1
    char* names;        // zero-length name => synthesize in Python
    int64_t* name_off;  // n_records + 1
    uint8_t* qual;      // raw phred, 0xFF = missing; NULL unless requested
                        // (shares seq_off: qual length == seq length)
    int32_t* next_ref;  // mate pointers (BAM next_refID / next_pos / tlen)
    int64_t* next_pos;
    int64_t* tlen;
    int64_t need_lo;    // rc == 2: reference span required
    int64_t need_hi;
    void* holder;
};

}  // extern "C"

namespace cramdec {

// CF / MF bits (io/cram.py)
constexpr int CF_QS_ARRAY = 0x1;
constexpr int CF_DETACHED = 0x2;
constexpr int CF_MATE_DOWNSTREAM = 0x4;
constexpr int CF_NO_SEQ = 0x8;
constexpr int MF_MATE_REVERSE = 0x1;
constexpr int MF_MATE_UNMAPPED = 0x2;

// BAM cigar op codes (MIDNSHP=X)
constexpr uint8_t OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4,
                  OP_H = 5, OP_P = 6;

struct RefWindow {
    const uint8_t* buf;
    int64_t start;
    int64_t len;
    int64_t contig_len;
    bool pad_mode;
    std::vector<uint8_t> tmp;

    // n reference bytes at pos0, mirroring decode_slice_records'
    // ref_window + the reader's ref_fetch closures
    const uint8_t* window(int64_t pos0, int64_t n) {
        if (n <= 0) {
            tmp.clear();
            return tmp.data();
        }
        // Every arithmetic form below subtracts before it compares:
        // pos0 (alignment position), start and contig_len all derive
        // from file bytes, so ANY additive expression over them
        // (`pos0 + n`, `start + len`) can signed-overflow — UB that can
        // also wrap past a bounds check (fuzz regression: OOB read in
        // fill_to's memcpy). `pos0 >= start` is always established
        // before `pos0 - start` is formed, and len is bounded by the
        // caller's real buffer, so the differences cannot overflow.
        if (pad_mode) {
            if (pos0 < start || pos0 - start >= len) {
                tmp.assign(n, 'N');
                return tmp.data();
            }
            int64_t lo = pos0 - start;
            int64_t have = std::min<int64_t>(n, len - lo);
            tmp.assign(n, 'N');
            std::memcpy(tmp.data(), buf + lo, have);
            return tmp.data();
        }
        // FASTA-backed: the prefetched span is the source of truth where
        // it covers; past the contig end pads N; anything else must be
        // refetched by the caller (rc 2)
        if (pos0 >= start && pos0 - start <= len && n <= len - (pos0 - start))
            return buf + (pos0 - start);
        bool covers_contig_end =
            contig_len >= 0 &&
            (start >= contig_len || len >= contig_len - start);
        if (pos0 >= start && covers_contig_end) {
            int64_t lo = pos0 - start;
            int64_t have = lo < len ? std::min<int64_t>(n, len - lo) : 0;
            tmp.assign(n, 'N');
            if (have > 0) std::memcpy(tmp.data(), buf + lo, have);
            return tmp.data();
        }
        int64_t hi = pos0 <= INT64_MAX - n ? pos0 + n : INT64_MAX;
        throw RefNeeded{std::min(pos0, start), hi};
    }
};

static int decode_slice(const Spec& spec, Streams& streams,
                        RefWindow& ref, Holder& h) {
    const Codec& c_bf = spec.series[S_BF];
    const Codec& c_cf = spec.series[S_CF];
    const Codec& c_ri = spec.series[S_RI];
    const Codec& c_rl = spec.series[S_RL];
    const Codec& c_ap = spec.series[S_AP];
    const Codec& c_rg = spec.series[S_RG];
    const Codec& c_rn = spec.series[S_RN];
    const Codec& c_mf = spec.series[S_MF];
    const Codec& c_ns = spec.series[S_NS];
    const Codec& c_np = spec.series[S_NP];
    const Codec& c_ts = spec.series[S_TS];
    const Codec& c_nf = spec.series[S_NF];
    const Codec& c_tl = spec.series[S_TL];
    const Codec& c_fn = spec.series[S_FN];
    const Codec& c_fc = spec.series[S_FC];
    const Codec& c_fp = spec.series[S_FP];
    const Codec& c_bs = spec.series[S_BS];
    const Codec& c_ba = spec.series[S_BA];
    const Codec& c_qs = spec.series[S_QS];
    const Codec& c_in = spec.series[S_IN];
    const Codec& c_sc = spec.series[S_SC];
    const Codec& c_bb = spec.series[S_BB];
    const Codec& c_qq = spec.series[S_QQ];
    const Codec& c_dl = spec.series[S_DL];
    const Codec& c_rs = spec.series[S_RS];
    const Codec& c_hc = spec.series[S_HC];
    const Codec& c_pd = spec.series[S_PD];
    const Codec& c_mq = spec.series[S_MQ];

    const bool multi_ref = spec.ref_seq_id == -2;
    int64_t prev_ap = spec.ap_start;
    const int64_t n_records = spec.n_records;
    // throw, never return: the caller ignores this function's status and
    // publishes spec.n_records as the record count, so an early return
    // would advertise records the holder does not contain
    if (n_records < 0) throw std::runtime_error("negative n_records");

    // n_records is file-derived: reserve() with a forged huge value
    // would attempt a petabyte allocation up front (fuzz finding). Cap
    // the HINT only — the vectors still grow to any genuine size, and a
    // forged count fails later when the record streams run dry.
    const int64_t hint = std::min<int64_t>(n_records, 1 << 20);
    h.pos.reserve(hint);
    h.mapq.reserve(hint);
    h.flag.reserve(hint);
    h.refid.reserve(hint);
    h.seq_off.reserve(hint + 1);
    h.cig_off.reserve(hint + 1);
    h.name_off.reserve(hint + 1);
    h.seq_off.push_back(0);
    h.cig_off.push_back(0);
    h.name_off.push_back(0);

    std::vector<std::pair<int64_t, int64_t>> downstream;  // (rec_i, nf)
    std::vector<uint8_t> seq;
    std::vector<uint8_t> qual;
    std::vector<uint8_t> scratch;
    std::vector<std::pair<uint8_t, int64_t>> cigar;

    for (int64_t rec_i = 0; rec_i < n_records; rec_i++) {
        int64_t bf = read_int(c_bf, streams);
        int64_t cf = read_int(c_cf, streams);
        int32_t ref_id =
            multi_ref ? (int32_t)read_int(c_ri, streams) : spec.ref_seq_id;
        int64_t rl = read_int(c_rl, streams);
        if (rl < 0 || rl > (int64_t)1 << 31) throw Malformed{};
        int64_t ap;
        if (spec.ap_delta) {
            ap = prev_ap + read_int(c_ap, streams);
            prev_ap = ap;
        } else {
            ap = read_int(c_ap, streams);
        }
        read_int(c_rg, streams);  // read group (unused downstream)

        int64_t name_start = (int64_t)h.names.size();
        if (spec.names_included) {
            scratch.clear();
            read_bytes(c_rn, streams, scratch);
            h.names.insert(h.names.end(), scratch.begin(), scratch.end());
        }
        int64_t flag = bf;
        int32_t mate_ref = -1;
        int64_t mate_pos = -1, mate_tlen = 0;
        if (cf & CF_DETACHED) {
            int64_t mf = read_int(c_mf, streams);
            if (!spec.names_included) {
                scratch.clear();
                read_bytes(c_rn, streams, scratch);
                h.names.insert(h.names.end(), scratch.begin(), scratch.end());
            }
            mate_ref = (int32_t)read_int(c_ns, streams);
            mate_pos = read_int(c_np, streams) - 1;  // NP is 1-based
            mate_tlen = read_int(c_ts, streams);
            if (mf & MF_MATE_REVERSE) flag |= 0x20;
            if (mf & MF_MATE_UNMAPPED) flag |= 0x8;
        } else if (cf & CF_MATE_DOWNSTREAM) {
            downstream.emplace_back(rec_i, read_int(c_nf, streams));
        }
        h.name_off.push_back((int64_t)h.names.size());
        (void)name_start;

        int64_t tl = read_int(c_tl, streams);
        if (tl < 0 || (size_t)tl >= spec.tag_lines.size()) throw Malformed{};
        for (const TagSpec& t : spec.tag_lines[tl])
            skip_tag_value(t.codec, t.typ, streams, scratch);

        cigar.clear();
        seq.assign(rl, 'N');
        if (spec.want_quals) qual.assign(rl, 0xFF);  // 0xFF = missing
        int32_t mapq = 0;

        if (!(bf & 4)) {  // mapped
            int64_t fn = read_int(c_fn, streams);
            if (fn < 0) throw Malformed{};
            int64_t qc = 1;       // 1-based query cursor
            int64_t rc = ap - 1;  // 0-based reference cursor
            int64_t fpos = 0;

            auto push_op = [&](uint8_t op, int64_t n) {
                if (!cigar.empty() && cigar.back().first == op)
                    cigar.back().second += n;
                else
                    cigar.emplace_back(op, n);
            };
            auto fill_to = [&](int64_t q) {
                int64_t n = q - qc;
                if (n <= 0) return;
                if (qc - 1 + n > rl) throw Malformed{};
                const uint8_t* w = ref.window(rc, n);
                std::memcpy(seq.data() + (qc - 1), w, n);
                push_op(OP_M, n);
                qc += n;
                rc += n;
            };

            for (int64_t f = 0; f < fn; f++) {
                int fc = read_byte(c_fc, streams);
                fpos += read_int(c_fp, streams);
                fill_to(fpos);
                switch (fc) {
                    case 'X': {  // substitution
                        int code = read_byte(c_bs, streams);
                        if (code < 0 || code > 3) throw Malformed{};
                        if (qc - 1 >= rl) throw Malformed{};
                        const uint8_t* w = ref.window(rc, 1);
                        seq[qc - 1] = spec.sub_table[w[0]][code];
                        push_op(OP_M, 1);
                        qc++;
                        rc++;
                        break;
                    }
                    case 'B': {  // base + qual
                        if (qc - 1 >= rl) throw Malformed{};
                        seq[qc - 1] = (uint8_t)read_byte(c_ba, streams);
                        int qv = read_byte(c_qs, streams);
                        if (spec.want_quals) qual[qc - 1] = (uint8_t)qv;
                        push_op(OP_M, 1);
                        qc++;
                        rc++;
                        break;
                    }
                    case 'I': {  // insertion
                        scratch.clear();
                        int64_t nb = read_bytes(c_in, streams, scratch);
                        if (nb) {
                            if (qc - 1 + nb > rl) throw Malformed{};
                            std::memcpy(seq.data() + (qc - 1), scratch.data(),
                                        nb);
                            push_op(OP_I, nb);
                            qc += nb;
                        }
                        break;
                    }
                    case 'i': {  // single-base insert
                        if (qc - 1 >= rl) throw Malformed{};
                        seq[qc - 1] = (uint8_t)read_byte(c_ba, streams);
                        push_op(OP_I, 1);
                        qc++;
                        break;
                    }
                    case 'S': {  // soft clip
                        scratch.clear();
                        int64_t nb = read_bytes(c_sc, streams, scratch);
                        if (nb) {
                            if (qc - 1 + nb > rl) throw Malformed{};
                            std::memcpy(seq.data() + (qc - 1), scratch.data(),
                                        nb);
                            push_op(OP_S, nb);
                            qc += nb;
                        }
                        break;
                    }
                    case 'b': {  // verbatim bases (consume ref too)
                        scratch.clear();
                        int64_t nb = read_bytes(c_bb, streams, scratch);
                        if (nb) {
                            if (qc - 1 + nb > rl) throw Malformed{};
                            std::memcpy(seq.data() + (qc - 1), scratch.data(),
                                        nb);
                            push_op(OP_M, nb);
                            qc += nb;
                            rc += nb;
                        }
                        break;
                    }
                    case 'D': {
                        int64_t n = read_int(c_dl, streams);
                        if (n > 0) {
                            push_op(OP_D, n);
                            rc += n;
                        }
                        break;
                    }
                    case 'N': {
                        int64_t n = read_int(c_rs, streams);
                        if (n > 0) {
                            push_op(OP_N, n);
                            rc += n;
                        }
                        break;
                    }
                    case 'H': {
                        int64_t n = read_int(c_hc, streams);
                        if (n > 0) push_op(OP_H, n);
                        break;
                    }
                    case 'P': {
                        int64_t n = read_int(c_pd, streams);
                        if (n > 0) push_op(OP_P, n);
                        break;
                    }
                    case 'Q': {
                        int qv = read_byte(c_qs, streams);
                        if (spec.want_quals && qc >= 1 && qc - 1 < rl)
                            qual[qc - 1] = (uint8_t)qv;
                        break;
                    }
                    case 'q': {
                        scratch.clear();
                        int64_t nb = read_bytes(c_qq, streams, scratch);
                        if (spec.want_quals && qc >= 1 && nb > 0) {
                            int64_t ncp = std::min<int64_t>(nb, rl - (qc - 1));
                            if (ncp > 0)
                                std::memcpy(qual.data() + (qc - 1),
                                            scratch.data(), ncp);
                        }
                        break;
                    }
                    default:
                        throw Malformed{};  // unknown feature code
                }
            }
            fill_to(rl + 1);
            mapq = (int32_t)read_int(c_mq, streams);
            if (cf & CF_QS_ARRAY) {
                if (spec.want_quals)
                    read_byte_run_into(c_qs, streams, qual.data(), rl);
                else
                    skip_byte_run(c_qs, streams, rl);
            }
        } else {
            if (!(cf & CF_NO_SEQ))
                read_byte_run_into(c_ba, streams, seq.data(), rl);
            if (cf & CF_QS_ARRAY) {
                if (spec.want_quals)
                    read_byte_run_into(c_qs, streams, qual.data(), rl);
                else
                    skip_byte_run(c_qs, streams, rl);
            }
            if (cf & CF_NO_SEQ) seq.assign(rl, 'N');
        }

        h.pos.push_back(ap - 1);
        h.mapq.push_back(mapq);
        h.flag.push_back((int32_t)flag);
        h.refid.push_back(ref_id);
        h.next_ref.push_back(mate_ref);
        h.next_pos.push_back(mate_pos);
        h.tlen.push_back(mate_tlen);
        h.seq.insert(h.seq.end(), seq.begin(), seq.end());
        if (spec.want_quals)
            h.qual.insert(h.qual.end(), qual.begin(), qual.end());
        h.seq_off.push_back((int64_t)h.seq.size());
        for (auto& [op, n] : cigar) {
            h.cig_ops.push_back(op);
            if (n > INT32_MAX) throw Malformed{};
            h.cig_lens.push_back((int32_t)n);
        }
        h.cig_off.push_back((int64_t)h.cig_ops.size());
    }

    // mate bits from the downstream mate (both directions, as in Python)
    auto ref_end = [&](int64_t r) {
        int64_t span = 0;
        for (int64_t k = h.cig_off[r]; k < h.cig_off[r + 1]; k++) {
            uint8_t op = h.cig_ops[k];
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                span += h.cig_lens[k];
        }
        return h.pos[r] + span;
    };
    for (auto& [i, nf] : downstream) {
        int64_t j = i + nf + 1;
        if (j < n_records && j >= 0) {
            if (h.flag[j] & 0x10) h.flag[i] |= 0x20;
            if (h.flag[j] & 0x4) h.flag[i] |= 0x8;
            if (h.flag[i] & 0x10) h.flag[j] |= 0x20;
            if (h.flag[i] & 0x4) h.flag[j] |= 0x8;
            // mate pointers + computed TLEN (htslib semantics: leftmost
            // start to rightmost end; leftmost signs positive, ties keep
            // the earlier record positive; 0 across contigs)
            h.next_ref[i] = h.refid[j];
            h.next_pos[i] = h.pos[j];
            h.next_ref[j] = h.refid[i];
            h.next_pos[j] = h.pos[i];
            if (h.refid[i] == h.refid[j] && h.pos[i] >= 0 && h.pos[j] >= 0) {
                int64_t lo = std::min(h.pos[i], h.pos[j]);
                int64_t hi = std::max(ref_end(i), ref_end(j));
                int64_t span = hi - lo;
                if (h.pos[i] <= h.pos[j]) {
                    h.tlen[i] = span;
                    h.tlen[j] = -span;
                } else {
                    h.tlen[i] = -span;
                    h.tlen[j] = span;
                }
            }
        }
    }
    return 0;
}

}  // namespace cramdec

extern "C" {

int clair_cram_decode_slice(const uint8_t* spec_buf, int64_t spec_len,
                            const uint8_t* core, int64_t core_len,
                            const uint8_t* ext_meta, int32_t n_ext,
                            const uint8_t* ext_data, int64_t ext_total,
                            const uint8_t* ref_buf, int64_t ref_len,
                            CramSliceOut* out) {
    using namespace cramdec;
    std::memset(out, 0, sizeof(*out));
    try {
        Spec spec;
        parse_spec(spec_buf, spec_len, spec);

        Streams streams;
        streams.core.data = core;
        streams.core.len = core_len;
        int64_t off = 0;
        for (int32_t i = 0; i < n_ext; i++) {
            int32_t cid;
            int64_t len;
            std::memcpy(&cid, ext_meta + i * 12, 4);
            std::memcpy(&len, ext_meta + i * 12 + 4, 8);
            if (len < 0 || off + len > ext_total) return 1;
            streams.ext[cid] = Cursor{ext_data + off, len, 0};
            off += len;
        }

        RefWindow ref;
        ref.buf = ref_buf;
        ref.start = spec.ref_buf_start;
        // the window length must come from the caller's actual buffer,
        // never the spec blob: the blob carries file-derived (hostile)
        // fields, and a forged ref_buf_len would move every bounds check
        // past the real allocation
        ref.len = std::min<int64_t>(spec.ref_buf_len, ref_len);
        if (ref.len < 0) ref.len = 0;
        // a negative window start is never valid (and would overflow the
        // subtraction forms in RefWindow::window): degrade to an empty
        // window so lookups N-pad or raise RefNeeded instead
        if (ref.start < 0) { ref.start = 0; ref.len = 0; }
        ref.contig_len = spec.contig_len;
        ref.pad_mode = spec.ref_pad_mode;

        auto holder = std::make_unique<Holder>();
        decode_slice(spec, streams, ref, *holder);

        Holder& h = *holder;
        out->n_records = spec.n_records;
        out->pos = h.pos.data();
        out->mapq = h.mapq.data();
        out->flag = h.flag.data();
        out->refid = h.refid.data();
        out->seq = h.seq.data();
        out->seq_off = h.seq_off.data();
        out->cig_ops = h.cig_ops.data();
        out->cig_lens = h.cig_lens.data();
        out->cig_off = h.cig_off.data();
        out->names = h.names.data();
        out->name_off = h.name_off.data();
        out->qual = h.qual.empty() ? nullptr : h.qual.data();
        out->next_ref = h.next_ref.data();
        out->next_pos = h.next_pos.data();
        out->tlen = h.tlen.data();
        out->holder = holder.release();
        return 0;
    } catch (cramdec::RefNeeded& r) {
        out->need_lo = r.lo;
        out->need_hi = r.hi;
        return 2;
    } catch (cramdec::Unsupported&) {
        return 3;
    } catch (...) {
        return 1;
    }
}

void clair_cram_free_slice(CramSliceOut* out) {
    delete static_cast<cramdec::Holder*>(out->holder);
    out->holder = nullptr;
}

}  // extern "C"
