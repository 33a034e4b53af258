// clair_native: native BAM -> pileup-event engine.
//
// The hot host path of the framework (the reference's bottleneck is the
// equivalent CreateTensor CIGAR walk, README.md:322). This library streams
// BGZF blocks (chunked reads, block-parallel inflate), parses BAM records,
// applies the standard filters (exclude flags, MAPQ, per-start-position
// depth cap, soft-clip fraction) and expands CIGARs into the flat event
// arrays the numpy/TPU pipeline consumes — replacing the Python per-read
// loop in clair_tpu.data.pileup.
//
// Region scans are bounded on BOTH ends: a BAI virtual offset seeds the
// start, and the coordinate-sorted early break (pos >= end) stops the
// stream, so a 10Mb window on a 100GB BAM reads/inflates only its own
// blocks.
//
// C ABI (ctypes): see EventBuffers below. All arrays are malloc'd here and
// released with clair_free_events.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>
#include <zlib.h>
#ifdef CLAIR_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// SAM spec: which CIGAR ops consume reference
const bool kConsumesRef[9] = {true, false, true, true, false, false, false, true, true};

// BAM 4-bit seq code -> candidate column (A=0 C=1 G=2 T=3, ambiguity codes
// collapsed like IUPAC_base_to_num with N kept distinct as column 6)
// code order: =ACMGRSVTWYHKDBN
const int8_t kCodeToCol[16] = {
    /*=*/ -1, /*A*/ 0, /*C*/ 1, /*M(A|C)->A*/ 0, /*G*/ 2, /*R(A|G)->A*/ 0,
    /*S(G|C)->C*/ 1, /*V->A*/ 0, /*T*/ 3, /*W(A|T)->A*/ 0, /*Y(C|T)->C*/ 1,
    /*H->A*/ 0, /*K(G|T)->G*/ 2, /*D->A*/ 0, /*B->C*/ 1, /*N*/ 6};

// Size of the BGZF block starting at raw[offset] within [0, size):
// walks the gzip extra subfields for BC (SAM spec §4.1). 0 on failure.
size_t bgzf_block_size(const uint8_t* raw, size_t size, size_t offset) {
  if (offset + 18 > size) return 0;
  if (raw[offset] != 0x1f || raw[offset + 1] != 0x8b) return 0;
  if (!(raw[offset + 3] & 4)) return 0;
  uint16_t xlen;
  memcpy(&xlen, raw + offset + 10, 2);
  size_t cursor = offset + 12, end = cursor + xlen;
  while (cursor + 4 <= end && end <= size) {
    uint8_t si1 = raw[cursor], si2 = raw[cursor + 1];
    uint16_t slen;
    memcpy(&slen, raw + cursor + 2, 2);
    if (si1 == 'B' && si2 == 'C' && slen == 2) {
      uint16_t bsize_m1;
      memcpy(&bsize_m1, raw + cursor + 4, 2);
      return (size_t)bsize_m1 + 1;
    }
    cursor += 4 + slen;
  }
  return 0;
}

#ifdef CLAIR_HAVE_LIBDEFLATE
// One decompressor per worker thread, freed at thread exit (the BGZF pump
// spawns fresh threads per chunk, so a bare thread_local pointer would
// leak one allocation per spawned thread).
struct DeflateTL {
  libdeflate_decompressor* d;
  DeflateTL() : d(libdeflate_alloc_decompressor()) {}
  ~DeflateTL() {
    if (d) libdeflate_free_decompressor(d);
  }
};
#endif

bool inflate_one_block(const uint8_t* src, size_t src_size,
                       std::vector<uint8_t>& dst) {
  uint32_t isize;  // ISIZE (mod 2^32): last 4 bytes of the member
  memcpy(&isize, src + src_size - 4, 4);
  dst.resize(isize);
  if (isize == 0) return true;
#ifdef CLAIR_HAVE_LIBDEFLATE
  // ~2x zlib on BGZF-sized members; enabled by the Makefile only when
  // both header and library link on the build machine (zlib otherwise)
  static thread_local DeflateTL tl;
  if (tl.d) {
    size_t actual = 0;
    if (libdeflate_gzip_decompress(tl.d, src, src_size, dst.data(), isize,
                                   &actual) == LIBDEFLATE_SUCCESS &&
        actual == isize)
      return true;
    // any failure falls through to the zlib path below
  }
#endif
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = src_size;
  zs.next_out = dst.data();
  zs.avail_out = isize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// Chunked BGZF stream: reads ~4MB of raw bytes at a time, inflates complete
// blocks in parallel, appends to `data`. Falls back to streaming zlib over
// the whole remaining file for plain (non-BGZF) concatenated gzip.
struct StreamInflater {
  FILE* fp = nullptr;
  std::vector<uint8_t> carry;   // raw tail not yet forming a full block
  std::vector<uint8_t> data;    // inflated bytes (grows)
  bool raw_eof = false;
  bool done = false;
  bool first_pump = true;
  int threads = 4;
  // (inflated offset, compressed file offset) per block — for virtual
  // offsets when building a BAI
  bool track_blocks = false;
  std::vector<std::pair<size_t, int64_t>> block_table;
  int64_t carry_file_offset = 0;  // file offset of carry[0]
  static const size_t kChunk = 4u << 20;

  bool open(const char* path, int64_t start_coffset) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    if (start_coffset > 0 && fseek(fp, (long)start_coffset, SEEK_SET) != 0) {
      fclose(fp);
      fp = nullptr;
      return false;
    }
    carry_file_offset = start_coffset;
    return true;
  }

  ~StreamInflater() {
    if (fp) fclose(fp);
  }

  // Inflate more data; returns false when nothing further can be produced.
  bool pump() {
    if (done) return false;
    if (!raw_eof) {
      size_t old = carry.size();
      carry.resize(old + kChunk);
      size_t got = fread(carry.data() + old, 1, kChunk, fp);
      carry.resize(old + got);
      if (got < kChunk) raw_eof = true;
    }
    if (carry.empty()) {
      done = true;
      return false;
    }

    // split carry into complete BGZF blocks
    std::vector<std::pair<size_t, size_t>> blocks;
    size_t offset = 0;
    bool parse_ok = true;
    while (offset < carry.size()) {
      size_t size = bgzf_block_size(carry.data(), carry.size(), offset);
      if (size == 0) {
        // header truncated at the chunk edge is fine; anything else on the
        // very first block means non-BGZF input
        if (first_pump && offset == 0) parse_ok = false;
        break;
      }
      if (offset + size > carry.size()) break;  // partial block: keep in carry
      blocks.push_back({offset, size});
      offset += size;
    }
    first_pump = false;

    if (!parse_ok) {
      // plain-gzip fallback: stream-inflate carry + the rest of the file
      return pump_plain_gzip();
    }
    if (blocks.empty()) {
      if (raw_eof) {
        done = true;
        return false;
      }
      return pump();  // need more raw bytes for one block
    }

    std::vector<std::vector<uint8_t>> parts(blocks.size());
    int workers = threads > 1 ? threads : 1;
    if ((int)blocks.size() < workers) workers = blocks.size();
    if (workers > 1) {
      std::vector<std::thread> pool;
      for (int t = 0; t < workers; t++) {
        pool.emplace_back([&, t]() {
          for (size_t i = t; i < blocks.size(); i += workers)
            inflate_one_block(carry.data() + blocks[i].first,
                              blocks[i].second, parts[i]);
        });
      }
      for (auto& th : pool) th.join();
    } else {
      for (size_t i = 0; i < blocks.size(); i++)
        inflate_one_block(carry.data() + blocks[i].first, blocks[i].second,
                          parts[i]);
    }
    for (size_t i = 0; i < blocks.size(); i++) {
      if (track_blocks)
        block_table.push_back(
            {data.size(), carry_file_offset + (int64_t)blocks[i].first});
      data.insert(data.end(), parts[i].begin(), parts[i].end());
    }
    carry.erase(carry.begin(), carry.begin() + offset);
    carry_file_offset += (int64_t)offset;
    if (raw_eof && carry.empty()) done = true;
    return true;
  }

  bool pump_plain_gzip() {
    // consume carry + whole remaining file through streaming zlib
    std::vector<uint8_t> raw(std::move(carry));
    carry.clear();
    if (!raw_eof) {
      std::vector<uint8_t> chunk(kChunk);
      size_t got;
      while ((got = fread(chunk.data(), 1, kChunk, fp)) > 0)
        raw.insert(raw.end(), chunk.data(), chunk.data() + got);
      raw_eof = true;
    }
    done = true;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
    zs.next_in = raw.data();
    zs.avail_in = raw.size();
    std::vector<uint8_t> chunk(1 << 20);
    bool produced = false;
    while (zs.avail_in > 0) {
      zs.next_out = chunk.data();
      zs.avail_out = chunk.size();
      int rc = inflate(&zs, Z_NO_FLUSH);
      size_t n = chunk.size() - zs.avail_out;
      data.insert(data.end(), chunk.data(), chunk.data() + n);
      produced = produced || n > 0;
      if (rc == Z_STREAM_END) {
        if (inflateReset2(&zs, 15 + 16) != Z_OK) break;
      } else if (rc != Z_OK) {
        break;
      }
    }
    inflateEnd(&zs);
    return produced;
  }

  // Grow `data` until it holds at least `need` bytes.
  bool ensure(size_t need) {
    while (data.size() < need) {
      if (!pump()) return false;
    }
    return true;
  }

  // Drop inflated bytes before `cursor` (long scans stay memory-bounded);
  // returns the amount trimmed so callers can rebase their cursors.
  size_t discard_before(size_t cursor) {
    if (cursor < (8u << 20)) return 0;  // not worth compacting yet
    // keep the block containing `cursor` intact
    size_t keep_from = 0;
    size_t table_keep = 0;
    for (size_t i = 0; i < block_table.size(); i++) {
      if (block_table[i].first <= cursor) {
        keep_from = block_table[i].first;
        table_keep = i;
      } else {
        break;
      }
    }
    if (keep_from == 0) return 0;
    data.erase(data.begin(), data.begin() + keep_from);
    block_table.erase(block_table.begin(), block_table.begin() + table_keep);
    for (auto& entry : block_table) entry.first -= keep_from;
    return keep_from;
  }

  // Virtual offset of inflated position `upos` (track_blocks must be on).
  int64_t voffset_of(size_t upos, size_t rebase) const {
    // binary search the last block with ustart <= upos
    size_t lo = 0, hi = block_table.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (block_table[mid].first <= upos) lo = mid + 1;
      else hi = mid;
    }
    if (lo == 0) return 0;
    const auto& blk = block_table[lo - 1];
    (void)rebase;
    return (blk.second << 16) | (int64_t)(upos - blk.first);
  }
};

int bai_reg2bin(int64_t beg, int64_t end) {
  end -= 1;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
  return 0;
}

template <typename T>
T read_le(const uint8_t* p) {
  T v;
  memcpy(&v, p, sizeof(T));
  return v;
}

template <typename T>
void write_le(uint8_t* p, T v) {
  memcpy(p, &v, sizeof(T));
}

template <typename T>
T* to_heap(const std::vector<T>& v) {
  T* p = (T*)malloc(v.size() * sizeof(T));
  if (p && !v.empty()) memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

// query-consuming cigar ops: M I S = X
const bool kConsumesQueryOp[9] = {true,  true,  false, false, true,
                                  false, false, true,  true};

enum RecordCheck { kRecOk = 0, kRecSkip = 1, kRecCorrupt = 2 };

// A corrupt or torn BAM stream — or a stale .bai seeking into the middle
// of a record — yields arbitrary record geometry; every walk admits a
// record only after this check so no later field access leaves the
// record's block_size bytes. kRecCorrupt means framing is gone (the
// caller must abort the scan with an error: silently truncating a
// region scan would silently drop variants); kRecSkip marks a record
// whose frame is consistent but whose seq cannot be indexed by its
// cigar (seq-less alignments) — safe to pass over. The per-base seq
// indexing downstream is safe because the spec invariant (query-
// consuming cigar lengths sum to l_seq) is verified here.
inline RecordCheck check_record(const uint8_t* rec, int64_t block_size) {
  if (block_size < 32) return kRecCorrupt;
  uint8_t l_read_name = rec[8];
  if (l_read_name < 1) return kRecCorrupt;
  uint16_t n_cigar = read_le<uint16_t>(rec + 12);
  int32_t l_seq = read_le<int32_t>(rec + 16);
  if (l_seq < 0) return kRecCorrupt;
  int64_t need = 32 + (int64_t)l_read_name + 4ll * n_cigar +
                 ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq;
  if (need > block_size) return kRecCorrupt;
  const uint8_t* cigar_p = rec + 32 + (int64_t)l_read_name;
  int64_t qlen = 0;
  for (int i = 0; i < n_cigar; i++) {
    uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
    if ((cv & 0xF) > 8) return kRecCorrupt;
    if (kConsumesQueryOp[cv & 0xF]) qlen += (int64_t)(cv >> 4);
  }
  if (n_cigar > 0 && qlen != l_seq) return kRecSkip;
  return kRecOk;
}

}  // namespace

extern "C" {

struct EventBuffers {
  int64_t* match_pos;
  int8_t* match_qcol;
  int8_t* match_strand;
  int64_t n_match;

  int64_t* ins_pos;
  int64_t* ins_adv;
  int8_t* ins_qcol;
  int8_t* ins_strand;
  int64_t n_ins;

  int64_t* del_pos;
  int8_t* del_strand;
  int64_t n_del;

  int64_t* ins_op_pos;
  int64_t n_ins_op;
  int64_t* del_op_pos;
  int64_t n_del_op;
  int64_t* ins_op_len;
  int64_t* del_op_len;

  int64_t n_reads_used;
};

}  // extern "C" (resumed below)

namespace {

struct EventVecs {
  std::vector<int64_t> match_pos, ins_pos, ins_adv, del_pos, ins_op, del_op,
      ins_op_len, del_op_len;
  std::vector<int8_t> match_qcol, match_strand, ins_qcol, ins_strand,
      del_strand;
  int64_t reads_used = 0;

  void fill(struct EventBuffers* out);
};

void EventVecs::fill(EventBuffers* out) {
  out->match_pos = to_heap(match_pos);
  out->match_qcol = to_heap(match_qcol);
  out->match_strand = to_heap(match_strand);
  out->n_match = match_pos.size();
  out->ins_pos = to_heap(ins_pos);
  out->ins_adv = to_heap(ins_adv);
  out->ins_qcol = to_heap(ins_qcol);
  out->ins_strand = to_heap(ins_strand);
  out->n_ins = ins_pos.size();
  out->del_pos = to_heap(del_pos);
  out->del_strand = to_heap(del_strand);
  out->n_del = del_pos.size();
  out->ins_op_pos = to_heap(ins_op);
  out->n_ins_op = ins_op.size();
  out->del_op_pos = to_heap(del_op);
  out->n_del_op = del_op.size();
  out->ins_op_len = to_heap(ins_op_len);
  out->del_op_len = to_heap(del_op_len);
  out->n_reads_used = reads_used;
}

// Direct per-position candidate pileup counts: (region_length, 7) columns
// A,C,G,T,I,D,N (clair_tpu/data/pileup.py column order). Accumulating in
// the scan replaces materializing ~30 bytes/aligned-base of candidate
// events plus a separate numpy counting pass — the candidate side needs
// only these counts.
struct CountsAcc {
  int32_t* counts;
  int64_t region_start;
  int64_t region_length;

  inline void base(int64_t pos, int8_t col) {
    int64_t idx = pos - region_start;
    if (col >= 0 && idx >= 0 && idx < region_length) counts[idx * 7 + col]++;
  }
  inline void op(int64_t op_pos, int col) {
    // I/D ops attach to the position before the op (EVC.py:304-311)
    int64_t idx = op_pos - 1 - region_start;
    if (idx >= 0 && idx < region_length) counts[idx * 7 + col]++;
  }
};

// Shared streaming record scan: each passing read's CIGAR expands once,
// emitting into the candidate set (soft-clip filter, no depth cap) and/or
// the tensor set (depth cap, no soft-clip filter). Either may be null.
// cand_counts, when set, accumulates the candidate-side pileup counts
// directly (the soft-clip filter applies) instead of candidate events.
// The stream stops early once records start past `end` (coordinate-sorted
// input), bounding IO/inflate to the region.
// Per-record scan state + body, shared by the stream walker
// (scan_records) and the RegionHandle walker (clair_region_scan_window /
// clair_region_events_dual — the CRAM packed-array path). scan_record
// returns false when the scan should stop (coordinate-sorted input has
// moved past the region).
struct ScanState {
  int32_t ref_id;
  int64_t start, end;
  int32_t exclude_flag, min_mapq, dcov;
  EventVecs* candidate;
  EventVecs* tensor;
  CountsAcc* cand_counts;
  int64_t previous_pos = -1;
  int32_t same_pos_count = 0;
};

bool scan_record(const uint8_t* rec, ScanState& st) {
  EventVecs* targets[2];
  EventVecs* candidate = st.candidate;
  EventVecs* tensor = st.tensor;
  CountsAcc* cand_counts = st.cand_counts;
  int32_t dcov = st.dcov;
  {
    int32_t rec_ref = read_le<int32_t>(rec);
    int64_t pos = read_le<int32_t>(rec + 4);
    uint8_t l_read_name = rec[8];
    uint8_t mapq = rec[9];
    uint16_t n_cigar = read_le<uint16_t>(rec + 12);
    uint16_t flag = read_le<uint16_t>(rec + 14);

    if (rec_ref != st.ref_id) {
      if (st.ref_id >= 0 && rec_ref > st.ref_id) return false;  // sorted past
      return true;
    }
    if (flag & st.exclude_flag) return true;
    if (mapq < st.min_mapq) return true;
    if (st.end >= 0 && pos >= st.end) return false;
    if (pos < 0) return true;  // corrupt/unmapped position on a kept ref

    const uint8_t* cigar_p = rec + 32 + l_read_name;
    const uint8_t* seq_p = cigar_p + 4 * n_cigar;

    // reference span + soft-clip fraction in one pass
    int64_t ref_len = 0, total_len = 0, soft_len = 0;
    for (int i = 0; i < n_cigar; i++) {
      uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
      uint32_t op = cv & 0xF, len = cv >> 4;
      total_len += len;
      if (op < 9 && kConsumesRef[op]) ref_len += len;
      if (op == 4) soft_len += len;
    }
    if (st.start >= 0 && pos + ref_len <= st.start) return true;

    bool softclip_ok =
        1.0 - (double)soft_len / (double)(total_len + 1) >= 0.55;

    // depth cap per start position (counted over every flag/mapq-passing
    // read, like CreateTensor which has no soft-clip filter)
    if (pos != st.previous_pos) {
      st.previous_pos = pos;
      st.same_pos_count = 0;
    } else {
      st.same_pos_count++;
    }
    bool dcov_ok = dcov <= 0 || st.same_pos_count < dcov;

    int n_targets = 0;
    if (candidate && softclip_ok) targets[n_targets++] = candidate;
    if (tensor && dcov_ok) targets[n_targets++] = tensor;
    bool to_counts = cand_counts != nullptr && softclip_ok;
    if (n_targets == 0 && !to_counts) return true;
    for (int t = 0; t < n_targets; t++) targets[t]->reads_used++;

    int8_t strand = (flag & 16) ? 1 : 0;
    int64_t refp = pos;
    int64_t qp = 0;
    for (int i = 0; i < n_cigar; i++) {
      uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
      uint32_t op = cv & 0xF;
      int64_t len = cv >> 4;
      switch (op) {
        case 0: case 7: case 8: {  // M, =, X
          for (int64_t k = 0; k < len; k++) {
            int64_t q = qp + k;
            uint8_t code = seq_p[q >> 1];
            code = (q & 1) ? (code & 0xF) : (code >> 4);
            for (int t = 0; t < n_targets; t++) {
              targets[t]->match_pos.push_back(refp + k);
              targets[t]->match_qcol.push_back(kCodeToCol[code]);
              targets[t]->match_strand.push_back(strand);
            }
            if (to_counts) cand_counts->base(refp + k, kCodeToCol[code]);
          }
          refp += len;
          qp += len;
          break;
        }
        case 1: {  // I
          for (int t = 0; t < n_targets; t++) {
            targets[t]->ins_op.push_back(refp);
            targets[t]->ins_op_len.push_back(len);
          }
          if (to_counts) cand_counts->op(refp, 4);
          for (int64_t k = 0; k < len; k++) {
            int64_t q = qp + k;
            uint8_t code = seq_p[q >> 1];
            code = (q & 1) ? (code & 0xF) : (code >> 4);
            for (int t = 0; t < n_targets; t++) {
              targets[t]->ins_pos.push_back(refp);
              targets[t]->ins_adv.push_back(k);
              targets[t]->ins_qcol.push_back(kCodeToCol[code]);
              targets[t]->ins_strand.push_back(strand);
            }
          }
          qp += len;
          break;
        }
        case 2: {  // D
          for (int t = 0; t < n_targets; t++) {
            targets[t]->del_op.push_back(refp);
            targets[t]->del_op_len.push_back(len);
          }
          if (to_counts) cand_counts->op(refp, 5);
          for (int64_t k = 0; k < len; k++) {
            for (int t = 0; t < n_targets; t++) {
              targets[t]->del_pos.push_back(refp + k);
              targets[t]->del_strand.push_back(strand);
            }
          }
          refp += len;
          break;
        }
        case 3:  // N (ref skip)
          refp += len;
          break;
        case 4:  // S
          qp += len;
          break;
        default:  // H, P: no movement
          break;
      }
    }
  }
  return true;
}

// false -> a corrupt record broke the stream's framing (callers must
// fail the scan rather than return silently-truncated events).
bool scan_records(StreamInflater& in, size_t cursor, int32_t ref_id,
                  int64_t start, int64_t end, int32_t exclude_flag,
                  int32_t min_mapq, EventVecs* candidate, EventVecs* tensor,
                  int32_t dcov, CountsAcc* cand_counts = nullptr) {
  ScanState st{ref_id, start, end, exclude_flag, min_mapq, dcov,
               candidate, tensor, cand_counts};
  if (candidate) candidate->match_pos.reserve(1 << 20);
  if (tensor) tensor->match_pos.reserve(1 << 20);
  while (in.ensure(cursor + 4)) {
    int32_t block_size = read_le<int32_t>(in.data.data() + cursor);
    if (block_size < 32) return false;
    if (!in.ensure(cursor + 4 + block_size)) return false;  // torn record
    const uint8_t* rec = in.data.data() + cursor + 4;
    cursor += 4 + block_size;
    RecordCheck rc = check_record(rec, block_size);
    if (rc == kRecCorrupt) return false;
    if (rc == kRecSkip) continue;
    if (!scan_record(rec, st)) break;
  }
  return true;
}

// IUPAC char -> base row (A=0 C=1 G=2 T=3; -1 unknown), matching
// clair_tpu.utils.genomics.BASE_NUM_LUT (upper+lower case).
struct BaseNumLut {
  int8_t lut[256];
  BaseNumLut() {
    memset(lut, -1, sizeof(lut));
    const char* bases = "ACGTURYSWKMBDHVN";
    const int8_t nums[] = {0, 1, 2, 3, 3, 0, 1, 1, 0, 2, 0, 1, 0, 0, 0, 0};
    for (int i = 0; bases[i]; i++) {
      lut[(uint8_t)bases[i]] = nums[i];
      lut[(uint8_t)(bases[i] | 0x20)] = nums[i];
    }
  }
};
const BaseNumLut kBaseNum;

// Parse/skip the BAM header; returns the record-region cursor or SIZE_MAX.
size_t skip_header(StreamInflater& in) {
  if (!in.ensure(8)) return SIZE_MAX;
  if (memcmp(in.data.data(), "BAM\x01", 4) != 0) return SIZE_MAX;
  int32_t l_text = read_le<int32_t>(in.data.data() + 4);
  size_t cursor = 8 + (size_t)l_text;
  if (!in.ensure(cursor + 4)) return SIZE_MAX;
  int32_t n_ref = read_le<int32_t>(in.data.data() + cursor);
  cursor += 4;
  for (int i = 0; i < n_ref; i++) {
    if (!in.ensure(cursor + 4)) return SIZE_MAX;
    int32_t l_name = read_le<int32_t>(in.data.data() + cursor);
    cursor += 4 + (size_t)l_name + 4;
  }
  if (!in.ensure(cursor)) return SIZE_MAX;
  return cursor;
}

}  // namespace

extern "C" {

// Scan one contig's reads and emit flat event arrays.
// ref_id: target reference index (from the BAM header, resolved by caller).
// start/end: 0-based half-open region filter (-1 -> whole contig).
// start_coffset/start_uoffset: BAI seek point (compressed byte offset of a
// BGZF block + offset within its inflated data); pass -1/-1 to scan from
// the top of the file (the header is then parsed and skipped).
// With softclip_filter the scan matches candidate extraction (no depth
// cap); otherwise tensor creation (depth cap via dcov, no soft-clip
// filter). Returns 0 on success.
int clair_bam_events(const char* path, int32_t ref_id, int64_t start,
                     int64_t end, int32_t exclude_flag, int32_t min_mapq,
                     int32_t dcov, int32_t softclip_filter,
                     int64_t start_coffset, int32_t start_uoffset,
                     EventBuffers* out) {
  memset(out, 0, sizeof(*out));
  bool seeked = start_coffset >= 0 && start_uoffset >= 0;
  StreamInflater in;
  if (!in.open(path, seeked ? start_coffset : 0)) return 1;

  size_t cursor;
  if (seeked) {
    cursor = (size_t)start_uoffset;
    if (!in.ensure(cursor)) return 3;
  } else {
    cursor = skip_header(in);
    if (cursor == SIZE_MAX) return 2;
  }

  EventVecs vecs;
  if (!scan_records(in, cursor, ref_id, start, end, exclude_flag, min_mapq,
                    softclip_filter ? &vecs : nullptr,
                    softclip_filter ? nullptr : &vecs, dcov))
    return 4;  // corrupt record framing
  vecs.fill(out);
  return 0;
}

// One scan, candidate pileup COUNTS + tensor events: the candidate side
// accumulates its (region_length, 7) A/C/G/T/I/D/N matrix directly in the
// walk (soft-clip filtered, no depth cap) while the tensor side still
// materializes events (depth-capped, no soft-clip filter). counts_out must
// hold region_length * 7 int32 zeros.
int clair_bam_scan_window(const char* path, int32_t ref_id, int64_t start,
                          int64_t end, int32_t exclude_flag, int32_t min_mapq,
                          int32_t dcov, int64_t region_start,
                          int64_t region_length, int64_t start_coffset,
                          int32_t start_uoffset, int32_t* counts_out,
                          EventBuffers* tensor_out) {
  memset(tensor_out, 0, sizeof(*tensor_out));
  bool seeked = start_coffset >= 0 && start_uoffset >= 0;
  StreamInflater in;
  if (!in.open(path, seeked ? start_coffset : 0)) return 1;

  size_t cursor;
  if (seeked) {
    cursor = (size_t)start_uoffset;
    if (!in.ensure(cursor)) return 3;
  } else {
    cursor = skip_header(in);
    if (cursor == SIZE_MAX) return 2;
  }

  CountsAcc acc{counts_out, region_start, region_length};
  EventVecs tensor_vecs;
  if (!scan_records(in, cursor, ref_id, start, end, exclude_flag, min_mapq,
                    nullptr, &tensor_vecs, dcov, &acc))
    return 4;  // corrupt record framing
  tensor_vecs.fill(tensor_out);
  return 0;
}

// One scan, TWO event sets with the reference's per-stage filters:
// candidate extraction (soft-clip filtered, no depth cap; EVC.py:155-170)
// and tensor creation (depth-capped, no soft-clip filter;
// CreateTensor.py:267-274). IO + inflate + record parse happen once.
int clair_bam_events_dual(const char* path, int32_t ref_id, int64_t start,
                          int64_t end, int32_t exclude_flag, int32_t min_mapq,
                          int32_t dcov, int64_t start_coffset,
                          int32_t start_uoffset, EventBuffers* candidate_out,
                          EventBuffers* tensor_out) {
  memset(candidate_out, 0, sizeof(*candidate_out));
  memset(tensor_out, 0, sizeof(*tensor_out));
  bool seeked = start_coffset >= 0 && start_uoffset >= 0;
  StreamInflater in;
  if (!in.open(path, seeked ? start_coffset : 0)) return 1;

  size_t cursor;
  if (seeked) {
    cursor = (size_t)start_uoffset;
    if (!in.ensure(cursor)) return 3;
  } else {
    cursor = skip_header(in);
    if (cursor == SIZE_MAX) return 2;
  }

  EventVecs candidate_vecs, tensor_vecs;
  if (!scan_records(in, cursor, ref_id, start, end, exclude_flag, min_mapq,
                    &candidate_vecs, &tensor_vecs, dcov))
    return 4;  // corrupt record framing
  candidate_vecs.fill(candidate_out);
  tensor_vecs.fill(tensor_out);
  return 0;
}

// Build a spec-compliant .bai for a coordinate-sorted BAM. Streams the file
// once (block-parallel inflate, bounded memory via prefix compaction) —
// the native replacement for the Python builder in io/bai.py, which walks
// records in pure Python. Returns 0 on success.
int clair_build_bai(const char* bam_path, const char* bai_path) {
  StreamInflater in;
  in.track_blocks = true;
  if (!in.open(bam_path, 0)) return 1;

  if (!in.ensure(8)) return 2;
  if (memcmp(in.data.data(), "BAM\x01", 4) != 0) return 2;
  int32_t l_text = read_le<int32_t>(in.data.data() + 4);
  size_t cursor = 8 + (size_t)l_text;
  if (!in.ensure(cursor + 4)) return 2;
  int32_t n_ref = read_le<int32_t>(in.data.data() + cursor);
  cursor += 4;
  for (int i = 0; i < n_ref; i++) {
    if (!in.ensure(cursor + 4)) return 2;
    int32_t l_name = read_le<int32_t>(in.data.data() + cursor);
    cursor += 4 + (size_t)l_name + 4;
  }
  if (!in.ensure(cursor)) return 2;

  struct Chunk { uint64_t beg, end; };
  const int kLinearShift = 14;
  std::vector<std::vector<std::pair<uint32_t, std::vector<Chunk>>>> bins(n_ref);
  // per ref: map bin -> index into bins[ref] for append
  std::vector<std::vector<int32_t>> bin_slot(n_ref, std::vector<int32_t>(37450, -1));
  std::vector<std::vector<uint64_t>> linear(n_ref);

  size_t rebase_total = 0;
  while (in.ensure(cursor + 4)) {
    int32_t block_size = read_le<int32_t>(in.data.data() + cursor);
    if (block_size < 32) return 4;                         // corrupt framing
    if (!in.ensure(cursor + 4 + block_size)) return 4;     // torn record
    uint64_t voff_beg = (uint64_t)in.voffset_of(cursor, rebase_total);
    uint64_t voff_end = (uint64_t)in.voffset_of(cursor + 4 + block_size, rebase_total);
    const uint8_t* rec = in.data.data() + cursor + 4;
    cursor += 4 + block_size;

    if (check_record(rec, block_size) == kRecCorrupt) return 4;
    int32_t ref_id = read_le<int32_t>(rec);
    int64_t pos = read_le<int32_t>(rec + 4);
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar = read_le<uint16_t>(rec + 12);
    // a negative/absurd position would index the linear table with a
    // huge size_t (multi-GB resize); spec keeps mapped pos in [0, 2^31).
    // Skip ONLY the index insertion (not the whole loop body): a sorted
    // BAM's unmapped tail (pos = -1) can be GBs, and skipping the
    // discard_before trim below would hold all of it inflated in memory
    if (pos >= 0 && pos <= (1ll << 31) && ref_id >= 0 && ref_id < n_ref) {
      const uint8_t* cigar_p = rec + 32 + l_read_name;
      int64_t span = 0;
      for (int k = 0; k < n_cigar; k++) {
        uint32_t cv = read_le<uint32_t>(cigar_p + 4 * k);
        uint32_t op = cv & 0xF;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          span += cv >> 4;
      }
      int64_t end = pos + (span > 1 ? span : 1);
      if (end > (1ll << 31)) return 4;  // beyond BAI addressability: corrupt
      int bin = bai_reg2bin(pos, end);
      int32_t slot = bin_slot[ref_id][bin];
      if (slot < 0) {
        slot = (int32_t)bins[ref_id].size();
        bin_slot[ref_id][bin] = slot;
        bins[ref_id].push_back({(uint32_t)bin, {}});
      }
      auto& chunks = bins[ref_id][slot].second;
      if (!chunks.empty() && voff_beg <= chunks.back().end)
        chunks.back().end = std::max(chunks.back().end, voff_end);
      else
        chunks.push_back({voff_beg, voff_end});

      size_t w_end = (size_t)((end - 1) >> kLinearShift);
      if (linear[ref_id].size() <= w_end) linear[ref_id].resize(w_end + 1, 0);
      for (size_t w = (size_t)(pos >> kLinearShift); w <= w_end; w++) {
        if (linear[ref_id][w] == 0 || voff_beg < linear[ref_id][w])
          linear[ref_id][w] = voff_beg;
      }
    }

    // bound memory on huge files
    size_t trimmed = in.discard_before(cursor);
    if (trimmed) {
      cursor -= trimmed;
      rebase_total += trimmed;
    }
  }

  std::string tmp = std::string(bai_path) + ".tmp";
  FILE* out = fopen(tmp.c_str(), "wb");
  if (!out) return 3;
  fwrite("BAI\x01", 1, 4, out);
  fwrite(&n_ref, 4, 1, out);
  for (int r = 0; r < n_ref; r++) {
    // sort bins by id like the Python builder
    std::sort(bins[r].begin(), bins[r].end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    int32_t n_bins = (int32_t)bins[r].size();
    fwrite(&n_bins, 4, 1, out);
    for (auto& entry : bins[r]) {
      uint32_t bin_id = entry.first;
      int32_t n_chunks = (int32_t)entry.second.size();
      fwrite(&bin_id, 4, 1, out);
      fwrite(&n_chunks, 4, 1, out);
      for (auto& c : entry.second) {
        fwrite(&c.beg, 8, 1, out);
        fwrite(&c.end, 8, 1, out);
      }
    }
    // fill-forward the linear index like the Python builder
    int32_t n_intervals = (int32_t)linear[r].size();
    fwrite(&n_intervals, 4, 1, out);
    uint64_t last = 0;
    for (int32_t w = 0; w < n_intervals; w++) {
      if (linear[r][w]) last = linear[r][w];
      fwrite(&last, 8, 1, out);
    }
  }
  fclose(out);
  if (rename(tmp.c_str(), bai_path) != 0) return 4;
  return 0;
}

// ---------------------------------------------------------------------------
// Region handle: inflate + filter a region's records ONCE, then run cheap
// passes over them — counts for candidate selection, then tensors for the
// selected centers. The two-pass structure exists because candidates are
// only known after the counts pass; re-inflating the region for the tensor
// pass would dominate, so the inflated bytes stay resident in the handle.
// ---------------------------------------------------------------------------

struct RegionHandle {
  std::vector<uint8_t> data;      // inflated bytes
  std::vector<size_t> records;    // offsets of the 4-byte length prefix of
                                  // region/flag/mapq-passing records, in order
};

void* clair_region_open2(const char* path, int32_t ref_id, int64_t start,
                         int64_t end, int32_t exclude_flag, int32_t min_mapq,
                         int64_t start_coffset, int32_t start_uoffset,
                         int64_t region_start, int64_t region_length,
                         int32_t* counts_out);

// Open a region: stream/inflate, keep passing record offsets.
// Returns nullptr on IO/format failure.
void* clair_region_open(const char* path, int32_t ref_id, int64_t start,
                        int64_t end, int32_t exclude_flag, int32_t min_mapq,
                        int64_t start_coffset, int32_t start_uoffset) {
  return clair_region_open2(path, ref_id, start, end, exclude_flag, min_mapq,
                            start_coffset, start_uoffset, 0, 0, nullptr);
}

void clair_region_free(void* h) { delete (RegionHandle*)h; }

int64_t clair_region_n_records(void* h) {
  return (int64_t)((RegionHandle*)h)->records.size();
}

// One record's candidate-side counts accumulation (soft-clip filter, no
// depth cap); shared by the standalone counts pass and the fused open.
static void accumulate_counts_record(const uint8_t* rec, CountsAcc& acc) {
  int64_t pos = read_le<int32_t>(rec + 4);
  uint8_t l_read_name = rec[8];
  uint16_t n_cigar = read_le<uint16_t>(rec + 12);
  const uint8_t* cigar_p = rec + 32 + l_read_name;
  const uint8_t* seq_p = cigar_p + 4 * n_cigar;

  int64_t total_len = 0, soft_len = 0;
  for (int i = 0; i < n_cigar; i++) {
    uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
    total_len += cv >> 4;
    if ((cv & 0xF) == 4) soft_len += cv >> 4;
  }
  if (1.0 - (double)soft_len / (double)(total_len + 1) < 0.55) return;

  int64_t refp = pos, qp = 0;
  for (int i = 0; i < n_cigar; i++) {
    uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
    uint32_t op = cv & 0xF;
    int64_t len = cv >> 4;
    switch (op) {
      case 0: case 7: case 8: {
        // Region-clip once per run, then decode seq nibbles two per byte:
        // the per-base bounds checks and the odd/even nibble branch were
        // the scan's hottest instructions — this pass visits EVERY aligned
        // base of every accepted read (~35M for a 250 kb ONT window).
        int64_t region_end = acc.region_start + acc.region_length;
        int64_t a = refp > acc.region_start ? refp : acc.region_start;
        int64_t b = refp + len < region_end ? refp + len : region_end;
        if (a < b) {
          int64_t q = qp + (a - refp);
          int32_t* row = acc.counts + (a - acc.region_start) * 7;
          int64_t n = b - a;
          if (q & 1) {  // align to a byte boundary
            int8_t col = kCodeToCol[seq_p[q >> 1] & 0xF];
            if (col >= 0) row[col]++;
            q++; row += 7; n--;
          }
          const uint8_t* bp = seq_p + (q >> 1);
          for (; n >= 2; n -= 2, bp++, row += 14) {
            int8_t c0 = kCodeToCol[*bp >> 4];
            int8_t c1 = kCodeToCol[*bp & 0xF];
            if (c0 >= 0) row[c0]++;
            if (c1 >= 0) row[7 + c1]++;
          }
          if (n) {
            int8_t col = kCodeToCol[*bp >> 4];
            if (col >= 0) row[col]++;
          }
        }
        refp += len;
        qp += len;
        break;
      }
      case 1:
        acc.op(refp, 4);
        qp += len;
        break;
      case 2:
        acc.op(refp, 5);
        refp += len;
        break;
      case 3: refp += len; break;
      case 4: qp += len; break;
      default: break;
    }
  }
}

// Candidate-side counts pass (soft-clip filter, no depth cap).
int clair_region_counts(void* h, int64_t region_start, int64_t region_length,
                        int32_t* counts_out) {
  RegionHandle* handle = (RegionHandle*)h;
  CountsAcc acc{counts_out, region_start, region_length};
  for (size_t rec_offset : handle->records)
    accumulate_counts_record(handle->data.data() + rec_offset + 4, acc);
  return 0;
}

// Build a RegionHandle from packed record arrays — the native CRAM slice
// decoder's output (clair_cram.cpp: ASCII seq bytes, BAM cigar op codes,
// position-sorted records) — so the counts/tensors passes run unchanged
// on CRAM input instead of falling back to the Python events engine
// (measured ~128x slower on a noisy ONT window). Each passing record is
// synthesized as a BAM-format record block (32-byte fixed header +
// 1-byte empty name + cigar + 4-bit packed seq; quals omitted — only
// this library's own passes read these bytes and none touch quals).
// Record selection matches clair_region_open (flag/mapq/region overlap);
// counts_out (nullable) fuses the candidate counts pass like
// clair_region_open2. Returns nullptr when a record cannot be expressed
// in BAM limits (cigar ops > 65535, pos > INT32_MAX) — the caller falls
// back to the Python path rather than silently dropping reads.
void* clair_region_from_packed(
    int64_t n, const int64_t* pos, const int32_t* mapq, const int32_t* flag,
    const int32_t* refid,
    const uint8_t* seq, const int64_t* seq_off,
    const uint8_t* cig_ops, const int32_t* cig_lens, const int64_t* cig_off,
    int32_t ref_id, int64_t start, int64_t end,
    int32_t exclude_flag, int32_t min_mapq,
    int64_t region_start, int64_t region_length, int32_t* counts_out) {
  struct Ascii4Bit {
    uint8_t lut[256];
    Ascii4Bit() {
      // BAM 4-bit base codes ("=ACMGRSVTWYHKDBN"); unknowns become N
      const char* bases = "=ACMGRSVTWYHKDBN";
      for (int b = 0; b < 256; b++) lut[b] = 15;
      for (int c = 1; c < 16; c++) {
        lut[(uint8_t)bases[c]] = (uint8_t)c;
        lut[(uint8_t)(bases[c] + 32)] = (uint8_t)c;  // lowercase
      }
    }
  };
  static const Ascii4Bit k4bit;

  CountsAcc acc{counts_out, region_start, region_length};
  RegionHandle* handle = new RegionHandle();
  handle->records.reserve((size_t)n);
  // offsets must be monotonic: a negative span would wrap the size_t
  // arithmetic below (the Python wrapper validates extents against the
  // blob lengths; this guards direct callers)
  for (int64_t i = 0; i < n; i++) {
    if (cig_off[i + 1] < cig_off[i] || seq_off[i + 1] < seq_off[i]) {
      delete handle;
      return nullptr;
    }
  }
  size_t upper = 0;
  for (int64_t i = 0; i < n; i++)
    upper += 4 + 33 + 4 * (size_t)(cig_off[i + 1] - cig_off[i]) +
             (size_t)(seq_off[i + 1] - seq_off[i] + 1) / 2;
  handle->data.reserve(upper);

  for (int64_t i = 0; i < n; i++) {
    if (refid[i] != ref_id) continue;
    if (flag[i] & exclude_flag) continue;
    if (mapq[i] < min_mapq) continue;
    if (end >= 0 && pos[i] >= end) continue;
    int64_t c0 = cig_off[i], nc = cig_off[i + 1] - c0;
    if (nc > 0xFFFF || pos[i] > INT32_MAX || pos[i] < INT32_MIN) {
      delete handle;
      return nullptr;
    }
    int64_t qlen = 0;
    for (int64_t j = 0; j < nc; j++) {
      // BAM packs op length into 28 bits; a longer (or negative) op
      // cannot be expressed and must not silently wrap; an op code past
      // X has no defined query/ref semantics
      uint8_t op = cig_ops[c0 + j];
      if (cig_lens[c0 + j] < 0 || cig_lens[c0 + j] >= (1 << 28) || op > 8) {
        delete handle;
        return nullptr;
      }
      if (kConsumesQueryOp[op]) qlen += cig_lens[c0 + j];
    }
    // the scans index the synthesized record's seq array by cumulative
    // query-consumed cigar length, so the spec invariant (M/I/S/=/X
    // lengths sum to the seq length) must hold HERE — check_record
    // guards only the BGZF walks, and a mismatched packed record would
    // read past the seq blob (heap OOB for the final record)
    if (nc > 0 && qlen != seq_off[i + 1] - seq_off[i]) {
      delete handle;
      return nullptr;
    }
    if (start >= 0) {
      int64_t ref_len = 0;
      for (int64_t j = 0; j < nc; j++) {
        uint8_t op = cig_ops[c0 + j];
        if (op < 9 && kConsumesRef[op]) ref_len += cig_lens[c0 + j];
      }
      if (pos[i] + ref_len <= start) continue;
    }
    int64_t s0 = seq_off[i], sl = seq_off[i + 1] - s0;
    int32_t block_size =
        (int32_t)(32 + 1 + 4 * nc + (sl + 1) / 2);
    size_t off = handle->data.size();
    handle->data.resize(off + 4 + (size_t)block_size);
    uint8_t* out = handle->data.data() + off;
    write_le<int32_t>(out, block_size);
    uint8_t* rec = out + 4;
    write_le<int32_t>(rec + 0, refid[i]);
    write_le<int32_t>(rec + 4, (int32_t)pos[i]);
    rec[8] = 1;  // l_read_name: empty name, NUL only
    // BAM mapq is one byte; clamp ITF8-range CRAM values to 255 so the
    // re-applied `mapq >= min_mapq` filter in the handle scans keeps any
    // record the build filter kept (min_mapq is at most 255 in practice)
    rec[9] = (uint8_t)(mapq[i] < 0 || mapq[i] > 255 ? 255 : mapq[i]);
    write_le<uint16_t>(rec + 10, 0);  // bin (unused by the passes)
    write_le<uint16_t>(rec + 12, (uint16_t)nc);
    write_le<uint16_t>(rec + 14, (uint16_t)flag[i]);
    write_le<int32_t>(rec + 16, (int32_t)sl);
    write_le<int32_t>(rec + 20, -1);  // next_refID
    write_le<int32_t>(rec + 24, -1);  // next_pos
    write_le<int32_t>(rec + 28, 0);   // tlen
    rec[32] = 0;                      // read name terminator
    uint8_t* cp = rec + 33;
    for (int64_t j = 0; j < nc; j++)
      write_le<uint32_t>(
          cp + 4 * j,
          ((uint32_t)cig_lens[c0 + j] << 4) | (cig_ops[c0 + j] & 0xF));
    uint8_t* sp = cp + 4 * nc;
    for (int64_t q = 0; q < sl; q++) {
      uint8_t code = k4bit.lut[seq[s0 + q]];
      if (q & 1)
        sp[q >> 1] |= code;
      else
        sp[q >> 1] = (uint8_t)(code << 4);
    }
    handle->records.push_back(off);
    if (counts_out != nullptr) accumulate_counts_record(rec, acc);
  }
  return handle;
}

// Data-prep scans over a RegionHandle — the CRAM packed-array path's
// equivalent of clair_bam_scan_window / clair_bam_events_dual: identical
// per-record semantics (scan_record), iterating the handle's records
// instead of a BGZF stream. Handle records are already flag/mapq/region
// filtered at build time; the filters are applied again here with the
// same constants (idempotent) so the depth-cap and soft-clip decisions
// match the stream scans exactly.
int clair_region_scan_window(void* h, int32_t ref_id, int64_t start,
                             int64_t end, int32_t exclude_flag,
                             int32_t min_mapq, int32_t dcov,
                             int64_t region_start, int64_t region_length,
                             int32_t* counts_out, EventBuffers* tensor_out) {
  memset(tensor_out, 0, sizeof(*tensor_out));
  RegionHandle* handle = (RegionHandle*)h;
  CountsAcc acc{counts_out, region_start, region_length};
  EventVecs tensor_vecs;
  ScanState st{ref_id, start, end, exclude_flag, min_mapq, dcov,
               nullptr, &tensor_vecs, &acc};
  for (size_t rec_offset : handle->records)
    if (!scan_record(handle->data.data() + rec_offset + 4, st)) break;
  tensor_vecs.fill(tensor_out);
  return 0;
}

int clair_region_events_dual(void* h, int32_t ref_id, int64_t start,
                             int64_t end, int32_t exclude_flag,
                             int32_t min_mapq, int32_t dcov,
                             EventBuffers* candidate_out,
                             EventBuffers* tensor_out) {
  memset(candidate_out, 0, sizeof(*candidate_out));
  memset(tensor_out, 0, sizeof(*tensor_out));
  RegionHandle* handle = (RegionHandle*)h;
  EventVecs candidate_vecs, tensor_vecs;
  ScanState st{ref_id, start, end, exclude_flag, min_mapq, dcov,
               &candidate_vecs, &tensor_vecs, nullptr};
  for (size_t rec_offset : handle->records)
    if (!scan_record(handle->data.data() + rec_offset + 4, st)) break;
  candidate_vecs.fill(candidate_out);
  tensor_vecs.fill(tensor_out);
  return 0;
}

// Fused open + counts: identical record selection to clair_region_open,
// with each accepted record's candidate counts accumulated while its
// bytes are still cache-hot. The accumulation work itself dominates, so
// the measured win over open + a separate counts pass is modest (~3 ms
// on a 250 kb 35x window) — the header re-parse, buffer re-stream, and
// one Python->C round trip are what it removes.
// counts_out covers [region_start, region_start + region_length).
void* clair_region_open2(const char* path, int32_t ref_id, int64_t start,
                         int64_t end, int32_t exclude_flag, int32_t min_mapq,
                         int64_t start_coffset, int32_t start_uoffset,
                         int64_t region_start, int64_t region_length,
                         int32_t* counts_out) {
  bool seeked = start_coffset >= 0 && start_uoffset >= 0;
  StreamInflater in;
  if (!in.open(path, seeked ? start_coffset : 0)) return nullptr;

  size_t cursor;
  if (seeked) {
    cursor = (size_t)start_uoffset;
    if (!in.ensure(cursor)) return nullptr;
  } else {
    cursor = skip_header(in);
    if (cursor == SIZE_MAX) return nullptr;
  }

  CountsAcc acc{counts_out, region_start, region_length};
  RegionHandle* handle = new RegionHandle();
  handle->records.reserve(1 << 16);
  while (in.ensure(cursor + 4)) {
    int32_t block_size = read_le<int32_t>(in.data.data() + cursor);
    // corrupt framing (or a stale .bai seeking mid-record): fail the
    // whole open — callers fall back to the loud checksummed Python
    // path; a silently truncated record list would silently drop calls
    if (block_size < 32) { delete handle; return nullptr; }
    if (!in.ensure(cursor + 4 + block_size)) { delete handle; return nullptr; }
    const uint8_t* rec = in.data.data() + cursor + 4;
    size_t rec_offset = cursor;
    cursor += 4 + block_size;

    RecordCheck chk = check_record(rec, block_size);
    if (chk == kRecCorrupt) { delete handle; return nullptr; }
    if (chk == kRecSkip) continue;

    int32_t rec_ref = read_le<int32_t>(rec);
    int64_t pos = read_le<int32_t>(rec + 4);
    uint8_t l_read_name = rec[8];
    uint8_t mapq = rec[9];
    uint16_t n_cigar = read_le<uint16_t>(rec + 12);
    uint16_t flag = read_le<uint16_t>(rec + 14);

    if (rec_ref != ref_id) {
      if (ref_id >= 0 && rec_ref > ref_id) break;
      continue;
    }
    if (flag & exclude_flag) continue;
    if (mapq < min_mapq) continue;
    if (end >= 0 && pos >= end) break;
    if (pos < 0) continue;  // corrupt/unmapped position on a kept ref
    if (start >= 0) {
      const uint8_t* cigar_p = rec + 32 + l_read_name;
      int64_t ref_len = 0;
      for (int i = 0; i < n_cigar; i++) {
        uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
        uint32_t op = cv & 0xF;
        if (op < 9 && kConsumesRef[op]) ref_len += cv >> 4;
      }
      if (pos + ref_len <= start) continue;
    }
    handle->records.push_back(rec_offset);
    if (counts_out != nullptr) accumulate_counts_record(rec, acc);
  }
  handle->data = std::move(in.data);
  return handle;
}

// Tensor pass for selected centers (depth cap, no soft-clip filter).
// Builds the (n_centers, 33, 8, 4) count tensors directly — match events
// (~93% of event volume) never materialize. Indel events + ops still come
// back (allele recovery needs them). Semantics mirror
// clair_tpu/data/pileup.py create_tensors exactly:
//   window contains p when p - c + 17 in [0, 33)  (c 1-based)
//   match: ref-base row ch0+ch2, query-base row ch1+ch3 (both gated on a
//          known reference base and p within the reference chunk)
//   insertion: query row ch1 at min(idx + adv, 32), no reference gating
//   deletion: ref-base row ch2
int clair_region_tensors(void* h, int32_t dcov, const int64_t* centers,
                         int64_t n_centers, const char* ref_seq,
                         int64_t ref_seq_start, int64_t ref_seq_len,
                         int32_t* tensors_out, EventBuffers* indel_out) {
  RegionHandle* handle = (RegionHandle*)h;
  memset(indel_out, 0, sizeof(*indel_out));
  if (n_centers == 0) {
    EventVecs empty;
    empty.fill(indel_out);
    return 0;
  }

  const int64_t kFlank = 16, kT = 33;
  int64_t mask_lo = centers[0] - kFlank - 1;
  int64_t mask_len = centers[n_centers - 1] + kFlank - mask_lo;
  // Per-position center ranges, precomputed in one two-pointer sweep:
  // the tensor pass visits every aligned base of every read (35M+ for an
  // ONT window), and two binary searches per near-center base were the
  // hottest host-side loop after nativization. win_lo/win_hi[p - mask_lo]
  // = the centers c with p in c's 33-wide window, i.e. c in [p-15, p+17]
  // (1-based centers; hi exclusive). hi <= lo encodes "not near".
  std::vector<int32_t> win_lo(mask_len), win_hi(mask_len);
  {
    int64_t lo = 0, hi = 0;
    for (int64_t idx = 0; idx < mask_len; idx++) {
      int64_t p = mask_lo + idx;
      while (lo < n_centers && centers[lo] < p - kFlank + 1) lo++;
      while (hi < n_centers && centers[hi] <= p + kFlank + 1) hi++;
      win_lo[idx] = (int32_t)lo;
      win_hi[idx] = (int32_t)hi;
    }
  }

  auto windows = [&](int64_t p, int64_t* lo_out, int64_t* hi_out) -> bool {
    int64_t idx = p - mask_lo;
    if (idx < 0 || idx >= mask_len) return false;
    *lo_out = win_lo[idx];
    *hi_out = win_hi[idx];
    return *hi_out > *lo_out;
  };

  const int64_t kSize = kT * 8 * 4;
  int64_t ref_lo = ref_seq_start, ref_hi = ref_seq_start + ref_seq_len;

  EventVecs indel;
  int64_t previous_pos = -1;
  int32_t same_pos_count = 0;

  for (size_t rec_offset : handle->records) {
    const uint8_t* rec = handle->data.data() + rec_offset + 4;
    int64_t pos = read_le<int32_t>(rec + 4);
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar = read_le<uint16_t>(rec + 12);
    uint16_t flag = read_le<uint16_t>(rec + 14);
    const uint8_t* cigar_p = rec + 32 + l_read_name;
    const uint8_t* seq_p = cigar_p + 4 * n_cigar;

    if (pos != previous_pos) {
      previous_pos = pos;
      same_pos_count = 0;
    } else {
      same_pos_count++;
      if (dcov > 0 && same_pos_count >= dcov) continue;
    }

    int8_t strand = (flag & 16) ? 1 : 0;
    int64_t strand_rows = strand ? 4 : 0;
    int64_t refp = pos, qp = 0;
    for (int i = 0; i < n_cigar; i++) {
      uint32_t cv = read_le<uint32_t>(cigar_p + 4 * i);
      uint32_t op = cv & 0xF;
      int64_t len = cv >> 4;
      switch (op) {
        case 0: case 7: case 8: {
          // Iterate per overlapping WINDOW, not per aligned base: a long
          // ONT read visits ~14M aligned bases per 250 kb region but
          // only ~20-30% sit inside any candidate window — the per-base
          // windows() lookup on the cold majority was the pass's
          // dominant cost. Center range for the whole run comes from the
          // same precomputed sweep tables in O(1), then each (window,
          // position) pair is visited exactly once, identical to the
          // per-base form (equivalence-tested against the Python engine
          // in tests/test_native.py).
          int64_t a = std::max(refp, ref_lo);          // ref-gated span
          int64_t b = std::min(refp + len, ref_hi);
          if (a < b) {
            // centers c whose 33-wide window [c-17, c+15] meets [a, b):
            // c >= a - kFlank + 1 and c <= (b-1) + kFlank + 1
            int64_t a_idx = a - mask_lo;
            int64_t b_idx = (b - 1) - mask_lo;
            int64_t c_lo = a_idx < 0 ? 0
                : (a_idx >= mask_len ? n_centers : win_lo[a_idx]);
            int64_t c_hi = b_idx < 0 ? 0
                : (b_idx >= mask_len ? n_centers : win_hi[b_idx]);
            for (int64_t w = c_lo; w < c_hi; w++) {
              int64_t c = centers[w];
              int64_t p_lo = std::max(a, c - kFlank - 1);
              int64_t p_hi = std::min(b - 1, c + kFlank - 1);
              int32_t* win_cells = tensors_out + w * kSize;
              for (int64_t p = p_lo; p <= p_hi; p++) {
                int64_t q = qp + (p - refp);
                uint8_t code = seq_p[q >> 1];
                code = (q & 1) ? (code & 0xF) : (code >> 4);
                int8_t qc = kCodeToCol[code];
                if (qc < 0) continue;
                int8_t rr = kBaseNum.lut[(uint8_t)ref_seq[p - ref_seq_start]];
                if (rr < 0) continue;
                int64_t q_row = (qc > 3 ? 0 : qc) + strand_rows;
                int64_t r_row = rr + strand_rows;
                int32_t* cell = win_cells + (p - c + kFlank + 1) * 32;
                cell[r_row * 4 + 0]++;
                cell[r_row * 4 + 2]++;
                cell[q_row * 4 + 1]++;
                cell[q_row * 4 + 3]++;
              }
            }
          }
          refp += len;
          qp += len;
          break;
        }
        case 1: {
          indel.ins_op.push_back(refp);
          indel.ins_op_len.push_back(len);
          int64_t w_lo = 0, w_hi = 0;
          bool in_window = windows(refp, &w_lo, &w_hi);
          for (int64_t k = 0; k < len; k++) {
            int64_t q = qp + k;
            uint8_t code = seq_p[q >> 1];
            code = (q & 1) ? (code & 0xF) : (code >> 4);
            int8_t qc = kCodeToCol[code];
            // indel recovery consumes every inserted base (op order)
            indel.ins_pos.push_back(refp);
            indel.ins_adv.push_back(k);
            indel.ins_qcol.push_back(qc);
            indel.ins_strand.push_back(strand);
            if (!in_window || qc < 0) continue;
            int64_t q_row = (qc > 3 ? 0 : qc) + strand_rows;
            for (int64_t w = w_lo; w < w_hi; w++) {
              int64_t idx = refp - centers[w] + kFlank + 1 + k;
              if (idx > kT - 1) idx = kT - 1;
              tensors_out[w * kSize + idx * 32 + q_row * 4 + 1]++;
            }
          }
          qp += len;
          break;
        }
        case 2: {
          indel.del_op.push_back(refp);
          indel.del_op_len.push_back(len);
          for (int64_t k = 0; k < len; k++) {
            int64_t p = refp + k;
            int64_t w_lo, w_hi;
            if (p < ref_lo || p >= ref_hi || !windows(p, &w_lo, &w_hi)) continue;
            int8_t rr = kBaseNum.lut[(uint8_t)ref_seq[p - ref_seq_start]];
            if (rr < 0) continue;
            int64_t r_row = rr + strand_rows;
            for (int64_t w = w_lo; w < w_hi; w++) {
              int64_t idx = p - centers[w] + kFlank + 1;
              tensors_out[w * kSize + idx * 32 + r_row * 4 + 2]++;
            }
          }
          refp += len;
          break;
        }
        case 3: refp += len; break;
        case 4: qp += len; break;
        default: break;
      }
    }
  }
  indel.fill(indel_out);
  return 0;
}

// Single-pass candidate filter over a (region_length, 7) counts matrix.
// Mirrors data/pileup.py select_candidates exactly (ref EVC.py:319-378):
// depth over the A,C,G,T,N columns, first-argmax top column in the stable
// A,C,G,T,I,D,N tie order, second-largest value over the remaining
// columns, and the same collapsed reference-base map (uppercase IUPAC
// collapses to its ACGT representative, N and anything else pass through).
// ref points at the region's reference bytes (already offset to
// region_start); mask may be null. Returns the number of selected sites;
// idx_out/depth_out/base_out must each have room for region_length
// entries.
int64_t clair_select_candidates(const int32_t* counts, int64_t region_length,
                                const char* ref, const uint8_t* mask,
                                double min_af, double min_cov,
                                int64_t* idx_out, int32_t* depth_out,
                                uint8_t* base_out) {
  // byte -> candidate column (CANDIDATE_COL_LUT) and byte -> collapsed
  // reported base, built once to match the Python tables bit for bit.
  // A function-local static struct gets C++11 magic-static init: the
  // first pileup worker thread to arrive builds it, concurrent first
  // calls from other workers block until it is complete (a plain
  // `static bool ready` guard would be a data race here — ctypes
  // releases the GIL, so worker threads do run this concurrently).
  struct CandidateLuts {
    int8_t col[256];
    uint8_t collapse[256];
    CandidateLuts() {
      const char* iupac = "ACGTURYSWKMBDHV";
      const int8_t iupac_col[] = {0, 1, 2, 3, 3, 0, 1, 1, 0, 2, 0, 1, 0, 0, 0};
      const char iupac_acgt[] = "ACGTTACCAGACAAA";
      for (int b = 0; b < 256; b++) {
        col[b] = -1;
        collapse[b] = (uint8_t)b;  // not an uppercase IUPAC code: keep
      }
      for (int i = 0; iupac[i]; i++) {
        uint8_t up = (uint8_t)iupac[i];
        uint8_t lo = (uint8_t)(up + 32);
        col[up] = col[lo] = iupac_col[i];
        collapse[up] = (uint8_t)iupac_acgt[i];  // lowercase keeps itself
      }
      col['N'] = col['n'] = 6;
      collapse['N'] = 'N';  // N reports as N, not its A collapse
    }
  };
  static const CandidateLuts luts;
  const int8_t* col_lut = luts.col;
  const uint8_t* collapse_lut = luts.collapse;

  int64_t n_out = 0;
  for (int64_t i = 0; i < region_length; i++) {
    int8_t ref_col = col_lut[(uint8_t)ref[i]];
    if (ref_col < 0) continue;
    if (mask != nullptr && mask[i] == 0) continue;
    const int32_t* c = counts + i * 7;
    int32_t depth = c[0] + c[1] + c[2] + c[3] + c[6];
    if ((double)depth < min_cov) continue;
    int top = 0;
    int32_t top_count = c[0];
    for (int k = 1; k < 7; k++)
      if (c[k] > top_count) { top_count = c[k]; top = k; }
    if (top != ref_col) {
      // dominant column is non-reference: passes regardless of AF
    } else {
      int32_t second = INT32_MIN;
      for (int k = 0; k < 7; k++)
        if (k != top && c[k] > second) second = c[k];
      int32_t denom = depth > 0 ? depth : 1;
      if ((double)second / (double)denom < min_af) continue;
    }
    idx_out[n_out] = i;
    depth_out[n_out] = depth;
    base_out[n_out] = collapse_lut[(uint8_t)ref[i]];
    n_out++;
  }
  return n_out;
}

// Shared finalize loop for filled (n, 33, 8, 4) int32 window tensors:
// one pass applies the keep filter (center coverage + complete flank
// context, data/pileup.py finalize_window_tensors, ref
// CreateTensor.py:57-59), gathers the kept rows through the
// store functor, and cuts the kept 33-mer sequences (33 bytes each).
// A store may refuse a row (return false) to abort the whole finalize —
// the u8 store uses this to reject counts that do not fit a byte instead
// of silently saturating. Returns the kept count, or -1 on store refusal.
}  // extern "C" (resumed below — templates need C++ linkage)
namespace {
template <typename StoreFn>
int64_t finalize_windows_loop(const int32_t* tensors, int64_t n,
                              const int64_t* centers, const char* ref,
                              int64_t ref_len, int64_t ref_seq_start,
                              double minimum_coverage, int64_t* kept_idx,
                              uint8_t* seqs_out, StoreFn&& store) {
  const int64_t kFlank = 16, kSize = 33 * 8 * 4;
  int64_t n_kept = 0;
  for (int64_t i = 0; i < n; i++) {
    const int32_t* t = tensors + i * kSize;
    int64_t center_depth = 0;
    for (int r = 0; r < 8; r++) center_depth += t[kFlank * 32 + r * 4];
    int64_t c = centers[i] - ref_seq_start;
    if ((double)center_depth < minimum_coverage) continue;
    if (c - (kFlank + 1) < 0 || c + kFlank > ref_len) continue;
    if (!store(t, n_kept)) return -1;
    memcpy(seqs_out + n_kept * 33, ref + c - (kFlank + 1), 33);
    kept_idx[n_kept] = i;
    n_kept++;
  }
  return n_kept;
}
}  // namespace
extern "C" {

// float32 finalize: store converts to float32 and channel-normalizes
// (channels 1..3 -= channel 0, tensor_stream.py normalize_channels) —
// replacing an astype + fancy-index + in-place subtract chain over the
// full window in numpy. ref points at the reference bytes starting at
// ref_seq_start; out buffers must have room for n entries.
int64_t clair_finalize_windows(const int32_t* tensors, int64_t n,
                               const int64_t* centers, const char* ref,
                               int64_t ref_len, int64_t ref_seq_start,
                               double minimum_coverage, float* out_tensors,
                               int64_t* kept_idx, uint8_t* seqs_out) {
  const int64_t kSize = 33 * 8 * 4;
  return finalize_windows_loop(
      tensors, n, centers, ref, ref_len, ref_seq_start, minimum_coverage,
      kept_idx, seqs_out, [&](const int32_t* t, int64_t n_kept) {
        float* o = out_tensors + n_kept * kSize;
        for (int64_t p = 0; p < kSize; p += 4) {
          float v0 = (float)t[p];
          o[p] = v0;
          o[p + 1] = (float)t[p + 1] - v0;
          o[p + 2] = (float)t[p + 2] - v0;
          o[p + 3] = (float)t[p + 3] - v0;
        }
        return true;
      });
}

// Raw-count variant of clair_finalize_windows for the device-normalized
// uplink: same keep filter + 33-mer extraction, but counts stay raw uint8
// (no channel normalization, no float conversion) — the device subtracts
// ch0 inside the jitted forward. dcov caps reads per START position
// (ref CreateTensor.py:267-274), NOT pileup column depth, so cell counts
// can exceed 255 on >255x data (chrM, amplicons, the 550x highcov
// regime) even at dcov=250. Rather than silently saturating — which
// would change model inputs and therefore calls — any kept cell outside
// [0, 255] aborts with -1 and the caller re-finalizes through the exact
// float32 path.
int64_t clair_finalize_windows_u8(const int32_t* tensors, int64_t n,
                                  const int64_t* centers, const char* ref,
                                  int64_t ref_len, int64_t ref_seq_start,
                                  double minimum_coverage,
                                  uint8_t* out_tensors, int64_t* kept_idx,
                                  uint8_t* seqs_out) {
  const int64_t kSize = 33 * 8 * 4;
  return finalize_windows_loop(
      tensors, n, centers, ref, ref_len, ref_seq_start, minimum_coverage,
      kept_idx, seqs_out, [&](const int32_t* t, int64_t n_kept) {
        uint8_t* o = out_tensors + n_kept * kSize;
        for (int64_t p = 0; p < kSize; p++) {
          int32_t v = t[p];
          if ((uint32_t)v > 255u) return false;  // does not fit a byte
          o[p] = (uint8_t)v;
        }
        return true;
      });
}

void clair_free_events(EventBuffers* buffers) {
  free(buffers->match_pos);
  free(buffers->match_qcol);
  free(buffers->match_strand);
  free(buffers->ins_pos);
  free(buffers->ins_adv);
  free(buffers->ins_qcol);
  free(buffers->ins_strand);
  free(buffers->del_pos);
  free(buffers->del_strand);
  free(buffers->ins_op_pos);
  free(buffers->del_op_pos);
  free(buffers->ins_op_len);
  free(buffers->del_op_len);
  memset(buffers, 0, sizeof(*buffers));
}

}  // extern "C"
