// clair_decode: native fast-path variant decode.
//
// Mirrors clair_tpu/pipeline/batch_decode.py exactly: category maxima
// factorize over the two length heads, the winner is the first category
// attaining the global max (the reference's tie order,
// call_var.py:693-947). Besides the three fast-path categories
// (homo-reference / homo-SNP / hetero-SNP) this also assembles the six
// indel categories that need no allele-recovery callback (homo ins/del,
// het ACGT+ins/del, het del+del, het ins+del) when `sequences` is given;
// only het ins+ins (insertion_bases callback), lengths >= 16 (BAM
// recovery), and degenerate del+del alleles return as fallback indices
// for the exact Python path. Argmax loops iterate in the Python arrays'
// index order so ties break identically (deletion arrays are reversed:
// length ascending = vl index descending).
//
// Outputs fully formatted VCF row strings so the Python layer only merges
// them (in site order) with the rare fallback rows.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// gt21 class codes (clair_tpu/task/gt21.py)
const int kHomoSnp[4] = {0, 4, 7, 9};                 // AA CC GG TT
const int kHeteroSnp[6] = {1, 2, 3, 5, 6, 8};         // AC AG AT CG CT GT
const char kHomoBase[4] = {'A', 'C', 'G', 'T'};
const char kHeteroB1[6] = {'A', 'A', 'A', 'C', 'C', 'G'};
const char kHeteroB2[6] = {'C', 'G', 'T', 'G', 'T', 'T'};
const int kInsIns = 15, kDelDel = 10, kInsDel = 20;
const int kHetIns[4] = {16, 17, 18, 19};              // AIns..TIns
const int kHetDel[4] = {11, 12, 13, 14};              // ADel..TDel

// unordered base-pair -> gt21 code (A=0 C=1 G=2 T=3)
const int kPairCode[4][4] = {
    {0, 1, 2, 3},
    {1, 4, 5, 6},
    {2, 5, 7, 8},
    {3, 6, 8, 9},
};

int base_index(char b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

// IUPAC -> ACGT index (shared/utils maps; N -> A(0))
int acgt_index(char b) {
  switch (b) {
    case 'A': case 'W': case 'M': case 'D': case 'H': case 'V': case 'N':
    case 'R': return 0;
    case 'C': case 'Y': case 'S': case 'B': return 1;
    case 'G': case 'K': return 2;
    case 'T': case 'U': return 3;
    default: return -1;
  }
}

bool is_basic_base(char b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T' || b == 'U';
}

struct Maxima {
  double v[10];
};

// Unsigned decimal formatter (the snprintf in the row emitter was ~60% of
// per-site decode cost; rows are the hot path when --showRef is on).
inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int k = 0;
  do {
    tmp[k++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  while (k) *p++ = tmp[--k];
  return p;
}

// %.4f equivalent for af in [0, 1]. llrint (round-half-even) matches
// printf's correctly-rounded conversion except when the scaled value sits
// within double noise of a .5 boundary — fall back to snprintf there so
// rows stay byte-identical to the Python formatter.
inline char* put_af4(char* p, double af) {
  if (af < 0.0) {  // indel support sums can go negative on normalized
    return p + snprintf(p, 16, "%.4f", af);  // tensors; match Python %.4f
  }
  double scaled = af * 10000.0;
  double frac = scaled - std::floor(scaled);
  if (std::fabs(frac - 0.5) < 1e-6) {
    return p + snprintf(p, 8, "%.4f", af);
  }
  long v = llrint(scaled);
  *p++ = (char)('0' + v / 10000);
  *p++ = '.';
  long r = v % 10000;
  *p++ = (char)('0' + r / 1000);
  *p++ = (char)('0' + (r / 100) % 10);
  *p++ = (char)('0' + (r / 10) % 10);
  *p++ = (char)('0' + r % 10);
  return p;
}

}  // namespace

extern "C" {

// Returns 0 on success. rows_out: malloc'd '\n'-joined VCF rows;
// row_sites: site index of each row (ascending); fallback: site indices
// needing the Python lattice. Free all three with clair_decode_free.
// The four probability arrays carry explicit row strides (in floats) so
// Python can pass views into one (n, 90) forward-output buffer without
// copying each head out (strides 90/90/90/90 with offset pointers);
// dense arrays pass their own widths (21/3/33/33).
int clair_decode_fast2(
    const float* x,            // (n, 33, 8, 4) channel-normalized
    const float* gt21,         // (n, 21) rows, stride s_g
    const float* geno,         // (n, 3) rows, stride s_gn
    const float* vl1,          // (n, 33) rows, stride s_v1
    const float* vl2,          // (n, 33) rows, stride s_v2
    int32_t s_g, int32_t s_gn, int32_t s_v1, int32_t s_v2,
    const int64_t* positions,  // 1-based
    const char* center_bases,  // (n,)
    const char* sequences,     // (n, 33) ref windows, NULL -> indels fall back
    int64_t n,
    const char* contig,
    int32_t has_insertion_source,  // nonzero -> het ins+ins needs the
                                   // Python allele-recovery callback
    int32_t show_ref, int32_t haploid_precision, int32_t haploid_sensitive,
    int32_t qual_cutoff,       // INT32_MIN -> '.', else PASS/LowQual
    int32_t n_threads,
    char** rows_out, int64_t* rows_len,
    int64_t** row_sites_out, int64_t* n_rows_out,
    int64_t** fallback_out, int64_t* n_fallback_out) {
  struct Shard {
    std::string rows;
    std::vector<int64_t> row_sites;
    std::vector<int64_t> fallback;
  };

  const int center = 16;
  const size_t contig_len = strlen(contig);

  auto decode_range = [&](int64_t lo, int64_t hi, Shard& shard) {
  // row buffer: prefix (<=257) + position (<=20) + fixed fields (<~110);
  // 512 leaves ample slack, and the prefix cap bounds the total
  char line[512];
  char prefix[258];
  size_t prefix_len = std::min(contig_len, sizeof(prefix) - 2);
  memcpy(prefix, contig, prefix_len);
  prefix[prefix_len++] = '\t';
  std::string& rows = shard.rows;
  std::vector<int64_t>& row_sites = shard.row_sites;
  std::vector<int64_t>& fallback = shard.fallback;
  rows.reserve((size_t)(hi - lo) * 48);

  // shared row emitter: "<ctg>\t<pos>\t.\t<ref>\t<alt>\t<qual>\t<filter>
  // \t.\tGT:GQ:DP:AF\t<gt>:<qual>:<depth>:<af>\n" (hand-rolled; snprintf
  // dominated per-site decode cost)
  auto emit_row = [&](int64_t i, const char* ref_str, const char* alt_str,
                      const char* genotype_out, long quality, double depth,
                      double af) {
    const char* filter = ".";
    if (qual_cutoff != INT32_MIN) {
      filter = quality >= qual_cutoff ? "PASS" : "LowQual";
    }
    char* wp = line;
    memcpy(wp, prefix, prefix_len);
    wp += prefix_len;
    wp = put_u64(wp, (uint64_t)positions[i]);
    *wp++ = '\t'; *wp++ = '.'; *wp++ = '\t';
    for (const char* s = ref_str; *s; s++) *wp++ = *s;
    *wp++ = '\t';
    for (const char* s = alt_str; *s; s++) *wp++ = *s;
    *wp++ = '\t';
    wp = put_u64(wp, (uint64_t)quality);
    *wp++ = '\t';
    for (const char* s = filter; *s; s++) *wp++ = *s;
    memcpy(wp, "\t.\tGT:GQ:DP:AF\t", 15);
    wp += 15;
    for (const char* s = genotype_out; *s; s++) *wp++ = *s;
    *wp++ = ':';
    wp = put_u64(wp, (uint64_t)quality);
    *wp++ = ':';
    wp = put_u64(wp, (uint64_t)llrint(depth));
    *wp++ = ':';
    wp = put_af4(wp, af);
    *wp++ = '\n';
    rows.append(line, wp - line);
    row_sites.push_back(i);
  };

  for (int64_t i = lo; i < hi; i++) {
    const char raw_base = center_bases[i];
    if (!is_basic_base(raw_base)) continue;

    const float* xi = x + i * 33 * 8 * 4;
    // read depth: center row, channels delete(2) + reference(0)
    double depth = 0.0;
    for (int r = 0; r < 8; r++) depth += xi[center * 32 + r * 4 + 2] + xi[center * 32 + r * 4 + 0];
    if (depth == 0.0) continue;

    const float* g21 = gt21 + i * s_g;
    const float* gn = geno + i * s_gn;
    const float* v1 = vl1 + i * s_v1;
    const float* v2 = vl2 + i * s_v2;

    const double p_ref = gn[0], p_homo = gn[1], p_het = gn[2];
    const double z1 = v1[16], z2 = v2[16];
    const double vl0 = z1 * z2;

    double pos1max = 0, pos2max = 0;
    double n1max = 0, n2max = 0, n1second = 0, n2second = 0;
    int n1arg = 0, n2arg = 0;
    double homo_ins_pair = 0, homo_del_pair = 0;
    for (int k = 0; k < 16; k++) {
      double a1 = v1[17 + k], a2 = v2[17 + k];
      if (a1 > pos1max) pos1max = a1;
      if (a2 > pos2max) pos2max = a2;
      homo_ins_pair = std::max(homo_ins_pair, a1 * a2);
      double b1 = v1[k], b2 = v2[k];
      if (b1 > n1max) { n1second = n1max; n1max = b1; n1arg = k; }
      else if (b1 > n1second) n1second = b1;
      if (b2 > n2max) { n2second = n2max; n2max = b2; n2arg = k; }
      else if (b2 > n2second) n2second = b2;
      homo_del_pair = std::max(homo_del_pair, b1 * b2);
    }
    double deldel_pair = (n1arg == n2arg)
        ? std::max(n1max * n2second, n1second * n2max)
        : n1max * n2max;

    int ref_idx = acgt_index(raw_base);
    int ref_code = kPairCode[ref_idx][ref_idx];

    double homo_snp_g = 0, het_snp_g = 0, het_ins_g = 0, het_del_g = 0;
    int homo_arg = 0, het_arg = 0;
    for (int k = 0; k < 4; k++) {
      if (g21[kHomoSnp[k]] > homo_snp_g) { homo_snp_g = g21[kHomoSnp[k]]; homo_arg = k; }
      het_ins_g = std::max(het_ins_g, (double)g21[kHetIns[k]]);
      het_del_g = std::max(het_del_g, (double)g21[kHetDel[k]]);
    }
    for (int k = 0; k < 6; k++) {
      if (g21[kHeteroSnp[k]] > het_snp_g) { het_snp_g = g21[kHeteroSnp[k]]; het_arg = k; }
    }

    Maxima m;
    m.v[0] = vl0 * p_ref * g21[ref_code];
    m.v[1] = vl0 * p_homo * homo_snp_g;
    m.v[2] = vl0 * p_het * het_snp_g;
    m.v[3] = homo_ins_pair * p_homo * g21[kInsIns];
    m.v[4] = std::max(z1 * pos2max, pos1max * z2) * het_ins_g * p_het;
    m.v[5] = pos1max * pos2max * p_het * g21[kInsIns];
    m.v[6] = homo_del_pair * p_homo * g21[kDelDel];
    m.v[7] = std::max(z1 * n2max, n1max * z2) * het_del_g * p_het;
    m.v[8] = deldel_pair * p_het * g21[kDelDel];
    m.v[9] = std::max(pos1max * n2max, n1max * pos2max) * p_het * g21[kInsDel];

    int winner = 0;
    double best = m.v[0];
    for (int c = 1; c < 10; c++) {
      if (m.v[c] > best) { best = m.v[c]; winner = c; }
    }

    if (winner > 2) {
      // --- indel assembly (batch_decode_indels semantics) ---
      if (sequences == nullptr
          || (winner == 5 && has_insertion_source)) {
        // het ins+ins consults the insertion-recovery callback when one is
        // configured (call_bam's event-indexed sources); without one the
        // shorter allele is the winning bases' prefix and decodes here
        fallback.push_back(i);
        continue;
      }
      const char* seq = sequences + i * 33;
      const char refc = seq[16];

      // Python's length-ascending views: pos[j] = vl[17+j] (length j+1),
      // negL[j] = vl[15-j] (length j+1)
      auto pv1 = [&](int j) { return (double)v1[17 + j]; };
      auto pv2 = [&](int j) { return (double)v2[17 + j]; };
      auto nv1 = [&](int j) { return (double)v1[15 - j]; };
      auto nv2 = [&](int j) { return (double)v2[15 - j]; };

      // inserted bases from the folded profile of rows 17..16+L; numpy's
      // argmax runs over [f0..f3, 0,0,0,0] % 4: an all-negative profile
      // resolves to 'A' via the zero at index 4
      char insb[17];
      auto ins_str = [&](int L) {
        for (int t = 0; t < L; t++) {
          const float* row = xi + (17 + t) * 32;
          float vals[5];
          for (int b = 0; b < 4; b++)
            vals[b] = row[b * 4 + 1] + row[(b + 4) * 4 + 1]
                    - row[b * 4 + 3] - row[(b + 4) * 4 + 3];
          vals[4] = 0.0f;
          int arg = 0;
          for (int b = 1; b < 5; b++)
            if (vals[b] > vals[arg]) arg = b;
          insb[t] = "ACGT"[arg == 4 ? 0 : arg];
        }
        insb[L] = 0;
      };

      // float accumulation in numpy's order (separate channel sums, then
      // subtract) so AF matches the Python path bit-for-bit even on
      // non-integer tensors
      float ins_pos = 0.0f, ins_neg = 0.0f, del_f = 0.0f;
      for (int r = 0; r < 8; r++) {
        ins_pos += xi[17 * 32 + r * 4 + 1];
        ins_neg += xi[17 * 32 + r * 4 + 3];
        del_f += xi[17 * 32 + r * 4 + 2];
      }
      double ins_sup = (double)(ins_pos - ins_neg), del_sup = (double)del_f;

      int het_ins_arg = 0, het_del_arg = 0;
      for (int k = 1; k < 4; k++) {
        if (g21[kHetIns[k]] > g21[kHetIns[het_ins_arg]]) het_ins_arg = k;
        if (g21[kHetDel[k]] > g21[kHetDel[het_del_arg]]) het_del_arg = k;
      }

      auto base_sup = [&](int b) {
        // float32 left-to-right like the Python base_support
        return (double)(xi[center * 32 + b * 4 + 3]
                        + xi[center * 32 + (b + 4) * 4 + 3]
                        + xi[center * 32 + b * 4 + 0]
                        + xi[center * 32 + (b + 4) * 4 + 0]);
      };

      char ref_buf[24];
      char alt_buf[72];
      const char* genotype = nullptr;
      int gcode = 0, geno_idx = 2;
      double supported = 0.0, extra = 0.0;
      bool is_multi = false, homo_indel = false, give_up = false;

      auto set_ref_span = [&](int L) {  // refc + seq[17 .. 17+L)
        ref_buf[0] = refc;
        memcpy(ref_buf + 1, seq + 17, (size_t)L);
        ref_buf[1 + L] = 0;
      };

      switch (winner) {
        case 3: {  // homo ins
          int arg = 0;
          for (int j = 1; j < 16; j++)
            if (pv1(j) * pv2(j) > pv1(arg) * pv2(arg)) arg = j;
          int L = arg + 1;
          if (L >= 16) { give_up = true; break; }
          ins_str(L);
          ref_buf[0] = refc; ref_buf[1] = 0;
          alt_buf[0] = refc;
          memcpy(alt_buf + 1, insb, (size_t)L + 1);
          supported = ins_sup;
          genotype = "1/1"; geno_idx = 1; homo_indel = true;
          gcode = kInsIns;
          break;
        }
        case 4: {  // het ACGT + ins
          int arg = 0;
          double bestj = std::max(z1 * pv2(0), pv1(0) * z2);
          for (int j = 1; j < 16; j++) {
            double v = std::max(z1 * pv2(j), pv1(j) * z2);
            if (v > bestj) { bestj = v; arg = j; }
          }
          int L = arg + 1;
          if (L >= 16) { give_up = true; break; }
          ins_str(L);
          char het_base = "ACGT"[het_ins_arg];
          ref_buf[0] = refc; ref_buf[1] = 0;
          supported = ins_sup;
          if (het_base != refc) {
            extra = base_sup(het_ins_arg);
            alt_buf[0] = het_base; alt_buf[1] = ','; alt_buf[2] = refc;
            memcpy(alt_buf + 3, insb, (size_t)L + 1);
            genotype = "1/2"; is_multi = true;
            gcode = kHetIns[het_ins_arg];
          } else {
            alt_buf[0] = refc;
            memcpy(alt_buf + 1, insb, (size_t)L + 1);
            genotype = "0/1";
            gcode = kHetIns[base_index(refc)];
          }
          break;
        }
        case 5: {  // het ins+ins (no recovery source: prefix allele)
          int ai = 0, aj = 0;
          double bestp = -1.0;
          for (int ii = 0; ii < 16; ii++)
            for (int jj = 0; jj < 16; jj++) {
              double v = pv1(ii) * pv2(jj);
              if (v > bestp) { bestp = v; ai = ii; aj = jj; }
            }
          int vls = std::min(ai, aj) + 1, vll = std::max(ai, aj) + 1;
          if (vll >= 16) { give_up = true; break; }
          ins_str(vll);
          // alt1 = refc + bases[:vls], alt2 = refc + bases; identical
          // alleles retry through the Python lattice (ref call_var.py:838)
          if (vls == vll) { give_up = true; break; }
          ref_buf[0] = refc; ref_buf[1] = 0;
          alt_buf[0] = refc;
          memcpy(alt_buf + 1, insb, (size_t)vls);
          alt_buf[1 + vls] = ',';
          alt_buf[2 + vls] = refc;
          memcpy(alt_buf + 3 + vls, insb, (size_t)vll + 1);
          supported = ins_sup;
          genotype = "1/2"; is_multi = true;
          gcode = kInsIns;
          break;
        }
        case 6: {  // homo del
          int arg = 0;
          for (int j = 1; j < 16; j++)
            if (nv1(j) * nv2(j) > nv1(arg) * nv2(arg)) arg = j;
          int L = arg + 1;
          if (L >= 16) { give_up = true; break; }
          set_ref_span(L);
          alt_buf[0] = ref_buf[0]; alt_buf[1] = 0;
          supported = del_sup;
          genotype = "1/1"; geno_idx = 1; homo_indel = true;
          gcode = kDelDel;
          break;
        }
        case 7: {  // het ACGT + del
          int arg = 0;
          double bestj = std::max(z1 * nv2(0), nv1(0) * z2);
          for (int j = 1; j < 16; j++) {
            double v = std::max(z1 * nv2(j), nv1(j) * z2);
            if (v > bestj) { bestj = v; arg = j; }
          }
          int L = arg + 1;
          if (L >= 16) { give_up = true; break; }
          set_ref_span(L);
          char het_base = "ACGT"[het_del_arg];
          supported = del_sup;
          if (het_base != ref_buf[0]) {
            extra = base_sup(het_del_arg);
            alt_buf[0] = ref_buf[0]; alt_buf[1] = ','; alt_buf[2] = het_base;
            memcpy(alt_buf + 3, ref_buf + 1, (size_t)L + 1);
            genotype = "1/2"; is_multi = true;
            gcode = kHetDel[het_del_arg];
          } else {
            alt_buf[0] = ref_buf[0]; alt_buf[1] = 0;
            genotype = "0/1";
            gcode = kHetDel[base_index(refc)];
          }
          break;
        }
        case 8: {  // het del + del (i != j, row-major first max like numpy)
          int ai = 0, aj = 1;
          double bestp = -2.0;
          for (int ii = 0; ii < 16; ii++)
            for (int jj = 0; jj < 16; jj++) {
              if (ii == jj) continue;
              double v = nv1(ii) * nv2(jj);
              if (v > bestp) { bestp = v; ai = ii; aj = jj; }
            }
          int vls = std::min(ai, aj) + 1, vll = std::max(ai, aj) + 1;
          if (vll >= 16) { give_up = true; break; }
          set_ref_span(vll);
          // alt1 = ref[0]; alt2 = ref[0] + ref[vls+1:]
          char alt2[24];
          alt2[0] = ref_buf[0];
          int tail = vll - vls;  // strlen(ref_buf) - (vls + 1)
          memcpy(alt2 + 1, ref_buf + vls + 1, (size_t)tail + 1);
          // degenerate allele combinations retry through the Python lattice
          if (alt2[1] == 0 || strcmp(ref_buf, alt2) == 0) {
            give_up = true;
            break;
          }
          alt_buf[0] = ref_buf[0]; alt_buf[1] = ',';
          memcpy(alt_buf + 2, alt2, strlen(alt2) + 1);
          supported = del_sup;
          genotype = "1/2"; is_multi = true;
          gcode = kDelDel;
          break;
        }
        case 9: {  // het ins + del (grid order (i, j, kind) like numpy)
          int ai = 0, aj = 0, kind = 0;
          double bestp = -1.0;
          for (int ii = 0; ii < 16; ii++)
            for (int jj = 0; jj < 16; jj++)
              for (int kk = 0; kk < 2; kk++) {
                double v = kk == 0 ? pv1(ii) * nv2(jj) : nv1(ii) * pv2(jj);
                if (v > bestp) { bestp = v; ai = ii; aj = jj; kind = kk; }
              }
          int vl_ins = (kind == 0 ? ai : aj) + 1;
          int vl_del = (kind == 0 ? aj : ai) + 1;
          if (vl_ins >= 16 || vl_del >= 16) { give_up = true; break; }
          ins_str(vl_ins);
          set_ref_span(vl_del);
          alt_buf[0] = ref_buf[0]; alt_buf[1] = ',';
          alt_buf[2] = ref_buf[0];
          memcpy(alt_buf + 3, insb, (size_t)vl_ins);
          memcpy(alt_buf + 3 + vl_ins, ref_buf + 1, (size_t)vl_del + 1);
          supported = ins_sup + del_sup;
          genotype = "1/2"; is_multi = true;
          gcode = kInsDel;
          break;
        }
        default:
          give_up = true;
      }
      if (give_up) {
        fallback.push_back(i);
        continue;
      }
      if (strcmp(ref_buf, alt_buf) == 0) continue;
      if (haploid_precision && !homo_indel) continue;
      if (haploid_sensitive && is_multi) continue;

      double p = (double)g21[gcode] * (double)gn[geno_idx];
      double tmp = (-10.0 * std::log(std::exp(1.0)) / std::log(10.0))
                   * std::log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 16.0;
      if (tmp < 0) tmp = 0;
      long quality = llrint(tmp * tmp);
      const char* genotype_out = genotype;
      if (haploid_precision || haploid_sensitive) {
        genotype_out = strchr(genotype, '1') ? "1" : "0";
      }
      double af = (supported + extra) / depth;
      if (af > 1.0) af = 1.0;
      emit_row(i, ref_buf, alt_buf, genotype_out, quality, depth, af);
      continue;
    }

    char ref_out[2] = {0, 0};
    char alt_out[4] = {0, 0, 0, 0};
    const char* genotype = nullptr;
    int quality_code, quality_geno;
    double supported = 0.0;
    bool is_multi = false;

    auto base_support = [&](int b) {
      // SNP(3) + reference(0) channels, both strands, at the center row
      return (double)xi[center * 32 + b * 4 + 3] + xi[center * 32 + (b + 4) * 4 + 3]
           + xi[center * 32 + b * 4 + 0] + xi[center * 32 + (b + 4) * 4 + 0];
    };

    if (winner == 0) {
      if (!show_ref) continue;
      ref_out[0] = "ACGT"[ref_idx];
      alt_out[0] = ref_out[0];
      genotype = "0/0";
      quality_code = ref_code;
      quality_geno = 0;
      supported = (double)xi[center * 32 + ref_idx * 4 + 0]
                + xi[center * 32 + (ref_idx + 4) * 4 + 0];
    } else if (winner == 1) {
      char b = kHomoBase[homo_arg];
      ref_out[0] = raw_base;
      alt_out[0] = b;
      if (ref_out[0] == alt_out[0]) continue;  // degenerate, matches Python skip
      genotype = "1/1";
      int bi = base_index(b);
      quality_code = kPairCode[bi][bi];
      quality_geno = 1;
      supported = base_support(bi);
    } else {
      char b1 = kHeteroB1[het_arg], b2 = kHeteroB2[het_arg];
      ref_out[0] = raw_base;
      int raw_idx = base_index(raw_base);  // -1 for U: labels never match
      bool multi = (base_index(b1) != raw_idx) && (base_index(b2) != raw_idx);
      if (multi) {
        alt_out[0] = b1; alt_out[1] = ','; alt_out[2] = b2;
        genotype = "1/2";
        is_multi = true;
        quality_code = kPairCode[base_index(b1)][base_index(b2)];
        supported = base_support(base_index(b1)) + base_support(base_index(b2));
      } else {
        char alt = (base_index(b1) != raw_idx) ? b1 : b2;
        alt_out[0] = alt;
        if (ref_out[0] == alt_out[0]) continue;
        genotype = "0/1";
        quality_code = kPairCode[ref_idx][base_index(alt)];
        supported = base_support(base_index(alt));
      }
      quality_geno = 2;
      if (haploid_precision) continue;   // hetero dropped in precision mode
      if (haploid_sensitive && is_multi) continue;
    }

    // Phred-like quality (decode.py quality_score_from)
    double p = (double)g21[quality_code] * (double)gn[quality_geno];
    double tmp = (-10.0 * std::log(std::exp(1.0)) / std::log(10.0))
                 * std::log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 16.0;
    if (tmp < 0) tmp = 0;
    long quality = llrint(tmp * tmp);

    const char* genotype_out = genotype;
    if (haploid_precision || haploid_sensitive) {
      genotype_out = strchr(genotype, '1') ? "1" : "0";
    }

    double af = supported / depth;
    if (af > 1.0) af = 1.0;
    emit_row(i, ref_out, alt_out, genotype_out, quality, depth, af);
  }
  };  // decode_range

  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > 16) workers = 16;
  if (n < 2048) workers = 1;  // threading overhead not worth it
  std::vector<Shard> shards(workers);
  if (workers == 1) {
    decode_range(0, n, shards[0]);
  } else {
    std::vector<std::thread> threads;
    int64_t per = (n + workers - 1) / workers;
    for (int t = 0; t < workers; t++) {
      int64_t lo = t * per;
      int64_t hi = std::min<int64_t>(lo + per, n);
      if (lo >= hi) break;
      threads.emplace_back([&, lo, hi, t]() { decode_range(lo, hi, shards[t]); });
    }
    for (auto& th : threads) th.join();
  }

  size_t total_rows_bytes = 0, total_rows = 0, total_fallback = 0;
  for (auto& s : shards) {
    total_rows_bytes += s.rows.size();
    total_rows += s.row_sites.size();
    total_fallback += s.fallback.size();
  }
  *rows_out = (char*)malloc(total_rows_bytes + 1);
  *row_sites_out = (int64_t*)malloc(total_rows * sizeof(int64_t));
  *fallback_out = (int64_t*)malloc(total_fallback * sizeof(int64_t));
  size_t rb = 0, rs = 0, fb = 0;
  for (auto& s : shards) {
    memcpy(*rows_out + rb, s.rows.data(), s.rows.size());
    rb += s.rows.size();
    if (!s.row_sites.empty()) {
      memcpy(*row_sites_out + rs, s.row_sites.data(),
             s.row_sites.size() * sizeof(int64_t));
      rs += s.row_sites.size();
    }
    if (!s.fallback.empty()) {
      memcpy(*fallback_out + fb, s.fallback.data(),
             s.fallback.size() * sizeof(int64_t));
      fb += s.fallback.size();
    }
  }
  (*rows_out)[total_rows_bytes] = 0;
  *rows_len = (int64_t)total_rows_bytes;
  *n_rows_out = (int64_t)total_rows;
  *n_fallback_out = (int64_t)total_fallback;
  return 0;
}

// Dense-stride compatibility entry (the pre-stride ABI).
int clair_decode_fast(
    const float* x, const float* gt21, const float* geno,
    const float* vl1, const float* vl2,
    const int64_t* positions, const char* center_bases,
    const char* sequences, int64_t n, const char* contig,
    int32_t has_insertion_source,
    int32_t show_ref, int32_t haploid_precision, int32_t haploid_sensitive,
    int32_t qual_cutoff, int32_t n_threads,
    char** rows_out, int64_t* rows_len,
    int64_t** row_sites_out, int64_t* n_rows_out,
    int64_t** fallback_out, int64_t* n_fallback_out) {
  return clair_decode_fast2(
      x, gt21, geno, vl1, vl2, 21, 3, 33, 33,
      positions, center_bases, sequences, n, contig, has_insertion_source,
      show_ref, haploid_precision, haploid_sensitive, qual_cutoff, n_threads,
      rows_out, rows_len, row_sites_out, n_rows_out,
      fallback_out, n_fallback_out);
}

void clair_decode_free(char* rows, int64_t* row_sites, int64_t* fallback) {
  free(rows);
  free(row_sites);
  free(fallback);
}

}  // extern "C"
