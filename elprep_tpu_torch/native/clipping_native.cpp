// Native read-clipping engine: columnar port of the per-read clipping
// chain in elprep_tpu/filters/clipping.py (itself a transliteration of
// the reference's filters/utils.go:81-627). The Python module remains
// the oracle; tests/test_clipping_native.py fuzzes both against each
// other. Semantics must match clipping.py EXACTLY — any change lands in
// both.
//
// The engine never moves sequence bytes: clipping narrows a
// [base_start, base_start+base_len) window over the original read and
// rewrites the CIGAR, matching ClipRead.base_start bookkeeping.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t MULTIPLE = 0x1;
constexpr int32_t UNMAPPED = 0x4;
constexpr int32_t NEXT_UNMAPPED = 0x8;
constexpr int32_t REVERSED = 0x10;
constexpr int32_t NEXT_REVERSED = 0x20;

struct CigOp {
  int64_t len;
  char op;
};

struct Rd {
  int32_t flag;
  int64_t pos;
  int64_t pnext;
  int64_t tlen;
  int32_t mapq;
  std::vector<CigOp> cig;
  const uint8_t* qual0;  // original qual bytes
  int64_t bstart;        // window start within the original read
  int64_t blen;          // window length (== len(seq) == len(qual))
  bool rname_star;       // rname in ("", "*")
  bool rnext_star;
  bool err;
};

inline bool read_consumes(char op) {
  return op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X';
}
inline bool ref_consumes(char op) {
  return op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X';
}

int64_t read_length_from_cigar(const std::vector<CigOp>& c) {
  int64_t s = 0;
  for (const auto& e : c)
    if (read_consumes(e.op)) s += e.len;
  return s;
}

int64_t reference_length_from_cigar(const std::vector<CigOp>& c) {
  int64_t s = 0;
  for (const auto& e : c)
    if (ref_consumes(e.op)) s += e.len;
  return s;
}

inline int64_t read_end(const Rd& r) {
  return r.pos + reference_length_from_cigar(r.cig) - 1;
}

inline bool is_strict_unmapped(const Rd& r) {
  return (r.flag & UNMAPPED) != 0 || r.rname_star || r.pos == 0;
}
inline bool is_strict_next_unmapped(const Rd& r) {
  return (r.flag & NEXT_UNMAPPED) != 0 || r.rnext_star || r.pnext == 0;
}

// (clipping.py:83-96)
bool has_well_defined_fragment_size(const Rd& r, int64_t* aln_end_out) {
  *aln_end_out = -1;
  if (r.tlen != 0 && (r.flag & MULTIPLE) && !is_strict_unmapped(r) &&
      !is_strict_next_unmapped(r) &&
      (((r.flag & REVERSED) != 0) != ((r.flag & NEXT_REVERSED) != 0))) {
    if (r.flag & REVERSED) {
      int64_t aln_end = read_end(r);
      *aln_end_out = aln_end;
      return aln_end > r.pnext;
    }
    return r.pos <= r.pnext + r.tlen;
  }
  return false;
}

// (clipping.py:99-108)
bool compute_adaptor_boundary(const Rd& r, int64_t* boundary, int64_t* aln_end) {
  bool well = has_well_defined_fragment_size(r, aln_end);
  if (well) {
    if (r.flag & REVERSED)
      *boundary = r.pnext - 1;
    else
      *boundary = r.pos + (r.tlen < 0 ? -r.tlen : r.tlen);
    return true;
  }
  *boundary = -1;
  *aln_end = -1;
  return false;
}

// (clipping.py:111-117)
bool is_inside_read(const Rd& r, int64_t aln_end, int64_t ref_coord) {
  if (ref_coord >= r.pos) {
    if (aln_end < 0) aln_end = read_end(r);
    return ref_coord <= aln_end;
  }
  return false;
}

// (clipping.py:120-128)
bool read_starts_with_insertion(const std::vector<CigOp>& c, int64_t* first_len) {
  for (const auto& e : c) {
    if (e.op == 'I') {
      *first_len = e.len;
      return true;
    }
    if (e.op == 'H' || e.op == 'S') continue;
    *first_len = -1;
    return false;
  }
  *first_len = -1;
  return false;
}

// (clipping.py:131-139)
int64_t soft_start(const Rd& r) {
  int64_t start = r.pos;
  for (const auto& e : r.cig) {
    if (e.op == 'S')
      start -= e.len;
    else if (e.op != 'H')
      break;
  }
  return start;
}

// (clipping.py:142-151)
int64_t soft_end(const Rd& r) {
  int64_t end = read_end(r);
  int64_t se = end;
  for (auto it = r.cig.rbegin(); it != r.cig.rend(); ++it) {
    if (it->op == 'S')
      se += it->len;
    else if (it->op != 'H')
      return se;
  }
  return end;
}

// (clipping.py:154-205)
bool compute_read_coordinate_for_reference_coordinate(
    const std::vector<CigOp>& cigar, int64_t soft_start_, int64_t ref_index,
    int64_t* read_bases_out, bool* falls_out) {
  int64_t goal = ref_index - soft_start_;
  *read_bases_out = -1;
  *falls_out = false;
  if (goal < 0) return false;
  int64_t read_bases = 0;
  int64_t ref_bases = 0;
  bool falls_inside = false;
  bool ends_just_before = false;
  bool falls_inside_or_just_before = false;
  size_t index = 0;
  size_t n = cigar.size();
  while (ref_bases != goal && index < n) {
    int64_t length = cigar[index].len;
    char op = cigar[index].op;
    index++;
    int64_t shift = 0;
    if (ref_consumes(op) || op == 'S') {
      if (ref_bases + length < goal)
        shift = length;
      else
        shift = goal - ref_bases;
      ref_bases += shift;
    }
    if (ref_bases != goal) {
      read_bases += read_consumes(op) ? length : 0;
    } else {
      if (shift >= length && index == n) return false;
      char next_op = 0;
      bool have_next = false;
      if (shift < length) {
        falls_inside = (op == 'D' || op == 'N');
      } else {
        int64_t next_len = cigar[index].len;
        next_op = cigar[index].op;
        have_next = true;
        index++;
        if (next_op == 'I') {
          read_bases += next_len;
          if (index == n) return false;
          next_op = cigar[index].op;
          index++;
        }
        ends_just_before = (next_op == 'D' || next_op == 'N');
      }
      falls_inside_or_just_before = ends_just_before || falls_inside;
      if (!falls_inside_or_just_before) {
        read_bases += read_consumes(op) ? shift : 0;
      } else if (ends_just_before) {
        read_bases += read_consumes(op) ? (shift - 1) : 0;
      } else if (falls_inside ||
                 (ends_just_before && have_next &&
                  (next_op == 'D' || next_op == 'N'))) {
        read_bases -= 1;
      }
    }
  }
  if (ref_bases != goal) return false;
  *read_bases_out = read_bases;
  *falls_out = falls_inside_or_just_before;
  return true;
}

constexpr int LEFT = 0;
constexpr int RIGHT = 1;

// (clipping.py:212-227)
bool get_read_coordinate_for_reference_coordinate(
    const std::vector<CigOp>& cigar, int64_t soft_start_, int64_t ref_index,
    int tail, int64_t* read_bases_out) {
  int64_t read_bases;
  bool falls;
  bool ok = compute_read_coordinate_for_reference_coordinate(
      cigar, soft_start_, ref_index, &read_bases, &falls);
  if (!ok || read_bases == -1) {
    *read_bases_out = -1;
    return false;
  }
  if (tail == RIGHT && falls) read_bases += 1;
  if (tail == LEFT && read_bases == 0) {
    int64_t first_len;
    if (read_starts_with_insertion(cigar, &first_len)) {
      int64_t rl = read_length_from_cigar(cigar) - 1;
      read_bases = first_len < rl ? first_len : rl;
    }
  }
  *read_bases_out = read_bases;
  return true;
}

// (clipping.py:230-240)
int64_t calculate_hard_soft_offset(const std::vector<CigOp>& cigar) {
  int64_t size = 0;
  size_t i = 0;
  while (i < cigar.size() && cigar[i].op == 'H') {
    size += cigar[i].len;
    i++;
  }
  while (i < cigar.size() && cigar[i].op == 'S') {
    size += cigar[i].len;
    i++;
  }
  return size;
}

int64_t calculate_aln_start_shift(const std::vector<CigOp>& cigar,
                                  const std::vector<CigOp>& clipped) {
  return calculate_hard_soft_offset(clipped) - calculate_hard_soft_offset(cigar);
}

// (clipping.py:247-255)
int64_t hard_clipping_shift(char op, int64_t op_ref_len, int64_t cigar_length) {
  if (op == 'I') return -cigar_length;
  if (op == 'D' || op == 'N') return op_ref_len;
  return 0;
}

// (clipping.py:258-274)
std::vector<CigOp> clean_hard_clipped_cigar(std::vector<CigOp> cigar) {
  int64_t total = 0;
  size_t index = 0;
  while (index < cigar.size() &&
         (cigar[index].op == 'H' || cigar[index].op == 'D' ||
          cigar[index].op == 'N')) {
    total += cigar[index].len;
    index++;
  }
  if (index > 0) {
    std::vector<CigOp> out;
    out.push_back({total, 'H'});
    out.insert(out.end(), cigar.begin() + index, cigar.end());
    cigar = std::move(out);
  }
  total = 0;
  int64_t last = (int64_t)cigar.size() - 1;
  while (last >= 0 &&
         (cigar[last].op == 'H' || cigar[last].op == 'D' ||
          cigar[last].op == 'N')) {
    total += cigar[last].len;
    last--;
  }
  if (last < (int64_t)cigar.size() - 1) {
    cigar.resize(last + 1);
    cigar.push_back({total, 'H'});
  }
  return cigar;
}

// (clipping.py:277-327)
std::vector<CigOp> hard_clip_cigar(const Rd& r, int64_t start, int64_t stop) {
  const std::vector<CigOp>& cigar = r.cig;
  int64_t index = 0;
  int64_t total_hard_clip = stop - start + 1;
  int64_t shift = 0;
  std::vector<CigOp> new_cigar;
  if (start == 0) {
    size_t k = 0;
    while (k < cigar.size() && cigar[k].op == 'H') {
      total_hard_clip += cigar[k].len;
      k++;
    }
    while (index <= stop && k < cigar.size()) {
      int64_t length = cigar[k].len;
      char op = cigar[k].op;
      k++;
      int64_t consumed = read_consumes(op) ? length : 0;
      if (index + consumed == stop + 1) {
        shift += hard_clipping_shift(op, length, length);
        new_cigar.push_back({total_hard_clip + shift, 'H'});
      } else if (index + consumed > stop + 1) {
        int64_t length_after = length - (stop - index + 1);
        shift += hard_clipping_shift(op, length, stop - index + 1);
        new_cigar.push_back({total_hard_clip + shift, 'H'});
        new_cigar.push_back({length_after, op});
      }
      index += consumed;
      shift += hard_clipping_shift(op, length, consumed);
    }
    new_cigar.insert(new_cigar.end(), cigar.begin() + k, cigar.end());
  } else {
    size_t k = 0;
    while (index < start && k < cigar.size()) {
      int64_t length = cigar[k].len;
      char op = cigar[k].op;
      k++;
      int64_t consumed = read_consumes(op) ? length : 0;
      if (index + consumed < start) {
        new_cigar.push_back({length, op});
      } else {
        int64_t length_after = start - index;
        shift += hard_clipping_shift(op, length, length - (start - index));
        if (op == 'H')
          total_hard_clip += length_after;
        else
          new_cigar.push_back({length_after, op});
      }
      index += consumed;
    }
    while (k < cigar.size()) {
      int64_t length = cigar[k].len;
      char op = cigar[k].op;
      k++;
      shift += hard_clipping_shift(op, length, length);
      if (op == 'H') total_hard_clip += length;
    }
    new_cigar.push_back({total_hard_clip + shift, 'H'});
  }
  return clean_hard_clipped_cigar(std::move(new_cigar));
}

// (clipping.py:330-344)
void hard_clip(Rd& r, int64_t start, int64_t stop) {
  std::vector<CigOp> clipped = hard_clip_cigar(r, start, stop);
  int64_t read_length = r.blen;
  int64_t new_length = read_length - (stop - start + 1);
  int64_t copy_start = 0;
  if (start == 0) copy_start = stop + 1;
  std::vector<CigOp> old = std::move(r.cig);
  // window slice clamps like Python slicing (never negative length)
  if (copy_start > read_length) copy_start = read_length;
  if (new_length < 0) new_length = 0;
  if (copy_start + new_length > read_length) new_length = read_length - copy_start;
  r.bstart += copy_start;
  r.blen = new_length;
  r.cig = std::move(clipped);
  if (start == 0) {
    // evaluate strict-unmapped BEFORE the pos shift, like the oracle
    if (!((r.flag & UNMAPPED) != 0 || r.rname_star || r.pos == 0))
      r.pos += calculate_aln_start_shift(old, r.cig);
  }
}

// (clipping.py:347-354)
bool hard_clip_left_tail(Rd& r, int64_t ref_stop) {
  int64_t stop;
  if (!get_read_coordinate_for_reference_coordinate(r.cig, soft_start(r),
                                                    ref_stop, LEFT, &stop)) {
    r.err = true;
    return false;
  }
  hard_clip(r, 0, stop);
  return true;
}

// (clipping.py:357-365)
bool hard_clip_right_tail(Rd& r, int64_t ref_start) {
  int64_t start;
  bool ok = get_read_coordinate_for_reference_coordinate(
      r.cig, soft_start(r), ref_start, RIGHT, &start);
  int64_t stop = r.blen - 1;
  if (!ok) {
    r.err = true;
    return false;
  }
  hard_clip(r, start, stop);
  return true;
}

// (clipping.py:368-375)
void hard_clip_adaptor_sequence(Rd& r) {
  int64_t boundary, aln_end;
  bool ok = compute_adaptor_boundary(r, &boundary, &aln_end);
  if (ok && is_inside_read(r, aln_end, boundary)) {
    if (r.flag & REVERSED)
      hard_clip_left_tail(r, boundary);
    else
      hard_clip_right_tail(r, boundary);
  }
}

// (clipping.py:378-398)
void hard_clip_soft_clipped_bases(Rd& r) {
  int64_t read_index = 0;
  int64_t cut_left = -1;
  int64_t cut_right = -1;
  bool right_tail = false;
  for (const auto& e : r.cig) {
    if (e.op == 'S') {
      if (right_tail)
        cut_right = read_index;
      else
        cut_left = read_index + e.len - 1;
    } else if (e.op == 'H') {
    } else {
      right_tail = true;
    }
    read_index += read_consumes(e.op) ? e.len : 0;
  }
  if (cut_right >= 0) hard_clip(r, cut_right, r.blen - 1);
  if (cut_left >= 0) hard_clip(r, 0, cut_left);
}

// (clipping.py:401-408)
void empty_read(Rd& r) {
  r.flag |= UNMAPPED;
  r.mapq = 0;
  r.cig.clear();
  r.blen = 0;
}

// (clipping.py:411-425)
void hard_clip_low_qual_ends(Rd& r, int64_t low_qual) {
  int64_t length = r.blen;
  int64_t left = 0, right = length - 1;
  const uint8_t* q = r.qual0 + r.bstart;
  while (right >= 0 && q[right] <= low_qual) right--;
  while (left < length && q[left] <= low_qual) left++;
  if (left > right) {
    empty_read(r);
    return;
  }
  if (right < length - 1) hard_clip(r, right + 1, length - 1);
  if (left > 0) hard_clip(r, 0, left - 1);
}

// (clipping.py:428-450)
void revert_soft_clipped_bases(Rd& r) {
  std::vector<CigOp> unclipped;
  int64_t matches = 0;
  for (const auto& e : r.cig) {
    if (e.op == 'S' || e.op == 'M') {
      matches += e.len;
    } else {
      if (matches > 0) {
        unclipped.push_back({matches, 'M'});
        matches = 0;
      }
      unclipped.push_back(e);
    }
  }
  if (matches > 0) unclipped.push_back({matches, 'M'});
  int64_t new_start = r.pos + calculate_aln_start_shift(r.cig, unclipped);
  r.cig = std::move(unclipped);
  if (new_start <= 0) {
    r.pos = 1;
    hard_clip(r, 0, -new_start);
    if (!is_strict_unmapped(r)) r.pos = 1;
  } else {
    r.pos = new_start;
  }
}

// (clipping.py:453-468)
void hard_clip_to_region(Rd& r, int64_t start, int64_t stop) {
  if (r.blen == 0 || start - 1 == stop + 1) {
    empty_read(r);
    return;
  }
  int64_t aln_start = r.pos;
  int64_t aln_stop = read_end(r);
  if (aln_start <= stop && aln_stop >= start) {
    if (aln_stop > stop) {
      if (!hard_clip_right_tail(r, stop + 1)) return;
      if (aln_start < start && start - 1 > read_end(r)) {
        empty_read(r);
        return;
      }
    }
    if (aln_start < start) {
      if (!hard_clip_left_tail(r, start - 1)) return;
    }
  } else {
    empty_read(r);
  }
}

}  // namespace

extern "C" {

// Mode bits for clip_reads_columnar.
enum {
  CLIP_LOWQ_ENDS = 1,       // hard_clip_low_qual_ends(lowq)
  CLIP_SOFT_OR_REVERT = 2,  // finalize rule: revert if well-defined else clip
  CLIP_SOFTCLIP = 4,        // hard_clip_soft_clipped_bases unconditionally
  CLIP_ADAPTOR = 8,         // hard_clip_adaptor_sequence (gated in BQSR/finalize)
  CLIP_ADAPTOR_IF_MAPPED = 16,  // finalize gate: only if not strict-unmapped
  CLIP_TO_REGION = 32,      // hard_clip_to_region(region_start, region_end)
};

// Batched clipping over columnar reads. Per-row outputs land at
// out_cig_base[i] = cig_off[i] + 8*i (8 ops of slack per row);
// out_n_ops[i] gives the actual count. flag/pos/mapq arrays are
// mutated in place (callers pass copies). Returns the number of rows
// flagged with a coordinate-mapping error (Python raises in that case,
// mirroring the oracle's ValueError).
int64_t clip_reads_columnar(
    int64_t n, int32_t* flag, int64_t* pos, const int64_t* pnext,
    const int64_t* tlen, int32_t* mapq, const int64_t* cig_off,
    const int32_t* cig_len_in, const uint8_t* cig_op_in, const uint8_t* qual,
    const int64_t* qual_off, const uint8_t* rname_star,
    const uint8_t* rnext_star, int32_t modes, int64_t lowq,
    int64_t region_start, int64_t region_end, int32_t* out_n_ops,
    int32_t* out_cig_len, uint8_t* out_cig_op, int64_t* out_bstart,
    int64_t* out_blen, uint8_t* out_err, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> errors(0);
  const int64_t CHUNK = 1024;
  auto worker = [&]() {
    Rd r;
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n) return;
      int64_t i1 = i0 + CHUNK < n ? i0 + CHUNK : n;
      for (int64_t i = i0; i < i1; i++) {
        r.flag = flag[i];
        r.pos = pos[i];
        r.pnext = pnext[i];
        r.tlen = tlen[i];
        r.mapq = mapq[i];
        r.qual0 = qual + qual_off[i];
        r.bstart = 0;
        r.blen = qual_off[i + 1] - qual_off[i];
        r.rname_star = rname_star[i] != 0;
        r.rnext_star = rnext_star[i] != 0;
        r.err = false;
        int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
        r.cig.clear();
        for (int64_t c = c0; c < c1; c++)
          r.cig.push_back({(int64_t)cig_len_in[c], (char)cig_op_in[c]});

        if (modes & CLIP_LOWQ_ENDS) hard_clip_low_qual_ends(r, lowq);
        if (!r.err && r.blen > 0 && (modes & CLIP_SOFT_OR_REVERT)) {
          int64_t aln_end;
          if (has_well_defined_fragment_size(r, &aln_end))
            revert_soft_clipped_bases(r);
          else
            hard_clip_soft_clipped_bases(r);
        } else if (!r.err && (modes & CLIP_SOFT_OR_REVERT) && r.blen == 0) {
          // emptied read: the oracle still runs the (no-op) soft-clip
          // step on the empty cigar; both branches are no-ops here
        }
        if (!r.err && (modes & CLIP_SOFTCLIP)) hard_clip_soft_clipped_bases(r);
        if (!r.err && (modes & CLIP_ADAPTOR)) hard_clip_adaptor_sequence(r);
        if (!r.err && (modes & CLIP_ADAPTOR_IF_MAPPED) &&
            !is_strict_unmapped(r))
          hard_clip_adaptor_sequence(r);
        if (!r.err && (modes & CLIP_TO_REGION))
          hard_clip_to_region(r, region_start, region_end);

        int64_t base = c0 + 8 * i;
        int64_t cap = (c1 - c0) + 8;
        int64_t m = (int64_t)r.cig.size();
        if (m > cap) {  // cannot happen (clips add <= 2 ops per call)
          r.err = true;
          m = cap;
        }
        for (int64_t c = 0; c < m; c++) {
          out_cig_len[base + c] = (int32_t)r.cig[c].len;
          out_cig_op[base + c] = (uint8_t)r.cig[c].op;
        }
        out_n_ops[i] = (int32_t)m;
        out_bstart[i] = r.bstart;
        out_blen[i] = r.blen;
        out_err[i] = r.err ? 1 : 0;
        if (r.err) errors.fetch_add(1);
        flag[i] = r.flag;
        pos[i] = r.pos;
        mapq[i] = r.mapq;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return errors.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native GVCF reference-confidence region engine.
//
// One call runs the whole no-variation region path for a region's reads:
// finalize_assembly_region's region clip + coordinate sort + overlapping
// mate reconciliation (haplotypecaller.go:410-443, haploutils.go:368-430),
// filterNonPassingReads (haploutils.go:437-455), and calculateRefConfidence
// (ref-confidence.go:266-361) — producing the per-position DP/AD/PL/GQ
// columns that hc/refconf.py turns into RefRun GVCF blocks.
//
// hc/refconf.py's calculate_ref_confidence remains the ORACLE
// (tests/test_refconf_native.py fuzzes both against each other;
// ELPREP_TPU_NO_NATIVE_REFCONF=1 forces the Python engine). Float
// accumulation order matches the oracle's np.add.reduceat exactly:
// per-position contributions add in coordinate-sorted read order.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cmath>
#include <unordered_map>

extern "C" void refconf_informative(
    const uint8_t* read_bases, int64_t rb_len, const uint8_t* read_quals,
    int64_t read_start, const uint8_t* ref, int64_t ref_index,
    int64_t padded_end, int64_t read_length, int64_t max_indel,
    const int64_t* base_mask, uint8_t* out);

namespace {

struct RcRead {
  Rd rd;
  const uint8_t* seq0;  // original read seq bytes (window = rd.bstart/blen)
  int32_t qrank;
  uint8_t bad_mate;
  std::vector<uint8_t> local_qual;  // window-relative copy when pair-cleaned
  bool has_local = false;

  const uint8_t* seq() const { return seq0 + rd.bstart; }
  const uint8_t* qual() const {
    return has_local ? local_qual.data() : rd.qual0 + rd.bstart;
  }
  uint8_t* mut_qual() {
    if (!has_local) {
      local_qual.assign(rd.qual0 + rd.bstart, rd.qual0 + rd.bstart + rd.blen);
      has_local = true;
    }
    return local_qual.data();
  }
};

// (activity.py:934-963)
bool rc_clean_overlapping_pair(RcRead* a, RcRead* b) {
  RcRead* r1 = a;
  RcRead* r2 = b;
  int64_t s1 = soft_start(r1->rd);
  int64_t s2 = soft_start(r2->rd);
  if (s1 >= s2) std::swap(r1, r2);
  if (read_end(r1->rd) < r2->rd.pos) return true;
  int64_t read_bases;
  bool falls;
  compute_read_coordinate_for_reference_coordinate(
      r1->rd.cig, soft_start(r1->rd), r2->rd.pos, &read_bases, &falls);
  if (read_bases == -1) return false;  // oracle raises ValueError
  if (falls) read_bases += 1;
  int64_t n_overlap = r1->rd.blen - read_bases;
  if (r2->rd.blen < n_overlap) n_overlap = r2->rd.blen;
  if (n_overlap > 0) {
    const uint8_t* s1b = r1->seq();
    const uint8_t* s2b = r2->seq();
    uint8_t* q1 = r1->mut_qual();
    uint8_t* q2 = r2->mut_qual();
    const uint8_t HALF_PCR = 20;  // HALF_PCR_SNV_ERROR_QUAL
    for (int64_t i2 = 0; i2 < n_overlap; i2++) {
      int64_t i1 = read_bases + i2;
      if (s1b[i1] == s2b[i2]) {
        if (q1[i1] > HALF_PCR) q1[i1] = HALF_PCR;
        if (q2[i2] > HALF_PCR) q2[i2] = HALF_PCR;
      } else {
        q1[i1] = 0;
        q2[i2] = 0;
      }
    }
  }
  return true;
}

// refconf.py:287-303 (_bases_and_quals_one_to_one)
void rc_one_to_one(const RcRead& r, std::vector<uint8_t>& ob,
                   std::vector<uint8_t>& oq) {
  bool has_indel = false;
  for (const auto& e : r.rd.cig)
    if (e.op == 'I' || e.op == 'D') { has_indel = true; break; }
  if (!has_indel) {
    ob.assign(r.seq(), r.seq() + r.rd.blen);
    oq.assign(r.qual(), r.qual() + r.rd.blen);
    return;
  }
  ob.clear();
  oq.clear();
  int64_t pos = 0;
  for (const auto& e : r.rd.cig) {
    if (read_consumes(e.op)) {
      int64_t end = pos + e.len;
      if (ref_consumes(e.op)) {
        ob.insert(ob.end(), r.seq() + pos, r.seq() + end);
        oq.insert(oq.end(), r.qual() + pos, r.qual() + end);
      }
      pos = end;
    } else if (ref_consumes(e.op)) {
      ob.insert(ob.end(), (size_t)e.len, (uint8_t)'-');
      oq.insert(oq.end(), (size_t)e.len, (uint8_t)0);
    }
  }
}

// finalize_assembly_region's columnar core over preclipped block rows:
// region clip + coordinate sort + overlapping-mate reconciliation
// (activity.py:1056-1103; reference haplotypecaller.go:410-443,
// haploutils.go:368-430). Shared by the refconf region engine and the
// standalone finalize export that feeds the assembly engine. Returns
// false when the oracle path would raise (caller falls back to Python).
bool rc_finalize(
    int64_t n_sel, const int64_t* rows, const int32_t* flag,
    const int64_t* pos, const int32_t* pnext, const int32_t* tlen,
    const int32_t* mapq, const int32_t* qrank, const uint8_t* bad_mate,
    const int32_t* cig_n_ops, const int64_t* cig_base,
    const int32_t* cig_len, const uint8_t* cig_op, const uint8_t* seq_data,
    const int64_t* seq_off, const uint8_t* qual_data, const int64_t* qual_off,
    const int64_t* bstart, const int64_t* blen, int64_t padded_start,
    int64_t padded_end, std::vector<RcRead>* out) {
  std::vector<RcRead>& reads = *out;
  reads.clear();
  reads.reserve((size_t)n_sel);
  for (int64_t s = 0; s < n_sel; s++) {
    int64_t i = rows[s];
    RcRead rr;
    Rd& r = rr.rd;
    r.flag = flag[i];
    r.pos = pos[i];
    r.pnext = pnext[i];
    r.tlen = tlen[i];
    r.mapq = mapq[i];
    r.qual0 = qual_data + qual_off[i];
    r.bstart = bstart[i];
    r.blen = blen[i];
    r.rname_star = false;
    r.rnext_star = false;
    r.err = false;
    int64_t b = cig_base[i];
    int64_t m = cig_n_ops[i];
    r.cig.clear();
    for (int64_t c = 0; c < m; c++)
      r.cig.push_back({(int64_t)cig_len[b + c], (char)cig_op[b + c]});
    // finalize's preclip-template skip (activity.py:995-996)
    if (r.blen == 0 || read_length_from_cigar(r.cig) == 0) continue;
    hard_clip_to_region(r, padded_start, padded_end);
    if (r.err) return false;
    // read_overlaps_region (activity.py:254-260)
    if (r.blen == 0) continue;
    int64_t e = read_end(r);
    if (r.pos > e || r.pos > padded_end || e < padded_start) continue;
    rr.seq0 = seq_data + seq_off[i];
    rr.qrank = qrank[i];
    rr.bad_mate = bad_mate[i];
    reads.push_back(std::move(rr));
  }

  // coordinate sort (activity.py:1031-1042)
  std::stable_sort(reads.begin(), reads.end(),
                   [](const RcRead& a, const RcRead& b) {
    if (a.rd.pos != b.rd.pos) return a.rd.pos < b.rd.pos;
    bool ra = (a.rd.flag & REVERSED) != 0, rb = (b.rd.flag & REVERSED) != 0;
    if (ra != rb) return rb;
    if (a.qrank != b.qrank) return a.qrank < b.qrank;
    if (a.rd.flag != b.rd.flag) return a.rd.flag < b.rd.flag;
    if (a.rd.mapq != b.rd.mapq) return a.rd.mapq < b.rd.mapq;
    if (a.rd.pnext != b.rd.pnext) return a.rd.pnext < b.rd.pnext;
    return a.rd.tlen < b.rd.tlen;
  });

  // overlapping-mate reconciliation (activity.py:966-978)
  {
    std::unordered_map<int32_t, size_t> pending;
    for (size_t k = 0; k < reads.size(); k++) {
      Rd& r2 = reads[k].rd;
      if (!(r2.flag & MULTIPLE) || (r2.flag & NEXT_UNMAPPED) ||
          r2.pnext == 0 || r2.pnext > read_end(r2))
        continue;
      auto it = pending.find(reads[k].qrank);
      if (it != pending.end()) {
        size_t j = it->second;
        pending.erase(it);
        if (!rc_clean_overlapping_pair(&reads[j], &reads[k])) return false;
      } else {
        pending[reads[k].qrank] = k;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Standalone columnar finalize for ACTIVE regions: emits the finalized
// reads' (seq, qual) in coordinate-sorted order as concatenated buffers
// + offsets — exactly the assembly engine's input format (assembly_try),
// so active regions assemble without materializing Python read objects.
// Oracle: finalize_assembly_region (activity.py:1056-1103) followed by
// the [(r.seq, r.qual)] comprehension in prepare_region.
// Returns n_kept >= 0, or -1 when the oracle would raise / the output
// capacity is insufficient (caller falls back to the Python path).
int64_t finalize_region_reads(
    int64_t n_sel, const int64_t* rows,
    const int32_t* flag, const int64_t* pos, const int32_t* pnext,
    const int32_t* tlen, const int32_t* mapq, const int32_t* qrank,
    const uint8_t* bad_mate,
    const int32_t* cig_n_ops, const int64_t* cig_base,
    const int32_t* cig_len, const uint8_t* cig_op,
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const int64_t* bstart, const int64_t* blen,
    int64_t padded_start, int64_t padded_end,
    // outputs: concatenated seq + qual (shared offsets), capacity cap
    uint8_t* out_seq, uint8_t* out_qual, int64_t cap, int64_t* out_offs) {
  std::vector<RcRead> reads;
  if (!rc_finalize(n_sel, rows, flag, pos, pnext, tlen, mapq, qrank,
                   bad_mate, cig_n_ops, cig_base, cig_len, cig_op, seq_data,
                   seq_off, qual_data, qual_off, bstart, blen, padded_start,
                   padded_end, &reads))
    return -1;
  int64_t off = 0;
  out_offs[0] = 0;
  for (size_t k = 0; k < reads.size(); k++) {
    const RcRead& r = reads[k];
    if (off + r.rd.blen > cap) return -1;
    std::memcpy(out_seq + off, r.seq(), (size_t)r.rd.blen);
    std::memcpy(out_qual + off, r.qual(), (size_t)r.rd.blen);
    off += r.rd.blen;
    out_offs[k + 1] = off;
  }
  return (int64_t)reads.size();
}

// Returns 0 on success, -1 when the oracle path would raise (caller
// falls back to the Python engine, which raises identically).
// Outputs are length n_pos = high - low (ad_ref, ad_nonref, gq) and
// n_pos*3 (pls, row-major).
int64_t refconf_region_columnar(
    int64_t n_sel, const int64_t* rows,
    // post-preclip per-row columns over the whole block
    const int32_t* flag, const int64_t* pos, const int32_t* pnext,
    const int32_t* tlen, const int32_t* mapq, const int32_t* qrank,
    const uint8_t* bad_mate,
    const int32_t* cig_n_ops, const int64_t* cig_base,
    const int32_t* cig_len, const uint8_t* cig_op,
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const int64_t* bstart, const int64_t* blen,
    // region
    int64_t padded_start, int64_t padded_end, int64_t low, int64_t high,
    const uint8_t* ref, int64_t ref_len,
    // params
    int64_t max_indel, int64_t min_read_len, int64_t min_mapq,
    int64_t max_informative, int64_t max_qual,
    // tables
    const double* qual2prob, const double* jac_table, int64_t jac_n,
    double jac_step, double jac_max_tol, double log10_ploidy,
    double log10_one_third, const double* indel_gq, const int64_t* indel_pls,
    const int64_t* base_mask,
    // outputs
    int64_t* out_ad_ref, int64_t* out_ad_nonref, int64_t* out_pls,
    int64_t* out_gq) {
  const int64_t n_pos = high - low;
  if (n_pos <= 0) return 0;

  // 1-3. finalize: region clip + coordinate sort + overlapping-mate
  // reconciliation (shared helper, also behind finalize_region_reads)
  std::vector<RcRead> reads;
  if (!rc_finalize(n_sel, rows, flag, pos, pnext, tlen, mapq, qrank,
                   bad_mate, cig_n_ops, cig_base, cig_len, cig_op, seq_data,
                   seq_off, qual_data, qual_off, bstart, blen, padded_start,
                   padded_end, &reads))
    return -1;

  // 4. filterNonPassingReads (activity.py:1045-1059)
  {
    size_t w = 0;
    for (size_t k = 0; k < reads.size(); k++) {
      const RcRead& r = reads[k];
      if (r.rd.blen < min_read_len || r.rd.mapq < min_mapq || r.bad_mate)
        continue;
      if (w != k) reads[w] = std::move(reads[k]);
      w++;
    }
    reads.resize(w);
  }

  // 5. calculateRefConfidence core (refconf.py:1069-1204)
  std::vector<double> gl0((size_t)n_pos, 0.0), gl1((size_t)n_pos, 0.0),
      gl2((size_t)n_pos, 0.0);
  std::vector<int64_t> cnt((size_t)n_pos, 0), ad_ref((size_t)n_pos, 0),
      ad_nonref((size_t)n_pos, 0), n_inf((size_t)n_pos, 0);
  std::vector<uint8_t> bits;       // per-read informative bitset
  std::vector<uint8_t> oob, ooq;   // one-to-one scratch

  for (const RcRead& rr : reads) {
    const Rd& r = rr.rd;
    if (r.pos >= high) break;  // reads sorted; expansion stops here
    // adaptor keep rule (refconf.py:747-755)
    int keep_mode = 0;
    int64_t bound = 0;
    if (r.tlen <= 100) {
      int64_t boundary, aln_end;
      if (compute_adaptor_boundary(r, &boundary, &aln_end)) {
        keep_mode = (r.flag & REVERSED) ? 1 : 2;
        bound = boundary;
      }
    }
    const uint8_t* seq = rr.seq();
    const uint8_t* qual = rr.qual();
    const int64_t bl = r.blen;
    bool bits_ready = false;
    int64_t base_index = 0, loc = r.pos, refs_cum = 0;
    const size_t n_ops = r.cig.size();
    for (size_t ci = 0; ci < n_ops; ci++) {
      int64_t length = r.cig[ci].len;
      char op = r.cig[ci].op;
      if (op == 'H' || op == 'P') continue;
      if (op == 'I') { base_index += length; continue; }
      if (op == 'S') { base_index += length; refs_cum += length; continue; }
      int64_t s_ = loc > low ? loc : low;
      int64_t e_ = loc + length < high ? loc + length : high;
      bool next_di = ci + 1 < n_ops &&
                     (r.cig[ci + 1].op == 'D' || r.cig[ci + 1].op == 'I');
      bool is_match = op == 'M' || op == '=' || op == 'X';
      bool is_del = op == 'D';
      for (int64_t p = s_; p < e_; p++) {
        int64_t off = p - loc;
        // adaptor filter
        if (keep_mode == 1 ? !(p > bound) : (keep_mode == 2 && !(p < bound)))
          continue;
        int64_t bi = is_match ? base_index + off
                              : (base_index > 0 ? base_index - 1 : 0);
        int64_t bic = bi < 0 ? 0 : (bi >= bl ? (bl > 0 ? bl - 1 : 0) : bi);
        int64_t base = bl ? (int64_t)seq[bic] : 0;
        int64_t q = bl ? (int64_t)qual[bic] : 0;
        int64_t qual_eff = is_del ? 30 : q;
        int64_t upos = p - low;
        // usable gate (refconf.py:1120)
        if (is_del || qual_eff > 6) {
          int64_t rp1 = p - 1;
          if (rp1 < 0) rp1 = 0;
          if (rp1 >= ref_len) rp1 = ref_len - 1;
          int64_t ref_base = ref[rp1];
          bool is_alt = base != ref_base || is_del;
          int64_t qc = qual_eff < 0 ? 0 : (qual_eff > max_qual ? max_qual
                                                               : qual_eff);
          double ref_lik = qual2prob[qc];
          double nonref_lik = (double)qual_eff / -10.0 + log10_one_third;
          double rl = is_alt ? nonref_lik : ref_lik;
          double nl = is_alt ? ref_lik : nonref_lik;
          double t0 = rl + log10_ploidy;
          double big = rl > nl ? rl : nl;
          double small = rl < nl ? rl : nl;
          double diff = big - small;
          double t1;
          if (std::isinf(small) || diff >= jac_max_tol) {
            t1 = big;
          } else {
            double idx_f = std::rint(diff / jac_step);
            if (!std::isfinite(idx_f)) idx_f = 0.0;
            int64_t jidx = (int64_t)idx_f;
            if (jidx > jac_n - 1) jidx = jac_n - 1;
            t1 = big + jac_table[jidx];
          }
          double t2 = nl + log10_ploidy;
          gl0[upos] += t0;
          gl1[upos] += t1;
          gl2[upos] += t2;
          cnt[upos] += 1;
          if (is_alt) ad_nonref[upos] += 1; else ad_ref[upos] += 1;
        }
        // indel-informative candidates (refconf.py:1159-1186)
        bool cand = !is_del && !(next_di && off == length - 1);
        if (cand) {
          int64_t refs_off = refs_cum + off;
          if (!bits_ready) {
            // first candidate defines the per-read bitset (cache quirk)
            bits.assign((size_t)(bl > 1 ? bl : 1), 0);
            rc_one_to_one(rr, oob, ooq);
            refconf_informative(oob.data(), (int64_t)oob.size(), ooq.data(),
                                refs_off, ref, p - 1, padded_end, bl,
                                max_indel, base_mask, bits.data());
            bits_ready = true;
          }
          if (refs_off < (int64_t)bits.size() && bits[(size_t)refs_off])
            n_inf[upos] += 1;
        }
      }
      loc += length;
      refs_cum += length;
      if (is_match) base_index += length;
    }
  }

  // 6. per-position PL/GQ assembly (refconf.py:1188-1204)
  for (int64_t p = 0; p < n_pos; p++) {
    double denom = (double)cnt[p] * log10_ploidy;
    double g0 = gl0[p] - denom;
    double g1 = gl1[p] - denom;
    double g2 = gl2[p] - denom;
    if (g1 > g0) g1 = g0;
    if (g2 > g0) g2 = g0;
    // gq_log10 (refconf.py:1039-1048)
    double qual = g0 - (g1 > g2 ? g1 : g2);
    double mx = g0 > g1 ? (g0 > g2 ? g0 : g2) : (g1 > g2 ? g1 : g2);
    double nrm0 = std::pow(10.0, g0 - mx);
    double nrm1 = std::pow(10.0, g1 - mx);
    double nrm2 = std::pow(10.0, g2 - mx);
    double total = nrm0 + nrm1 + nrm2;
    double gq_snp = qual < 0.0 ? std::log10(1.0 - nrm0 / total) : -qual;
    int64_t ninf = n_inf[p] < max_informative ? n_inf[p] : max_informative;
    double gq_ind = indel_gq[ninf];
    bool use_indel = gq_ind > gq_snp;
    int64_t pls[3];
    if (use_indel) {
      pls[0] = indel_pls[ninf * 3 + 0];
      pls[1] = indel_pls[ninf * 3 + 1];
      pls[2] = indel_pls[ninf * 3 + 2];
    } else {
      double adjust = mx;
      const double g[3] = {g0, g1, g2};
      for (int k = 0; k < 3; k++) {
        double v = -10.0 * (g[k] - adjust);
        if (v > 2147483647.0) v = 2147483647.0;
        pls[k] = (int64_t)std::floor(v + 0.5);
      }
    }
    int64_t m0 = pls[0] < pls[1] ? (pls[0] < pls[2] ? pls[0] : pls[2])
                                 : (pls[1] < pls[2] ? pls[1] : pls[2]);
    int64_t m2 = pls[0] > pls[1] ? (pls[0] > pls[2] ? pls[0] : pls[2])
                                 : (pls[1] > pls[2] ? pls[1] : pls[2]);
    int64_t m1 = pls[0] + pls[1] + pls[2] - m0 - m2;
    int64_t gq = m1 - m0;
    if (gq > 99) gq = 99;
    out_ad_ref[p] = ad_ref[p];
    out_ad_nonref[p] = ad_nonref[p];
    out_pls[p * 3 + 0] = pls[0];
    out_pls[p * 3 + 1] = pls[1];
    out_pls[p * 3 + 2] = pls[2];
    out_gq[p] = gq;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched isGoodCigar (reference: haploutils.go:36-113; oracle:
// filters/hcprep.py _is_good_cigar — the Python loop remains the oracle,
// exercised via ELPREP_TPU_NO_NATIVE_GOODCIG in tests).
// ---------------------------------------------------------------------------

extern "C" {

void good_cigar_mask(int64_t n, const int64_t* off, const int32_t* lens,
                     const uint8_t* ops, uint8_t* out) {
  auto in = [](char op, const char* set) {
    for (const char* p = set; *p; p++)
      if (*p == op) return true;
    return false;
  };
  for (int64_t i = 0; i < n; i++) {
    int64_t a = off[i], b = off[i + 1];
    int64_t m = b - a;
    out[i] = 0;
    if (m == 0) continue;
    bool zero = false;
    for (int64_t c = a; c < b; c++)
      if (lens[c] == 0) { zero = true; break; }
    if (zero) continue;
    auto op_at = [&](int64_t k) { return (char)ops[a + k]; };
    int64_t index = 0;
    char op = op_at(index);
    if (op == 'H') {
      index++;
      if (index == m) continue;
      if (op_at(index) == 'S') {
        index++;
        if (index == m) continue;
      }
    } else if (op == 'S' || op == 'P') {
      index++;
      if (index == m) continue;
    }
    op = op_at(index);
    bool bad = false;
    if (in(op, "M=XN")) {
      index++;
    } else if (op == 'I') {
      index++;
      if (index < m && in(op_at(index), "IDSH")) continue;
    } else {
      continue;
    }
    bool ret = false, good = false;
    while (index < m) {
      op = op_at(index);
      if (in(op, "M=XN")) {
        index++;
      } else if (op == 'I' || op == 'D') {
        index++;
        if (index < m) {
          if (in(op_at(index), "IDSH")) { bad = true; break; }
        } else if (op == 'D') {
          bad = true;
          break;
        }
      } else if (op == 'P') {
        index++;
        if (index < m) {
          if (in(op_at(index), "PSH")) { bad = true; break; }
        } else {
          bad = true;
          break;
        }
      } else if (op == 'S') {
        index++;
        if (index < m) {
          if (op_at(index) != 'H') { bad = true; break; }
          index++;
          if (index != m) { bad = true; break; }
        }
        // trailing S ok
      } else if (op == 'H') {
        ret = true;
        good = index + 1 == m;
        break;
      } else {
        bad = true;
        break;
      }
    }
    if (ret) {
      out[i] = good ? 1 : 0;
    } else {
      out[i] = bad ? 0 : 1;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native activity model: isActive probability + hq-soft-clip mean per
// position (reference: pileup.go:470-554 with the cursor's element
// semantics; oracle: hc/activity.py compute_activity + expand_elements,
// fuzzed in tests/test_activity_native.py; ELPREP_TPU_NO_NATIVE_ACTIVITY
// forces the Python engine). Per-position float accumulation follows the
// oracle's ordered reduceat (coordinate read order), so results are
// bit-identical.
// ---------------------------------------------------------------------------

extern "C" {

void activity_region_columnar(
    int64_t n_sel, const int64_t* rows,
    const int32_t* flag, const int64_t* pos, const int32_t* pnext,
    const int32_t* tlen,
    const int64_t* cig_off, const int32_t* cig_len, const uint8_t* cig_op,
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const uint8_t* rname_star, const uint8_t* rnext_star,
    int64_t low, int64_t high, const uint8_t* ref, int64_t ref_len,
    int64_t min_base_qual, int64_t hq_sc_threshold, int64_t max_qual,
    const double* qual2prob, const double* jac, int64_t jac_n,
    double jac_step, double jac_max_tol, double log10_ploidy,
    double log10_one_third, double p0, double p1, double p2,
    double acgt0_prior, double stdconf_min10,
    double* out_active, double* out_hq) {
  const int64_t n_pos = high - low;
  if (n_pos <= 0) return;
  for (int64_t i = 0; i < n_pos; i++) out_active[i] = out_hq[i] = 0.0;
  std::vector<double> gl0((size_t)n_pos, 0.0), gl1((size_t)n_pos, 0.0),
      gl2((size_t)n_pos, 0.0), hq_mean((size_t)n_pos, 0.0),
      hq_cnt((size_t)n_pos, 0.0);
  std::vector<int64_t> cnt((size_t)n_pos, 0);
  std::vector<CigOp> cig;

  auto approx2 = [&](double a, double b) {
    double big = a > b ? a : b;
    double small = a < b ? a : b;
    double diff = big - small;
    if (std::isinf(small) || diff >= jac_max_tol) return big;
    double idx_f = std::rint(diff / jac_step);
    if (!std::isfinite(idx_f)) idx_f = 0.0;
    int64_t j = (int64_t)idx_f;
    if (j > jac_n - 1) j = jac_n - 1;
    return big + jac[j];
  };

  for (int64_t s = 0; s < n_sel; s++) {
    int64_t i = rows[s];
    if (pos[i] >= high) break;  // reads in coordinate order
    int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
    int64_t m = c1 - c0;
    cig.clear();
    for (int64_t c = c0; c < c1; c++)
      cig.push_back({(int64_t)cig_len[c], (char)cig_op[c]});
    const uint8_t* seq = seq_data + seq_off[i];
    const uint8_t* qual = qual_data + qual_off[i];
    const int64_t sl = seq_off[i + 1] - seq_off[i];
    const int64_t ql = qual_off[i + 1] - qual_off[i];

    // count_high_quality_soft_clips (pileup.go:33-48)
    int64_t hq = 0;
    {
      int64_t ap = 0;
      for (const auto& e : cig) {
        if (e.op == 'S') {
          for (int64_t k = 0; k < e.len; k++)
            if (qual[ap + k] > hq_sc_threshold) hq++;
          ap += e.len;
        } else if (e.op == 'M' || e.op == 'I' || e.op == '=' || e.op == 'X') {
          ap += e.len;
        }
      }
    }
    // adaptor keep rule (pileup.go:252-278)
    int keep_mode = 0;
    int64_t bound = 0;
    if (tlen[i] <= 100) {
      Rd r;
      r.flag = flag[i];
      r.pos = pos[i];
      r.pnext = pnext[i];
      r.tlen = tlen[i];
      r.mapq = 0;
      r.cig = cig;
      r.qual0 = qual;
      r.bstart = 0;
      r.blen = ql;
      r.rname_star = rname_star[i] != 0;
      r.rnext_star = rnext_star[i] != 0;
      r.err = false;
      int64_t boundary, aln_end;
      if (compute_adaptor_boundary(r, &boundary, &aln_end)) {
        keep_mode = (r.flag & REVERSED) ? 1 : 2;
        bound = boundary;
      }
    }
    // per-op previous/next on-genome (M=XD) op chars
    std::vector<int64_t> prev_g((size_t)m, 0), next_g((size_t)m, 0);
    {
      int64_t g = 0;
      for (int64_t ci = 0; ci < m; ci++) {
        prev_g[(size_t)ci] = g;
        char op = cig[(size_t)ci].op;
        if (op == 'M' || op == '=' || op == 'X' || op == 'D') g = op;
      }
      g = 0;
      for (int64_t ci = m - 1; ci >= 0; ci--) {
        next_g[(size_t)ci] = g;
        char op = cig[(size_t)ci].op;
        if (op == 'M' || op == '=' || op == 'X' || op == 'D') g = op;
      }
    }
    int64_t base_index = 0, loc = pos[i];
    for (int64_t ci = 0; ci < m; ci++) {
      int64_t length = cig[(size_t)ci].len;
      char op = cig[(size_t)ci].op;
      if (op == 'H' || op == 'P') continue;
      if (op == 'I' || op == 'S') { base_index += length; continue; }
      // ref-consuming M=XDN
      int64_t s_ = loc > low ? loc : low;
      int64_t e_ = loc + length < high ? loc + length : high;
      bool is_match = op == 'M' || op == '=' || op == 'X';
      bool is_del = op == 'D';
      bool is_n = op == 'N';
      int64_t pc = ci > 0 ? (int64_t)(uint8_t)cig[(size_t)(ci - 1)].op : 0;
      int64_t nc = ci + 1 < m ? (int64_t)(uint8_t)cig[(size_t)(ci + 1)].op : 0;
      for (int64_t p = s_; p < e_; p++) {
        int64_t off = p - loc;
        if (keep_mode == 1 ? !(p > bound) : (keep_mode == 2 && !(p < bound)))
          continue;
        bool first_of_op = off == 0;
        bool last_of_op = off == length - 1;
        int64_t bi = is_match ? base_index + off : base_index - 1;
        int64_t bq = bi < 0 ? 0 : (bi >= ql ? (ql > 0 ? ql - 1 : 0) : bi);
        int64_t bs = bi < 0 ? 0 : (bi >= sl ? (sl > 0 ? sl - 1 : 0) : bi);
        int64_t q = ql ? (int64_t)qual[bq] : 0;
        int64_t base = sl ? (int64_t)seq[bs] : 0;
        int64_t qual_eff = is_del ? 30 : q;
        if (!(is_del || qual_eff > min_base_qual)) continue;
        int64_t prev_char = first_of_op ? pc : (int64_t)(uint8_t)op;
        int64_t next_char = last_of_op ? nc : (int64_t)(uint8_t)op;
        int64_t prev_gen = is_n ? prev_g[(size_t)ci]
                                : (first_of_op ? prev_g[(size_t)ci]
                                               : (int64_t)(uint8_t)op);
        int64_t next_gen = is_n ? next_g[(size_t)ci]
                                : (last_of_op ? next_g[(size_t)ci]
                                              : (int64_t)(uint8_t)op);
        bool alt_flags = is_del || prev_char == 'I' || prev_char == 'S' ||
                         next_char == 'I' || next_char == 'S' ||
                         prev_gen == 'D' || next_gen == 'D';
        bool next_to_sc = prev_char == 'S' || next_char == 'S';
        int64_t rp1 = p - 1;
        if (rp1 < 0) rp1 = 0;
        if (rp1 >= ref_len) rp1 = ref_len - 1;
        bool alt = alt_flags || base != (int64_t)ref[rp1];
        int64_t qc = qual_eff < 0 ? 0 : (qual_eff > max_qual ? max_qual
                                                             : qual_eff);
        double ref_lik = qual2prob[qc];
        double nonref_lik = (double)qual_eff / -10.0 + log10_one_third;
        double rl = alt ? nonref_lik : ref_lik;
        double nl = alt ? ref_lik : nonref_lik;
        int64_t upos = p - low;
        gl0[upos] += rl + log10_ploidy;
        gl1[upos] += approx2(rl, nl);
        gl2[upos] += nl + log10_ploidy;
        cnt[upos] += 1;
        if (alt && next_to_sc) {
          hq_cnt[upos] += 1.0;
          hq_mean[upos] += ((double)hq - hq_mean[upos]) / hq_cnt[upos];
        }
      }
      loc += length;
      if (is_match) base_index += length;
    }
  }

  const double INT32MAX = 2147483647.0;
  for (int64_t p = 0; p < n_pos; p++) {
    if (!cnt[p]) continue;
    double denom = (double)cnt[p] * log10_ploidy;
    double g[3] = {gl0[p] - denom, gl1[p] - denom, gl2[p] - denom};
    double adjust = g[0] > g[1] ? (g[0] > g[2] ? g[0] : g[2])
                                : (g[1] > g[2] ? g[1] : g[2]);
    for (int k = 0; k < 3; k++) {
      double adjusted = -10.0 * (g[k] - adjust);
      g[k] = adjusted > INT32MAX ? INT32MAX / -10.0
                                 : std::floor(adjusted + 0.5) / -10.0;
    }
    double post0 = g[0] + p0;
    bool trigger = (p1 + g[1] > post0) || (p2 + g[2] > post0);
    double gt0_lik = approx2(g[1], g[2]);
    double gt0_post = gt0_lik + acgt0_prior;
    double norm_const = approx2(post0, gt0_post);
    double norm0 = post0 - norm_const;
    double prob = norm0 < stdconf_min10 ? 1.0 - std::pow(10.0, norm0) : 0.0;
    out_active[p] = trigger ? prob : 0.0;
    out_hq[p] = hq_mean[p];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BQSR known-sites skip masks (reference: bqsr.go:389-414; oracle: the
// per-read Python loop in filters/bqsr.py _prep_recal_native). For each
// candidate read, intersect its [soft_start, soft_end] with the
// contig's sorted known-site intervals and mark the covered read
// coordinates in the row-major skip[m, L] byte mask. Candidate rows are
// disjoint, so rows parallelize freely.
// ---------------------------------------------------------------------------

extern "C" {

void bqsr_skip_sites(
    int64_t n_cand, const int64_t* cand,
    const int64_t* pos,       // [n_real] post-clip POS
    const int64_t* cig_base,  // [n_real] op offset into lens/ops
    const int64_t* n_ops,     // [n_real]
    const int32_t* lens, const uint8_t* ops,
    const int64_t* blen,                     // [n_real]
    const int64_t* sites, int64_t n_sites,   // flat (start,end), sorted
    uint8_t* skip, int64_t L,                // row-major [m, L]
    int64_t n_threads) {
  if (n_cand <= 0 || n_sites <= 0) return;
  auto run = [&](int64_t c0, int64_t c1) {
    Rd r{};
    for (int64_t c = c0; c < c1; c++) {
      int64_t k = cand[c];
      int64_t b = cig_base[k], m = n_ops[k];
      r.pos = pos[k];
      r.cig.clear();
      for (int64_t i = 0; i < m; i++)
        r.cig.push_back({(int64_t)lens[b + i], (char)ops[b + i]});
      int64_t ss = soft_start(r);
      int64_t se = soft_end(r);
      // intervals.intersect: lo = first site with end >= ss,
      // hi = first site with start > se (intervals.py:69-75)
      int64_t lo = 0, hi = n_sites;
      {
        int64_t a = 0, z = n_sites;
        while (a < z) {
          int64_t mid = (a + z) >> 1;
          if (sites[2 * mid + 1] < ss) a = mid + 1; else z = mid;
        }
        lo = a;
      }
      {
        int64_t a = lo, z = n_sites;
        while (a < z) {
          int64_t mid = (a + z) >> 1;
          if (sites[2 * mid] <= se) a = mid + 1; else z = mid;
        }
        hi = a;
      }
      int64_t sl = blen[k];
      for (int64_t i = lo; i < hi; i++) {
        int64_t fs, fe;
        bool ok = get_read_coordinate_for_reference_coordinate(
            r.cig, ss, sites[2 * i], LEFT, &fs);
        if (!ok || fs < 0) fs = 0;
        ok = get_read_coordinate_for_reference_coordinate(
            r.cig, ss, sites[2 * i + 1], LEFT, &fe);
        if (!ok || fe > sl - 1) fe = sl - 1;
        if (fe >= fs && fs < L) {
          int64_t e2 = fe < L - 1 ? fe : L - 1;
          memset(skip + k * L + fs, 1, (size_t)(e2 - fs + 1));
        }
      }
    }
  };
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (nt > n_cand) nt = n_cand;
  if (nt <= 1) {
    run(0, n_cand);
    return;
  }
  std::vector<std::thread> ths;
  int64_t chunk = (n_cand + nt - 1) / nt;
  for (int64_t t = 0; t < nt; t++) {
    int64_t c0 = t * chunk, c1 = c0 + chunk < n_cand ? c0 + chunk : n_cand;
    if (c0 >= c1) break;
    ths.emplace_back(run, c0, c1);
  }
  for (auto& th : ths) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched no-variation reference model: one call per worker prep task
// instead of one per region. Row selection (hc/parallel._slice_rows:
// positions/ends binary search + overlap filter) moves in here too, so
// the per-region Python/ctypes glue disappears. Each region writes its
// slice of the concatenated outputs at out_off[r]; out_rc[r] is the
// per-region refconf_region_columnar return code.
// ---------------------------------------------------------------------------

extern "C" {

void refconf_regions_batch(
    int64_t n_regions,
    const int64_t* r_padded_start, const int64_t* r_padded_end,
    const int64_t* r_low, const int64_t* r_high,
    const int64_t* out_off,
    // block row-selection arrays (coordinate order)
    const int64_t* positions, const int64_t* ends, int64_t n_block,
    int64_t max_ref_len,
    // post-preclip per-row columns over the whole block
    const int32_t* flag, const int64_t* pos, const int32_t* pnext,
    const int32_t* tlen, const int32_t* mapq, const int32_t* qrank,
    const uint8_t* bad_mate,
    const int32_t* cig_n_ops, const int64_t* cig_base,
    const int32_t* cig_len, const uint8_t* cig_op,
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const int64_t* bstart, const int64_t* blen,
    const uint8_t* ref, int64_t ref_len,
    int64_t max_indel, int64_t min_read_len, int64_t min_mapq,
    int64_t max_informative, int64_t max_qual,
    const double* qual2prob, const double* jac_table, int64_t jac_n,
    double jac_step, double jac_max_tol, double log10_ploidy,
    double log10_one_third, const double* indel_gq, const int64_t* indel_pls,
    const int64_t* base_mask,
    int64_t* out_ad_ref, int64_t* out_ad_nonref, int64_t* out_pls,
    int64_t* out_gq, int64_t* out_rc) {
  std::vector<int64_t> rows;
  for (int64_t r = 0; r < n_regions; r++) {
    int64_t ps = r_padded_start[r], pe = r_padded_end[r];
    // rows overlapping [ps, pe]: pos in [ps - max_ref_len + 1, pe],
    // filtered on end >= ps (identical to _slice_rows)
    int64_t lowest = ps - max_ref_len + 1;
    int64_t j = (int64_t)(std::lower_bound(positions, positions + n_block,
                                           lowest) - positions);
    int64_t k = (int64_t)(std::upper_bound(positions, positions + n_block,
                                           pe) - positions);
    rows.clear();
    for (int64_t i = j; i < k; i++)
      if (ends[i] >= ps) rows.push_back(i);
    int64_t off = out_off[r];
    out_rc[r] = refconf_region_columnar(
        (int64_t)rows.size(), rows.data(),
        flag, pos, pnext, tlen, mapq, qrank, bad_mate,
        cig_n_ops, cig_base, cig_len, cig_op,
        seq_data, seq_off, qual_data, qual_off, bstart, blen,
        ps, pe, r_low[r], r_high[r], ref, ref_len,
        max_indel, min_read_len, min_mapq, max_informative, max_qual,
        qual2prob, jac_table, jac_n, jac_step, jac_max_tol, log10_ploidy,
        log10_one_third, indel_gq, indel_pls, base_mask,
        out_ad_ref + off, out_ad_nonref + off, out_pls + 3 * off,
        out_gq + off);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GVCF band-block aggregation for VariantCombiner.merge_run: one pass
// over a reference run's (gq, dp, pls) arrays computing the complete
// band blocks (the numpy reduceat/lexsort/partition sequence in
// hc/refconf.py _merge_run_impl is the oracle; fuzzed in
// tests/test_refconf.py). The trailing open band run is left to the
// caller. Returns the number of blocks written.
// ---------------------------------------------------------------------------

#include <algorithm>

extern "C" long long gvcf_band_blocks(
    const int* gq,          // [m] raw GQ (clipped at 99 here)
    const int* dp,          // [m]
    const int* pls,         // [m,3]
    long long m, long long j,
    const long long* bands, long long n_bands,
    long long* out_starts,  // [cap] block start (absolute index)
    long long* out_counts,  // [cap]
    long long* out_med,     // [cap] go-rounded median DP
    long long* out_min_dp,  // [cap]
    long long* out_gq,      // [cap]
    long long* out_min_pls, // [cap,3]
    long long* open_start,  // -> start of the trailing open run
    long long cap) {
  if (j >= m) { *open_start = m; return 0; }
  auto band_of = [&](int g) {
    const long long gg = g < 99 ? g : 99;
    // upper_bound over the sorted band edges (numpy side='right')
    return (long long)(std::upper_bound(bands, bands + n_bands, gg) - bands);
  };
  long long nb = 0;
  long long a = j;
  long long cur = band_of(gq[j]);
  std::vector<int> scratch;
  auto flush_block = [&](long long b) {
    // complete block [a, b)
    if (nb >= cap) return false;
    const long long n = b - a;
    int mp0 = pls[3 * a], mp1 = pls[3 * a + 1], mp2 = pls[3 * a + 2];
    int mdp = dp[a];
    scratch.assign(dp + a, dp + b);
    for (long long t = a + 1; t < b; t++) {
      if (pls[3 * t] < mp0) mp0 = pls[3 * t];
      if (pls[3 * t + 1] < mp1) mp1 = pls[3 * t + 1];
      if (pls[3 * t + 2] < mp2) mp2 = pls[3 * t + 2];
      if (dp[t] < mdp) mdp = dp[t];
    }
    long long med;
    const long long lo_r = (n - 1) / 2;
    std::nth_element(scratch.begin(), scratch.begin() + lo_r, scratch.end());
    const long long lo_v = scratch[lo_r];
    if (n % 2 == 1) {
      med = lo_v;
    } else {
      const long long hi_v =
          *std::min_element(scratch.begin() + lo_r + 1, scratch.end());
      med = (lo_v + hi_v + 1) / 2;  // go round-half-away for ints >= 0
    }
    // gq = second smallest PL minus smallest, capped at 99
    long long s0 = mp0, s1 = mp1;
    if (s1 < s0) std::swap(s0, s1);
    if (mp2 < s0) { s1 = s0; s0 = mp2; }
    else if (mp2 < s1) { s1 = mp2; }
    long long g = s1 - s0;
    if (g > 99) g = 99;
    out_starts[nb] = a;
    out_counts[nb] = n;
    out_med[nb] = med;
    out_min_dp[nb] = mdp;
    out_gq[nb] = g;
    out_min_pls[3 * nb] = mp0;
    out_min_pls[3 * nb + 1] = mp1;
    out_min_pls[3 * nb + 2] = mp2;
    nb++;
    return true;
  };
  for (long long t = j + 1; t < m; t++) {
    const long long bd = band_of(gq[t]);
    if (bd != cur) {
      if (!flush_block(t)) { *open_start = -1; return -1; }
      a = t;
      cur = bd;
    }
  }
  *open_start = a;  // trailing run [a, m) stays open
  return nb;
}
