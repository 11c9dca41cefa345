// De Bruijn assembly engine (native port of elprep_tpu/hc/assembly.py,
// which reimplements the reference's filters/assemble-reads.go).
//
// The Python module remains the semantic oracle: this file mirrors its
// control flow exactly — including object-identity edge semantics
// (edges are pooled and referenced, like Python objects), id-ordered
// vertex iteration, the restart-on-success simplification loops, and
// the exact Smith-Waterman used for dangling-end recovery
// (ops/sw.py run_smith_waterman, itself a port of filters/sw.go).
//
// Entry point: assemble_try() = one process_kmer_size() attempt,
// returning k-best candidate haplotypes (score, bases); the Python
// driver keeps the kmer-size retry ladder and the final
// calculate_cigar/dedup step (few calls, cheap).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <set>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int MIN_PRUNING_FACTOR = 2;
constexpr int MAX_CIGAR_COMPLEXITY = 3;
constexpr int MAX_HAPLOTYPES = 128;

// ---------------------------------------------------------------------------
// Smith-Waterman (ops/sw.py:54-214 semantics; params = ASSEMBLY_SW_PARAMS,
// strategy = LEADING_INDEL for dangling-end recovery)
// ---------------------------------------------------------------------------

struct CigOp { int64_t len; char op; };

constexpr int SW_SOFTCLIP = 0, SW_INDEL = 1, SW_LEADING_INDEL = 2, SW_IGNORE = 3;
constexpr int64_t MATRIX_MIN_CUTOFF = -100000000;
constexpr int64_t LOW_INIT = -(int64_t(1) << 30);

static void run_smith_waterman(const std::string& reference,
                               const std::string& alternate,
                               int64_t match_value, int64_t mismatch_penalty,
                               int64_t gap_open, int64_t gap_extend,
                               int strategy, std::vector<CigOp>& lce_out,
                               int64_t* alignment_offset_out) {
  lce_out.clear();
  if (strategy == SW_SOFTCLIP || strategy == SW_IGNORE) {
    size_t off = reference.rfind(alternate);
    if (off != std::string::npos) {
      lce_out.push_back({(int64_t)alternate.size(), 'M'});
      *alignment_offset_out = (int64_t)off;
      return;
    }
  }
  const int64_t nrow = (int64_t)reference.size() + 1;
  const int64_t ncol = (int64_t)alternate.size() + 1;
  std::vector<int64_t> sw(nrow * ncol, 0);
  std::vector<int64_t> bt(nrow * ncol, 0);
  if (strategy == SW_INDEL || strategy == SW_LEADING_INDEL) {
    for (int64_t j = 1; j < ncol; j++) sw[j] = gap_open + (j - 1) * gap_extend;
    for (int64_t i = 1; i < nrow; i++) sw[i * ncol] = gap_open + (i - 1) * gap_extend;
  }
  std::vector<int64_t> best_gap_v(ncol, LOW_INIT), gap_size_v(ncol, 0);
  std::vector<int64_t> best_gap_h(nrow, LOW_INIT), gap_size_h(nrow, 0);
  for (int64_t i = 1; i < nrow; i++) {
    const uint8_t a = (uint8_t)reference[i - 1];
    int64_t* cur = &sw[i * ncol];
    const int64_t* prev = &sw[(i - 1) * ncol];
    int64_t* btr = &bt[i * ncol];
    for (int64_t j = 1; j < ncol; j++) {
      const uint8_t b = (uint8_t)alternate[j - 1];
      const int64_t step_diag = prev[j - 1] + (a == b ? match_value : mismatch_penalty);
      // vertical gap (strictly greater keeps longer gap, sw.go:175-185)
      {
        const int64_t prev_gap = prev[j] + gap_open;
        best_gap_v[j] += gap_extend;
        if (prev_gap > best_gap_v[j]) {
          best_gap_v[j] = prev_gap;
          gap_size_v[j] = 1;
        } else {
          gap_size_v[j] += 1;
        }
      }
      const int64_t step_down = best_gap_v[j];
      const int64_t kd = gap_size_v[j];
      // horizontal gap (sw.go:187-196)
      {
        const int64_t prev_gap = cur[j - 1] + gap_open;
        best_gap_h[i] += gap_extend;
        if (prev_gap > best_gap_h[i]) {
          best_gap_h[i] = prev_gap;
          gap_size_h[i] = 1;
        } else {
          gap_size_h[i] += 1;
        }
      }
      const int64_t step_right = best_gap_h[i];
      const int64_t ki = gap_size_h[i];
      // winner priority (sw.go:198-208)
      if (step_diag >= step_down && step_diag >= step_right) {
        cur[j] = std::max(MATRIX_MIN_CUTOFF, step_diag);
        btr[j] = 0;
      } else if (step_right >= step_down) {
        cur[j] = std::max(MATRIX_MIN_CUTOFF, step_right);
        btr[j] = -ki;
      } else {
        cur[j] = std::max(MATRIX_MIN_CUTOFF, step_down);
        btr[j] = kd;
      }
    }
  }
  const int64_t ref_len = nrow - 1, alt_len = ncol - 1;
  int64_t max_score = INT64_MIN;
  int64_t segment_length = 0;
  int64_t p1 = 0, p2 = alt_len;
  if (strategy == SW_INDEL) {
    p1 = ref_len;
  } else {
    // >= : later i wins ties (sw.go:218-224)
    int64_t best = INT64_MIN;
    for (int64_t i = 1; i < nrow; i++) {
      const int64_t cs = sw[i * ncol + alt_len];
      if (cs >= best) {
        best = cs;
        p1 = i;
      }
    }
    max_score = best;
    if (strategy != SW_LEADING_INDEL) {
      const int64_t* bottom = &sw[ref_len * ncol];
      for (int64_t j = 1; j < ncol; j++) {
        const int64_t cur_score = bottom[j];
        if (cur_score > max_score ||
            (cur_score == max_score &&
             std::llabs(ref_len - j) < std::llabs(p1 - p2))) {
          p1 = ref_len;
          p2 = j;
          max_score = cur_score;
          segment_length = alt_len - j;
        }
      }
    }
  }
  // backtrack (sw.go:240-276)
  std::vector<CigOp> lce;
  if (segment_length > 0 && strategy == SW_SOFTCLIP) {
    lce.push_back({segment_length, 'S'});
    segment_length = 0;
  }
  char state = 'M';
  for (;;) {
    const int64_t b = bt[p1 * ncol + p2];
    char new_state;
    int64_t step_length;
    if (b > 0) {
      new_state = 'D';
      step_length = b;
      p1 -= b;
    } else if (b < 0) {
      new_state = 'I';
      step_length = -b;
      p2 += b;
    } else {
      new_state = 'M';
      step_length = 1;
      p1 -= 1;
      p2 -= 1;
    }
    if (new_state == state) {
      segment_length += step_length;
    } else {
      lce.push_back({segment_length, state});
      segment_length = step_length;
      state = new_state;
    }
    if (p1 <= 0 || p2 <= 0) break;
  }
  int64_t alignment_offset = 0;
  if (strategy == SW_SOFTCLIP) {
    lce.push_back({segment_length, state});
    if (p2 > 0) lce.push_back({p2, 'S'});
    alignment_offset = p1;
  } else if (strategy == SW_IGNORE) {
    lce.push_back({segment_length + p2, state});
    alignment_offset = p1 - p2;
  } else {
    lce.push_back({segment_length, state});
    if (p1 > 0) lce.push_back({p1, 'D'});
    else if (p2 > 0) lce.push_back({p2, 'I'});
    alignment_offset = 0;
  }
  std::reverse(lce.begin(), lce.end());
  // merge pass replicating the reference's exact loop (sw.go:289-302)
  size_t i = 1;
  while (i < lce.size()) {
    if (lce[i - 1].len == 0) {
      lce.erase(lce.begin() + (i - 1));
    } else if (lce[i - 1].op == lce[i].op) {
      lce[i - 1].len += lce[i].len;
      lce.erase(lce.begin() + i);
    } else {
      i++;
    }
  }
  if (!lce.empty() && lce.back().len == 0) lce.pop_back();
  lce_out = std::move(lce);
  *alignment_offset_out = alignment_offset;
}

static int64_t cigar_reference_length(const std::vector<CigOp>& cigar) {
  int64_t n = 0;
  for (const auto& c : cigar)
    if (c.op == 'M' || c.op == 'D' || c.op == 'N' || c.op == '=' || c.op == 'X')
      n += c.len;
  return n;
}

static int64_t cigar_read_length(const std::vector<CigOp>& cigar) {
  int64_t n = 0;
  for (const auto& c : cigar)
    if (c.op == 'M' || c.op == 'I' || c.op == 'S' || c.op == '=' || c.op == 'X')
      n += c.len;
  return n;
}

// assembly dangling-end SW params (assemble-reads.go:1042,1152)
constexpr int64_t ASM_MATCH = 25, ASM_MISMATCH = -50, ASM_OPEN = -110, ASM_EXT = -6;

// ---------------------------------------------------------------------------
// Kmer graph (assembly.py KmerGraph)
// ---------------------------------------------------------------------------

struct AEdge;

struct AVert {
  int64_t id = 0;  // -1 = deleted
  std::string bases;
  std::vector<AEdge*> out, in;  // adjacency lives on the vertex
  uint8_t suffix() const { return (uint8_t)bases.back(); }
  bool deleted() const { return id == -1; }
};

struct AEdge {
  AVert* nbr;  // the OTHER endpoint (target for out, source for in)
  int64_t mult;
  bool is_ref;
};

struct Kseq {
  const uint8_t* bases;
  int64_t bases_len;
  int64_t start, stop;
  bool is_ref;
};

struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const {
    return std::hash<std::string_view>{}(s);
  }
  size_t operator()(const std::string& s) const {
    return std::hash<std::string_view>{}(s);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};

// 2-bit kmer codes for the membership-heavy scans: kmers of k <= 32
// whose window is pure ACGT pack injectively into a uint64 (rolling
// update, O(1) per position); any other kmer (N survives only in the
// reference Kseq, IUPAC codes, k > 32) takes the original string path.
// Content partitioning keeps semantics exact: a pure-ACGT kmer can
// never equal a non-ACGT one, so membership across the two containers
// never mixes.
struct U64Hash {
  size_t operator()(uint64_t x) const {  // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return (size_t)(x ^ (x >> 31));
  }
};

static inline int base2_code(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
  }
  return -1;
}

// Rolling window encoder over a byte scan: after feed(i, b) for
// consecutive positions, window_ok(i, k) says whether the k-window
// ending at i is pure ACGT, and code(mask) is its 2-bit packing.
struct KmerRoll {
  uint64_t acc = 0;
  int64_t last_bad = -1;
  inline void feed(int64_t i, uint8_t b) {
    const int c = base2_code(b);
    if (c < 0) {
      last_bad = i;
      acc = (acc << 2);
    } else {
      acc = (acc << 2) | (uint64_t)c;
    }
  }
  inline bool window_ok(int64_t i, int k) const { return last_bad <= i - k; }
  inline uint64_t code(uint64_t mask) const { return acc & mask; }
};

// Pointwise encode (for lookups at arbitrary offsets).
static inline bool encode_kmer_u64(const uint8_t* p, int k, uint64_t* out) {
  if (k > 32) return false;
  uint64_t acc = 0;
  for (int i = 0; i < k; i++) {
    const int c = base2_code(p[i]);
    if (c < 0) return false;
    acc = (acc << 2) | (uint64_t)c;
  }
  *out = acc;
  return true;
}

struct Graph {
  int64_t vertices_id = 0;
  int kmer_size;
  std::map<int64_t, AVert*> vertices;
  std::unordered_map<std::string, AVert*, SvHash, SvEq> unique_kmers;
  std::unordered_set<std::string, SvHash, SvEq> non_unique_kmers;
  // u64 fast tier of non_unique_kmers (pure-ACGT kmers, k <= 32);
  // the string set above keeps the rest. seen_u64 is the reusable
  // per-segment scratch of determine_non_unique_kmers.
  std::unordered_set<uint64_t, U64Hash> non_unique_u64;
  std::unordered_set<uint64_t, U64Hash> seen_u64;
  std::deque<AVert> vpool;
  std::deque<AEdge> epool;

  explicit Graph(int k) : kmer_size(k) {}

  AVert* make_vert(std::string bases) {
    vpool.push_back(AVert{0, std::move(bases)});
    return &vpool.back();
  }
  AEdge* make_edge(AVert* nbr, int64_t mult, bool is_ref) {
    epool.push_back(AEdge{nbr, mult, is_ref});
    return &epool.back();
  }

  static const std::vector<AEdge*>& outs(const AVert* v) { return v->out; }
  static const std::vector<AEdge*>& inns(const AVert* v) { return v->in; }
  int64_t out_degree(const AVert* v) const { return (int64_t)v->out.size(); }
  int64_t in_degree(const AVert* v) const { return (int64_t)v->in.size(); }

  void add_vertex(AVert* v) {
    vertices_id++;
    v->id = vertices_id;
    vertices[v->id] = v;
  }

  void update_vertex_id(AVert* v) {
    if (v->id == vertices_id) return;
    const int64_t old = v->id;
    vertices_id++;
    const int64_t nid = vertices_id;
    // neighbors reference v by pointer, so only the id map rekeys
    v->id = nid;
    vertices.erase(old);
    vertices[nid] = v;
  }

  void set_out_edges(AVert* v, std::vector<AEdge*> edges) {
    v->out = std::move(edges);
  }
  void set_in_edges(AVert* v, std::vector<AEdge*> edges) {
    v->in = std::move(edges);
  }

  AEdge* get_out_edge(const AVert* source, const AVert* target) const {
    for (AEdge* e : source->out)
      if (e->nbr == target) return e;
    return nullptr;
  }

  std::pair<AEdge*, AEdge*> add_edge(AVert* v1, AVert* v2, int64_t mult,
                                     bool is_ref) {
    if (get_out_edge(v1, v2) != nullptr) return {nullptr, nullptr};
    AEdge* incoming = make_edge(v1, mult, is_ref);
    v2->in.push_back(incoming);
    AEdge* outgoing = make_edge(v2, mult, is_ref);
    v1->out.push_back(outgoing);
    return {incoming, outgoing};
  }

  AEdge* heaviest_out_edge(const AVert* v) const {
    const auto& edges = outs(v);
    AEdge* best = edges[0];
    for (size_t i = 1; i < edges.size(); i++)
      if (edges[i]->mult > best->mult) best = edges[i];
    return best;
  }

  bool is_singleton(const AVert* v) const {
    return in_degree(v) == 0 && out_degree(v) == 0;
  }

  void remove_singleton(AVert* v) {
    if (v->id == -1) return;
    vertices.erase(v->id);
    auto it = unique_kmers.find(v->bases);
    if (it != unique_kmers.end() && it->second == v) unique_kmers.erase(it);
    v->id = -1;
  }

  void remove_edge_raw(AVert* source, AVert* target) {
    {
      std::vector<AEdge*> keep;
      for (AEdge* e : source->out)
        if (e->nbr != target) keep.push_back(e);
      source->out = std::move(keep);
    }
    {
      std::vector<AEdge*> keep;
      for (AEdge* e : target->in)
        if (e->nbr != source) keep.push_back(e);
      target->in = std::move(keep);
    }
  }

  void remove_edge(AVert* source, AVert* target) {
    if (target == nullptr) return;
    remove_edge_raw(source, target);
    if (is_singleton(target)) remove_singleton(target);
    if (is_singleton(source) && vertices.size() != 1) remove_singleton(source);
  }

  void remove_all_out_edges(AVert* source) {
    for (AEdge* e : source->out) {
      AVert* target = e->nbr;
      std::vector<AEdge*> keep;
      for (AEdge* x : target->in)
        if (x->nbr != source) keep.push_back(x);
      target->in = std::move(keep);
      if (is_singleton(target)) remove_singleton(target);
    }
    source->out.clear();
    if (is_singleton(source) && vertices.size() != 1) remove_singleton(source);
  }

  void remove_all_in_edges(AVert* target) {
    for (AEdge* e : target->in) {
      AVert* source = e->nbr;
      std::vector<AEdge*> keep;
      for (AEdge* x : source->out)
        if (x->nbr != target) keep.push_back(x);
      source->out = std::move(keep);
      if (is_singleton(source)) remove_singleton(source);
    }
    target->in.clear();
    if (is_singleton(target) && vertices.size() != 1) remove_singleton(target);
  }

  void remove_vertex(AVert* v) {
    remove_all_out_edges(v);
    remove_all_in_edges(v);
    remove_singleton(v);
  }

  std::vector<AVert*> all_vertices() const {
    std::vector<AVert*> out;
    out.reserve(vertices.size());
    for (const auto& kv : vertices) out.push_back(kv.second);
    return out;  // std::map iterates in id order
  }

  // -- reference topology --

  bool vertex_is_reference_source(const AVert* v) const {
    if (vertices.size() == 1) return true;
    for (AEdge* e : inns(v))
      if (e->is_ref) return false;
    for (AEdge* e : outs(v))
      if (e->is_ref) return true;
    return false;
  }
  bool vertex_is_reference_sink(const AVert* v) const {
    if (vertices.size() == 1) return true;
    for (AEdge* e : outs(v))
      if (e->is_ref) return false;
    for (AEdge* e : inns(v))
      if (e->is_ref) return true;
    return false;
  }
  bool vertex_is_reference_node(const AVert* v) const {
    if (vertices.size() == 1) return true;
    for (AEdge* e : inns(v))
      if (e->is_ref) return true;
    for (AEdge* e : outs(v))
      if (e->is_ref) return true;
    return false;
  }
  bool is_source_vertex(const AVert* v) const { return in_degree(v) == 0; }

  bool vertex_is_linear_chain_start(const AVert* v) const {
    if (out_degree(v) != 1) return false;
    if (in_degree(v) != 1) return true;
    const auto& incoming = inns(v);
    return incoming.size() == 1 &&
           (int64_t)outs(incoming[0]->nbr).size() > 1;
  }

  AVert* reference_source() const {
    for (const auto& kv : vertices)
      if (vertex_is_reference_source(kv.second)) return kv.second;
    return nullptr;
  }
  AVert* reference_sink() const {
    for (const auto& kv : vertices)
      if (vertex_is_reference_sink(kv.second)) return kv.second;
    return nullptr;
  }

  // -- graph construction --

  bool in_non_unique(std::string_view km) const {
    uint64_t code;
    if ((int)km.size() <= 32 &&
        encode_kmer_u64((const uint8_t*)km.data(), (int)km.size(), &code))
      return non_unique_u64.find(code) != non_unique_u64.end();
    return non_unique_kmers.find(km) != non_unique_kmers.end();
  }

  void determine_non_unique_kmers(const Kseq& seq) {
    const int k = kmer_size;
    if (k <= 32) {
      // rolling-code fast path; windows touching a non-ACGT byte fall
      // back to the string tier (same membership semantics)
      const uint64_t mask =
          k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
      seen_u64.clear();
      std::unordered_set<std::string, SvHash, SvEq> seen_str;
      KmerRoll roll;
      int64_t i = 0;
      for (; i < k - 1 && i < seq.stop; i++) roll.feed(i, seq.bases[i]);
      for (int64_t e = k - 1; e < seq.stop; e++) {
        roll.feed(e, seq.bases[e]);
        const int64_t i0 = e - k + 1;
        if (roll.window_ok(e, k)) {
          const uint64_t code = roll.code(mask);
          if (!seen_u64.insert(code).second) non_unique_u64.insert(code);
        } else {
          std::string_view km((const char*)seq.bases + i0, k);
          if (seen_str.find(km) != seen_str.end()) {
            if (non_unique_kmers.find(km) == non_unique_kmers.end())
              non_unique_kmers.emplace(km);
          } else {
            seen_str.emplace(km);
          }
        }
      }
      return;
    }
    std::unordered_set<std::string, SvHash, SvEq> seen;
    for (int64_t i = 0; i <= seq.stop - k; i++) {
      std::string_view km((const char*)seq.bases + i, k);
      if (seen.find(km) != seen.end()) {
        if (non_unique_kmers.find(km) == non_unique_kmers.end())
          non_unique_kmers.emplace(km);
      } else {
        seen.emplace(km);
      }
    }
  }

  int64_t find_start_of_kmers(const Kseq& seq) const {
    if (seq.is_ref) return 0;
    const int k = kmer_size;
    if (k <= 32) {
      const uint64_t mask = k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
      KmerRoll roll;
      for (int64_t i = seq.start; i < seq.start + k - 1 && i < seq.stop; i++)
        roll.feed(i, seq.bases[i]);
      for (int64_t e = seq.start + k - 1; e < seq.stop - 1; e++) {
        roll.feed(e, seq.bases[e]);
        const int64_t i = e - k + 1;
        if (roll.window_ok(e, k)) {
          if (non_unique_u64.find(roll.code(mask)) == non_unique_u64.end())
            return i;
        } else {
          std::string_view km((const char*)seq.bases + i, k);
          if (non_unique_kmers.find(km) == non_unique_kmers.end()) return i;
        }
      }
      return -1;
    }
    for (int64_t i = seq.start; i < seq.stop - k; i++) {
      std::string_view km((const char*)seq.bases + i, k);
      if (non_unique_kmers.find(km) == non_unique_kmers.end()) return i;
    }
    return -1;
  }

  AVert* new_kmer_vertex(std::string_view kmer_seq) {
    AVert* v = make_vert(std::string(kmer_seq));
    add_vertex(v);
    if (!in_non_unique(kmer_seq) &&
        unique_kmers.find(kmer_seq) == unique_kmers.end())
      unique_kmers.emplace(kmer_seq, v);
    return v;
  }

  AVert* get_kmer_vertex(const Kseq& seq, int64_t start) {
    std::string_view km((const char*)seq.bases + start, kmer_size);
    auto it = unique_kmers.find(km);
    if (it != unique_kmers.end()) return it->second;
    return new_kmer_vertex(km);
  }

  AVert* get_kmer_vertex_but_not_ref_source(const std::string& ref_source,
                                            const Kseq& seq, int64_t start) {
    std::string_view km((const char*)seq.bases + start, kmer_size);
    if (km == std::string_view(ref_source)) return new_kmer_vertex(km);
    auto it = unique_kmers.find(km);
    if (it != unique_kmers.end()) return it->second;
    return new_kmer_vertex(km);
  }

  void increment_out_multiplicity(const AVert* frm, const AVert* to) {
    for (AEdge* e : outs(frm))
      if (e->nbr->id == to->id) {
        e->mult++;
        return;
      }
  }
  void increment_in_multiplicity(const AVert* frm, const AVert* to) {
    for (AEdge* e : inns(to))
      if (e->nbr->id == frm->id) {
        e->mult++;
        return;
      }
  }

  void increase_counts_matched_kmers(const Kseq& seq, AVert* original) {
    // (assemble-reads.go:787-805) — iterative form of the recursion
    AVert* vertex = original;
    for (int64_t offset = kmer_size - 2; offset >= 0; offset--) {
      if (in_degree(vertex) != 1) return;
      AEdge* e = inns(vertex)[0];
      AVert* previous = e->nbr;
      if (previous->suffix() != (uint8_t)original->bases[offset]) return;
      e->mult++;
      increment_out_multiplicity(previous, vertex);
      vertex = previous;
    }
  }

  AVert* extend_chain_by_one(const std::string& ref_source, AVert* vertex,
                             const Kseq& seq, int64_t i) {
    const int64_t next_pos = i + kmer_size - 1;
    const uint8_t last_base = seq.bases[next_pos];
    for (AEdge* e : outs(vertex)) {
      AVert* connecting = e->nbr;
      if (last_base == connecting->suffix()) {
        e->mult++;
        increment_in_multiplicity(vertex, connecting);
        return connecting;
      }
    }
    AVert* nv = get_kmer_vertex_but_not_ref_source(ref_source, seq, i);
    add_edge(vertex, nv, 1, seq.is_ref);
    return nv;
  }

  // -- cycle detection (iterative DFS mirroring assembly.py:385-456) --

  bool has_cycle() {
    std::vector<AVert*> verts = all_vertices();
    std::unordered_map<int64_t, int> seen;
    std::vector<AVert*> stack;  // nullptr = frame marker
    std::vector<AVert*> path;
    const int PROCESSING = 1, DONE = 2;
    size_t vi = 0;
    auto encounter = [&](AVert* v) {
      seen[v->id] = PROCESSING;
      stack.push_back(v);
    };
    auto component_exhausted = [&]() -> bool {
      for (;;) {
        if (stack.empty()) return true;
        if (stack.back() != nullptr) return false;
        stack.resize(stack.size() - 2);
      }
    };
    if (verts.empty()) return false;
    encounter(verts[vi]);
    vi++;
    for (;;) {
      if (component_exhausted()) {
        bool advanced = false;
        while (vi < verts.size()) {
          AVert* v = verts[vi];
          vi++;
          if (seen.find(v->id) == seen.end()) {
            encounter(v);
            advanced = true;
            break;
          }
        }
        if (!advanced) return false;
      }
      AVert* v;
      for (;;) {
        v = stack.back();
        stack.pop_back();
        if (v == nullptr) stack.pop_back();
        else break;
      }
      stack.push_back(v);
      stack.push_back(nullptr);
      seen[v->id] = DONE;
      {
        int64_t i = (int64_t)path.size() - 1;
        while (i >= 0) {
          bool found = false;
          for (AEdge* e : outs(path[i]))
            if (e->nbr == v) {
              found = true;
              break;
            }
          if (found) break;
          path.pop_back();
          i--;
        }
        path.push_back(v);
      }
      bool cycle = false;
      for (AEdge* e : outs(v)) {
        AVert* target = e->nbr;
        auto it = seen.find(target->id);
        if (it != seen.end()) {
          bool in_path = false;
          for (AVert* p : path)
            if (p == target) {
              in_path = true;
              break;
            }
          if (in_path) {
            cycle = true;
            break;
          }
          if (it->second == PROCESSING) {
            for (int64_t i = (int64_t)stack.size() - 1; i >= 0; i--)
              if (stack[i] == target) {
                stack.erase(stack.begin() + i);
                break;
              }
            stack.push_back(target);
          }
        } else {
          encounter(target);
        }
      }
      if (cycle) return true;
    }
  }

  // -- chains & pruning --

  std::vector<AEdge> find_chain(const AVert* start, const AEdge* edge) const {
    const AVert* end = edge->nbr;
    std::vector<AEdge> chain{AEdge{edge->nbr, edge->mult, edge->is_ref}};
    for (;;) {
      if (in_degree(end) > 1 || start == end) return chain;
      const auto& end_edges = outs(end);
      if (end_edges.size() != 1) return chain;
      const AEdge* nxt = end_edges[0];
      chain.push_back(AEdge{nxt->nbr, nxt->mult, nxt->is_ref});
      end = nxt->nbr;
    }
  }

  void prune_chains_with_low_weight() {
    // find_all_chains (assembly.py:473-486)
    std::vector<AVert*> sources;
    std::unordered_set<int64_t> seen;
    for (const auto& kv : vertices)
      if (is_source_vertex(kv.second)) {
        sources.push_back(kv.second);
        seen.insert(kv.second->id);
      }
    std::vector<std::pair<AVert*, std::vector<AEdge>>> chains;
    while (!sources.empty()) {
      AVert* source = sources.back();
      sources.pop_back();
      for (AEdge* e : outs(source)) {
        chains.emplace_back(source, find_chain(source, e));
        AVert* last = chains.back().second.back().nbr;
        if (seen.insert(last->id).second) sources.push_back(last);
      }
    }
    for (auto& sc : chains) {
      bool all_low = true;
      for (const AEdge& e : sc.second)
        if (e.mult >= MIN_PRUNING_FACTOR || e.is_ref) {
          all_low = false;
          break;
        }
      if (!all_low) continue;
      AVert* s = sc.first;
      for (const AEdge& e : sc.second) {
        AVert* t = e.nbr->deleted() ? nullptr : e.nbr;
        if (t != nullptr && s->id != -1) remove_edge_raw(s, t);
        s = t;
        if (s == nullptr) break;
      }
      // only this chain's vertices can have BECOME singletons (earlier
      // chains already swept theirs), so the oracle's full-graph sweep
      // reduces to the chain — same removals, same order by id below
      std::vector<AVert*> touched{sc.first};
      for (const AEdge& e : sc.second) touched.push_back(e.nbr);
      std::sort(touched.begin(), touched.end(),
                [](const AVert* a, const AVert* b) { return a->id < b->id; });
      for (AVert* v : touched) {
        if (vertices.size() == 1) break;
        if (!v->deleted() && is_singleton(v)) remove_singleton(v);
      }
    }
  }

  bool is_low_complexity() const {
    return ((int64_t)non_unique_kmers.size() + (int64_t)non_unique_u64.size())
               * 4 > (int64_t)unique_kmers.size();
  }

  // -- dangling tail/head recovery --

  bool find_path_upwards_to_lca(AVert* vertex, std::vector<AVert*>& path) {
    path.clear();
    AVert* current = vertex;
    while (in_degree(current) == 1 && out_degree(current) < 2) {
      AEdge* edge = inns(current)[0];
      AVert* target = edge->nbr;
      if (edge->mult < MIN_PRUNING_FACTOR) path.clear();
      else path.push_back(current);
      current = target;
    }
    if (out_degree(current) > 1) {
      path.push_back(current);
      std::reverse(path.begin(), path.end());
      return true;
    }
    return false;
  }

  std::vector<AVert*> find_reference_path(const std::vector<AVert*>& path) {
    AVert* vertex = path[0];
    const auto& edges0 = inns(path[1]);
    AEdge* max_edge = edges0[0];
    for (size_t i = 1; i < edges0.size(); i++)
      if (edges0[i]->mult > max_edge->mult) max_edge = edges0[i];
    if (max_edge->nbr == vertex)
      max_edge = get_out_edge(vertex, path[1]);
    else
      max_edge = nullptr;
    std::vector<AVert*> out;
    for (;;) {
      out.push_back(vertex);
      const auto& edges = outs(vertex);
      if (edges.empty()) return out;
      AEdge* ref_edge = nullptr;
      for (AEdge* e : edges)
        if (e->is_ref) {
          ref_edge = e;
          break;
        }
      if (ref_edge != nullptr) {
        vertex = ref_edge->nbr;
        continue;
      }
      if (max_edge == nullptr) {
        if (edges.size() == 1) {
          vertex = edges[0]->nbr;
          continue;
        }
        return out;
      }
      AVert* next_vertex = nullptr;
      bool too_many = false;
      for (AEdge* e : edges) {
        if (e != max_edge) {
          if (next_vertex == nullptr) next_vertex = e->nbr;
          else {
            too_many = true;
            break;
          }
        }
      }
      if (too_many) return out;
      if (next_vertex != nullptr) {
        vertex = next_vertex;
        continue;
      }
      return out;
    }
  }

  static std::string path_suffix_bases(const std::vector<AVert*>& path) {
    std::string out;
    out.reserve(path.size());
    for (const AVert* v : path) out.push_back((char)v->suffix());
    return out;
  }

  std::string path_bases_expanded_sources(const std::vector<AVert*>& path) const {
    std::string out;
    for (const AVert* v : path) {
      if (is_source_vertex(v)) {
        std::string rev(v->bases.rbegin(), v->bases.rend());
        out += rev;
      } else {
        out.push_back((char)v->suffix());
      }
    }
    return out;
  }

  static int64_t longest_suffix_match(const std::string& sequence,
                                      const std::string& kmer, int64_t start) {
    const int64_t klen = (int64_t)kmer.size();
    for (int64_t length = 1; length <= klen; length++) {
      const int64_t seqi = start - length + 1;
      if (seqi < 0 || sequence[seqi] != kmer[klen - length]) return length - 1;
    }
    return klen;
  }

  bool merge_dangling_tail(const std::vector<AVert*>& alt_path,
                           const std::vector<AVert*>& ref_path,
                           const std::string& alt_bases,
                           const std::string& ref_bases,
                           const std::vector<CigOp>& cigar) {
    const int64_t last_ref_index = cigar_reference_length(cigar) - 1;
    const int64_t matching_suffix =
        std::min(longest_suffix_match(ref_bases, alt_bases, last_ref_index),
                 cigar.back().len);
    if (matching_suffix == 0) return false;
    const int64_t alt_index =
        std::max(cigar_read_length(cigar) - matching_suffix - 1, (int64_t)0);
    int64_t ref_index = last_ref_index - matching_suffix + 1;
    if (cigar[0].op == 'D' && cigar[0].len + matching_suffix == last_ref_index + 1)
      ref_index++;
    if (ref_index == 0) return false;
    add_edge(const_cast<AVert*>(alt_path[alt_index]),
             const_cast<AVert*>(ref_path[ref_index]), 1, false);
    return true;
  }

  void recover_dangling_tails() {
    std::vector<AVert*> dests;
    for (const auto& kv : vertices)
      if (out_degree(kv.second) == 0 && !vertex_is_reference_sink(kv.second))
        dests.push_back(kv.second);
    for (AVert* vertex : dests) {
      std::vector<AVert*> alt_path;
      if (!find_path_upwards_to_lca(vertex, alt_path) || alt_path.size() < 5 ||
          vertex_is_reference_source(alt_path[0]))
        continue;
      std::vector<AVert*> ref_path = find_reference_path(alt_path);
      std::string alt_bases = path_suffix_bases(alt_path);
      std::string ref_bases = path_suffix_bases(ref_path);
      std::vector<CigOp> cigar;
      int64_t off;
      run_smith_waterman(ref_bases, alt_bases, ASM_MATCH, ASM_MISMATCH,
                         ASM_OPEN, ASM_EXT, SW_LEADING_INDEL, cigar, &off);
      if (!cigar.empty() && cigar.back().op == 'D') cigar.pop_back();
      if (cigar.empty() || (int)cigar.size() > MAX_CIGAR_COMPLEXITY ||
          cigar.back().op != 'M')
        continue;
      merge_dangling_tail(alt_path, ref_path, alt_bases, ref_bases, cigar);
    }
  }

  bool find_path_downwards_to_hcd(AVert* vertex, std::vector<AVert*>& path) {
    path.clear();
    AVert* current = vertex;
    while (!vertex_is_reference_node(current) && out_degree(current) == 1) {
      AEdge* edge = outs(current)[0];
      AVert* target = edge->nbr;
      if (edge->mult < MIN_PRUNING_FACTOR) path.clear();
      else path.push_back(current);
      current = target;
    }
    if (vertex_is_reference_node(current)) {
      path.push_back(current);
      std::reverse(path.begin(), path.end());
      return true;
    }
    return false;
  }

  std::vector<AVert*> find_reference_path_up(const std::vector<AVert*>& path) {
    AVert* vertex = path[0];
    std::vector<AVert*> new_path;
    for (;;) {
      new_path.push_back(vertex);
      bool advanced = false;
      for (AEdge* e : inns(vertex)) {
        vertex = e->nbr;
        if (vertex_is_reference_node(vertex)) {
          advanced = true;
          break;
        }
      }
      if (!advanced) return new_path;
    }
  }

  static int64_t best_prefix_match(const std::string& seq1,
                                   const std::string& seq2, int64_t max_index,
                                   int kmer_size) {
    const int64_t max_mismatches = std::max((int64_t)1, max_index / kmer_size);
    int64_t mismatches = 0;
    int64_t last_good = -1;
    for (int64_t index = 0; index < max_index; index++) {
      if (seq1[index] != seq2[index]) {
        mismatches++;
        if (mismatches > max_mismatches) return -1;
        last_good = index;
      }
    }
    return last_good;
  }

  bool extend_path_against_reference(std::vector<AVert*>& alt_path,
                                     const std::vector<AVert*>& ref_path,
                                     int64_t n_nodes, int kmer_size) {
    const int64_t index_last = (int64_t)alt_path.size() - 1;
    const int64_t index_ref = index_last + n_nodes;
    if (index_ref >= (int64_t)ref_path.size()) return false;
    AVert* dangling_source = alt_path[index_last];
    alt_path.erase(alt_path.begin() + index_last);
    const std::string& ref_source_seq = ref_path[index_ref]->bases;
    std::string seq_to_extend =
        ref_source_seq.substr(0, n_nodes) + dangling_source->bases;
    AEdge* source_edge = heaviest_out_edge(dangling_source);
    const int64_t se_mult = source_edge->mult;
    AVert* source_target = source_edge->nbr;
    remove_edge(dangling_source, source_target);
    for (int64_t i = n_nodes; i >= 1; i--) {
      const int64_t end = std::min<int64_t>(i + kmer_size, (int64_t)seq_to_extend.size());
      AVert* nv = make_vert(seq_to_extend.substr(i, end - i));
      add_vertex(nv);
      add_edge(nv, source_target, se_mult, false);
      alt_path.push_back(nv);
      source_target = nv;
    }
    return true;
  }

  void recover_dangling_heads(int kmer_size_arg) {
    std::vector<AVert*> starts;
    for (const auto& kv : vertices)
      if (in_degree(kv.second) == 0 && !vertex_is_reference_source(kv.second))
        starts.push_back(kv.second);
    for (AVert* vertex : starts) {
      std::vector<AVert*> alt_path;
      if (!find_path_downwards_to_hcd(vertex, alt_path) || alt_path.size() < 5 ||
          vertex_is_reference_sink(alt_path[0]))
        continue;
      std::vector<AVert*> ref_path = find_reference_path_up(alt_path);
      std::string alt_bases = path_bases_expanded_sources(alt_path);
      std::string ref_bases = path_bases_expanded_sources(ref_path);
      std::vector<CigOp> cigar;
      int64_t off;
      run_smith_waterman(ref_bases, alt_bases, ASM_MATCH, ASM_MISMATCH,
                         ASM_OPEN, ASM_EXT, SW_LEADING_INDEL, cigar, &off);
      if (!cigar.empty() && cigar.back().op == 'D') cigar.pop_back();
      if (cigar.empty() || (int)cigar.size() > MAX_CIGAR_COMPLEXITY ||
          cigar[0].op != 'M')
        continue;
      const int64_t index_to_merge =
          best_prefix_match(ref_bases, alt_bases, cigar[0].len, kmer_size_arg);
      if (index_to_merge <= 0 || index_to_merge >= (int64_t)ref_path.size() - 1)
        continue;
      if (index_to_merge >= (int64_t)alt_path.size()) {
        if (!extend_path_against_reference(
                alt_path, ref_path,
                index_to_merge - (int64_t)alt_path.size() + 2, kmer_size_arg))
          continue;
      }
      add_edge(ref_path[index_to_merge + 1], alt_path[index_to_merge], 1, false);
    }
  }

  // -- connectivity cleanups --

  void remove_paths_not_connected_to_reference() {
    AVert* ref_source = reference_source();
    std::unordered_set<int64_t> from_source;
    {
      std::vector<AVert*> stack{ref_source};
      while (!stack.empty()) {
        AVert* v = stack.back();
        stack.pop_back();
        if (!from_source.insert(v->id).second) continue;
        for (AEdge* e : outs(v)) stack.push_back(e->nbr);
      }
    }
    AVert* ref_sink = reference_sink();
    std::unordered_set<int64_t> from_sink;
    {
      std::vector<AVert*> stack{ref_sink};
      while (!stack.empty()) {
        AVert* v = stack.back();
        stack.pop_back();
        if (!from_sink.insert(v->id).second) continue;
        for (AEdge* e : inns(v)) stack.push_back(e->nbr);
      }
    }
    for (AVert* v : all_vertices())
      if (!(from_source.count(v->id) && from_sink.count(v->id)))
        remove_vertex(v);
  }

  void convert_to_sequence_graph() {
    for (AVert* v : all_vertices())
      if (!is_source_vertex(v)) v->bases = std::string(1, (char)v->suffix());
  }

  void remove_non_reference_components() {
    AVert* ref_source = reference_source();
    std::unordered_set<int64_t> visited;
    std::vector<AVert*> stack{ref_source};
    while (!stack.empty()) {
      AVert* v = stack.back();
      stack.pop_back();
      if (!visited.insert(v->id).second) continue;
      for (AEdge* e : inns(v)) stack.push_back(e->nbr);
      for (AEdge* e : outs(v)) stack.push_back(e->nbr);
    }
    for (AVert* v : all_vertices())
      if (!visited.count(v->id)) remove_vertex(v);
  }

  // -- simplification --

  void merge_out_edges_of(AVert* v1, AVert* v2) {
    std::vector<AEdge*> edges2 = v2->out;
    for (AEdge* e : edges2) {
      auto& incoming = e->nbr->in;
      for (size_t i = 0; i < incoming.size(); i++) {
        if (incoming[i]->nbr == v2) {
          AEdge* ie = incoming[i];
          ie->nbr = v1;
          incoming.erase(incoming.begin() + i);
          incoming.push_back(ie);
          break;
        }
      }
    }
    for (AEdge* e : v1->in) {
      auto& outgoing = e->nbr->out;
      for (size_t i = 0; i < outgoing.size(); i++) {
        if (outgoing[i]->nbr == v1) {
          AEdge* oe = outgoing[i];
          outgoing.erase(outgoing.begin() + i);
          outgoing.push_back(oe);
          break;
        }
      }
    }
    v1->out = std::move(edges2);
    v2->out.clear();
    v2->in.clear();
    remove_singleton(v2);
  }

  void merge_vertices(AVert* v1, AVert* v2) {
    v1->bases += v2->bases;
    merge_out_edges_of(v1, v2);
    update_vertex_id(v1);
  }

  bool merge_linear_chains() {
    bool modified = false;
    for (AVert* vertex : all_vertices()) {
      if (vertex->deleted() || !vertex_is_linear_chain_start(vertex)) continue;
      const bool prev_is_ref = vertex_is_reference_node(vertex);
      for (;;) {
        const auto& edges = outs(vertex);
        if (edges.size() != 1) break;
        AVert* next_vertex = edges[0]->nbr;
        if (vertex == next_vertex || in_degree(next_vertex) != 1 ||
            prev_is_ref != vertex_is_reference_node(next_vertex))
          break;
        modified = true;
        merge_vertices(vertex, next_vertex);
      }
    }
    return modified;
  }

  static void common_prefix_suffix(const std::vector<AVert*>& vs,
                                   std::string* prefix, std::string* suffix) {
    int64_t mn = INT64_MAX;
    for (const AVert* v : vs) mn = std::min(mn, (int64_t)v->bases.size());
    int64_t plen = 0;
    for (int64_t i = 0; i < mn; i++) {
      const char c = vs[0]->bases[i];
      bool diff = false;
      for (size_t k = 1; k < vs.size(); k++)
        if (vs[k]->bases[i] != c) {
          diff = true;
          break;
        }
      if (diff) break;
      plen++;
    }
    int64_t slen = 0;
    for (int64_t i = 1; i <= mn - plen; i++) {
      const char c = vs[0]->bases[vs[0]->bases.size() - i];
      bool diff = false;
      for (size_t k = 1; k < vs.size(); k++)
        if (vs[k]->bases[vs[k]->bases.size() - i] != c) {
          diff = true;
          break;
        }
      if (diff) break;
      slen++;
    }
    const std::string& seq = vs[0]->bases;
    *prefix = seq.substr(0, plen);
    *suffix = slen ? seq.substr(seq.size() - slen) : std::string();
  }

  static std::string without_prefix_suffix(const std::string& seq, int64_t plen,
                                           int64_t slen) {
    if ((int64_t)seq.size() - plen - slen <= 0) return std::string();
    return seq.substr(plen, seq.size() - plen - slen);
  }

  AVert* detach_top(AVert* top, const std::string& prefix) {
    AVert* prefix_vertex = make_vert(prefix);
    add_vertex(prefix_vertex);
    bool any_ref = false;
    for (AEdge* oe : outs(top)) {
      if (oe->is_ref) any_ref = true;
      for (AEdge* ie : inns(oe->nbr))
        if (ie->nbr == top) ie->nbr = prefix_vertex;
    }
    prefix_vertex->out = std::move(top->out);
    top->out.clear();
    add_edge(top, prefix_vertex, 1, any_ref);
    return prefix_vertex;
  }

  bool merge_diamond(AVert* vertex) {
    std::vector<AVert*> middles;
    for (AEdge* e : outs(vertex)) middles.push_back(e->nbr);
    if (middles.size() <= 1) return false;
    AVert* bottom = nullptr;
    for (AVert* middle : middles) {
      if (out_degree(middle) < 1 || in_degree(middle) != 1) return false;
      for (AEdge* e : outs(middle)) {
        AVert* target = e->nbr;
        if (bottom == nullptr) bottom = target;
        else if (bottom != target) return false;
      }
    }
    if ((int64_t)inns(bottom).size() != (int64_t)middles.size()) return false;
    return merge_diamond_sequences(vertex, bottom, middles);
  }

  bool merge_diamond_sequences(AVert* top, AVert* bottom,
                               std::vector<AVert*>& middles) {
    std::string prefix, suffix;
    common_prefix_suffix(middles, &prefix, &suffix);
    if (prefix.empty() && suffix.empty()) return false;
    for (AVert* middle : middles) update_vertex_id(middle);
    AVert* prefix_vertex = top;
    if (!prefix.empty()) prefix_vertex = detach_top(top, prefix);
    AVert* suffix_vertex = bottom;
    if (!suffix.empty()) {
      suffix_vertex = make_vert(suffix);
      add_vertex(suffix_vertex);
      bool any_ref = false;
      for (AEdge* ie : inns(bottom)) {
        if (ie->is_ref) any_ref = true;
        for (AEdge* oe : outs(ie->nbr))
          if (oe->nbr == bottom) oe->nbr = suffix_vertex;
      }
      suffix_vertex->in = std::move(bottom->in);
      bottom->in.clear();
      add_edge(suffix_vertex, bottom, 1, any_ref);
    }
    std::vector<AEdge*> new_incoming, new_outgoing;
    AEdge* direct_in = nullptr;
    AEdge* direct_out = nullptr;
    std::vector<AEdge*> prefix_outs = outs(prefix_vertex);  // copy
    for (AEdge* e : prefix_outs) {
      AVert* middle = e->nbr;
      std::string remaining =
          without_prefix_suffix(middle->bases, prefix.size(), suffix.size());
      if (!remaining.empty()) {
        middle->bases = remaining;
        new_outgoing.push_back(e);
      } else {
        AEdge* incoming = middle->in[0];
        AEdge* outgoing = middle->out[0];
        const int64_t mult = incoming->mult + outgoing->mult;
        const bool is_ref = incoming->is_ref || outgoing->is_ref;
        if (direct_out == nullptr) {
          auto pr = add_edge(prefix_vertex, suffix_vertex, mult, is_ref);
          direct_in = pr.first;
          direct_out = pr.second;
          new_incoming.push_back(direct_in);
          new_outgoing.push_back(direct_out);
        } else {
          direct_in->mult += mult;
          direct_out->mult += mult;
          if (is_ref) {
            direct_in->is_ref = true;
            direct_out->is_ref = true;
          }
        }
        middle->in.clear();
        middle->out.clear();
        vertices.erase(middle->id);
        middle->id = -1;
      }
    }
    for (AEdge* e : inns(suffix_vertex)) {
      AVert* middle = e->nbr->deleted() ? nullptr : e->nbr;
      if (middle != nullptr && middle->id != prefix_vertex->id)
        new_incoming.push_back(e);
    }
    prefix_vertex->out = std::move(new_outgoing);
    suffix_vertex->in = std::move(new_incoming);
    return true;
  }

  bool merge_diamonds() {
    bool merged = false;
    bool found = true;
    while (found) {
      found = false;
      for (AVert* v : all_vertices())
        if (v->id != -1 && merge_diamond(v)) {
          merged = true;
          found = true;
          break;
        }
    }
    return merged;
  }

  bool merge_tail(AVert* vertex) {
    std::vector<AVert*> tails;
    for (AEdge* e : outs(vertex)) tails.push_back(e->nbr);
    if (tails.size() <= 1) return false;
    for (AVert* t : tails)
      if (out_degree(t) != 0 || in_degree(t) > 1) return false;
    std::string prefix, suffix;
    common_prefix_suffix(tails, &prefix, &suffix);
    if ((int64_t)suffix.size() < 10) return false;
    AVert* prefix_vertex = vertex;
    if (!prefix.empty()) prefix_vertex = detach_top(vertex, prefix);
    AVert* suffix_vertex = make_vert(suffix);
    add_vertex(suffix_vertex);
    int64_t multiplicity = 0;
    bool any_ref = false;
    for (AVert* tail : tails) {
      std::string remaining =
          without_prefix_suffix(tail->bases, prefix.size(), suffix.size());
      if (!remaining.empty()) {
        tail->bases = remaining;
      } else {
        AEdge* incoming = tail->in[0];
        if (incoming->is_ref) any_ref = true;
        multiplicity += incoming->mult;
        remove_edge(prefix_vertex, tail);
      }
    }
    if (multiplicity > 0)
      add_edge(prefix_vertex, suffix_vertex, multiplicity, any_ref);
    return true;
  }

  bool merge_tails() {
    bool merged = false;
    bool found = true;
    while (found) {
      found = false;
      for (AVert* v : all_vertices())
        if (v->id != -1 && merge_tail(v)) {
          merged = true;
          found = true;
          break;
        }
    }
    return merged;
  }

  bool safe_to_split(const AVert* bottom, const std::vector<AVert*>& tops) const {
    const auto& bottom_connections = outs(bottom);
    for (const AVert* top : tops) {
      if (top->id == bottom->id) return false;
      const auto& middle_edges = outs(top);
      if (middle_edges.size() != 1 || middle_edges[0]->nbr != bottom)
        return false;
      for (const AEdge* e : bottom_connections)
        if (e->nbr->id == top->id) return false;
    }
    return true;
  }

  bool common_suffix_of(const AVert* vertex, const std::vector<AVert*>& tops,
                        std::string* out) const {
    if (tops.size() < 2 || !safe_to_split(vertex, tops)) return false;
    int64_t mn = INT64_MAX;
    for (const AVert* v : tops) mn = std::min(mn, (int64_t)v->bases.size());
    int64_t slen = 0;
    for (int64_t i = 1; i <= mn; i++) {
      const char c = tops[0]->bases[tops[0]->bases.size() - i];
      bool diff = false;
      for (size_t k = 1; k < tops.size(); k++)
        if (tops[k]->bases[tops[k]->bases.size() - i] != c) {
          diff = true;
          break;
        }
      if (diff) break;
      slen++;
    }
    if (slen == 0) return false;
    std::string suffix = tops[0]->bases.substr(tops[0]->bases.size() - slen);
    const AVert* ref_source = nullptr;
    for (const AVert* t : tops)
      if (vertex_is_reference_source(t)) {
        ref_source = t;
        break;
      }
    if (ref_source != nullptr && ref_source->bases.size() == suffix.size())
      return false;
    bool all_eq = true;
    for (const AVert* t : tops)
      if (t->bases.size() != suffix.size()) {
        all_eq = false;
        break;
      }
    if (all_eq) return false;
    *out = std::move(suffix);
    return true;
  }

  bool split_common_suffixes_of_vertex(AVert* vertex) {
    std::vector<AEdge*> incoming_edges = inns(vertex);  // copy like list()
    std::vector<AVert*> tops;
    for (AEdge* e : incoming_edges) tops.push_back(e->nbr);
    std::string suffix;
    if (!common_suffix_of(vertex, tops, &suffix)) return false;
    for (AEdge* top_edge : incoming_edges) {
      AVert* top = top_edge->nbr;
      AEdge* out = top->out[0];
      const int64_t top_multiplicity = top_edge->mult;
      const bool out_is_ref = out->is_ref;
      AVert* suffix_vertex = make_vert(suffix);
      add_vertex(suffix_vertex);
      std::string remaining =
          top->bases.size() >= suffix.size()
              ? top->bases.substr(0, top->bases.size() - suffix.size())
              : std::string();
      AVert* target_vertex;
      if (remaining.empty()) {
        target_vertex = suffix_vertex;
      } else {
        target_vertex = make_vert(remaining);
        add_vertex(target_vertex);
        add_edge(target_vertex, suffix_vertex, 1, out_is_ref);
      }
      add_edge(suffix_vertex, vertex, top_multiplicity, out_is_ref);
      for (AEdge* e : inns(top))
        add_edge(e->nbr, target_vertex, e->mult, e->is_ref);
      remove_vertex(top);
    }
    return true;
  }

  bool split_common_suffixes() {
    bool split = false;
    std::unordered_set<const AVert*> already;
    bool found = true;
    while (found) {
      found = false;
      for (AVert* v : all_vertices()) {
        if (v->id != -1 && !already.count(v)) {
          already.insert(v);
          if (split_common_suffixes_of_vertex(v)) {
            split = true;
            found = true;
            break;
          }
        }
      }
    }
    return split;
  }

  bool merge_common_sequences(AVert* bottom) {
    std::vector<AVert*> tops;
    for (AEdge* e : inns(bottom)) tops.push_back(e->nbr);
    if (tops.empty()) return false;
    const std::string seq = tops[0]->bases;
    for (AVert* top : tops) {
      if (top->bases != seq || out_degree(top) != 1 || in_degree(top) == 0 ||
          outs(top)[0]->nbr != bottom)
        return false;
    }
    bottom->bases = seq + bottom->bases;
    update_vertex_id(bottom);
    for (AVert* top : tops) {
      std::vector<AEdge*> top_in = inns(top);  // copy: remove_vertex mutates
      for (AEdge* e : top_in)
        add_edge(e->nbr, bottom, e->mult, e->is_ref);
      remove_vertex(top);
    }
    for (AEdge* e : outs(bottom)) {
      auto& incoming = e->nbr->in;
      for (size_t i = 0; i < incoming.size(); i++) {
        if (incoming[i]->nbr == bottom) {
          AEdge* ie = incoming[i];
          incoming.erase(incoming.begin() + i);
          incoming.push_back(ie);
          break;
        }
      }
    }
    return true;
  }

  bool merge_common_incoming_sequences() {
    bool merged = false;
    bool found = true;
    while (found) {
      found = false;
      for (AVert* v : all_vertices())
        if (v->id != -1 && merge_common_sequences(v)) {
          merged = true;
          found = true;
          break;
        }
    }
    return merged;
  }

  bool simplify_once() {
    bool modified = false;
    if (merge_diamonds()) modified = true;
    if (merge_tails()) modified = true;
    if (split_common_suffixes()) modified = true;
    if (merge_common_incoming_sequences()) modified = true;
    if (merge_linear_chains()) modified = true;
    return modified;
  }

  struct PartialCopy {
    size_t n_vertices;
    std::set<std::string> vertex_bases;
    std::vector<std::pair<int64_t, int64_t>> out_pairs, in_pairs;
  };

  PartialCopy partial_copy() const {
    PartialCopy pc;
    pc.n_vertices = vertices.size();
    for (const auto& kv : vertices) {
      pc.vertex_bases.insert(kv.second->bases);
      for (const AEdge* e : kv.second->out)
        pc.out_pairs.emplace_back(kv.first, e->nbr->id);
      for (const AEdge* e : kv.second->in)
        pc.in_pairs.emplace_back(kv.first, e->nbr->id);
    }
    std::sort(pc.out_pairs.begin(), pc.out_pairs.end());
    std::sort(pc.in_pairs.begin(), pc.in_pairs.end());
    return pc;
  }

  static bool partial_equal(const PartialCopy& a, const PartialCopy& b) {
    if (a.n_vertices != b.n_vertices || a.out_pairs.size() != b.out_pairs.size() ||
        a.in_pairs.size() != b.in_pairs.size())
      return false;
    // a.vertex_bases <= b.vertex_bases (subset)
    for (const auto& s : a.vertex_bases)
      if (!b.vertex_bases.count(s)) return false;
    return a.out_pairs == b.out_pairs && a.in_pairs == b.in_pairs;
  }

  void simplify() {
    merge_linear_chains();
    for (int i = 0; i < 7; i++)
      if (!simplify_once()) return;
    PartialCopy prev = partial_copy();
    for (int i = 7; i < 101; i++) {
      if (!simplify_once()) return;
      PartialCopy cur = partial_copy();
      if (partial_equal(prev, cur)) return;
      prev = std::move(cur);
    }
  }

  void clean_sequence_graph() {
    merge_linear_chains();
    remove_non_reference_components();
    simplify();
    remove_non_reference_components();
    simplify();
    if (vertices.size() == 1) {
      AVert* vertex = vertices.begin()->second;
      AVert* dummy = make_vert(std::string());
      add_vertex(dummy);
      add_edge(vertex, dummy, 0, true);
    }
  }

  // -- k-best haplotypes (binary max-heap mirroring assembly.py) --

  struct HeapItem {
    double score;
    std::vector<AVert*> path;
  };

  void add_best_haplotypes(std::vector<std::pair<double, std::string>>& results) {
    AVert* source = reference_source();
    AVert* sink = reference_sink();
    std::vector<HeapItem> pq;
    auto sift_up = [&](size_t k, HeapItem x) {
      while (k > 0) {
        const size_t parent = (k - 1) >> 1;
        if (x.score <= pq[parent].score) break;
        pq[k] = std::move(pq[parent]);
        k = parent;
      }
      pq[k] = std::move(x);
    };
    auto enqueue = [&](HeapItem x) {
      if (pq.empty()) {
        pq.push_back(std::move(x));
        return;
      }
      pq.emplace_back();
      sift_up(pq.size() - 1, std::move(x));
    };
    auto sift_down = [&](size_t k, HeapItem x) {
      const size_t half = pq.size() >> 1;
      while (k < half) {
        size_t child = (k << 1) + 1;
        const size_t right = child + 1;
        if (right < pq.size() && pq[child].score < pq[right].score) child = right;
        if (x.score >= pq[child].score) break;
        pq[k] = std::move(pq[child]);
        k = child;
      }
      pq[k] = std::move(x);
    };
    auto dequeue = [&]() -> HeapItem {
      const size_t s = pq.size() - 1;
      HeapItem top = std::move(pq[0]);
      HeapItem x = std::move(pq.back());
      pq.pop_back();
      if (s != 0) sift_down(0, std::move(x));
      return top;
    };
    enqueue(HeapItem{0.0, {source}});
    std::unordered_map<const AVert*, int> vertex_counts;
    while (!pq.empty() && (int)results.size() < MAX_HAPLOTYPES) {
      HeapItem item = dequeue();
      AVert* vertex_to_extend = item.path.back();
      if (vertex_to_extend == sink) {
        std::string bases;
        for (const AVert* v : item.path) bases += v->bases;
        results.emplace_back(item.score, std::move(bases));
        continue;
      }
      const int count = vertex_counts[vertex_to_extend]++;
      if (count >= MAX_HAPLOTYPES) continue;
      const auto& edges = outs(vertex_to_extend);
      int64_t total = 0;
      for (const AEdge* e : edges) total += e->mult;
      if (total <= 0) continue;
      const double total_log10 = std::log10((double)total);
      for (const AEdge* e : edges) {
        double ext;
        if (e->mult > 0)
          ext = item.score + std::log10((double)e->mult) - total_log10;
        else
          ext = -INFINITY;
        std::vector<AVert*> np = item.path;
        np.push_back(e->nbr);
        enqueue(HeapItem{ext, std::move(np)});
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C interface: one process_kmer_size attempt.
//   returns number of candidate haplotypes (>= 0) on success,
//   -1 when the attempt fails (like process_kmer_size -> False),
//   -2 when out_bases_cap is too small (caller retries with more).
// ---------------------------------------------------------------------------

extern "C" long long assembly_try(
    const uint8_t* ref, long long ref_len,
    const uint8_t* seq_concat, const uint8_t* qual_concat,
    const long long* read_offs, long long n_reads,
    int kmer_size, int min_base_qual, int last_attempt,
    double* out_scores, uint8_t* out_bases, long long out_bases_cap,
    long long* out_base_offs) {
  // non_unique_kmers_exist(reference) gate (assembly.py:1289)
  if (!last_attempt) {
    bool nuk = false;
    if (kmer_size <= 32) {
      const uint64_t mask =
          kmer_size == 32 ? ~0ULL : ((1ULL << (2 * kmer_size)) - 1);
      std::unordered_set<uint64_t, U64Hash> seen_u64;
      std::unordered_set<std::string> seen_str;
      KmerRoll roll;
      for (long long i = 0; i < kmer_size - 1 && i < ref_len; i++)
        roll.feed(i, ref[i]);
      for (long long e = kmer_size - 1; e < ref_len && !nuk; e++) {
        roll.feed(e, ref[e]);
        if (roll.window_ok(e, kmer_size)) {
          nuk = !seen_u64.insert(roll.code(mask)).second;
        } else {
          std::string km((const char*)ref + e - kmer_size + 1, kmer_size);
          nuk = !seen_str.insert(km).second;
        }
      }
    } else {
      std::unordered_set<std::string> seen;
      for (long long i = 0; i + kmer_size <= ref_len; i++) {
        std::string km((const char*)ref + i, kmer_size);
        if (!seen.insert(km).second) {
          nuk = true;
          break;
        }
      }
    }
    if (nuk) return -1;
  }
  Graph graph(kmer_size);
  std::vector<Kseq> seqs;
  seqs.push_back(Kseq{ref, ref_len, 0, ref_len, true});
  // add_sequences_for_kmers per read (assembly.py:1248-1262)
  for (long long r = 0; r < n_reads; r++) {
    const long long s0 = read_offs[r], s1 = read_offs[r + 1];
    const uint8_t* seq = seq_concat + s0;
    const uint8_t* qual = qual_concat + s0;
    const long long len = s1 - s0;
    long long start = -1;
    for (long long stop = 0; stop < len; stop++) {
      const bool usable = seq[stop] != 'N' && qual[stop] >= min_base_qual;
      if (!usable) {
        if (start != -1 && stop - start >= kmer_size)
          seqs.push_back(Kseq{seq, len, start, stop, false});
        start = -1;
      } else if (start == -1) {
        start = stop;
      }
    }
    if (start != -1 && len - start >= kmer_size)
      seqs.push_back(Kseq{seq, len, start, len, false});
  }
  for (const Kseq& s : seqs) graph.determine_non_unique_kmers(s);
  const std::string ref_source((const char*)ref, kmer_size);
  for (const Kseq& s : seqs) {
    const long long unique_start = graph.find_start_of_kmers(s);
    if (unique_start == -1) continue;
    AVert* vertex = graph.get_kmer_vertex(s, unique_start);
    graph.increase_counts_matched_kmers(s, vertex);
    for (long long i = unique_start + 1; i <= s.stop - kmer_size; i++)
      vertex = graph.extend_chain_by_one(ref_source, vertex, s, i);
  }
  if (graph.vertices.empty()) return -1;
  graph.prune_chains_with_low_weight();
  if (graph.vertices.empty() || graph.has_cycle()) return -1;
  if (!last_attempt && graph.is_low_complexity()) return -1;
  graph.recover_dangling_tails();
  graph.recover_dangling_heads(kmer_size);
  graph.remove_paths_not_connected_to_reference();
  graph.convert_to_sequence_graph();
  graph.clean_sequence_graph();
  std::vector<std::pair<double, std::string>> results;
  graph.add_best_haplotypes(results);
  long long off = 0;
  out_base_offs[0] = 0;
  for (size_t i = 0; i < results.size(); i++) {
    out_scores[i] = results[i].first;
    const std::string& b = results[i].second;
    if (off + (long long)b.size() > out_bases_cap) return -2;
    memcpy(out_bases + off, b.data(), b.size());
    off += (long long)b.size();
    out_base_offs[i + 1] = off;
  }
  return (long long)results.size();
}
