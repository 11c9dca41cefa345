// Native runtime components: parallel BGZF codec and SAM tokenizer.
//
// The reference gets its I/O throughput from goroutine pipelines over
// Go's flate (reference: utils/bgzf/bgzf-files.go, sam/sam-files.go).
// Here the equivalents are C++ with std::thread fan-out over zlib,
// exposed through a plain C ABI consumed via ctypes — these feed the
// TPU host pipeline so device compute is never starved by parsing.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <atomic>
#include <zlib.h>
#include <functional>
#include <algorithm>
#if defined(_OPENMP)
#include <parallel/algorithm>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

struct BgzfBlock {
  size_t in_off;     // offset of gzip member
  size_t in_size;    // bsize
  size_t payload_off;
  size_t payload_size;
  size_t out_off;    // offset in output buffer
  size_t out_size;   // isize
};

// Frame all blocks; returns number of blocks, or -1 on error.
// out arrays must hold max_blocks entries.
static int frame_blocks(const uint8_t* data, size_t n, std::vector<BgzfBlock>& blocks) {
  size_t pos = 0;
  size_t out_off = 0;
  while (pos < n) {
    if (pos + 18 > n || data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
    uint8_t flg = data[pos + 3];
    if (!(flg & 4)) return -1;
    uint16_t xlen = (uint16_t)(data[pos + 10] | (data[pos + 11] << 8));
    size_t xpos = pos + 12, xend = xpos + xlen;
    if (xend > n) return -1;
    long bsize = -1;
    while (xpos + 4 <= xend) {
      uint8_t si1 = data[xpos], si2 = data[xpos + 1];
      uint16_t slen = (uint16_t)(data[xpos + 2] | (data[xpos + 3] << 8));
      if (si1 == 0x42 && si2 == 0x43 && slen == 2)
        bsize = (long)(data[xpos + 4] | (data[xpos + 5] << 8)) + 1;
      xpos += 4 + slen;
    }
    if (bsize < 0 || pos + (size_t)bsize > n) return -1;
    if ((size_t)bsize < (size_t)12 + xlen + 8) return -1;  // corrupt BC field would underflow payload_size
    size_t payload_off = pos + 12 + xlen;
    size_t payload_size = (size_t)bsize - (12 + xlen) - 8;
    uint32_t isize;
    memcpy(&isize, data + pos + bsize - 4, 4);
    BgzfBlock b{pos, (size_t)bsize, payload_off, payload_size, out_off, isize};
    blocks.push_back(b);
    out_off += isize;
    pos += bsize;
  }
  return (int)blocks.size();
}

// Decompressed size of a whole BGZF buffer; -1 on framing error.
long long bgzf_decompressed_size(const uint8_t* data, size_t n) {
  std::vector<BgzfBlock> blocks;
  if (frame_blocks(data, n, blocks) < 0) return -1;
  size_t total = 0;
  for (auto& b : blocks) total += b.out_size;
  return (long long)total;
}

// Decompress all blocks in parallel into out (size must equal
// bgzf_decompressed_size). Returns 0 ok, nonzero error.
int bgzf_decompress(const uint8_t* data, size_t n, uint8_t* out, size_t out_n,
                    int n_threads) {
  std::vector<BgzfBlock> blocks;
  if (frame_blocks(data, n, blocks) < 0) return 1;
  size_t total = 0;
  for (auto& b : blocks) total += b.out_size;
  if (total != out_n) return 2;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > (int)blocks.size()) n_threads = (int)blocks.size();
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || err.load()) return;
      const BgzfBlock& b = blocks[i];
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) { err.store(3); return; }
      zs.next_in = const_cast<Bytef*>(data + b.payload_off);
      zs.avail_in = (uInt)b.payload_size;
      zs.next_out = out + b.out_off;
      zs.avail_out = (uInt)b.out_size;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END || zs.total_out != b.out_size) { err.store(4); return; }
      uint32_t crc = (uint32_t)crc32(0L, out + b.out_off, (uInt)b.out_size);
      uint32_t want;
      memcpy(&want, data + b.in_off + b.in_size - 8, 4);
      if (crc != want) { err.store(5); return; }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

// Compress data into BGZF blocks (64KB chunks). out must be at least
// bgzf_compress_bound(n). Returns output length or -1.
size_t bgzf_compress_bound(size_t n) {
  size_t chunks = n / 65536 + 2;
  return n + chunks * (18 + 8 + 64) + 4096 + n / 64;
}

long long bgzf_compress(const uint8_t* data, size_t n, uint8_t* out, size_t out_cap,
                        int level, int n_threads, int append_eof) {
  const size_t CHUNK = 65536;
  size_t n_chunks = (n + CHUNK - 1) / CHUNK;
  if (n == 0) n_chunks = 0;
  std::vector<std::vector<uint8_t>> results(n_chunks);
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > (int)n_chunks) n_threads = (int)n_chunks;
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<int> err(0);
  std::function<int(const uint8_t*, size_t, std::vector<uint8_t>&)> compress_chunk =
      [&](const uint8_t* src, size_t len, std::vector<uint8_t>& dst) -> int {
    // deflate; if the block would exceed 65536 total, halve recursively
    std::vector<uint8_t> payload(compressBound((uLong)len) + 64);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
      return 3;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = (uInt)len;
    zs.next_out = payload.data();
    zs.avail_out = (uInt)payload.size();
    int r = deflate(&zs, Z_FINISH);
    size_t psize = zs.total_out;
    deflateEnd(&zs);
    if (r != Z_STREAM_END) return 4;
    size_t bsize = psize + 12 + 6 + 8;
    if (bsize > 65536) {
      std::vector<uint8_t> left, right;
      size_t half = len / 2;
      int e = compress_chunk(src, half, left);
      if (e) return e;
      e = compress_chunk(src + half, len - half, right);
      if (e) return e;
      dst = std::move(left);
      dst.insert(dst.end(), right.begin(), right.end());
      return 0;
    }
    dst.resize(bsize);
    uint8_t* p = dst.data();
    const uint8_t hdr[16] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0, 'B', 'C', 2, 0};
    memcpy(p, hdr, 16);
    uint16_t bs16 = (uint16_t)(bsize - 1);
    memcpy(p + 16, &bs16, 2);
    memcpy(p + 18, payload.data(), psize);
    uint32_t crc = (uint32_t)crc32(0L, src, (uInt)len);
    uint32_t is = (uint32_t)len;
    memcpy(p + 18 + psize, &crc, 4);
    memcpy(p + 18 + psize + 4, &is, 4);
    return 0;
  };
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks || err.load()) return;
      size_t off = i * CHUNK;
      size_t len = (off + CHUNK <= n) ? CHUNK : n - off;
      int e = compress_chunk(data + off, len, results[i]);
      if (e) { err.store(e); return; }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  if (err.load()) return -1;
  static const uint8_t EOF_BLOCK[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
      0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
      0x00, 0x00, 0x00, 0x00};
  size_t pos = 0;
  for (auto& r : results) {
    if (pos + r.size() > out_cap) return -2;
    memcpy(out + pos, r.data(), r.size());
    pos += r.size();
  }
  if (append_eof) {
    if (pos + 28 > out_cap) return -2;
    memcpy(out + pos, EOF_BLOCK, 28);
    pos += 28;
  }
  return (long long)pos;
}

// ---------------------------------------------------------------------------
// SAM tokenizer: one pass over alignment lines, producing fixed columns
// and field byte ranges for ragged columns (reference parser semantics:
// sam/sam-files.go:386-410).
// ---------------------------------------------------------------------------

// For n lines, fills:
//   flag,pos,mapq,pnext,tlen      int32[n] (parsed in C)
//   starts/ends for qname(0), rname(1), cigar(2), rnext(3), seq(4),
//   qual(5), tags(6): int64[n] each (offsets into data; tags may be
//   empty with start==end)
// Returns number of lines parsed, or -1-errpos on parse error.
static long long sam_tokenize_range(
    const uint8_t* data, size_t n, size_t start, long long line0,
    long long line_stop, long long max_lines,
    int32_t* flag, int32_t* pos, int32_t* mapq, int32_t* pnext,
    int32_t* tlen, int64_t* f_start, int64_t* f_end) {
  size_t p = start;
  long long line = line0;
  while (p < n && line < line_stop) {
    // field 0: qname
    size_t fs[12], fe[12];
    int field = 0;
    fs[0] = p;
    while (p < n) {
      uint8_t c = data[p];
      if (c == '\t') {
        fe[field] = p;
        field++;
        p++;
        if (field < 11) {
          fs[field] = p;
          continue;
        } else {
          fs[11] = p;  // tags start
          // scan to end of line
          while (p < n && data[p] != '\n') p++;
          fe[11] = p;
          break;
        }
      } else if (c == '\n') {
        fe[field] = p;
        break;
      }
      p++;
    }
    if (p == n && field < 11) fe[field] = p;  // EOF terminates the final line
    if (field < 10) return -1 - (long long)p;  // missing tabulator
    size_t tags_s, tags_e;
    if (field >= 11) {
      tags_s = fs[11];
      tags_e = fe[11];
    } else {
      // exactly 11 fields, no tags; last field ended at newline
      tags_s = tags_e = fe[10];
    }
    // integer parses
    auto parse_i32 = [&](size_t s, size_t e, int32_t* out_v) -> bool {
      int64_t v = 0;
      bool neg = false;
      size_t i = s;
      if (i < e && (data[i] == '-' || data[i] == '+')) { neg = data[i] == '-'; i++; }
      if (i == e) return false;
      for (; i < e; i++) {
        if (data[i] < '0' || data[i] > '9') return false;
        v = v * 10 + (data[i] - '0');
        if (v > 4294967295LL) return false;
      }
      *out_v = (int32_t)(neg ? -v : v);
      return true;
    };
    if (!parse_i32(fs[1], fe[1], flag + line)) return -1 - (long long)fs[1];
    if (!parse_i32(fs[3], fe[3], pos + line)) return -1 - (long long)fs[3];
    if (!parse_i32(fs[4], fe[4], mapq + line)) return -1 - (long long)fs[4];
    if (!parse_i32(fs[7], fe[7], pnext + line)) return -1 - (long long)fs[7];
    if (!parse_i32(fs[8], fe[8], tlen + line)) return -1 - (long long)fs[8];
    // ragged ranges: qname, rname, cigar, rnext, seq, qual, tags
    const int src_idx[7] = {0, 2, 5, 6, 9, 10, -1};
    for (int k = 0; k < 6; k++) {
      f_start[k * max_lines + line] = (int64_t)fs[src_idx[k]];
      f_end[k * max_lines + line] = (int64_t)fe[src_idx[k]];
    }
    f_start[6 * max_lines + line] = (int64_t)tags_s;
    f_end[6 * max_lines + line] = (int64_t)tags_e;
    line++;
    // advance past newline
    while (p < n && data[p] != '\n') p++;
    if (p < n) p++;
  }
  return line;
}

long long sam_tokenize(const uint8_t* data, size_t n, size_t start, long long max_lines,
                       int32_t* flag, int32_t* pos, int32_t* mapq, int32_t* pnext,
                       int32_t* tlen,
                       int64_t* f_start, int64_t* f_end /* [7][max_lines] flat */) {
  long long nt = (long long)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 8) nt = 8;
  if (nt == 1 || max_lines < 65536 || n - start < (size_t)(1 << 22)) {
    return sam_tokenize_range(data, n, start, 0, max_lines, max_lines,
                              flag, pos, mapq, pnext, tlen, f_start, f_end);
  }
  // Parallel framing: split at newline boundaries (every line starting
  // before a boundary ends at or before it, so per-range tokenization
  // sees exactly the sequential framing). Two parallel passes: newline
  // counts -> line offsets, then range tokenization. Error reporting
  // matches the sequential scan: the smallest error position is the
  // first error it would have hit.
  std::vector<size_t> bounds(nt + 1);
  bounds[0] = start;
  bounds[nt] = n;
  const size_t span = (n - start) / (size_t)nt;
  for (long long t = 1; t < nt; t++) {
    size_t b = start + span * (size_t)t;
    while (b < n && data[b - 1] != '\n') b++;
    bounds[t] = b;
  }
  for (long long t = 1; t < nt; t++)
    if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
  std::vector<long long> counts(nt, 0);
  {
    std::vector<std::thread> ths;
    for (long long t = 0; t < nt; t++) {
      ths.emplace_back([&, t]() {
        long long c = 0;
        const uint8_t* q = data + bounds[t];
        const uint8_t* e = data + bounds[t + 1];
        while (q < e) {
          const uint8_t* nl = (const uint8_t*)memchr(q, '\n', (size_t)(e - q));
          if (nl == nullptr) break;
          c++;
          q = nl + 1;
        }
        if (t == nt - 1 && n > start && data[n - 1] != '\n') c++;  // unterminated tail line
        counts[t] = c;
      });
    }
    for (auto& th : ths) th.join();
  }
  std::vector<long long> line0(nt + 1, 0);
  for (long long t = 0; t < nt; t++) line0[t + 1] = line0[t] + counts[t];
  if (line0[nt] > max_lines) line0[nt] = max_lines;
  std::vector<long long> results(nt, 0);
  {
    std::vector<std::thread> ths;
    for (long long t = 0; t < nt; t++) {
      ths.emplace_back([&, t]() {
        long long stop = line0[t] + counts[t];
        if (stop > max_lines) stop = max_lines;
        results[t] = sam_tokenize_range(
            data, bounds[t + 1], bounds[t], line0[t], stop, max_lines,
            flag, pos, mapq, pnext, tlen, f_start, f_end);
      });
    }
    for (auto& th : ths) th.join();
  }
  long long err_pos = -1;  // smallest error position across ranges
  long long total = 0;
  for (long long t = 0; t < nt; t++) {
    if (results[t] < 0) {
      const long long ep = -1 - results[t];
      if (err_pos < 0 || ep < err_pos) err_pos = ep;
    } else if (results[t] > total) {
      total = results[t];
    }
  }
  if (err_pos >= 0) return -1 - err_pos;
  // A range whose line0 already sits at/past max_lines parses nothing
  // but still reports line0: clamp so the contract (result <=
  // max_lines) holds even for callers that size max_lines below the
  // input's true line count.
  if (total > max_lines) total = max_lines;
  return total;
}

// Parallel flat memcpy: first-touch faults on fresh (tmpfs/anon) pages
// are the dominant cost of large destination buffers on this host class
// (CLAUDE.md: 40 MB/s-1.4 GB/s single-thread, erratic) and they
// parallelize across cores.
extern "C" void parallel_memcpy(uint8_t* dst, const uint8_t* src,
                                long long n, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n < (4 << 20) || n_threads == 1) {
    memcpy(dst, src, (size_t)n);
    return;
  }
  std::vector<std::thread> ths;
  long long chunk = (n + n_threads - 1) / n_threads;
  chunk = (chunk + 4095) & ~4095LL;  // page-align the splits
  for (int t = 0; t < n_threads; t++) {
    long long lo = (long long)t * chunk;
    if (lo >= n) break;
    long long hi = lo + chunk < n ? lo + chunk : n;
    ths.emplace_back([=]() { memcpy(dst + lo, src + lo, (size_t)(hi - lo)); });
  }
  for (auto& th : ths) th.join();
}

// Dense lexicographic ranks of fixed-width byte rows (numpy 'S' array
// semantics: rows compare as their full null-padded width, which equals
// name-then-length order because qnames contain no NULs). Equal rows
// share a rank; ranks are 0..n_distinct-1 in sorted order. Oracle:
// np.unique(arr, return_inverse=True)[1] (ops/sortkeys.qname_ranks).
extern "C" void qname_ranks_fixed(const uint8_t* data, long long n,
                                  long long width, int* out_rank) {
  std::vector<int> idx((size_t)n);
  for (long long i = 0; i < n; i++) idx[(size_t)i] = (int)i;
  auto cmp = [&](int a, int b) {
    return memcmp(data + (size_t)a * width, data + (size_t)b * width,
                  (size_t)width) < 0;
  };
#if defined(_OPENMP)
  __gnu_parallel::stable_sort(idx.begin(), idx.end(), cmp);
#else
  std::stable_sort(idx.begin(), idx.end(), cmp);
#endif
  int r = -1;
  const uint8_t* prev = nullptr;
  for (long long i = 0; i < n; i++) {
    const uint8_t* cur = data + (size_t)idx[(size_t)i] * width;
    if (prev == nullptr || memcmp(prev, cur, (size_t)width) != 0) r++;
    out_rank[idx[(size_t)i]] = r;
    prev = cur;
  }
}

// Count alignment lines from `start`.
long long sam_count_lines(const uint8_t* data, size_t n, size_t start) {
  long long count = 0;
  for (size_t p = start; p < n; p++)
    if (data[p] == '\n') count++;
  if (n > start && data[n - 1] != '\n') count++;
  return count;
}

}  // extern "C"

extern "C" {

// Parallel ragged gather: out[k] = data[src_index(k)] where rows are
// (starts[i], ends[i]) ranges concatenated. out_offsets[i] gives the
// output offset of row i (precomputed prefix sums, n+1 entries).
void ranged_gather_u8(const uint8_t* data, const int64_t* starts,
                      const int64_t* ends, const int64_t* out_offsets,
                      int64_t n_rows, uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        int64_t len = ends[i] - starts[i];
        if (len > 0) memcpy(out + out_offsets[i], data + starts[i], (size_t)len);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Parallel ragged scatter: copy row i of (src + src_offsets[i], len)
// into out + dst_starts[i].
void ranged_scatter_u8(const uint8_t* src, const int64_t* src_offsets,
                       const int64_t* dst_starts, int64_t n_rows,
                       uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        int64_t len = src_offsets[i + 1] - src_offsets[i];
        if (len > 0) memcpy(out + dst_starts[i], src + src_offsets[i], (size_t)len);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Parallel pad: rows (flat + offsets) -> dense [n_rows, width] with fill,
// elem_size bytes per element.
void ragged_to_padded(const uint8_t* data, const int64_t* offsets,
                      int64_t n_rows, int64_t width, int64_t elem_size,
                      uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        if (len > width) len = width;
        if (len > 0)
          memcpy(out + i * width * elem_size, data + offsets[i] * elem_size,
                 (size_t)(len * elem_size));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ragged_to_padded with the fill fused in: each row copies its prefix
// and memsets its tail in the same parallel pass (the Python-side
// np.full pre-fill this replaces serialized the destination's
// first-touch faults — ~4 s per worker at 4M reads in a bad
// fault-rate window). fill_byte repeats across the element bytes, so
// callers must pass byte-uniform fill values (all current fills are).
void ragged_to_padded_fillb(const uint8_t* data, const int64_t* offsets,
                            int64_t n_rows, int64_t width, int64_t elem_size,
                            int fill_byte, uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 2048;
  const int64_t row_bytes = width * elem_size;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        if (len > width) len = width;
        if (len < 0) len = 0;
        uint8_t* dst = out + i * row_bytes;
        if (len > 0)
          memcpy(dst, data + offsets[i] * elem_size,
                 (size_t)(len * elem_size));
        if (len < width)
          memset(dst + len * elem_size, fill_byte,
                 (size_t)((width - len) * elem_size));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Parallel unpad (inverse of ragged_to_padded): dense [n_rows, width]
// rows -> flat ragged buffer at offsets, elem_size bytes per element.
// Rows longer than width keep their tail bytes untouched in `out`.
void padded_to_ragged(const uint8_t* data, const int64_t* offsets,
                      int64_t n_rows, int64_t width, int64_t elem_size,
                      uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        if (len > width) len = width;
        if (len > 0)
          memcpy(out + offsets[i] * elem_size, data + i * width * elem_size,
                 (size_t)(len * elem_size));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Parallel BAM SEQ nibble packing: row i of (data + offsets) holds ASCII
// bases; emit (len+1)/2 packed bytes at out + out_offsets[i], high nibble
// first, odd trailing low nibble zero (reference: sam/bam-files.go nibble
// table writeback).
void pack_nibbles_u8(const uint8_t* data, const int64_t* offsets,
                     const uint8_t* table, const int64_t* out_offsets,
                     int64_t n_rows, uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        const uint8_t* src = data + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        uint8_t* dst = out + out_offsets[i];
        int64_t j = 0;
        for (; j + 1 < len; j += 2)
          dst[j >> 1] = (uint8_t)((table[src[j]] << 4) | table[src[j + 1]]);
        if (j < len) dst[j >> 1] = (uint8_t)(table[src[j]] << 4);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"

extern "C" {

// Convert canonical SAM tag text rows to BAM binary tag blocks.
// In: flat text (rows at offsets[i]..offsets[i+1]).
// Out: bin buffer (caller-sized via sam_tags_bin_bound), out_offsets[n+1].
// Returns 0 ok, nonzero = error at row ~(-rc-1).
static int tags_row_to_bam(const uint8_t* s, int64_t len, uint8_t* out,
                           int64_t* out_len) {
  int64_t o = 0;
  int64_t i = 0;
  while (i < len) {
    // field: TG:T:VALUE up to tab or end
    int64_t fend = i;
    while (fend < len && s[fend] != '\t') fend++;
    if (fend - i < 5) return 1;
    out[o++] = s[i];
    out[o++] = s[i + 1];
    uint8_t typ = s[i + 3];
    const uint8_t* val = s + i + 5;
    int64_t vlen = fend - i - 5;
    if (typ == 'A') {
      out[o++] = 'A';
      out[o++] = vlen > 0 ? val[0] : 0;
    } else if (typ == 'i') {
      long long v = 0;
      bool neg = false;
      int64_t k = 0;
      if (vlen > 0 && (val[0] == '-' || val[0] == '+')) { neg = val[0] == '-'; k++; }
      for (; k < vlen; k++) {
        if (val[k] < '0' || val[k] > '9') return 2;
        v = v * 10 + (val[k] - '0');
      }
      if (neg) v = -v;
      if (v < 0) {
        if (v >= -128) { out[o++] = 'c'; out[o++] = (uint8_t)(int8_t)v; }
        else if (v >= -32768) { out[o++] = 's'; int16_t x = (int16_t)v; memcpy(out + o, &x, 2); o += 2; }
        else if (v >= -2147483648LL) { out[o++] = 'i'; int32_t x = (int32_t)v; memcpy(out + o, &x, 4); o += 4; }
        else return 3;
      } else {
        if (v <= 0xFF) { out[o++] = 'C'; out[o++] = (uint8_t)v; }
        else if (v <= 0xFFFF) { out[o++] = 'S'; uint16_t x = (uint16_t)v; memcpy(out + o, &x, 2); o += 2; }
        else if (v <= 0xFFFFFFFFLL) { out[o++] = 'I'; uint32_t x = (uint32_t)v; memcpy(out + o, &x, 4); o += 4; }
        else return 3;
      }
    } else if (typ == 'f') {
      float f = strtof((const char*)val, nullptr);
      out[o++] = 'f';
      memcpy(out + o, &f, 4);
      o += 4;
    } else if (typ == 'Z') {
      out[o++] = 'Z';
      memcpy(out + o, val, (size_t)vlen);
      o += vlen;
      out[o++] = 0;
    } else if (typ == 'H') {
      out[o++] = 'H';
      for (int64_t k = 0; k < vlen; k++) {
        uint8_t c = val[k];
        if (c >= 'a' && c <= 'f') c -= 32;  // uppercase hex in BAM
        out[o++] = c;
      }
      out[o++] = 0;
    } else if (typ == 'B') {
      return -100;  // handled by the Python fallback (rare)
    } else {
      return 4;
    }
    i = fend + 1;
  }
  *out_len = o;
  return 0;
}

long long sam_tags_to_bam(const uint8_t* flat, const int64_t* offsets,
                          int64_t n_rows, uint8_t* out, int64_t out_cap,
                          int64_t* out_offsets, int64_t* fallback_rows,
                          int64_t* n_fallback, int n_threads) {
  // sequential sizing pass is fine: work per row is tiny. Rows with a
  // B-type field go to fallback_rows (converted by Python), and their
  // output slot is sized 0 here; Python re-runs the row and the final
  // assembly splices them.
  (void)n_threads;
  int64_t o = 0;
  int64_t nf = 0;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n_rows; i++) {
    int64_t len = offsets[i + 1] - offsets[i];
    int64_t row_out = 0;
    if (len > 0) {
      if (o + len * 4 + 64 > out_cap) return -1;
      int rc = tags_row_to_bam(flat + offsets[i], len, out + o, &row_out);
      if (rc == -100) {
        fallback_rows[nf++] = i;
        row_out = 0;
      } else if (rc != 0) {
        return -2 - i;
      }
    }
    o += row_out;
    out_offsets[i + 1] = o;
  }
  *n_fallback = nf;
  return o;
}

// Extract the value byte-range of a :Z: tag per row; start=end=0 if absent.
void extract_z_tag(const uint8_t* flat, const int64_t* offsets, int64_t n_rows,
                   uint8_t t0, uint8_t t1, int64_t* val_starts, int64_t* val_ends) {
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (n_rows < 65536) nt = 1;
  auto scan_rows = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; i++) {
      int64_t s = offsets[i], e = offsets[i + 1];
      val_starts[i] = 0;
      val_ends[i] = 0;
      int64_t p = s;
      while (p + 5 <= e) {
        // field starts at p
        if (flat[p] == t0 && flat[p + 1] == t1 && flat[p + 2] == ':' &&
            flat[p + 3] == 'Z' && flat[p + 4] == ':') {
          int64_t v = p + 5;
          int64_t q = v;
          while (q < e && flat[q] != '\t') q++;
          val_starts[i] = v;
          val_ends[i] = q;
          break;
        }
        while (p < e && flat[p] != '\t') p++;
        p++;
      }
    }
  };
  if (nt == 1) {
    scan_rows(0, n_rows);
    return;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++)
    ths.emplace_back(scan_rows, (n_rows * t) / nt, (n_rows * (t + 1)) / nt);
  for (auto& th : ths) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SAM text formatter (reference: sam/sam-files.go:452-598). Mirrors the
// Python formatter in io/sam.py byte-for-byte, including tag
// canonicalization quirks (B:s uint16->int16 bit-cast, Go shortest-'g'
// float32 formatting via strconv.AppendFloat(..., 'g', -1, 32)).
// ---------------------------------------------------------------------------

#include <charconv>
#include <cmath>

namespace {

inline int put_i64(int64_t v, uint8_t* out) {
  char buf[24];
  auto r = std::to_chars(buf, buf + 24, (long long)v);
  int n = (int)(r.ptr - buf);
  memcpy(out, buf, (size_t)n);
  return n;
}

// Go strconv.FormatFloat(float64(f), 'g', -1, 32) (see io/gofmt.py).
inline int go_format_f32(float f, uint8_t* out) {
  if (std::isnan(f)) { memcpy(out, "NaN", 3); return 3; }
  if (std::isinf(f)) {
    if (f > 0) { memcpy(out, "+Inf", 4); return 4; }
    memcpy(out, "-Inf", 4); return 4;
  }
  int n = 0;
  bool neg = std::signbit(f);
  float a = std::fabs(f);
  if (a == 0.0f) { if (neg) out[n++] = '-'; out[n++] = '0'; return n; }
  char sci[48];
  auto res = std::to_chars(sci, sci + 48, a, std::chars_format::scientific);
  // shortest mantissa: "d[.ddd]e±XX"
  int sn = (int)(res.ptr - sci);
  sci[sn] = 0;  // to_chars does not NUL-terminate
  char digits[40];
  int nd = 0;
  int k = 0;
  for (; k < sn && sci[k] != 'e'; k++)
    if (sci[k] != '.') digits[nd++] = sci[k];
  int exp10 = atoi(sci + k + 1);
  while (nd > 1 && digits[nd - 1] == '0') nd--;  // defensive (to_chars is shortest)
  if (neg) out[n++] = '-';
  int dp = exp10 + 1;  // value = 0.digits * 10^dp
  int exp = dp - 1;
  if (exp < -4 || exp >= 6) {  // Go shortest-'g' eprec = 6 (strconv/ftoa.go)
    out[n++] = digits[0];
    if (nd > 1) {
      out[n++] = '.';
      memcpy(out + n, digits + 1, (size_t)(nd - 1));
      n += nd - 1;
    }
    out[n++] = 'e';
    if (exp < 0) { out[n++] = '-'; exp = -exp; }
    else out[n++] = '+';
    if (exp >= 100) { out[n++] = (uint8_t)('0' + exp / 100); exp %= 100; }
    out[n++] = (uint8_t)('0' + exp / 10);
    out[n++] = (uint8_t)('0' + exp % 10);
  } else if (dp <= 0) {
    out[n++] = '0'; out[n++] = '.';
    for (int z = 0; z < -dp; z++) out[n++] = '0';
    memcpy(out + n, digits, (size_t)nd); n += nd;
  } else if (dp >= nd) {
    memcpy(out + n, digits, (size_t)nd); n += nd;
    for (int z = 0; z < dp - nd; z++) out[n++] = '0';
  } else {
    memcpy(out + n, digits, (size_t)dp); n += dp;
    out[n++] = '.';
    memcpy(out + n, digits + dp, (size_t)(nd - dp)); n += nd - dp;
  }
  return n;
}

// Parse a decimal integer; returns false on non-digit.
inline bool parse_ll(const uint8_t* s, int64_t len, long long* out) {
  if (len <= 0) return false;
  bool neg = false;
  int64_t k = 0;
  if (s[0] == '-' || s[0] == '+') { neg = s[0] == '-'; k = 1; if (len == 1) return false; }
  long long v = 0;
  for (; k < len; k++) {
    if (s[k] < '0' || s[k] > '9') return false;
    v = v * 10 + (s[k] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

// Canonicalize one optional field (io/sam.py canonicalize_tag_field).
// Returns bytes written, or -1 if the field is malformed.
inline int canon_tag_field(const uint8_t* f, int64_t flen, uint8_t* out) {
  if (flen < 5 || f[2] != ':' || f[4] != ':') return -1;
  uint8_t typ = f[3];
  const uint8_t* val = f + 5;
  int64_t vlen = flen - 5;
  int n = 0;
  if (typ == 'A' || typ == 'Z') {
    memcpy(out, f, (size_t)flen);
    return (int)flen;
  }
  out[n++] = f[0]; out[n++] = f[1]; out[n++] = ':'; out[n++] = typ; out[n++] = ':';
  if (typ == 'i') {
    long long v;
    if (!parse_ll(val, vlen, &v)) return -1;
    n += put_i64(v, out + n);
    return n;
  }
  if (typ == 'f') {
    char tmp[64];
    if (vlen <= 0 || vlen >= 60) return -1;
    memcpy(tmp, val, (size_t)vlen);
    tmp[vlen] = 0;
    char* endp = nullptr;
    float fv = strtof(tmp, &endp);
    if (endp != tmp + vlen) return -1;
    n += go_format_f32(fv, out + n);
    return n;
  }
  if (typ == 'H') {
    for (int64_t j = 0; j + 1 < vlen; j += 2) {
      int hi, lo;
      uint8_t c1 = val[j], c2 = val[j + 1];
      if (c1 >= '0' && c1 <= '9') hi = c1 - '0';
      else if (c1 >= 'a' && c1 <= 'f') hi = c1 - 'a' + 10;
      else if (c1 >= 'A' && c1 <= 'F') hi = c1 - 'A' + 10;
      else return -1;
      if (c2 >= '0' && c2 <= '9') lo = c2 - '0';
      else if (c2 >= 'a' && c2 <= 'f') lo = c2 - 'a' + 10;
      else if (c2 >= 'A' && c2 <= 'F') lo = c2 - 'A' + 10;
      else return -1;
      static const char* hex = "0123456789abcdef";
      out[n++] = (uint8_t)hex[hi];
      out[n++] = (uint8_t)hex[lo];
    }
    return n;
  }
  if (typ == 'B') {
    if (vlen < 1) return -1;
    uint8_t sub = val[0];
    out[n++] = sub;
    int64_t p = 1;
    while (p < vlen) {
      if (val[p] != ',') return -1;
      p++;
      int64_t q = p;
      while (q < vlen && val[q] != ',') q++;
      if (sub == 'f') {
        char tmp[64];
        int64_t l = q - p;
        if (l <= 0 || l >= 60) return -1;
        memcpy(tmp, val + p, (size_t)l);
        tmp[l] = 0;
        char* endp = nullptr;
        float fv = strtof(tmp, &endp);
        if (endp != tmp + l) return -1;
        out[n++] = ',';
        n += go_format_f32(fv, out + n);
      } else {
        long long v;
        if (!parse_ll(val + p, q - p, &v)) return -1;
        long long w;
        switch (sub) {
          case 'c': w = (int8_t)v; break;
          case 'C': w = (uint8_t)v; break;
          // quirk: parsed as uint16, printed as int16
          // (reference: sam/sam-files.go:263-272)
          case 's': { long long u = v & 0xFFFF; w = u >= 0x8000 ? u - 0x10000 : u; break; }
          case 'S': w = (uint16_t)v; break;
          case 'i': w = (int32_t)v; break;
          case 'I': w = (uint32_t)v; break;
          default: return -1;
        }
        out[n++] = ',';
        n += put_i64(w, out + n);
      }
      p = q;
    }
    return n;
  }
  return -1;
}

}  // namespace

extern "C" {

// Format n_rows alignment lines into out at out_offsets[i] slack slots;
// writes actual per-row lengths to out_lens. Returns 0, or -(row+1) on a
// row the caller must format via the Python fallback.
long long sam_format_alignments(
    const uint8_t* qname_flat, int64_t qname_width,
    const int32_t* flag, const int32_t* rname_id, const int32_t* pos,
    const int32_t* mapq,
    const int32_t* cig_len_flat, const uint8_t* cig_op_flat,
    const int64_t* cig_offsets,
    const int32_t* rnext_id, const int32_t* pnext, const int32_t* tlen,
    const uint8_t* seq_flat, const int64_t* seq_offsets,
    const uint8_t* qual_flat, const int64_t* qual_offsets,
    const uint8_t* tags_flat, const int64_t* tags_offsets,
    const uint8_t* names_flat, const int64_t* names_offsets, int64_t n_names,
    int64_t n_rows, uint8_t* out, const int64_t* out_offsets,
    int64_t* out_lens, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<long long> err(0);
  const int64_t CHUNK = 1024;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n_rows || err.load()) return;
      int64_t i1 = i0 + CHUNK < n_rows ? i0 + CHUNK : n_rows;
      for (int64_t i = i0; i < i1; i++) {
        uint8_t* o = out + out_offsets[i];
        int64_t n = 0;
        // QNAME (fixed-width, NUL-padded)
        const uint8_t* q = qname_flat + i * qname_width;
        int64_t ql = 0;
        while (ql < qname_width && q[ql]) ql++;
        memcpy(o + n, q, (size_t)ql); n += ql;
        o[n++] = '\t';
        n += put_i64(flag[i], o + n);
        o[n++] = '\t';
        int64_t rn = rname_id[i];
        const uint8_t* rname = names_flat + names_offsets[rn];
        int64_t rname_len = names_offsets[rn + 1] - names_offsets[rn];
        memcpy(o + n, rname, (size_t)rname_len); n += rname_len;
        o[n++] = '\t';
        n += put_i64(pos[i], o + n);
        o[n++] = '\t';
        n += put_i64(mapq[i], o + n);
        o[n++] = '\t';
        int64_t c0 = cig_offsets[i], c1 = cig_offsets[i + 1];
        if (c1 == c0) {
          o[n++] = '*';
        } else {
          for (int64_t c = c0; c < c1; c++) {
            n += put_i64(cig_len_flat[c], o + n);
            o[n++] = cig_op_flat[c];
          }
        }
        o[n++] = '\t';
        int64_t xn = rnext_id[i];
        const uint8_t* xname = names_flat + names_offsets[xn];
        int64_t xname_len = names_offsets[xn + 1] - names_offsets[xn];
        if (xname_len == 1 && (xname[0] == '=' || xname[0] == '*')) {
          o[n++] = xname[0];
        } else if (xname_len == rname_len &&
                   memcmp(xname, rname, (size_t)rname_len) == 0) {
          o[n++] = '=';
        } else {
          memcpy(o + n, xname, (size_t)xname_len); n += xname_len;
        }
        o[n++] = '\t';
        n += put_i64(pnext[i], o + n);
        o[n++] = '\t';
        n += put_i64(tlen[i], o + n);
        o[n++] = '\t';
        int64_t s0 = seq_offsets[i], s1 = seq_offsets[i + 1];
        memcpy(o + n, seq_flat + s0, (size_t)(s1 - s0)); n += s1 - s0;
        o[n++] = '\t';
        int64_t u0 = qual_offsets[i], u1 = qual_offsets[i + 1];
        for (int64_t u = u0; u < u1; u++) o[n++] = (uint8_t)(qual_flat[u] + 33);
        int64_t t0 = tags_offsets[i], t1 = tags_offsets[i + 1];
        int64_t p = t0;
        while (p < t1) {
          int64_t fend = p;
          while (fend < t1 && tags_flat[fend] != '\t') fend++;
          o[n++] = '\t';
          int w = canon_tag_field(tags_flat + p, fend - p, o + n);
          if (w < 0) {
            long long want = -(long long)(i + 1);
            long long zero = 0;
            err.compare_exchange_strong(zero, want);
            return;
          }
          n += w;
          p = fend + 1;
        }
        o[n++] = '\n';
        out_lens[i] = n;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-confidence informative-indel bitset
// (reference: readHasNoPlausibleIndelsOfMaxIndelSize,
// ref-confidence.go:137-200). Mirrors hc/refconf.py
// read_has_no_plausible_indels for one read: the per-read bitset that
// Python computes once and caches (first-call read_start quirk).
// ---------------------------------------------------------------------------

extern "C" {

// base_mask: 256-entry IUPAC mask table. out: read_length bytes (0/1).
void refconf_informative(
    const uint8_t* read_bases, int64_t rb_len, const uint8_t* read_quals,
    int64_t read_start, const uint8_t* ref, int64_t ref_index,
    int64_t padded_end, int64_t read_length, int64_t max_indel,
    const int64_t* base_mask, uint8_t* out) {
  memset(out, 0, (size_t)read_length);
  if (read_length - read_start < max_indel || padded_end - ref_index < max_indel)
    return;
  int64_t secondary_break = read_length - max_indel;
  if (rb_len - read_start <= max_indel) return;
  int64_t last_relevant = padded_end - ref_index + read_start + 1;
  bool reference_was_shorter = rb_len >= last_relevant;
  if (!reference_was_shorter) last_relevant = rb_len - max_indel;

  // baseline mismatch suffix sums
  int64_t n = rb_len - read_start;
  if (padded_end - ref_index < n) n = padded_end - ref_index;
  std::vector<int64_t> baseline((size_t)(n > 0 ? n : 0));
  int64_t total = 0;
  for (int64_t i = n - 1; i >= 0; i--) {
    uint8_t rb = read_bases[read_start + i];
    uint8_t fb = ref[ref_index + i];
    if ((base_mask[rb] & base_mask[fb]) == 0 && rb != '-')
      total += read_quals[read_start + i];
    baseline[(size_t)i] = total;
  }

  int64_t big_len = rb_len + 1 > read_length ? rb_len + 1 : read_length;
  std::vector<uint8_t> info_big((size_t)big_len, 0);

  auto traverse = [&](int64_t ins_len, int64_t del_len) {
    int64_t global_cost = baseline.empty() ? 0 : baseline[0];
    int64_t base_qual_sum = 0;
    int64_t n_direct = rb_len - read_start - ins_len;
    int64_t alt = padded_end - ref_index - del_len;
    if (alt < n_direct) n_direct = alt;
    int64_t read_off = n_direct + ins_len - 1;
    int64_t ref_off = n_direct + del_len - 1;
    while (read_off >= 0 && ref_off >= 0) {
      uint8_t rb = read_bases[read_start + read_off];
      uint8_t fb = ref[ref_index + ref_off];
      if ((base_mask[rb] & base_mask[fb]) == 0 && rb != '-') {
        base_qual_sum += read_quals[read_start + read_off];
        if (base_qual_sum > global_cost) break;
      }
      int64_t site = read_off < ref_off ? read_off : ref_off;
      if (read_bases[read_start + site] != '-' &&
          read_start + site < last_relevant &&
          read_start + site <= secondary_break &&
          baseline[(size_t)site] >= base_qual_sum)
        info_big[(size_t)(read_start + site)] = 1;
      read_off--;
      ref_off--;
    }
  };

  for (int64_t sz = 1; sz <= max_indel; sz++) {
    traverse(0, sz);
    traverse(sz, 0);
  }
  if (last_relevant <= secondary_break) {
    for (int64_t i = 0; i < last_relevant; i++) info_big[(size_t)i] ^= 1;
    if (reference_was_shorter) info_big[(size_t)(last_relevant - 1)] = 0;
  } else {
    for (int64_t i = 0; i <= secondary_break; i++) info_big[(size_t)i] ^= 1;
  }
  int64_t out_n = read_length > 1 ? read_length : 1;
  if (out_n > big_len) out_n = big_len;
  memcpy(out, info_big.data(), (size_t)(out_n < read_length ? out_n : read_length));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Java-parity log10 via x87 (reference: filters/pedantic.go:29-52) — the
// JVM's StrictMath-adjacent log10 comes from the x87 fyl2x instruction,
// which is not correctly rounded; pedantic mode reproduces its exact
// bit patterns.
// ---------------------------------------------------------------------------

#include <cfenv>

extern "C" {

double x86_log10(double x) {
#if defined(__x86_64__) || defined(__i386__)
  double result;
  fesetround(FE_TONEAREST);
  __asm__ __volatile__("fldlg2; fxch; fyl2x" : "=t"(result) : "0"(x) : "st(1)");
  return result;
#else
  return log10(x);
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GVCF reference-block formatter
//
// Emits the fixed-shape reference-block records the GVCF writer
// produces for banded ref confidence (reference record shape:
// variant-combiner.go:183-212):
//   CHROM\tPOS\t.\tREF\t<NON_REF>\t.\t.\tEND=end\tGT:DP:GQ:MIN_DP:PL\t0/0:dp:gq:min_dp:p0,p1,p2\n
// Formatting millions of these through per-record Python %-interpolation
// dominates the HC write path; this emits the identical bytes in one
// pass.
// ---------------------------------------------------------------------------

namespace {

inline char* put_i64(char* p, long long v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + (v % 10)); v /= 10; } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 if cap is too small.
long long gvcf_format_blocks(const char* chrom, long long chrom_len,
                             const unsigned char* ref_base,
                             const long long* pos, const long long* end,
                             const long long* dp, const long long* gq,
                             const long long* min_dp, const long long* pls,
                             long long n, char* out, long long cap) {
  static const char kMid[] = "\t.\t";
  static const char kAlt[] = "\t<NON_REF>\t.\t.\tEND=";
  static const char kFmt[] = "\tGT:DP:GQ:MIN_DP:PL\t0/0:";
  char* p = out;
  char* lim = out + cap;
  // worst case per row: chrom + 7*20 digits + fixed text (~50)
  const long long row_bound = chrom_len + 7 * 20 + 64;
  for (long long k = 0; k < n; k++) {
    if (lim - p < row_bound) return -1;
    memcpy(p, chrom, chrom_len); p += chrom_len;
    *p++ = '\t';
    p = put_i64(p, pos[k]);
    memcpy(p, kMid, 3); p += 3;
    *p++ = (char)ref_base[k];
    memcpy(p, kAlt, sizeof(kAlt) - 1); p += sizeof(kAlt) - 1;
    p = put_i64(p, end[k]);
    memcpy(p, kFmt, sizeof(kFmt) - 1); p += sizeof(kFmt) - 1;
    p = put_i64(p, dp[k]); *p++ = ':';
    p = put_i64(p, gq[k]); *p++ = ':';
    p = put_i64(p, min_dp[k]); *p++ = ':';
    p = put_i64(p, pls[3 * k]); *p++ = ',';
    p = put_i64(p, pls[3 * k + 1]); *p++ = ',';
    p = put_i64(p, pls[3 * k + 2]); *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"

extern "C" {

// One-pass BQSR table histograms over per-base covariate codes
// (filters/bqsr.py accumulate_table_partials is the numpy oracle:
// out-of-range indices drop, matching the device scatter's mode="drop";
// mism accumulates the err value exactly like the device .add(err)).
// Output buffers must be zero-initialized by the caller.
void bqsr_histograms(const int* qs_idx, const int* cyc_idx,
                     const int* ctx_idx, const int* err, long long m,
                     long long qs_size, long long cyc_size,
                     long long ctx_size, int* qs_obs, int* qs_mism,
                     int* cyc_obs, int* cyc_mism, int* ctx_obs,
                     int* ctx_mism) {
  for (long long i = 0; i < m; i++) {
    const int e = err[i];
    const long long q = qs_idx[i];
    if (q >= 0 && q < qs_size) { qs_obs[q]++; qs_mism[q] += e; }
    const long long c = cyc_idx[i];
    if (c >= 0 && c < cyc_size) { cyc_obs[c]++; cyc_mism[c] += e; }
    const long long x = ctx_idx[i];
    if (x >= 0 && x < ctx_size) { ctx_obs[x]++; ctx_mism[x] += e; }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused BQSR covariate engine: per-base cycle/context/SNP covariates and
// the three dense table histograms in ONE pass over the padded read
// columns. ops/bqsr_ops.py _covariate_codes (jit) is the oracle — the
// fuzz test in tests/test_bqsr.py holds this bit-identical to it
// (identical masks, drop semantics, and mismatch indicator).
// ---------------------------------------------------------------------------

#include <vector>
#include <thread>
#include <atomic>

namespace {

// CIGAR op classes follow ops/readstats.py CIGAR_OPS = "MIDNSHP=X"
constexpr int kReadCons[9] = {1, 1, 0, 0, 1, 0, 0, 1, 1};
constexpr int kRefCons[9]  = {1, 0, 1, 1, 0, 0, 0, 1, 1};
constexpr int kIsMx[9]     = {1, 0, 0, 0, 0, 0, 0, 1, 1};

struct BaseTables {
  int base_idx[256];   // A0 C1 G2 T3 (+ lowercase, '*'->0), else -1
  int base_int[256];   // baseToIntMap classes (bqsr.go:247-252)
  BaseTables() {
    for (int i = 0; i < 256; i++) { base_idx[i] = -1; base_int[i] = 0; }
    const char* acgt = "ACGT";
    for (int i = 0; i < 4; i++) {
      base_idx[(unsigned char)acgt[i]] = i;
      base_idx[(unsigned char)(acgt[i] + 32)] = i;
    }
    base_idx[(unsigned char)'*'] = 0;
    const char* cls1 = "aA*"; const char* cls2 = "cC";
    const char* cls3 = "gG"; const char* cls4 = "tT";
    for (const char* p = cls1; *p; p++) base_int[(unsigned char)*p] = 1;
    for (const char* p = cls2; *p; p++) base_int[(unsigned char)*p] = 2;
    for (const char* p = cls3; *p; p++) base_int[(unsigned char)*p] = 3;
    for (const char* p = cls4; *p; p++) base_int[(unsigned char)*p] = 4;
  }
};
const BaseTables kBT;

struct CovariateArgs {
  long long m, L, C;
  const unsigned char* base;
  const unsigned char* qual;
  const unsigned char* skip;
  const int* seq_len;
  const int* flag;
  const int* pos;
  const int* rg;
  const long long* refoff;
  const signed char* op_class;
  const int* op_len;
  const unsigned char* ref_classes;
  long long ref_len;
  long long max_cycle, n_rg;
};

long long covariate_rows(const CovariateArgs& a, long long r0, long long r1,
                         int* qs_obs, int* qs_mism, int* cyc_obs,
                         int* cyc_mism, int* ctx_obs, int* ctx_mism) {
  const long long ncyc = 2 * a.max_cycle + 1;
  const long long qs_size = a.n_rg * 94;
  const long long cyc_size = qs_size * ncyc;
  const long long ctx_size = qs_size * 16;
  long long max_abs_cycle = 0;
  std::vector<int> refpos(a.L);
  std::vector<unsigned char> ismx(a.L);
  for (long long row = r0; row < r1; row++) {
    const long long sl = a.seq_len[row];
    if (sl <= 0) continue;
    const unsigned char* qrow = a.qual + row * a.L;
    const unsigned char* brow = a.base + row * a.L;
    const unsigned char* krow = a.skip + row * a.L;
    const int f = a.flag[row];
    const int rev = (f >> 4) & 1;
    const int last = (f >> 7) & 1;
    const int rof = 1 - 2 * last;
    const long long cf = (long long)rof + (long long)rev * (sl - 1) * rof;
    const int inc = (1 - 2 * rev) * rof;
    // context high-quality window (computeStrandedClippedSeq)
    long long left = sl, right = -1;
    for (long long i = 0; i < sl; i++) {
      if (qrow[i] > 2) { if (left == sl) left = i; right = i; }
    }
    // per-base reference position + M/=/X coverage from the CIGAR walk
    {
      long long rp = 0;   // read-consumed prefix
      long long fp = 0;   // ref-consumed prefix (exclusive)
      const signed char* ops = a.op_class + row * a.C;
      const int* lens = a.op_len + row * a.C;
      for (long long k = 0; k < a.C && rp < sl; k++) {
        const int oc = ops[k];
        const int len = lens[k];
        if (kReadCons[oc]) {
          const long long take =
              (rp + len <= sl) ? len : (sl - rp);
          for (long long off = 0; off < take; off++) {
            refpos[rp + off] = (int)(a.pos[row] - 1 + fp + off);
            ismx[rp + off] = (unsigned char)kIsMx[oc];
          }
          rp += len;
        }
        if (kRefCons[oc]) fp += len;
      }
      for (long long i = rp < 0 ? 0 : rp; i < sl; i++) {
        // bases past the cigar's read-consumed total: never M/=/X
        if (i >= 0 && i < (long long)a.L) { ismx[i] = 0; refpos[i] = 0; }
      }
    }
    const long long rgq0 = (long long)a.rg[row] * 94;
    for (long long i = 0; i < sl; i++) {
      const long long cycle = cf + i * (long long)inc;
      const long long ac = cycle < 0 ? -cycle : cycle;
      if (ac > max_abs_cycle) max_abs_cycle = ac;
      const int q = qrow[i];
      if (q < 6 || krow[i] || kBT.base_idx[brow[i]] < 0) continue;
      const long long rgq = rgq0 + q;
      int err = 0;
      if (ismx[i]) {
        long long gpos = a.refoff[row] + refpos[i];
        if (gpos < 0) gpos = 0;
        if (gpos > a.ref_len - 1) gpos = a.ref_len - 1;
        const int refc = a.ref_classes[gpos];
        err = (kBT.base_int[brow[i]] != refc) ? 1 : 0;
      }
      if (rgq >= 0 && rgq < qs_size) { qs_obs[rgq]++; qs_mism[rgq] += err; }
      const long long ci = rgq * ncyc + (cycle + a.max_cycle);
      if (ci >= 0 && ci < cyc_size) { cyc_obs[ci]++; cyc_mism[ci] += err; }
      // 2-mer context key over the strand-oriented clipped sequence
      int b1, b2;
      const bool in_i = (i >= left) && (i <= right);
      const int bi = in_i ? kBT.base_idx[brow[i]] : -1;
      if (!rev) {
        b2 = bi;
        if (i == 0) b1 = -1;
        else {
          const bool in_p = (i - 1 >= left) && (i - 1 <= right);
          const int bp = in_p ? kBT.base_idx[brow[i - 1]] : -1;
          b1 = bp;
        }
      } else {
        b2 = bi >= 0 ? 3 - bi : -1;
        if (i == sl - 1) b1 = -1;
        else {
          const bool in_n = (i + 1 >= left) && (i + 1 <= right);
          const int bn = in_n ? kBT.base_idx[brow[i + 1]] : -1;
          b1 = bn >= 0 ? 3 - bn : -1;
        }
      }
      if (b1 >= 0 && b2 >= 0) {
        const long long xi = rgq * 16 + (b1 * 4 + b2);
        if (xi >= 0 && xi < ctx_size) { ctx_obs[xi]++; ctx_mism[xi] += err; }
      }
    }
  }
  return max_abs_cycle;
}

}  // namespace

extern "C" long long bqsr_covariate_tables(
    long long m, long long L, long long C,
    const unsigned char* base, const unsigned char* qual,
    const unsigned char* skip, const int* seq_len, const int* flag,
    const int* pos, const int* rg, const long long* refoff,
    const signed char* op_class, const int* op_len,
    const unsigned char* ref_classes, long long ref_len,
    long long max_cycle, long long n_rg,
    int* qs_obs, int* qs_mism, int* cyc_obs, int* cyc_mism,
    int* ctx_obs, int* ctx_mism, long long n_threads) {
  CovariateArgs a{m, L, C, base, qual, skip, seq_len, flag, pos, rg,
                  refoff, op_class, op_len, ref_classes, ref_len,
                  max_cycle, n_rg};
  const long long ncyc = 2 * max_cycle + 1;
  const long long qs_size = n_rg * 94;
  const long long cyc_size = qs_size * ncyc;
  const long long ctx_size = qs_size * 16;
  long long nt = n_threads < 1
      ? (long long)std::thread::hardware_concurrency() : n_threads;
  if (nt < 1) nt = 1;
  if (nt > m) nt = m < 1 ? 1 : m;
  if (nt == 1) {
    return covariate_rows(a, 0, m, qs_obs, qs_mism, cyc_obs, cyc_mism,
                          ctx_obs, ctx_mism);
  }
  std::vector<std::vector<int>> priv(nt);
  std::vector<long long> macs(nt, 0);
  std::vector<std::thread> ths;
  const long long total = 2 * (qs_size + cyc_size + ctx_size);
  for (long long t = 0; t < nt; t++) {
    ths.emplace_back([&, t]() {
      priv[t].assign(total, 0);
      int* p = priv[t].data();
      const long long r0 = (m * t) / nt, r1 = (m * (t + 1)) / nt;
      macs[t] = covariate_rows(
          a, r0, r1, p, p + qs_size, p + 2 * qs_size,
          p + 2 * qs_size + cyc_size, p + 2 * (qs_size + cyc_size),
          p + 2 * (qs_size + cyc_size) + ctx_size);
    });
  }
  long long mac = 0;
  int* outs[6] = {qs_obs, qs_mism, cyc_obs, cyc_mism, ctx_obs, ctx_mism};
  const long long sizes[6] = {qs_size, qs_size, cyc_size, cyc_size,
                              ctx_size, ctx_size};
  for (long long t = 0; t < nt; t++) {
    ths[t].join();
    if (macs[t] > mac) mac = macs[t];
    const int* p = priv[t].data();
    for (int k = 0; k < 6; k++) {
      for (long long i = 0; i < sizes[k]; i++) outs[k][i] += p[i];
      p += sizes[k];
    }
  }
  return mac;
}

namespace {

struct ApplyArgs {
  long long m, L;
  const unsigned char* base;
  const unsigned char* qual;
  const int* seq_len;
  const int* flag;
  const int* rg;
  const unsigned char* rg_present;
  const int* cond_prior;
  const int* d_cyc;
  const int* d_ctx;
  const unsigned char* quant_lut;
  const unsigned char* sqq_lut;
  long long max_cycle, n_rg;
  unsigned char* out;
  // ragged mode: when non-null, row r's bytes live at offsets[r] of
  // base/qual/out (shared seq==qual offsets) and L/seq_len are unused.
  // out may alias qual (in-place recalibration, no big intermediates).
  const int64_t* offsets;
};

long long apply_rows(const ApplyArgs& a, long long r0, long long r1) {
  const long long ncyc = 2 * a.max_cycle + 1;
  long long mac = 0;
  for (long long row = r0; row < r1; row++) {
    long long sl;
    const unsigned char* qrow;
    const unsigned char* brow;
    unsigned char* orow;
    if (a.offsets) {
      sl = a.offsets[row + 1] - a.offsets[row];
      qrow = a.qual + a.offsets[row];
      brow = a.base + a.offsets[row];
      orow = a.out + a.offsets[row];
      if (orow != qrow && sl > 0) memcpy(orow, qrow, (size_t)sl);
    } else {
      sl = a.seq_len[row];
      qrow = a.qual + row * a.L;
      brow = a.base + row * a.L;
      orow = a.out + row * a.L;
      // invalid columns keep the input qual (oracle: out = where(mask, newq, q))
      memcpy(orow, qrow, a.L);
    }
    if (sl <= 0) continue;
    const int f = a.flag[row];
    const int rev = (f >> 4) & 1;
    const int last = (f >> 7) & 1;
    const int rof = 1 - 2 * last;
    const long long cf = (long long)rof + (long long)rev * (sl - 1) * rof;
    const int inc = (1 - 2 * rev) * rof;
    long long left = sl, right = -1;
    for (long long i = 0; i < sl; i++) {
      if (qrow[i] > 2) { if (left == sl) left = i; right = i; }
    }
    long long rgc = a.rg[row];
    if (rgc < 0) rgc = 0;
    if (rgc > a.n_rg - 1) rgc = a.n_rg - 1;
    const bool rg_ok = a.rg[row] >= 0 && a.rg_present[rgc];
    const int* cp = a.cond_prior + rgc * 94;
    const int* dc = a.d_cyc + rgc * 94 * ncyc;
    const int* dx = a.d_ctx + rgc * 94 * 17;
    for (long long i = 0; i < sl; i++) {
      const long long cycle = cf + i * (long long)inc;
      const long long ac = cycle < 0 ? -cycle : cycle;
      if (ac > mac) mac = ac;
      const int q = qrow[i];
      if (q < 6 || !rg_ok) continue;
      long long ci = cycle + a.max_cycle;
      if (ci < 0) ci = 0;
      if (ci > ncyc - 1) ci = ncyc - 1;
      // context key (same window semantics as the table build)
      int b1, b2;
      const bool in_i = (i >= left) && (i <= right);
      const int bi = in_i ? kBT.base_idx[brow[i]] : -1;
      if (!rev) {
        b2 = bi;
        if (i == 0) b1 = -1;
        else {
          const bool in_p = (i - 1 >= left) && (i - 1 <= right);
          b1 = in_p ? kBT.base_idx[brow[i - 1]] : -1;
        }
      } else {
        b2 = bi >= 0 ? 3 - bi : -1;
        if (i == sl - 1) b1 = -1;
        else {
          const bool in_n = (i + 1 >= left) && (i + 1 <= right);
          const int bn = in_n ? kBT.base_idx[brow[i + 1]] : -1;
          b1 = bn >= 0 ? 3 - bn : -1;
        }
      }
      const long long xi = (b1 >= 0 && b2 >= 0) ? (b1 * 4 + b2) : 16;
      const long long qc = q > 93 ? 93 : q;
      long long est = (long long)cp[qc] + dc[qc * ncyc + ci]
                      + dx[qc * 17 + xi];
      if (est < 1) est = 1;
      if (est > 93) est = 93;
      orow[i] = a.sqq_lut[a.quant_lut[est]];
    }
  }
  return mac;
}

}  // namespace

extern "C" long long bqsr_apply_quals(
    long long m, long long L, const unsigned char* base,
    const unsigned char* qual, const int* seq_len, const int* flag,
    const int* rg, const unsigned char* rg_present, const int* cond_prior,
    const int* d_cyc, const int* d_ctx, const unsigned char* quant_lut,
    const unsigned char* sqq_lut, long long max_cycle, long long n_rg,
    unsigned char* out, long long n_threads) {
  ApplyArgs a{m, L, base, qual, seq_len, flag, rg, rg_present, cond_prior,
              d_cyc, d_ctx, quant_lut, sqq_lut, max_cycle, n_rg, out};
  long long nt = n_threads < 1
      ? (long long)std::thread::hardware_concurrency() : n_threads;
  if (nt < 1) nt = 1;
  if (nt > m) nt = m < 1 ? 1 : m;
  if (nt == 1) return apply_rows(a, 0, m);
  std::vector<std::thread> ths;
  std::vector<long long> macs(nt, 0);
  for (long long t = 0; t < nt; t++) {
    ths.emplace_back([&, t]() {
      macs[t] = apply_rows(a, (m * t) / nt, (m * (t + 1)) / nt);
    });
  }
  long long mac = 0;
  for (long long t = 0; t < nt; t++) {
    ths[t].join();
    if (macs[t] > mac) mac = macs[t];
  }
  return mac;
}

// Ragged (offsets-addressed) ApplyBQSR; `out` may alias `qual` for
// in-place recalibration — rows are disjoint so the row-parallel
// threading stays safe, and within a row every qual byte is read
// before its own write (the left/right scan precedes the write loop).
extern "C" long long bqsr_apply_quals_ragged(
    long long m, const unsigned char* base, const unsigned char* qual,
    const int64_t* offsets, const int* flag, const int* rg,
    const unsigned char* rg_present, const int* cond_prior,
    const int* d_cyc, const int* d_ctx, const unsigned char* quant_lut,
    const unsigned char* sqq_lut, long long max_cycle, long long n_rg,
    unsigned char* out, long long n_threads) {
  ApplyArgs a{m, 0, base, qual, nullptr, flag, rg, rg_present, cond_prior,
              d_cyc, d_ctx, quant_lut, sqq_lut, max_cycle, n_rg, out,
              offsets};
  long long nt = n_threads < 1
      ? (long long)std::thread::hardware_concurrency() : n_threads;
  if (nt < 1) nt = 1;
  if (nt > m) nt = m < 1 ? 1 : m;
  if (nt == 1) return apply_rows(a, 0, m);
  std::vector<std::thread> ths;
  std::vector<long long> macs(nt, 0);
  for (long long t = 0; t < nt; t++) {
    ths.emplace_back([&, t]() {
      macs[t] = apply_rows(a, (m * t) / nt, (m * (t + 1)) / nt);
    });
  }
  long long mac = 0;
  for (long long t = 0; t < nt; t++) {
    ths[t].join();
    if (macs[t] > mac) mac = macs[t];
  }
  return mac;
}

// Ragged dedup inputs: per-read Phred score (sum of quals in [15,93],
// reference: filters/mark-duplicates.go:36-68) and 5' unclipped
// position (mark-duplicates.go:79-110) in one pass over the ragged
// qual/cigar buffers — the padded [n,L]/[n,C] matrices the jit oracles
// (ops/readstats.py phred_score / unclipped_position) consume never
// materialize. Cigar ops arrive as ASCII bytes.
extern "C" void dedup_score_upos(
    const uint8_t* qual_data, const int64_t* qual_off,
    const int32_t* cig_len, const uint8_t* cig_op, const int64_t* cig_off,
    const int32_t* pos, const int32_t* flag, int64_t n,
    int32_t* out_upos, int32_t* out_score, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  auto is_clip = [](uint8_t op) { return op == 'S' || op == 'H'; };
  auto is_refcons = [](uint8_t op) {
    return op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X';
  };
  std::atomic<int64_t> next(0);
  const int64_t CHUNK = 4096;
  auto worker = [&]() {
    for (;;) {
      int64_t i0 = next.fetch_add(CHUNK);
      if (i0 >= n) return;
      int64_t i1 = i0 + CHUNK < n ? i0 + CHUNK : n;
      for (int64_t i = i0; i < i1; i++) {
        int32_t score = 0;
        for (int64_t q = qual_off[i]; q < qual_off[i + 1]; q++) {
          const uint8_t v = qual_data[q];
          if (v >= 15 && v <= 93) score += v;
        }
        out_score[i] = score;
        const int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
        if (c0 == c1) {  // '*' cigar: POS unchanged
          out_upos[i] = pos[i];
          continue;
        }
        if (flag[i] & 0x10) {
          // reverse: POS - 1 + every reference-consuming op + the
          // trailing clip run
          int64_t sum = 0;
          int64_t t = c1 - 1;
          for (; t >= c0 && is_clip(cig_op[t]); t--) sum += cig_len[t];
          for (; t >= c0; t--)
            if (is_refcons(cig_op[t])) sum += cig_len[t];
          out_upos[i] = (int32_t)(pos[i] - 1 + sum);
        } else {
          int64_t lead = 0;
          for (int64_t t = c0; t < c1 && is_clip(cig_op[t]); t++)
            lead += cig_len[t];
          out_upos[i] = (int32_t)(pos[i] - lead);
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Per-base tandem-repeat lengths for the PairHMM gap-continuation
// tables (ops/pairhmm.py repeat_lengths_for_read is the oracle, itself
// mirroring pairhmm.go:104-162 — including the quirk that max_bw keeps
// the LAST tried unit's repeat count when no unit repeats).
// ---------------------------------------------------------------------------

namespace {

inline long long n_fw_reps(const unsigned char* unit, long long ul,
                           const unsigned char* s, long long sl) {
  long long n = 0;
  while (sl >= ul && memcmp(s, unit, ul) == 0) { n++; s += ul; sl -= ul; }
  return n;
}

inline long long n_bw_reps(const unsigned char* unit, long long ul,
                           const unsigned char* s, long long sl) {
  long long n = 0;
  while (sl >= ul && memcmp(s + sl - ul, unit, ul) == 0) { n++; sl -= ul; }
  return n;
}

}  // namespace

extern "C" void pairhmm_repeat_lengths(const unsigned char* bases,
                                       long long n, unsigned char* out) {
  for (long long i = 0; i < n - 1; i++) {
    const long long o1 = i + 1;
    long long max_bw = 0;
    const unsigned char* bw_unit = bases + i;
    long long bw_ul = 1;
    for (long long strlen_ = 1; strlen_ <= 8; strlen_++) {
      const long long ro = o1 - strlen_;
      if (ro < 0) break;
      max_bw = n_bw_reps(bases + ro, strlen_, bases, o1);
      if (max_bw > 1) { bw_unit = bases + ro; bw_ul = strlen_; break; }
    }
    long long max_rl = max_bw;
    if (o1 < n) {
      long long max_fw = 0;
      const unsigned char* fw_unit = bases + o1;
      long long fw_ul = 1;
      for (long long strlen_ = 1; strlen_ <= 8; strlen_++) {
        if (o1 + strlen_ > n) break;
        max_fw = n_fw_reps(bases + o1, strlen_, bases + o1, n - o1);
        if (max_fw > 1) { fw_ul = strlen_; break; }
      }
      fw_unit = bases + o1;
      const bool same = fw_ul == bw_ul && memcmp(fw_unit, bw_unit, fw_ul) == 0;
      if (!same) max_bw = n_bw_reps(fw_unit, fw_ul, bases, o1);
      max_rl = max_fw + max_bw;
    }
    if (max_rl > 20) max_rl = 20;
    out[i] = (unsigned char)max_rl;
  }
  if (n) out[n - 1] = 21;
}

// ---------------------------------------------------------------------------
// Stable index sort over up to four packed key words. The callers
// (ops/sortkeys.py, ops/dedup.py) pack their comparator key columns
// into non-overlapping bit fields order-preservingly, so one stable
// sort here equals their np.lexsort chains (which remain the fuzzed
// fallback/oracle).
// ---------------------------------------------------------------------------

namespace {

struct SortRec {
  unsigned long long w0, w1, w2;
  int idx;
};

}  // namespace

extern "C" void stable_sort_idx(
    const unsigned long long* w0, const unsigned long long* w1,
    const unsigned long long* w2, const unsigned long long* w3,
    long long n, int* out_idx) {
  // records carry the first three words inline (contiguous compares —
  // an index-indirect comparator cache-misses); only the rare w3 tie
  // falls back to an indirect load
  std::vector<SortRec> recs(n);
  for (long long i = 0; i < n; i++) {
    recs[i].w0 = w0[i];
    recs[i].w1 = w1 ? w1[i] : 0;
    recs[i].w2 = w2 ? w2[i] : 0;
    recs[i].idx = (int)i;
  }
  auto cmp = [&](const SortRec& a, const SortRec& b) {
    if (a.w0 != b.w0) return a.w0 < b.w0;
    if (a.w1 != b.w1) return a.w1 < b.w1;
    if (a.w2 != b.w2) return a.w2 < b.w2;
    if (w3 && w3[a.idx] != w3[b.idx]) return w3[a.idx] < w3[b.idx];
    return false;
  };
#if defined(_OPENMP)
  __gnu_parallel::stable_sort(recs.begin(), recs.end(), cmp);
#else
  std::stable_sort(recs.begin(), recs.end(), cmp);
#endif
  for (long long i = 0; i < n; i++) out_idx[i] = recs[i].idx;
}
