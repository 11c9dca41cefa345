// PairHMM forward pass (float32) over explicit (read, haplotype) pairs, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elprep_tpu/ops/pairhmm_pallas.py:39
// (_kernel, launched by pairhmm_pallas, fed by pairhmm_pallas_u8). Plain
// version: elprep_tpu_torch/ops/pairhmm_cuda.py::pairhmm_forward_plain.
//
// Two kernels compute the same function; the wrapper picks one per batch
// from the longest read (pairhmm_cuda.launch_plan):
//   pairhmm_warp_kernel    reads of up to 32 * kWarpMaxRows = 256 bases;
//   pairhmm_stripe_kernel  longer reads, up to 16384 bases.
// Both do the same operations in the same order, so each equals the plain
// version bit for bit on every pair.
//
// Bound (both). Per cell the recurrence needs 7 multiplies and 4 adds
// (11 f32 operations, with (I2 + D2) * i2m as one multiply, plus one add per
// cell of row lr): 11 * sum(lr * lh) operations per batch, against the
// card's 67 TFLOP/s of non-tensor float32 (H100 SXM). The bytes (u8 bases
// and quals, f32 output) are three orders of magnitude below the memory
// bound, so operations bound it. The 67 TFLOP/s counts an FMA as two
// operations; built with -fmad=false every operation is its own FMUL or
// FADD, so the card issues at most 33.5 T of them a second (132 SMs x 128
// lanes x 1.98 GHz): half the bound is this design's ceiling. The order
// below, which the goldens fix, multiplies I2 and D2 by i2m apart: one
// multiply more, 12 operations per cell, a cost of bit-equality.
//
// Warp per pair (pairhmm_warp_kernel<RMAX>). W = blockDim.x / 32 pairs per
// CTA, one per warp; warps never wait for each other, and each stops at its
// own pair's lr + lh. A warp takes R = ceil(lr / 32) rows per lane for its
// own pair (any R from 1 to RMAX = ceil(longest read / 32) <= 8, not only
// powers of two). Rows are aligned to the bottom: lane l owns rows
// l*R+1-off .. l*R+R-off, off = 32*R - lr, so row lr is always lane 31's
// last register; the boundary row 0 and the rows above it, when they fall
// inside the warp, run the same recurrence with zero tables (and i2i = 1 on
// row 0, whose D so stays init exactly). Its design:
//   - no block barrier and no shared-memory exchange per diagonal: the row
//     above a lane's first row comes from lane l-1 by __shfl_up_sync alone
//     (lane 0 takes M = I = 0, and D = init when off = 0, else 0);
//   - the R cells of a lane on one diagonal are independent, which gives
//     the scheduler R-way instruction-level parallelism; the states of
//     diagonals d-1 and d-2 swap roles every diagonal (the loop is
//     unrolled by two), so no register moves rotate them;
//   - a row's haplotype base on diagonal d is the one row i-1 used on d-1,
//     so bases travel down the rows in registers: one more shuffle per
//     diagonal, and only lane 0 loads one base a diagonal, two diagonals
//     ahead of its use; there is no per-cell global load (rows above row 0
//     start with the bases they pass down);
//   - the last row's M + I is added once per diagonal, not once per row;
//   - a read base 'N' is folded into the row's mismatch prior once
//     (nmp = mp), which leaves two compares per cell;
//   - cells left of column 1 (j < 1) are computed, not skipped: every
//     input they read is +0 (the boundary row's D = init reaches row 1 on
//     column 1 first), so they stay +0, as if skipped;
//   - the skew still idles rows before their first cell and after their
//     last: a warp sweeps 32*R rows over lr + lh diagonals for lr * lh
//     cells.
//
// Stripes (pairhmm_stripe_kernel), for reads over 256 bases. A lane cannot
// hold more than about 8 rows (12 live values a row) without spilling, so
// a warp sweeps a long read in stripes of rows, one after the other, with
// the warp path's per-stripe code (stripe_rows):
//   - one warp per pair, up to 4 pairs per CTA (fewer when the batch's
//     longest haplotype needs more shared memory), and as on the warp path
//     warps never wait for each other and each stops at its own pair's end;
//   - the first stripe takes the first lr0 = lr - 256 * n rows (1..256)
//     with R0 = ceil(lr0 / 32) rows per lane, aligned to the bottom as on
//     the warp path (row 0 inside it); each of the n stripes below it takes
//     256 rows at 8 rows per lane. A 300-base read runs 64 + 256 rows, not
//     512; a pair of up to 256 bases is one stripe and costs what it costs
//     on the warp path;
//   - the boundary between two stripes is the last row of the one above:
//     M, I and D of columns 1..lh, 12 bytes a column, in the warp's slice of
//     dynamic shared memory. Lane 31 writes column j - (32*R - 1) on the
//     diagonal where lane 0 reads column j: within a stripe the writes trail
//     the reads by 255 columns (and the value written on a column depends
//     on the value read there, so no write can pass its read), and
//     __syncwarp between stripes orders the writes of one before the reads
//     of the next. One buffer per warp is enough. Lane 0 loads the row
//     above two diagonals ahead; the d-2 terms are the values it took on
//     the diagonal before (the shuffle registers of the warp path);
//   - the haplotype's bases are copied once per pair into the warp's shared
//     memory by cp.async, and every stripe reads them from there;
//   - no block barrier: the only exchange between warps' work is within
//     one warp, between one stripe and the next, through a buffer that
//     needs no wait per diagonal.
//
// Numerics. Every product and sum is an explicit __fmul_rn / __fadd_rn
// (and the library is built with -fmad=false), so nothing is contracted
// into an FMA. The operation order is the one of the plain version and of
// elprep_tpu/ops/pairhmm.py:284 (the JAX scan that produced the goldens):
//   M = prior * ((M2*m2m + I2*i2m) + D2*i2m)
//   I = M1u*m2i + I1u*i2i        (u: row i-1)
//   D = M1*m2i + D1*i2i
// so on the card each kernel equals the plain version bit for bit. A
// pair's value depends only on its own inputs, never on its batch.
//
// Tables. mp / nmp are indexed by the modified quality, m2m / m2i by the
// tandem-repeat length; each table's last entry is an exact-zero
// sentinel. Rows past the read length take the sentinel values (zeros),
// as in the plain version. 'N' matches anything by a direct byte compare.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kN = 'N';

struct Args {
  const uint8_t* read_bases;
  const uint8_t* read_quals;
  const uint8_t* read_repeats;
  const int32_t* read_offsets;
  const int32_t* read_lengths;
  const uint8_t* hap_bases;
  const int32_t* hap_offsets;
  const int32_t* hap_lengths;
  const float* hap_init;
  const int32_t* pair_read;
  const int32_t* pair_hap;
  const float* mp;
  const float* nmp;
  const float* m2m;
  const float* m2i;
  float i2m;
  float i2i;
  float* acc;
};

// ---------------------------------------------------------------------------
// Warp per pair, and the stripes of a long read
// ---------------------------------------------------------------------------

constexpr int kWarpMaxRows = 8;
// rows per lane of a full stripe: 32 * 8 = 256 rows, the warp path's
// register budget
constexpr int kStripeRows = 8;
constexpr int kStripeRowsPerStripe = 32 * kStripeRows;
constexpr int kMaxDevices = 64;

// The rows one sweep of a warp takes (a stripe), where the row above its
// first row comes from, and what becomes of its last row.
enum Part : int {
  kWhole,   // the whole pair: boundary row 0 above; sum of row lr
  kTop,     // the first lr0 rows of a longer pair: boundary row 0 above;
            // last row to the buffer
  kMiddle,  // 256 rows: the buffer above; last row to the buffer
  kBottom,  // the last 256 rows: the buffer above; sum of row lr
};

// The last row of the stripe above: M, I and D of columns 1..lh at
// [j - 1], in the warp's slice of shared memory (the warp path has none).
struct Boundary {
  float* M;
  float* I;
  float* D;
};

// A warp's slice of dynamic shared memory on the stripe path, for
// haplotypes of up to lh bases: the boundary row (three floats a column,
// cap columns) and the haplotype's bases (cap bytes, with room for the
// 4-byte alignment of their copy), 16-byte aligned.
__host__ __device__ constexpr int stripe_cap(int lh) { return lh < 4 ? 4 : (lh + 3) / 4 * 4; }
__host__ __device__ constexpr int stripe_smem_bytes(int cap) {
  return 12 * cap + (cap + 8 + 15) / 16 * 16;
}

// A lane's rows. Rows 1..lr: read base, table entries, i2i; nmp is mp where
// the read base is 'N'. Row 0 (the boundary row, when it falls inside the
// warp): zero tables and i2i = 1, so that its D stays init. Rows above it:
// zeros.
template <int R>
struct LaneRows {
  int x[R];
  float mp[R], nmp[R], m2m[R], m2i[R], i2i[R];
};

// One anti-diagonal d of a lane's rows. C holds the states of diagonal d-1;
// O holds those of d-2 on entry and those of d on return. (nOM, nOI, nOD)
// is the row above the lane's first row on d-2; (nCM, nCI, nCD) receives it
// on d-1. hb[r] is row r's haplotype base: that of d-1 on entry, of d on
// return; h1 is the base of lane 0's first row on d; (tM, tI, tD) is the
// row above lane 0 on d-1. The last register of lane 31 is row lr: on
// kWhole and kBottom its M + I goes into acc, on kTop and kMiddle lane 31
// writes it to the boundary buffer.
template <int R, Part P>
__device__ __forceinline__ void warp_diagonal(
    const int d, const bool lane0, const int lr, const int lh,
    const LaneRows<R>& w, const float i2m, const float i2i, const float tM,
    const float tI, const float tD, const int h1, int (&hb)[R], const float (&CM)[R],
    const float (&CI)[R], const float (&CD)[R], float (&OM)[R], float (&OI)[R],
    float (&OD)[R], float& nCM, float& nCI, float& nCD, const float nOM,
    const float nOI, const float nOD, float& acc, const Boundary& bnd) {
  nCM = __shfl_up_sync(kFull, CM[R - 1], 1);
  nCI = __shfl_up_sync(kFull, CI[R - 1], 1);
  nCD = __shfl_up_sync(kFull, CD[R - 1], 1);
  int h0 = __shfl_up_sync(kFull, hb[R - 1], 1);
  if (lane0) {
    nCM = tM;
    nCI = tI;
    nCD = tD;
    h0 = h1;
  }
  // descending rows: row r-1 still holds diagonals d-1 (C) and d-2 (O)
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const float uM1 = r > 0 ? CM[r > 0 ? r - 1 : 0] : nCM;
    const float uI1 = r > 0 ? CI[r > 0 ? r - 1 : 0] : nCI;
    const float uM2 = r > 0 ? OM[r > 0 ? r - 1 : 0] : nOM;
    const float uI2 = r > 0 ? OI[r > 0 ? r - 1 : 0] : nOI;
    const float uD2 = r > 0 ? OD[r > 0 ? r - 1 : 0] : nOD;
    hb[r] = r > 0 ? hb[r > 0 ? r - 1 : 0] : h0;
    const bool match = (w.x[r] == hb[r]) | (hb[r] == kN);
    const float prior = match ? w.mp[r] : w.nmp[r];
    const float Mn = __fmul_rn(prior,
                               __fadd_rn(__fadd_rn(__fmul_rn(uM2, w.m2m[r]),
                                                   __fmul_rn(uI2, i2m)),
                                         __fmul_rn(uD2, i2m)));
    const float In = __fadd_rn(__fmul_rn(uM1, w.m2i[r]), __fmul_rn(uI1, i2i));
    const float Dn = __fadd_rn(__fmul_rn(CM[r], w.m2i[r]), __fmul_rn(CD[r], w.i2i[r]));
    OM[r] = Mn;
    OI[r] = In;
    OD[r] = Dn;
  }
  // row lr on column d - lr, in d order
  const int c = d - lr;
  if constexpr (P == kWhole || P == kBottom) {
    if (c >= 1 && c <= lh) {
      acc = __fadd_rn(acc, __fadd_rn(OM[R - 1], OI[R - 1]));
    }
  } else {
    if (c >= 1 && c <= lh && (threadIdx.x & 31) == 31) {
      bnd.M[c - 1] = OM[R - 1];
      bnd.I[c - 1] = OI[R - 1];
      bnd.D[c - 1] = OD[R - 1];
    }
  }
}

// One stripe of a pair on one warp with R rows per lane: lr rows, 32 * R >=
// lr, whose read bases, quals and repeat lengths start at rb, rq, rr; hg is
// the haplotype's bases (device memory on the warp path, the warp's shared
// memory on the stripe path). Rows are aligned to the bottom: lane l holds
// rows l*R+1-off .. l*R+R-off with off = 32 * R - lr, so the stripe's row lr
// is lane 31's last register. kMiddle and kBottom take full stripes (off =
// 0), whose row 0 is the buffer.
template <int R, Part P>
__device__ __forceinline__ void stripe_rows(const Args& a, const int b, const uint8_t* rb,
                                            const uint8_t* rq, const uint8_t* rr,
                                            const uint8_t* hg, const float init,
                                            const int lr, const int lh,
                                            const Boundary& bnd) {
  const float i2m = a.i2m;
  const float i2i = a.i2i;
  const int lane = threadIdx.x & 31;
  const bool lane0 = lane == 0;
  const int off = 32 * R - lr;
  const int row0 = lane * R + 1 - off;

  // per-row inputs; two sets of row states (diagonals 0 and -1: zero but
  // for row 0's D = init on diagonal 0) that swap roles every diagonal; the
  // row above the lane's first row on the matching diagonals; a row's
  // haplotype base on diagonal 0 (column -i: rows above row 0 pass the
  // bases of columns 1.. down to row 1)
  LaneRows<R> w;
  float AM[R], AI[R], AD[R], BM[R], BI[R], BD[R];
  int hb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= 1) {
      w.x[r] = rb[i - 1];
      const int q = rq[i - 1];
      const int k = rr[i - 1];
      w.mp[r] = a.mp[q];
      w.nmp[r] = w.x[r] == kN ? w.mp[r] : a.nmp[q];
      w.m2m[r] = a.m2m[k];
      w.m2i[r] = a.m2i[k];
      w.i2i[r] = i2i;
    } else {
      w.x[r] = 0;
      w.mp[r] = 0.0f;
      w.nmp[r] = 0.0f;
      w.m2m[r] = 0.0f;
      w.m2i[r] = 0.0f;
      w.i2i[r] = i == 0 ? 1.0f : 0.0f;
    }
    AM[r] = AI[r] = 0.0f;
    AD[r] = i == 0 ? init : 0.0f;
    BM[r] = BI[r] = BD[r] = 0.0f;
    hb[r] = (i <= -1 && -i <= lh) ? static_cast<int>(hg[-i - 1]) : 0;
  }
  float nAM = 0.0f, nAI = 0.0f, nAD = 0.0f, nBM = 0.0f, nBI = 0.0f, nBD = 0.0f;
  const float top = off == 0 ? init : 0.0f;
  // lane 0's first row's haplotype base on diagonal e (column e - row0)
  auto hap = [&](int e) -> int {
    const int j = e - row0;
    return (lane0 && j >= 1 && j <= lh) ? static_cast<int>(hg[j - 1]) : 0;
  };
  // the row above lane 0 on diagonal e - 1: the buffer's column e - 1
  // (kMiddle, kBottom: lane 0's first row is row 1), else the boundary row 0
  // (M = I = 0, D = init) or, when off > 0, a zero row above it
  auto above = [&](int e, float& m, float& i, float& dd) {
    if constexpr (P == kMiddle || P == kBottom) {
      const int j = e - 1;
      if (lane0 && j >= 1 && j <= lh) {
        m = bnd.M[j - 1];
        i = bnd.I[j - 1];
        dd = bnd.D[j - 1];
      } else {
        m = 0.0f;
        i = 0.0f;
        dd = 0.0f;
      }
    } else {
      m = 0.0f;
      i = 0.0f;
      dd = top;
    }
  };

  float acc = 0.0f;
  const int n_diag = lr + lh;
  int hd = hap(1);
  int he = hap(2);
  float dM, dI, dD, eM, eI, eD;
  above(1, dM, dI, dD);
  above(2, eM, eI, eD);
  int d = 1;
  for (; d + 1 <= n_diag; d += 2) {
    // the next pair of diagonals' bases and rows above, loaded two
    // diagonals ahead
    const int hd_next = hap(d + 2);
    const int he_next = hap(d + 3);
    float dM_next, dI_next, dD_next, eM_next, eI_next, eD_next;
    above(d + 2, dM_next, dI_next, dD_next);
    above(d + 3, eM_next, eI_next, eD_next);
    warp_diagonal<R, P>(d, lane0, lr, lh, w, i2m, i2i, dM, dI, dD, hd, hb, AM, AI,
                        AD, BM, BI, BD, nAM, nAI, nAD, nBM, nBI, nBD, acc, bnd);
    warp_diagonal<R, P>(d + 1, lane0, lr, lh, w, i2m, i2i, eM, eI, eD, he, hb, BM, BI,
                        BD, AM, AI, AD, nBM, nBI, nBD, nAM, nAI, nAD, acc, bnd);
    hd = hd_next;
    he = he_next;
    dM = dM_next;
    dI = dI_next;
    dD = dD_next;
    eM = eM_next;
    eI = eI_next;
    eD = eD_next;
  }
  if (d <= n_diag) {
    warp_diagonal<R, P>(d, lane0, lr, lh, w, i2m, i2i, dM, dI, dD, hd, hb, AM, AI, AD,
                        BM, BI, BD, nAM, nAI, nAD, nBM, nBI, nBD, acc, bnd);
  }
  if constexpr (P == kWhole || P == kBottom) {
    if (lane == 31) {
      a.acc[b] = acc;
    }
  }
}

// stripe_rows<rp, P> for a runtime rp in 1..R.
template <int R, Part P>
__device__ __forceinline__ void stripe_dispatch(const int rp, const Args& a, const int b,
                                                const uint8_t* rb, const uint8_t* rq,
                                                const uint8_t* rr, const uint8_t* hg,
                                                const float init, const int lr,
                                                const int lh, const Boundary& bnd) {
  if (rp == R) {
    stripe_rows<R, P>(a, b, rb, rq, rr, hg, init, lr, lh, bnd);
  } else if constexpr (R > 1) {
    stripe_dispatch<R - 1, P>(rp, a, b, rb, rq, rr, hg, init, lr, lh, bnd);
  }
}

// Each warp takes R = ceil(lr / 32) rows per lane for its own pair (at
// least 1, at most the batch's RMAX), so a short read beside long ones
// runs on few rows. A pair over 32 * RMAX bases gets NaN.
template <int RMAX>
__global__ void __launch_bounds__(kMaxThreads) pairhmm_warp_kernel(Args a, int n_pairs) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= n_pairs) return;  // the whole warp: no barrier follows
  const int rid = a.pair_read[b];
  const int hid = a.pair_hap[b];
  const int lr = a.read_lengths[rid];
  const int lh = a.hap_lengths[hid];
  const int rp = lr > 32 ? (lr + 31) / 32 : 1;
  if (rp > RMAX) {
    if ((threadIdx.x & 31) == 0) a.acc[b] = __int_as_float(0x7fffffff);
    return;
  }
  const int o = a.read_offsets[rid];
  stripe_dispatch<RMAX, kWhole>(rp, a, b, a.read_bases + o, a.read_quals + o,
                                a.read_repeats + o, a.hap_bases + a.hap_offsets[hid],
                                a.hap_init[hid], lr, lh, Boundary{});
}

template <int R>
cudaError_t launch_warp(const Args& a, int n_pairs, int threads, cudaStream_t stream) {
  const int warps = threads / 32;
  pairhmm_warp_kernel<R><<<(n_pairs + warps - 1) / warps, threads, 0, stream>>>(
      a, n_pairs);
  return cudaGetLastError();
}

// Copies a haplotype's lh bases into the warp's shared memory at s, by
// 4-byte cp.async of the aligned words that hold them (the batch's fields
// are 16-byte aligned and padded to 16 bytes, so no word reaches outside
// the buffer), and returns where the bases start there.
__device__ __forceinline__ const uint8_t* stage_hap(const uint8_t* g, const int lh,
                                                    uint8_t* s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(g);
  const int shift = static_cast<int>(p & 3);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(p - shift);
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  const int words = (shift + lh + 3) >> 2;
  for (int k = threadIdx.x & 31; k < words; k += 32) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * k),
                 "l"(src + k)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  return s + shift;
}

// One pair per warp, swept in stripes: the first lr0 = lr - 256 * n rows
// (1..256) at ceil(lr0 / 32) rows per lane, then n stripes of 256 rows at 8
// rows per lane, each below the last row of the one above (the buffer).
// cap: the haplotype length the warps' shared memory was sized for; a pair
// with a longer haplotype gets NaN.
__global__ void __launch_bounds__(kMaxThreads) pairhmm_stripe_kernel(Args a, int n_pairs,
                                                                     int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n_pairs) return;  // the whole warp: no block barrier follows
  const int rid = a.pair_read[b];
  const int hid = a.pair_hap[b];
  const int lr = a.read_lengths[rid];
  const int lh = a.hap_lengths[hid];
  if (lh > cap) {
    if ((threadIdx.x & 31) == 0) a.acc[b] = __int_as_float(0x7fffffff);
    return;
  }
  unsigned char* mine = smem + static_cast<size_t>(warp) * stripe_smem_bytes(cap);
  float* f = reinterpret_cast<float*>(mine);
  const Boundary bnd{f, f + cap, f + 2 * cap};
  const uint8_t* hg = stage_hap(a.hap_bases + a.hap_offsets[hid], lh, mine + 12 * cap);
  const int o = a.read_offsets[rid];
  const uint8_t* rb = a.read_bases + o;
  const uint8_t* rq = a.read_quals + o;
  const uint8_t* rr = a.read_repeats + o;
  const float init = a.hap_init[hid];
  const int n_full = lr > kStripeRowsPerStripe ? (lr - 1) / kStripeRowsPerStripe : 0;
  const int lr0 = lr - kStripeRowsPerStripe * n_full;
  const int rp = lr0 > 32 ? (lr0 + 31) / 32 : 1;
  if (n_full == 0) {
    stripe_dispatch<kStripeRows, kWhole>(rp, a, b, rb, rq, rr, hg, init, lr0, lh, bnd);
    return;
  }
  stripe_dispatch<kStripeRows, kTop>(rp, a, b, rb, rq, rr, hg, init, lr0, lh, bnd);
  for (int s = 1; s <= n_full; ++s) {
    // lane 31's writes of the stripe above, before lane 0 reads them
    __syncwarp();
    const int base = lr0 + kStripeRowsPerStripe * (s - 1);
    if (s < n_full) {
      stripe_rows<kStripeRows, kMiddle>(a, b, rb + base, rq + base, rr + base, hg, init,
                                        kStripeRowsPerStripe, lh, bnd);
    } else {
      stripe_rows<kStripeRows, kBottom>(a, b, rb + base, rq + base, rr + base, hg, init,
                                        kStripeRowsPerStripe, lh, bnd);
    }
  }
}

// whether cudaFuncAttributeMaxDynamicSharedMemorySize is set, per device
// (zero-initialized: static storage)
std::atomic<int> g_stripe_smem_set[kMaxDevices];

cudaError_t launch_stripe(const Args& a, int n_pairs, int threads, int cap,
                          cudaStream_t stream) {
  const int warps = threads / 32;
  const size_t bytes = static_cast<size_t>(warps) * stripe_smem_bytes(cap);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (!g_stripe_smem_set[dev].load()) {
    err = cudaFuncSetAttribute(pairhmm_stripe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    g_stripe_smem_set[dev].store(1);
  }
  pairhmm_stripe_kernel<<<(n_pairs + warps - 1) / warps, threads, bytes, stream>>>(
      a, n_pairs, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per CTA the kernels take at most (their __launch_bounds__).
int pairhmm_max_threads() { return kMaxThreads; }

const char* pairhmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows per lane the warp kernel was built for: 1, 2, 3, ..., this value.
int pairhmm_warp_max_rows_per_lane() { return kWarpMaxRows; }

// acc[b] = sum over the last DP row of pair b of M + I, scaled by the
// haplotype's init (2^100 / lh), by the warp-per-pair kernel: threads / 32
// pairs per CTA (threads: a multiple of 32, at most 256);
// rows_per_lane: 1 .. kWarpMaxRows with 32 * rows_per_lane >= the longest
// read. Returns cudaGetLastError() after the launch.
int pairhmm_forward_warp(const uint8_t* read_bases, const uint8_t* read_quals,
                         const uint8_t* read_repeats, const int32_t* read_offsets,
                         const int32_t* read_lengths, const uint8_t* hap_bases,
                         const int32_t* hap_offsets, const int32_t* hap_lengths,
                         const float* hap_init, const int32_t* pair_read,
                         const int32_t* pair_hap, const float* mp, const float* nmp,
                         const float* m2m, const float* m2i, float i2m, float i2i,
                         float* acc, int n_pairs, int threads, int rows_per_lane,
                         void* stream) {
  if (n_pairs <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{read_bases, read_quals, read_repeats, read_offsets, read_lengths,
               hap_bases, hap_offsets, hap_lengths, hap_init, pair_read,
               pair_hap, mp, nmp, m2m, m2i, i2m, i2i, acc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_lane) {
    case 1: return static_cast<int>(launch_warp<1>(a, n_pairs, threads, s));
    case 2: return static_cast<int>(launch_warp<2>(a, n_pairs, threads, s));
    case 3: return static_cast<int>(launch_warp<3>(a, n_pairs, threads, s));
    case 4: return static_cast<int>(launch_warp<4>(a, n_pairs, threads, s));
    case 5: return static_cast<int>(launch_warp<5>(a, n_pairs, threads, s));
    case 6: return static_cast<int>(launch_warp<6>(a, n_pairs, threads, s));
    case 7: return static_cast<int>(launch_warp<7>(a, n_pairs, threads, s));
    case 8: return static_cast<int>(launch_warp<8>(a, n_pairs, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows per lane of a full stripe of the stripe path (32 * this value rows
// a stripe).
int pairhmm_stripe_rows_per_lane() { return kStripeRows; }

// Bytes of dynamic shared memory a warp of the stripe path takes for a batch
// whose longest haplotype has max_hap_len bases.
int pairhmm_stripe_smem_bytes(int max_hap_len) {
  return stripe_smem_bytes(stripe_cap(max_hap_len));
}

// The most shared memory a block may take on device dev (the opt-in limit),
// or -1.
int pairhmm_smem_per_block_optin(int dev) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ==
                 cudaSuccess
             ? v
             : -1;
}

// The same function as pairhmm_forward_warp, by the stripe kernel: threads / 32
// pairs per CTA (threads: a multiple of 32, at most 256), each warp's
// shared memory sized for haplotypes of up to max_hap_len bases (the
// batch's longest); any read length. Returns cudaErrorInvalidValue, with
// nothing launched, when those warps' shared memory exceeds the device's
// opt-in limit per block, else cudaGetLastError() after the launch.
int pairhmm_forward_stripe(const uint8_t* read_bases, const uint8_t* read_quals,
                           const uint8_t* read_repeats, const int32_t* read_offsets,
                           const int32_t* read_lengths, const uint8_t* hap_bases,
                           const int32_t* hap_offsets, const int32_t* hap_lengths,
                           const float* hap_init, const int32_t* pair_read,
                           const int32_t* pair_hap, const float* mp, const float* nmp,
                           const float* m2m, const float* m2i, float i2m, float i2i,
                           float* acc, int n_pairs, int threads, int max_hap_len,
                           void* stream) {
  if (n_pairs <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || max_hap_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{read_bases, read_quals, read_repeats, read_offsets, read_lengths,
               hap_bases, hap_offsets, hap_lengths, hap_init, pair_read,
               pair_hap, mp, nmp, m2m, m2i, i2m, i2i, acc};
  return static_cast<int>(launch_stripe(a, n_pairs, threads, stripe_cap(max_hap_len),
                                        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
