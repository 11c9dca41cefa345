// PairHMM forward pass (float32) over explicit (read, haplotype) pairs, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elprep_tpu/ops/pairhmm_pallas.py::_kernel
// (launched by pairhmm_pallas, fed by pairhmm_pallas_u8). Plain version:
// elprep_tpu_torch/ops/pairhmm_cuda.py::pairhmm_forward_plain.
//
// Two kernels compute the same function; the wrapper picks one per batch
// from the longest read (pairhmm_cuda.launch_plan):
//   pairhmm_warp_kernel  reads of up to 32 * kWarpMaxRows = 256 bases;
//   pairhmm_kernel       longer reads, up to 256 * 64 = 16384 bases.
// Both do the same operations in the same order, so each equals the plain
// version bit for bit on every pair.
//
// Bound (both). Per cell the recurrence needs 7 multiplies and 4 adds (11
// f32 operations, with (I2 + D2) * i2m as one multiply, plus one add per
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
// row 0, whose D so stays init exactly). Against the CTA kernel below:
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
//     column 1 first), so they stay +0, as the CTA kernel's skipped cells;
//   - the skew still idles rows before their first cell and after their
//     last: a warp sweeps 32*R rows over lr + lh diagonals for lr * lh
//     cells.

// CTA per pair (pairhmm_kernel). Thread t owns the R consecutive DP rows
// i = t*R+1 .. t*R+R (row i is read base i-1; row 0 is the boundary row
// with M = I = 0 and D = init). The match/insertion/deletion states of
// diagonals d-1 and d-2 live in registers. A cell (i, j = d-i) needs row
// i-1 on diagonals d-1 and d-2 and its own row on d-1: inside a thread
// that is the neighbouring register; across threads the last row of
// thread t-1 comes by __shfl_up_sync inside a warp and through shared
// memory (double-buffered by diagonal parity) across warps, with one
// barrier per diagonal. The loop over d stops at this pair's lr + lh.
// The thread that owns row lr adds M + I for 1 <= d - lr <= lh, in d order.
//
// Numerics. Every product and sum is an explicit __fmul_rn / __fadd_rn
// (and the library is built with -fmad=false), so nothing is contracted
// into an FMA. The operation order is the one of the plain version and of
// elprep_tpu/ops/pairhmm.py:284 (the JAX scan that produced the goldens):
//   M = prior * ((M2*m2m + I2*i2m) + D2*i2m)
//   I = M1u*m2i + I1u*i2i        (u: row i-1)
//   D = M1*m2i + D1*i2i
// so on the card this kernel equals the plain version bit for bit. A
// pair's value depends only on its own inputs, never on its batch.
//
// Tables. mp / nmp are indexed by the modified quality, m2m / m2i by the
// tandem-repeat length; each table's last entry is an exact-zero
// sentinel. Rows past the read length take the sentinel values (zeros),
// as in the plain version. 'N' matches anything by a direct byte compare.
//
// The CTA kernel issues one barrier and three shuffles per diagonal and
// leaves threads past a short read idle, so it runs far from the bound; it
// stays for reads longer than 256 bases, where a lane would have to hold
// about 12 * R live values of R > 8 rows in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
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

template <int R>
__global__ void __launch_bounds__(kMaxThreads) pairhmm_kernel(Args a) {
  const int b = blockIdx.x;
  const int rid = a.pair_read[b];
  const int hid = a.pair_hap[b];
  const int lr = a.read_lengths[rid];
  const int lh = a.hap_lengths[hid];
  const uint8_t* rb = a.read_bases + a.read_offsets[rid];
  const uint8_t* rq = a.read_quals + a.read_offsets[rid];
  const uint8_t* rr = a.read_repeats + a.read_offsets[rid];
  const uint8_t* hb = a.hap_bases + a.hap_offsets[hid];
  const float init = a.hap_init[hid];
  const float i2m = a.i2m;
  const float i2i = a.i2i;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = t * R + 1;

  // per-row inputs (rows past the read: sentinel zeros, base 0)
  uint8_t x[R];
  float mp[R], nmp[R], m2m[R], m2i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i <= lr) {
      x[r] = rb[i - 1];
      const int q = rq[i - 1];
      const int k = rr[i - 1];
      mp[r] = a.mp[q];
      nmp[r] = a.nmp[q];
      m2m[r] = a.m2m[k];
      m2i[r] = a.m2i[k];
    } else {
      x[r] = 0;
      mp[r] = 0.0f;
      nmp[r] = 0.0f;
      m2m[r] = 0.0f;
      m2i[r] = 0.0f;
    }
  }

  // states of diagonal d-1 (M1, I1, D1) and d-2 (M2, I2, D2); diagonal 0
  // is zero on every row >= 1
  float M1[R], I1[R], D1[R], M2[R], I2[R], D2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    M1[r] = I1[r] = D1[r] = 0.0f;
    M2[r] = I2[r] = D2[r] = 0.0f;
  }
  // row row0-1 on diagonal d-2 (diagonal -1 at d = 1: zero)
  float nM2 = 0.0f, nI2 = 0.0f, nD2 = 0.0f;

  // last row of each warp, by diagonal parity: [parity][warp][M, I, D]
  __shared__ float xch[2][kMaxWarps][3];
  if (t < kMaxWarps * 3) {
    (&xch[0][0][0])[t] = 0.0f;
  }
  __syncthreads();

  float acc = 0.0f;
  const int n_diag = lr + lh;
  for (int d = 1; d <= n_diag; ++d) {
    // row row0-1 on diagonal d-1
    float nM1 = __shfl_up_sync(kFull, M1[R - 1], 1);
    float nI1 = __shfl_up_sync(kFull, I1[R - 1], 1);
    float nD1 = __shfl_up_sync(kFull, D1[R - 1], 1);
    if (lane == 0) {
      if (warp == 0) {
        nM1 = 0.0f;
        nI1 = 0.0f;
        nD1 = init;
      } else {
        const float* s = xch[(d - 1) & 1][warp - 1];
        nM1 = s[0];
        nI1 = s[1];
        nD1 = s[2];
      }
    }
    // descending rows: row r-1 and row r still hold diagonals d-1, d-2
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int i = row0 + r;
      const int j = d - i;
      const float uM1 = r > 0 ? M1[r > 0 ? r - 1 : 0] : nM1;
      const float uI1 = r > 0 ? I1[r > 0 ? r - 1 : 0] : nI1;
      const float uM2 = r > 0 ? M2[r > 0 ? r - 1 : 0] : nM2;
      const float uI2 = r > 0 ? I2[r > 0 ? r - 1 : 0] : nI2;
      const float uD2 = r > 0 ? D2[r > 0 ? r - 1 : 0] : nD2;
      float Mn = 0.0f, In = 0.0f, Dn = 0.0f;
      if (j >= 1) {
        const uint8_t h = j <= lh ? hb[j - 1] : 0;
        const bool match = (x[r] == h) | (x[r] == kN) | (h == kN);
        const float prior = match ? mp[r] : nmp[r];
        Mn = __fmul_rn(prior,
                       __fadd_rn(__fadd_rn(__fmul_rn(uM2, m2m[r]),
                                           __fmul_rn(uI2, i2m)),
                                 __fmul_rn(uD2, i2m)));
        In = __fadd_rn(__fmul_rn(uM1, m2i[r]), __fmul_rn(uI1, i2i));
        Dn = __fadd_rn(__fmul_rn(M1[r], m2i[r]), __fmul_rn(D1[r], i2i));
        if (i == lr && j <= lh) {
          acc = __fadd_rn(acc, __fadd_rn(Mn, In));
        }
      }
      M2[r] = M1[r];
      I2[r] = I1[r];
      D2[r] = D1[r];
      M1[r] = Mn;
      I1[r] = In;
      D1[r] = Dn;
    }
    nM2 = nM1;
    nI2 = nI1;
    nD2 = nD1;
    if (lane == 31) {
      float* s = xch[d & 1][warp];
      s[0] = M1[R - 1];
      s[1] = I1[R - 1];
      s[2] = D1[R - 1];
    }
    __syncthreads();
  }
  if ((lr - 1) / R == t) {
    a.acc[b] = acc;
  }
}

template <int R>
cudaError_t launch(const Args& a, int n_pairs, int threads, cudaStream_t stream) {
  pairhmm_kernel<R><<<n_pairs, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Warp per pair
// ---------------------------------------------------------------------------

constexpr int kWarpMaxRows = 8;

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
// return; h1 is the base of lane 0's first row on d; top is the D of the
// row above lane 0. The last register of lane 31 is row lr.
template <int R>
__device__ __forceinline__ void warp_diagonal(
    const int d, const bool lane0, const int lr, const int lh,
    const LaneRows<R>& w, const float i2m, const float i2i, const float top,
    const int h1, int (&hb)[R], const float (&CM)[R], const float (&CI)[R],
    const float (&CD)[R], float (&OM)[R], float (&OI)[R], float (&OD)[R],
    float& nCM, float& nCI, float& nCD, const float nOM, const float nOI,
    const float nOD, float& acc) {
  nCM = __shfl_up_sync(kFull, CM[R - 1], 1);
  nCI = __shfl_up_sync(kFull, CI[R - 1], 1);
  nCD = __shfl_up_sync(kFull, CD[R - 1], 1);
  int h0 = __shfl_up_sync(kFull, hb[R - 1], 1);
  if (lane0) {
    nCM = 0.0f;
    nCI = 0.0f;
    nCD = top;
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
  // row lr (used by lane 31 only), in d order
  if (d - lr >= 1 && d - lr <= lh) {
    acc = __fadd_rn(acc, __fadd_rn(OM[R - 1], OI[R - 1]));
  }
}

// One pair on one warp with R rows per lane, 32 * R >= lr. Rows are
// aligned to the bottom: lane l holds rows l*R+1-off .. l*R+R-off with
// off = 32 * R - lr, so row lr is lane 31's last register.
template <int R>
__device__ __forceinline__ void warp_pair(const Args& a, const int b, const int rid,
                                          const int hid, const int lr, const int lh) {
  const uint8_t* rb = a.read_bases + a.read_offsets[rid];
  const uint8_t* rq = a.read_quals + a.read_offsets[rid];
  const uint8_t* rr = a.read_repeats + a.read_offsets[rid];
  const uint8_t* hg = a.hap_bases + a.hap_offsets[hid];
  const float init = a.hap_init[hid];
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

  float acc = 0.0f;
  const int n_diag = lr + lh;
  int hd = hap(1);
  int he = hap(2);
  int d = 1;
  for (; d + 1 <= n_diag; d += 2) {
    // the next pair of diagonals' bases, loaded two diagonals ahead
    const int hd_next = hap(d + 2);
    const int he_next = hap(d + 3);
    warp_diagonal<R>(d, lane0, lr, lh, w, i2m, i2i, top, hd, hb, AM, AI, AD, BM,
                     BI, BD, nAM, nAI, nAD, nBM, nBI, nBD, acc);
    warp_diagonal<R>(d + 1, lane0, lr, lh, w, i2m, i2i, top, he, hb, BM, BI, BD,
                     AM, AI, AD, nBM, nBI, nBD, nAM, nAI, nAD, acc);
    hd = hd_next;
    he = he_next;
  }
  if (d <= n_diag) {
    warp_diagonal<R>(d, lane0, lr, lh, w, i2m, i2i, top, hd, hb, AM, AI, AD, BM,
                     BI, BD, nAM, nAI, nAD, nBM, nBI, nBD, acc);
  }
  if (lane == 31) {
    a.acc[b] = acc;
  }
}

// Each warp takes R = ceil(lr / 32) rows per lane for its own pair (at
// least 1, at most the batch's RMAX), so a short read beside long ones
// runs on few rows. A pair over 32 * RMAX bases gets NaN.
template <int R>
__device__ __forceinline__ void warp_dispatch(const Args& a, const int b, const int rid,
                                              const int hid, const int lr, const int lh,
                                              const int rp) {
  if (rp == R) {
    warp_pair<R>(a, b, rid, hid, lr, lh);
  } else if constexpr (R > 1) {
    warp_dispatch<R - 1>(a, b, rid, hid, lr, lh, rp);
  }
}

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
  warp_dispatch<RMAX>(a, b, rid, hid, lr, lh, rp);
}

template <int R>
cudaError_t launch_warp(const Args& a, int n_pairs, int threads, cudaStream_t stream) {
  const int warps = threads / 32;
  pairhmm_warp_kernel<R><<<(n_pairs + warps - 1) / warps, threads, 0, stream>>>(
      a, n_pairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per thread the library was built for: 1, 2, 4, ..., this value.
int pairhmm_max_rows_per_thread() { return 64; }
int pairhmm_max_threads() { return kMaxThreads; }

const char* pairhmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// acc[b] = sum over the last DP row of pair b of M + I, scaled by the
// haplotype's init (2^100 / lh). threads: a multiple of 32, at most 256;
// rows_per_thread: a power of two with threads * rows_per_thread >= the
// longest read. Returns cudaGetLastError() after the launch.
int pairhmm_forward(const uint8_t* read_bases, const uint8_t* read_quals,
                    const uint8_t* read_repeats, const int32_t* read_offsets,
                    const int32_t* read_lengths, const uint8_t* hap_bases,
                    const int32_t* hap_offsets, const int32_t* hap_lengths,
                    const float* hap_init, const int32_t* pair_read,
                    const int32_t* pair_hap, const float* mp, const float* nmp,
                    const float* m2m, const float* m2i, float i2m, float i2i,
                    float* acc, int n_pairs, int threads, int rows_per_thread,
                    void* stream) {
  if (n_pairs <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{read_bases, read_quals, read_repeats, read_offsets, read_lengths,
               hap_bases, hap_offsets, hap_lengths, hap_init, pair_read,
               pair_hap, mp, nmp, m2m, m2i, i2m, i2i, acc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 1: return static_cast<int>(launch<1>(a, n_pairs, threads, s));
    case 2: return static_cast<int>(launch<2>(a, n_pairs, threads, s));
    case 4: return static_cast<int>(launch<4>(a, n_pairs, threads, s));
    case 8: return static_cast<int>(launch<8>(a, n_pairs, threads, s));
    case 16: return static_cast<int>(launch<16>(a, n_pairs, threads, s));
    case 32: return static_cast<int>(launch<32>(a, n_pairs, threads, s));
    case 64: return static_cast<int>(launch<64>(a, n_pairs, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows per lane the warp kernel was built for: 1, 2, 3, ..., this value.
int pairhmm_warp_max_rows_per_lane() { return kWarpMaxRows; }

// The same function as pairhmm_forward, by the warp-per-pair kernel:
// threads / 32 pairs per CTA (threads: a multiple of 32, at most 256);
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

}  // extern "C"
