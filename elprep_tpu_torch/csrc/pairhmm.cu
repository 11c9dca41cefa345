// PairHMM forward pass (float32) over explicit (read, haplotype) pairs, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elprep_tpu/ops/pairhmm_pallas.py::_kernel
// (launched by pairhmm_pallas, fed by pairhmm_pallas_u8). Plain version:
// elprep_tpu_torch/ops/pairhmm_cuda.py::pairhmm_forward_plain.
//
// Layout. One CTA per pair; thread t owns the R consecutive DP rows
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
// Bound. Per cell the recurrence does 7 multiplies and 4 adds (11 f32
// operations, plus one add per cell of row lr). Work per batch is
// 11 * sum(lr * lh) f32 operations, against the card's 67 TFLOP/s of
// non-tensor float32 (H100 SXM); the bytes (u8 bases and quals, f32
// output) are three orders of magnitude below the memory bound. This
// first version issues one barrier and three shuffles per diagonal and
// leaves threads past a short read idle, so it runs far from that bound.

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

}  // extern "C"
