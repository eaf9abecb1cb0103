// The bucket MSM (Pippenger): out[r] = Σ_i s_ri·P_ri over rows of N pairs.
//
// Computes what bulletproofsplus_tpu/msm/pippenger.py:75-153 computes, which
// is XLA (lax.scan, gather/scatter), not a Pallas kernel; the coefficient-form
// prover (protocol/wip_coeff.py) runs its L/R rows on it. One template built
// once per family (family.cuh); three entry points, in launch order:
//
// - accumulate: one thread per (row, slice, window), window fastest. The N
//   pairs of a row split into `slices` runs; a thread sets its 2^c buckets
//   to the identity, then walks its run and adds each point whose c-bit
//   digit d (bits w·c .. w·c + c − 1 of the scalar, from the 64-bit pair of
//   its word and the next) is nonzero into bucket d. Each thread owns its
//   buckets, so no atomics (the conflict-free layout of pippenger.py:19-26).
//   Buckets are (R, slices, nwin, 2^c) points in global memory.
// - merge (only when slices > 1): one thread per (row, window, digit) adds
//   its digit's bucket over the slices, in slice order.
// - reduce (pippenger.py:123-151): Σ_w 2^(c·w)·Σ_d d·bucket_(w,d) a row, in
//   two launches whose dependent chains the quads of a warp share (the
//   quad adds and doublings of points.cuh: every lane of a quad holds the
//   same points, each does one product of a round, so an add's dependent
//   chain is 3 or 4 products, not 9 or 14, and a doubling's 2 or 3).
//   1. Window sums: a quad per (row, window, segment), `nseg` segments (1,
//      2, 4 or 8, which the wrapper picks so the launch fills the card: 8
//      at a single proof's rows) on consecutive quads; where even one quad
//      a window overfills the card (K = 256), nseg = 0: a thread a window
//      runs nseg = 1's adds alone, each add's products issued once and not
//      on four lanes with their shuffles.
//      Segment s holds digits s + nseg·j, j < J = 2^c / nseg, so at step j
//      the window's quads read neighbouring buckets. Each forms, from j =
//      J − 1 down, its sum S_s and its weighted sum W_s = Σ_j j·b_(s+nseg·j)
//      as running sums (2(J − 1) adds, and one more for S; bucket 0, of
//      weight 0, enters neither). Then Σ_d d·b_d = nseg·Σ_s W_s +
//      Σ_(s ≥ 1) T_s with T_s = Σ_(s' ≥ s) S_s': a suffix scan of the S
//      over the quads (log2 nseg shuffled adds), log2 nseg doublings of
//      each W, one add, and a butterfly over the quads (log2 nseg adds). The chain falls from
//      2(2^c − 1) single adds to about 2·2^c/nseg + 3·log2 nseg quad ops.
//   2. Horner: a quad a row, MSB first: the top window's sum, then c
//      doublings and one add a window below it, c·(nwin − 1) quad
//      doublings deep, the work's own dependent path.
//
// Points of a row may be shared: row r reads point row r mod prow, so the
// coefficient prover's K proofs read one copy of the key's generators.
// Every add is the family's complete pt_add or pt_add_quad (a bucket can
// meet P + P or the identity + P; the two give the same words), so the
// plain versions (curves/cuda_curve.py, which add in the same order) give
// the same coordinates. What bounds it: the adds, R·N·nwin at most in
// accumulate (9 or 14 Montgomery products each), each reading and writing
// its 96-144-byte bucket in global memory; and at few rows the dependent
// chains (N/slices adds, then slices, then the reduce's two stages).
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 128;

template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_accumulate_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ scal,
                             uint32_t* __restrict__ buckets, long long R, long long N,
                             long long prow, int nwin, int c, int slices, typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * slices * nwin) return;
  const int w = (int)(t % nwin);
  const long long rs = t / nwin;
  const long long s = rs % slices, r = rs / slices;
  const int B = 1 << c;
  uint32_t* bk = buckets + t * B * W;
  P acc, pt;
  pt_identity(acc, K);
#pragma unroll 1
  for (int d = 0; d < B; ++d) pt_store(bk + d * W, acc);
  const long long per = (N + slices - 1) / slices;
  const long long lo = s * per, hi = min(N, lo + per);
  const int pos = w * c, word = pos >> 5, shift = pos & 31;
  const uint32_t mask = (1u << c) - 1u;
  const uint32_t* sr = scal + r * N * SW;
  const uint32_t* pr = pts + (r % prow) * N * W;
#pragma unroll 1
  for (long long i = lo; i < hi; ++i) {
    const uint32_t* si = sr + i * SW;
    uint64_t pair = si[word];
    if (word + 1 < SW) pair |= (uint64_t)si[word + 1] << 32;
    const uint32_t d = (uint32_t)(pair >> shift) & mask;
    if (d == 0) continue;
    pt_load(acc, bk + d * W);
    pt_load(pt, pr + i * W);
    pt_add(acc, acc, pt, K);
    pt_store(bk + d * W, acc);
  }
}

template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_merge_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ merged,
                        long long R, int nwin, int c, int slices, typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const int B = 1 << c;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * nwin * B) return;
  const long long d = t % B, rw = t / B;
  const long long w = rw % nwin, r = rw / nwin;
  const long long stride = (long long)nwin * B * W;      // one slice's buckets
  const uint32_t* src = buckets + r * slices * stride + (w * B + d) * W;
  P acc, q;
  pt_load(acc, src);
#pragma unroll 1
  for (int s = 1; s < slices; ++s) {
    pt_load(q, src + s * stride);
    pt_add(acc, acc, q, K);
  }
  pt_store(merged + t * W, acc);
}

// Stage 1 of the reduce: sums[r·nwin + w] = Σ_d d·bucket_(r,w,d), a quad
// per (window, segment) as above. Every lane of a warp runs every quad op
// (their shuffles take the full warp); quads past the last window work on
// window 0 and store nothing.
template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_windows_kernel(const uint32_t* __restrict__ merged,
                                 uint32_t* __restrict__ sums, long long R, int nwin, int c,
                                 int nseg, typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const int B = 1 << c, J = B / nseg;
  const long long quad = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 4;
  const long long win = quad / nseg;
  const int s = (int)(quad % nseg);
  const bool live = win < R * nwin;
  const uint32_t* bk = merged + (live ? win : 0) * B * W;
  P run, wsum, q, t;
  pt_identity(run, K);
  pt_identity(wsum, K);
#pragma unroll 1
  for (int j = J - 1; j >= 1; --j) {
    pt_load(q, bk + (s + nseg * j) * W);
    pt_add_quad(run, run, q, K);
    pt_add_quad(wsum, wsum, run, K);
  }
  if (nseg > 1) {
    // S_s: segment 0 skips its digit 0
    pt_load(q, bk + s * W);
    pt_add_quad(t, run, q, K);
    if (s != 0) run = t;
    // T_s = Σ_(s' ≥ s) S_s', Hillis–Steele over the window's quads
#pragma unroll 1
    for (int k = 1; k < nseg; k <<= 1) {
      pt_shfl_down(q, run, 4 * k);
      pt_add_quad(t, run, q, K);
      if (s + k < nseg) run = t;
    }
#pragma unroll 1
    for (int k = 1; k < nseg; k <<= 1) pt_dbl_quad(wsum, wsum, K);
    pt_add_quad(t, wsum, run, K);
    if (s != 0) wsum = t;
    pt_butterfly(wsum, 4, 4 * nseg, K);
  }
  if (live && s == 0 && (threadIdx.x & 3) == 0) pt_store(sums + win * W, wsum);
}

// Stage 1 where one quad a window would overfill the card (nseg = 0): a
// thread a window runs segment 0's adds of nseg = 1, J = 2^c, each by
// pt_add (the same words as pt_add_quad's) on its own lane, so the card
// issues each product once and not on four lanes.
template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_windows_lane_kernel(const uint32_t* __restrict__ merged,
                                      uint32_t* __restrict__ sums, long long R, int nwin, int c,
                                      typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const int B = 1 << c;
  const long long win = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (win >= R * nwin) return;
  const uint32_t* bk = merged + win * B * W;
  P run, wsum, q;
  pt_identity(run, K);
  pt_identity(wsum, K);
#pragma unroll 1
  for (int j = B - 1; j >= 1; --j) {
    pt_load(q, bk + j * W);
    pt_add(run, run, q, K);
    pt_add(wsum, wsum, run, K);
  }
  pt_store(sums + win * W, wsum);
}

// Stage 2 of the reduce: out[r] = Horner over the row's window sums, MSB
// first, a quad a row (quads past the last row work on row 0 and store
// nothing).
template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_horner_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out,
                                long long R, int nwin, int c, typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 4;
  const bool live = r < R;
  const uint32_t* sr = sums + (live ? r : 0) * nwin * W;
  P acc, q;
  pt_load(acc, sr + (long long)(nwin - 1) * W);
#pragma unroll 1
  for (int w = nwin - 2; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < c; ++i) pt_dbl_quad(acc, acc, K);
    pt_load(q, sr + (long long)w * W);
    pt_add_quad(acc, acc, q, K);
  }
  if (live && (threadIdx.x & 3) == 0) pt_store(out + r * W, acc);
}

unsigned blocks_for(long long threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int BPP_ENTRY(bpp_pippenger_accumulate)(const void* pts, const void* scal,
                                                   void* buckets, long long R, long long N,
                                                   long long prow, int nwin, int c, int slices,
                                                   const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  if (c < 1 || c > 16 || slices < 1 || prow < 1) return (int)cudaErrorInvalidValue;
  bucket_accumulate_kernel<FamilyPt>
      <<<blocks_for(R * slices * nwin), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)pts, (const uint32_t*)scal, (uint32_t*)buckets, R, N, prow, nwin, c,
          slices, K);
  return (int)cudaGetLastError();
}

extern "C" int BPP_ENTRY(bpp_pippenger_merge)(const void* buckets, void* merged, long long R,
                                              int nwin, int c, int slices,
                                              const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  if (c < 1 || c > 16 || slices < 1) return (int)cudaErrorInvalidValue;
  bucket_merge_kernel<FamilyPt>
      <<<blocks_for(R * nwin * (1LL << c)), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)buckets, (uint32_t*)merged, R, nwin, c, slices, K);
  return (int)cudaGetLastError();
}

// scratch: R·nwin window sums; nseg: segments a window (1, 2, 4 or 8, at
// most 2^c), or 0 for a thread a window. Two launches, the window sums and
// Horner.
extern "C" int BPP_ENTRY(bpp_pippenger_reduce)(const void* merged, void* out, void* scratch,
                                               long long R, int nwin, int c, int nseg,
                                               const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  if (c < 1 || c > 16 || nwin < 1 ||
      (nseg != 0 && nseg != 1 && nseg != 2 && nseg != 4 && nseg != 8) || nseg > (1 << c))
    return (int)cudaErrorInvalidValue;
  uint32_t* sums = (uint32_t*)scratch;
  if (nseg == 0)
    bucket_reduce_windows_lane_kernel<FamilyPt>
        <<<blocks_for(R * nwin), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)merged, sums, R, nwin, c, K);
  else
    bucket_reduce_windows_kernel<FamilyPt>
        <<<blocks_for(R * nwin * nseg * 4), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)merged, sums, R, nwin, c, nseg, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bucket_reduce_horner_kernel<FamilyPt><<<blocks_for(R * 4), THREADS, 0, (cudaStream_t)stream>>>(
      sums, (uint32_t*)out, R, nwin, c, K);
  return (int)cudaGetLastError();
}

// Blocks of the accumulate kernel that the current device holds at once
// (blocks an SM at THREADS threads × SMs), or -1 on a CUDA error.
extern "C" int BPP_ENTRY(bpp_pippenger_accumulate_resident)(void) {
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bucket_accumulate_kernel<FamilyPt>, THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// Blocks of the reduce's window-sum kernel that the current device holds at
// once, or -1 on a CUDA error.
extern "C" int BPP_ENTRY(bpp_pippenger_reduce_resident)(void) {
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bucket_reduce_windows_kernel<FamilyPt>, THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}
