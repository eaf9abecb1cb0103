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
// - reduce: one thread per (row, window) forms Σ_d d·bucket_d as a running
//   sum from 2^c − 1 down to 1 (2·(2^c − 1) adds) and writes it to scratch;
//   the row's last window to finish (an atomic ticket after __threadfence)
//   runs Horner, MSB first: c doublings and one add per window
//   (pippenger.py:141-151).
//
// Points of a row may be shared: row r reads point row r mod prow, so the
// coefficient prover's K proofs read one copy of the key's generators.
// Every add is the family's complete pt_add (a bucket can meet P + P or the
// identity + P), so the plain versions (curves/cuda_curve.py, which add in
// the same order) give the same coordinates. What bounds it: the adds,
// R·N·nwin at most in accumulate (9 or 14 Montgomery products each), each
// reading and writing its 96-144-byte bucket in global memory; and at few
// rows the dependent chain of one thread (N/slices adds, then slices, then
// 2·(2^c − 1) adds, then c·nwin doublings and nwin adds).
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

template <class P>
__global__ void __launch_bounds__(THREADS)
    bucket_reduce_kernel(const uint32_t* __restrict__ merged, uint32_t* __restrict__ out,
                         uint32_t* sums, unsigned* __restrict__ tickets, long long R, int nwin,
                         int c, typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  const int B = 1 << c;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * nwin) return;
  const long long r = t / nwin;
  const uint32_t* bk = merged + t * B * W;
  P run, tot, q;
  pt_identity(run, K);
  pt_identity(tot, K);
#pragma unroll 1
  for (int d = B - 1; d >= 1; --d) {
    pt_load(q, bk + d * W);
    pt_add(run, run, q, K);
    pt_add(tot, tot, run, K);
  }
  pt_store(sums + t * W, tot);
  __threadfence();
  if (atomicAdd(&tickets[r], 1u) != (unsigned)(nwin - 1)) return;
  __threadfence();
  // the row's last window: Horner over the row's window sums, MSB first
  pt_identity(run, K);
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < c; ++i) pt_dbl(run, run, K);
    pt_load_cg(q, sums + (r * nwin + w) * W);
    pt_add(run, run, q, K);
  }
  pt_store(out + r * W, run);
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

// scratch: R·nwin window sums, then R tickets, which start at 0
extern "C" int BPP_ENTRY(bpp_pippenger_reduce)(const void* merged, void* out, void* scratch,
                                               long long R, int nwin, int c,
                                               const uint32_t* consts, void* stream) {
  constexpr int W = FamilyPt::NC * FamilyPt::NL;
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  if (c < 1 || c > 16) return (int)cudaErrorInvalidValue;
  uint32_t* sums = (uint32_t*)scratch;
  unsigned* tickets = (unsigned*)(sums + R * nwin * W);
  const cudaError_t err =
      cudaMemsetAsync(tickets, 0, R * sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  bucket_reduce_kernel<FamilyPt><<<blocks_for(R * nwin), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)merged, (uint32_t*)out, sums, tickets, R, nwin, c, K);
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
