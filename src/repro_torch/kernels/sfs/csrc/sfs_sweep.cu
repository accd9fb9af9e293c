// Fused Sort-Filter-Skyline sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas sweeps of the JAX package, which compute the
// same function:
//   src/repro/kernels/sfs/kernel.py  sfs_sweep_pallas      (TPU grid)
//   src/repro/kernels/sfs/gpu.py     sfs_sweep_pallas_gpu  (one program
//                                    per partition)
// and is held bit for bit against the plain PyTorch version
// (repro_torch.kernels.sfs.ops.sfs_sweep_torch).
//
// Contract.  In: P partitions of npad rows, (P, npad, d) f32 row-major,
// each presorted by a strictly monotone score with invalid rows holding
// the sentinel, and a (P, npad) bool mask; npad % block == 0.  Out, per
// partition: the first wcap kept rows in score order (the window, which
// the caller pre-fills with the sentinel), their mask (pre-filled with
// false), and the total keep count, which goes on past wcap.
//
// Design.  One CTA per partition walks the candidate blocks in order;
// the loop takes the place of the TPU's sequential grid dimension.  For
// each block:
//   (a) each candidate is tested against the live window rows
//       [0, min(count, wcap)) only (the TPU's untiled body tests all wcap
//       rows; empty slots hold the sentinel and are inert, so the bits
//       are the same).  The window is staged through shared memory in
//       tiles of kTile rows; a thread stops at its candidate's first
//       dominator, and the CTA stops when every candidate is dominated.
//   (b) thread i tests the earlier rows j < i of its block, held in
//       shared memory.  A dominator that the window dominates in turn
//       changes nothing: the window then dominates i too.
//   (c) a CTA-wide exclusive scan of the keep flags gives each kept row
//       its slot, count + prefix; a plain store writes it when the slot
//       is below wcap.  A plain store keeps -0.0, so the TPU's one-hot
//       integer-bit sum is not needed.
//
// What bounds it on this card.  The bytes it must move (points and mask
// in, window, mask and count out) take about 0.1 ms at 3.35 TB/s for
// N = 10^7, d = 4, and the compares tens of microseconds at 67 TFLOP/s
// f32, so the bytes set the bound.  The kernel is far from it: it runs P
// CTAs, so 8 of the H100's 132 SMs at the default p = 8 and 1 in the
// merge call, and each CTA walks its blocks one after another with a few
// barriers per block and per window tile.  More CTAs per partition
// (splitting the window test of a block across CTAs) is left for a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // largest candidate block
constexpr int kTile = 256;        // window rows staged per tile

template <int D>
__device__ __forceinline__ bool dominates(const float* w, const float (&x)[D]) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    le &= w[k] <= x[k];
    lt |= w[k] < x[k];
  }
  return le && lt;
}

// Exclusive prefix sum of v over the CTA (blockDim.x a multiple of 32);
// *total receives the CTA-wide sum.  The caller synchronises before
// warp_tot is written again.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_tot[lane] = s;
  }
  __syncthreads();
  *total = warp_tot[nwarps - 1];
  return (warp ? warp_tot[warp - 1] : 0) + x - v;
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
sfs_sweep_kernel(const float* __restrict__ pts,
                 const uint8_t* __restrict__ mask, float* win,
                 uint8_t* __restrict__ wmask, int* __restrict__ count_out,
                 int npad, int block, int wcap) {
  __shared__ float cand[kMaxThreads * D];
  __shared__ float tile[kTile * D];
  __shared__ int warp_tot[32];

  const int tid = threadIdx.x;
  const float* P = pts + (size_t)blockIdx.x * npad * D;
  const uint8_t* M = mask + (size_t)blockIdx.x * npad;
  float* W = win + (size_t)blockIdx.x * wcap * D;
  uint8_t* WM = wmask + (size_t)blockIdx.x * wcap;

  int count = 0;  // keeps so far, the same in every thread
  for (int base = 0; base < npad; base += block) {
    for (int e = tid; e < block * D; e += blockDim.x)
      cand[e] = P[(size_t)base * D + e];
    __syncthreads();
    const bool mine = tid < block;
    float x[D];
#pragma unroll
    for (int k = 0; k < D; ++k) x[k] = mine ? cand[tid * D + k] : 0.f;
    bool alive = mine && M[base + tid] != 0;

    // (a) the live window, one shared-memory tile at a time
    const int live = min(count, wcap);
    for (int t0 = 0; t0 < live; t0 += kTile) {
      if (!__syncthreads_or(alive)) break;
      const int rows = min(kTile, live - t0);
      for (int e = tid; e < rows * D; e += blockDim.x)
        tile[e] = W[(size_t)t0 * D + e];
      __syncthreads();
      if (alive) {
        for (int j = 0; j < rows; ++j) {
          if (dominates<D>(tile + j * D, x)) {
            alive = false;
            break;
          }
        }
      }
    }

    // (b) the earlier rows of the block
    if (alive) {
      for (int j = 0; j < tid; ++j) {
        if (dominates<D>(cand + j * D, x)) {
          alive = false;
          break;
        }
      }
    }

    // (c) append at count + prefix; keeps past wcap are counted only
    int total;
    const int prefix = block_exclusive_sum(alive ? 1 : 0, warp_tot, &total);
    if (alive && count + prefix < wcap) {
      const size_t slot = (size_t)(count + prefix);
#pragma unroll
      for (int k = 0; k < D; ++k) W[slot * D + k] = x[k];
      WM[slot] = 1;
    }
    count += total;
    __syncthreads();
  }
  if (tid == 0) count_out[blockIdx.x] = count;
}

template <int D>
cudaError_t launch(const void* pts, const void* mask, void* win, void* wmask,
                   void* count, int parts, int npad, int block, int wcap,
                   cudaStream_t stream) {
  const int threads = (block + 31) / 32 * 32;
  sfs_sweep_kernel<D><<<parts, threads, 0, stream>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<float*>(win), static_cast<uint8_t*>(wmask),
      static_cast<int*>(count), npad, block, wcap);
  return cudaGetLastError();
}

}  // namespace

// Launches the sweep on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and devices; the checks here only keep
// a bad call from launching.
extern "C" int sfs_sweep_launch(const void* pts, const void* mask, void* win,
                                void* wmask, void* count, int parts, int npad,
                                int d, int block, int wcap, void* stream) {
  if (parts < 1 || npad < 1 || block < 1 || block > kMaxThreads ||
      npad % block != 0 || wcap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SFS_CASE(D) \
  case D:           \
    return static_cast<int>(launch<D>(pts, mask, win, wmask, count, parts, npad, block, wcap, s));
    SFS_CASE(1) SFS_CASE(2) SFS_CASE(3) SFS_CASE(4) SFS_CASE(5) SFS_CASE(6)
    SFS_CASE(7) SFS_CASE(8) SFS_CASE(9) SFS_CASE(10) SFS_CASE(11) SFS_CASE(12)
#undef SFS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sfs_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
