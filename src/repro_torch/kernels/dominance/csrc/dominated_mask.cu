// Blocked pairwise dominance test for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas dominance kernels of the JAX package, which
// compute the same function:
//   src/repro/kernels/dominance/kernel.py  dominated_mask_pallas
//                                          (TPU grid, revisited OR block)
//   src/repro/kernels/dominance/gpu.py     dominated_mask_pallas_gpu
//                                          (one program per cand block)
// and is held bit for bit against the plain PyTorch version
// (repro_torch.kernels.dominance.ops.dominated_mask_torch).
//
// Contract.  In: B batches of C candidates, (B, C, d) f32 row-major;
// references (B, R, d) f32 with rows contiguous and any batch stride
// (0 broadcasts one reference set over the batch); a (B, R) bool mask,
// again with any batch stride.  Out: (B, C) bool, out[b, i] = some valid
// reference j of batch b dominates candidate i (all k ref <= cand, some
// k ref < cand); in lower_tri mode only references j < i count.  Every
// candidate gets its bit; only the references are masked.
//
// Design.  The grid is (ceil(C / 256), B); each thread holds one
// candidate row in registers.  The CTA walks the references in tiles of
// kTile rows, staged through shared memory with their mask:
//   - a thread stops at its candidate's first dominator, and the CTA
//     stops when every candidate is decided (__syncthreads_or);
//   - a tile whose mask is all false is skipped before its points are
//     loaded, so the masked tail of a compacted state buffer, or a batch
//     with no potential dominators at all (NoSeq's first slice), costs
//     one mask read and two barriers per tile;
//   - in lower_tri mode the walk ends at the CTA's last candidate.
// The TPU's transposed (8, N) layout and the padding to 512 rows served
// its lanes; here the kernel reads the row-major layout directly and
// masks the ragged edge itself.  The output is pure comparisons, so it
// is bit-exact by construction (-0.0 <= +0.0 holds and -0.0 < +0.0 does
// not, in both versions).
//
// What bounds it on this card.  The bytes it must move (candidates,
// references, mask in; one byte per candidate out) at 3.35 TB/s, or the
// 2d operations of each compare it needs at 67 TFLOP/s f32 (no tensor
// cores), whichever is larger.  With early exit the compares a call
// needs depend on the data: each candidate tests the valid references
// up to and including its first dominator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // candidates per CTA
constexpr int kTile = 256;     // reference rows staged per tile
static_assert(kTile == kThreads, "one mask byte per thread per tile");

template <int D>
__device__ __forceinline__ bool dominates(const float* r, const float (&x)[D]) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    le &= r[k] <= x[k];
    lt |= r[k] < x[k];
  }
  return le && lt;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dominated_mask_kernel(const float* __restrict__ cands,
                      const float* __restrict__ refs,
                      const uint8_t* __restrict__ mask,
                      uint8_t* __restrict__ out, int C, int R,
                      long long ref_bstride, long long mask_bstride,
                      int lower_tri) {
  __shared__ float tile[kTile * D];
  __shared__ uint8_t tmask[kTile];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int i = c0 + tid;
  const bool valid = i < C;
  const float* Rb = refs + b * ref_bstride;
  const uint8_t* Mb = mask + b * mask_bstride;

  float x[D];
  const float* xc = cands + (b * C + (valid ? i : 0)) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) x[k] = valid ? xc[k] : 0.f;

  bool dom = false;
  // lower_tri: refs j < i only, and the CTA's last candidate is
  // min(C, c0 + kThreads) - 1
  const int r_end = lower_tri ? min(R, min(C, c0 + kThreads) - 1) : R;
  for (int t0 = 0; t0 < r_end; t0 += kTile) {
    if (!__syncthreads_or(valid && !dom)) break;
    const int rows = min(kTile, r_end - t0);
    const bool m = tid < rows && Mb[t0 + tid] != 0;
    tmask[tid] = m;
    if (!__syncthreads_or(m)) continue;  // an all-masked tile
    for (int e = tid; e < rows * D; e += kThreads)
      tile[e] = Rb[(long long)t0 * D + e];
    __syncthreads();
    if (valid && !dom) {
      const int jmax = lower_tri ? min(rows, i - t0) : rows;
      for (int j = 0; j < jmax; ++j) {
        if (tmask[j] && dominates<D>(tile + j * D, x)) {
          dom = true;
          break;
        }
      }
    }
  }
  if (valid) out[b * C + i] = dom ? 1 : 0;
}

template <int D>
cudaError_t launch(const void* cands, const void* refs, const void* mask,
                   void* out, int batch, int C, int R, long long ref_bstride,
                   long long mask_bstride, int lower_tri,
                   cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, batch);
  dominated_mask_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(cands), static_cast<const float*>(refs),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out), C, R,
      ref_bstride, mask_bstride, lower_tri);
  return cudaGetLastError();
}

}  // namespace

// Launches the dominance test on `stream`; returns the cudaError_t of the
// launch.  Strides are in elements.  The caller checks shapes, types and
// devices; the checks here only keep a bad call from launching.
extern "C" int dominated_mask_launch(const void* cands, const void* refs,
                                     const void* mask, void* out, int batch,
                                     int C, int R, int d,
                                     long long ref_bstride,
                                     long long mask_bstride, int lower_tri,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || C < 1 || R < 0 || ref_bstride < 0 ||
      mask_bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define DOM_CASE(D)                                                          \
  case D:                                                                    \
    return static_cast<int>(launch<D>(cands, refs, mask, out, batch, C, R,   \
                                      ref_bstride, mask_bstride, lower_tri, \
                                      s));
    DOM_CASE(1) DOM_CASE(2) DOM_CASE(3) DOM_CASE(4) DOM_CASE(5) DOM_CASE(6)
    DOM_CASE(7) DOM_CASE(8) DOM_CASE(9) DOM_CASE(10) DOM_CASE(11) DOM_CASE(12)
#undef DOM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dominated_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
