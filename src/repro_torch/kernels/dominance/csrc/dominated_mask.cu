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
// candidate gets its bit; only the references are masked.  The output is
// an OR over references, so neither the order in which they are tested,
// nor the tiling, nor where a walk stops changes a bit; lower_tri
// compares a reference's original index with the candidate's.
// Subnormal coordinates compare as zeros of their sign, as XLA compares
// them on the CPU: the build passes --ftz=true (kernels/build.py), which
// flushes the operands of every f32 comparison; copies keep the bits.
//
// Design.  One entry call runs up to two grids on one stream, with no
// host synchronisation between or after them (kernel.py launches them):
//   1. dominance_compact_kernel, only when R is longer than one tile
//      (the wrapper decides from shapes): a grid of (chunks of
//      kCompactRows reference rows, batches), one grid per kMaxGridY
//      batches.  Each CTA counts the
//      valid rows of the chunks before its own, ranks its own in order
//      (one ballot per pass and warp, one scan of their counts) and
//      writes them, coalesced, into a dense scratch buffer stored by
//      coordinate, [b][k][row] for k < d and the row's original index as
//      int32 at k = d; the CTA of the last chunk writes the batch's
//      count.  References and mask that are both shared by the batch
//      (batch stride 0) are compacted once and the dense buffer is
//      shared as well.
//   2. dominance_walk_kernel, a 1-D grid over (candidate blocks,
//      batches), the batch fastest, so that the first blocks of every
//      batch (where NoSeq's valid candidates lie; the rest are sentinel
//      rows) start first.  The first kHeld lanes of each warp hold one
//      candidate each in registers, a block of 128 candidates.  The CTA's
//      shape is fixed per form at compile time: the direct form runs 128
//      threads holding 32 a warp (its walks are short, so full warps keep
//      the lanes busy), the compacted form 256 threads holding 16 (its
//      survivors walk every row through the warp form, one candidate at a
//      time, so fewer a warp spread a heavy block over more warps).
//      The walk ends at the batch's own count, read from device memory:
//      a batch with no valid reference writes all-false flags and walks
//      nothing.  The first kLaneRows dense rows go to a small head in
//      shared memory (one load per word) and are walked a lane at a
//      time, so that a CTA whose candidates all fall there (the sentinel
//      rows fall at the first row) stages no tile.  The rest comes in
//      tiles of tile_rows(d) rows (kTileBytes of coordinates) stored by
//      coordinate through a ring of kStages stages in dynamic shared
//      memory, filled with 16-byte cp.async copies and drained with
//      cp.async.wait_group, so that the next tile loads while the
//      current one is tested.  Per tile, a lane walks the first
//      kLaneRows rows for its own candidates, then the warp takes the
//      candidates still alive one at a time and tests 32 * kWarpUnroll
//      rows per vote.  The CTA stops when all its
//      candidates are decided.  lower_tri ends a candidate's walk at the
//      first row whose original index is >= its own.
//   When R fits one tile there is no grid 1: the walk stages the
//   references themselves as one tile, with a masked row stored as NaN
//   in every coordinate (no comparison with NaN holds, so it never
//   dominates, and the mask leaves the inner loop).
// What this does about the faults of the first design (one thread per
// candidate walking all R rows in tiles of 256, a mask read and two
// barriers per tile, row-major tiles): the walk ends at the valid count,
// so a compacted state buffer's masked tail and a batch with no
// potential dominators cost nothing; the lane-then-warp test keeps a
// warp from waiting on its slowest lane; coordinate-major tiles let a
// warp read 32 rows at once on 32 banks; and the ring hides the tile
// loads.  The candidate mask (padding rows) is not part of the contract,
// so the sentinel rows still get their bit, from the head.
//
// What bounds it on this card.  The bytes it must move (candidates and
// the mask in, each valid reference row's coordinates in once, one byte
// per candidate out) at 3.35 TB/s, or the 2d operations of each compare
// it needs at 67 TFLOP/s f32, whichever is larger; chip_smoke.py counts
// both from each call's inputs.  The test is comparisons with no product
// in it, so the tensor cores do not apply.
//
// The wide variant.  Every d up to kNarrowD has instantiations of its
// own, templates over D that hold each candidate and each staged
// reference row in float[D] registers.  Any wider d runs
// dominance_compact_wide_kernel and dominance_walk_wide_kernel, which take
// d at run time and follow the same two grids, forms and CTA shapes.  A
// candidate keeps its first kChunkD coordinates in registers and reads
// the rest from its row in device memory; a reference row is copied to
// shared memory a coordinate at a time.  A compare tests kChunkD
// coordinates at a time and ends after the first chunk in which the
// reference exceeds the candidate somewhere.  The result is an OR of a
// pure predicate, so neither changes a bit.  A tile holds at least 32
// rows at any d (tile_rows), so the ring's law 4 * (d + 1) * (kLaneRows +
// kStages * 32) bytes bounds d to 604 on this card.
//
// Shared memory (dynamic; dominance_smem_bytes in kernel.py states the
// same law), d + 1 words per staged row (the (d + 1)-th holds the
// original index under lower_tri): with grid 1, the head and the ring,
// 4 * (d + 1) * (kLaneRows + kStages * tile_rows(d)) bytes; without, one
// tile of 4 * (d + 1) * ceil32(R).  The walk's limit is raised to its
// form's largest footprint at D once per device, not at every launch.
// Grid 1 takes only static memory (its scan's warp totals and counts).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;         // grid 1
constexpr int kMaxGridY = 65535;      // a grid's y extent
constexpr int kDirectThreads = 128;   // the walk's CTA, direct form
constexpr int kDirectHeld = 32;       // lanes of a warp holding a candidate
constexpr int kRingThreads = 256;     // the walk's CTA, compacted form
constexpr int kRingHeld = 16;
constexpr int kLaneRows = 32;         // rows a lane walks alone, per test
constexpr int kLaneUnroll = 4;        // rows a lane tests per step
constexpr int kWarpUnroll = 8;        // 32-row steps a warp takes per vote
constexpr int kStages = 2;            // tiles in flight in the ring
constexpr int kTileBytes = 16384;     // coordinates of one stage's tile
constexpr int kCompactPer = 16;       // reference rows per compact thread
constexpr int kCompactRows = kThreads * kCompactPer;   // rows per chunk
constexpr int kSmemLimit = 232448;    // per CTA on sm_90
constexpr int kNarrowD = 12;          // widest d with its own instantiation
constexpr int kChunkD = 8;            // wide compare: coordinates a step
constexpr unsigned kFull = 0xffffffffu;

// Rows of one tile: kTileBytes of coordinates, in whole 32-row steps, at
// least one step.
__host__ __device__ constexpr int tile_rows(int d) {
  return kTileBytes / (4 * d) / 32 * 32 > 32 ? kTileBytes / (4 * d) / 32 * 32
                                             : 32;
}

__host__ __device__ constexpr int ceil32(int r) { return (r + 31) / 32 * 32; }

// The walk's dynamic shared memory: the ring when grid 1 compacts the
// references, one stage of the references themselves when it does not.
constexpr long long walk_smem_bytes(int d, int R, bool compact) {
  return compact ? 4LL * (d + 1) * (kLaneRows + kStages * tile_rows(d))
                 : 4LL * (d + 1) * ceil32(R);
}

// 16-byte global -> shared copy, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile rows are stored by coordinate (row j's k-th coordinate at
// [k * stride + j]): a lane walking rows alone reads one address for the
// whole warp, and a warp reading 32 rows at once hits 32 banks.
template <int D>
__device__ __forceinline__ bool dominates_soa(const float* t, int stride,
                                              int j, const float (&x)[D]) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float w = t[k * stride + j];
    le &= w <= x[k];
    lt |= w < x[k];
  }
  return le && lt;
}

// On skyline data most candidates meet their first dominator within a
// few rows, a few only after hundreds and survivors never, so neither
// one thread per candidate (a warp waits for its slowest lane) nor one
// warp per candidate (a warp spends a whole step on a one-row walk)
// fits.  The tests come in both forms (as in sfs_sweep.cu's filter
// grid): a lane walks the first kLaneRows rows of a tile for its own
// candidate, then the warp takes the candidates still alive one at a
// time.  Under LT only rows whose original index idx[j] < i count; the
// indices rise with j, so the walk ends at the first that does not.

// Lane form: does one of rows [lo, hi) of the tile t dominate x (the
// candidate of index i)?  kLaneUnroll rows per step, their loads issued
// together; under LT the rows that count are a prefix of the step.
template <int D, bool LT>
__device__ __forceinline__ bool lane_any(const float* t, const int* idx,
                                         int stride, int lo, int hi,
                                         const float (&x)[D], int i) {
  int j = lo;
  for (; j + kLaneUnroll <= hi; j += kLaneUnroll) {
    bool dom = false, past = false;
#pragma unroll
    for (int u = 0; u < kLaneUnroll; ++u) {
      const bool ok = !LT || idx[j + u] < i;
      past |= !ok;
      dom |= ok & dominates_soa<D>(t, stride, j + u, x);
    }
    if (dom) return true;
    if (past) return false;
  }
  for (; j < hi; ++j) {
    if (LT && idx[j] >= i) return false;
    if (dominates_soa<D>(t, stride, j, x)) return true;
  }
  return false;
}

// Warp form (every lane calls it with the same y, iy): rows [lo, hi) of
// the tile, up to 32 * kWarpUnroll at a time, the loads of a step issued
// together.
template <int D, bool LT>
__device__ __forceinline__ bool warp_any(const float* t, const int* idx,
                                         int stride, int lo, int hi,
                                         const float (&y)[D], int iy) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    if (LT && idx[j0] >= iy) return false;   // no later row counts
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      if (j0 + 32 * u >= hi) break;          // uniform: the step ends early
      const int j = j0 + 32 * u + lane;
      const int jc = min(j, hi - 1);
      bool ok = j < hi;
      if (LT) ok &= idx[jc] < iy;
      dom |= ok & dominates_soa<D>(t, stride, jc, y);
    }
    if (__any_sync(kFull, dom)) return true;
  }
  return false;
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
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_tot[lane] = s;
  }
  __syncthreads();
  *total = warp_tot[nwarps - 1];
  return (warp ? warp_tot[warp - 1] : 0) + x - v;
}

// Nonzero bytes of w.  Per byte, bit 7 of (b & 0x7f) + 0x7f is set when
// the low bits are, and the OR adds bit 7 itself; no carry crosses bytes.
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  return __popc((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u);
}

// This thread's share of the nonzero bytes among p[0, n): a head up to
// the first 16-byte boundary, 16-byte words (several in flight), then a
// tail.
__device__ __forceinline__ int count_set_share(const uint8_t* p, int n) {
  const int tid = threadIdx.x;
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  int c = tid < head && p[tid] != 0;
  const uint4* q = reinterpret_cast<const uint4*>(p + head);
  const int nq = (n - head) >> 4;
#pragma unroll 8
  for (int e = tid; e < nq; e += kThreads) {
    const uint4 v = q[e];
    c += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
         nonzero_bytes(v.w);
  }
  const int tail = head + (nq << 4) + tid;   // fewer than 16 bytes left
  if (tail < n) c += p[tail] != 0;
  return c;
}

// Grid 1: the valid rows of batch b's chunk [r0, r0 + kCompactRows), in
// order, to dense rows from `before` on, where before counts the valid
// rows of the earlier chunks.  Pass e of a thread is row r0 + e *
// kThreads + tid, so that loads and stores are coalesced; a row's rank in
// the chunk is the set flags before it in (pass, warp, lane) order, from
// one ballot per pass and warp and one scan of those counts.
template <int D>
__global__ void __launch_bounds__(kThreads)
dominance_compact_kernel(const float* __restrict__ refs,
                         const uint8_t* __restrict__ mask,
                         long long ref_bstride, long long mask_bstride,
                         int R, int Rs, float* __restrict__ dense,
                         int* __restrict__ count) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCounts = kCompactPer * kWarps;   // one per (pass, warp)
  static_assert(kCounts % 32 == 0, "the scan gives each lane whole counts");
  __shared__ int warp_tot[32];
  __shared__ int counts[kCounts];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * kCompactRows;
  const float* Rb = refs + b * ref_bstride;
  const uint8_t* Mb = mask + b * mask_bstride;
  float* Db = dense + b * (D + 1) * static_cast<long long>(Rs);
  int* Ib = reinterpret_cast<int*>(Db + static_cast<size_t>(D) * Rs);

  int before;
  block_exclusive_sum(count_set_share(Mb, r0), warp_tot, &before);
  unsigned ballots[kCompactPer];
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e) {
    const int row = r0 + e * kThreads + tid;
    ballots[e] = __ballot_sync(kFull, row < R && Mb[row] != 0);
    if (lane == 0) counts[e * kWarps + warp] = __popc(ballots[e]);
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the counts, kCounts / 32 a lane
    constexpr int kEach = kCounts / 32;
    int v[kEach], sum = 0;
#pragma unroll
    for (int q = 0; q < kEach; ++q) sum += v[q] = counts[lane * kEach + q];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kEach; ++q) {
      counts[lane * kEach + q] = run;
      run += v[q];
    }
    if (lane == 31 && blockIdx.x == gridDim.x - 1) count[b] = before + run;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e) {
    if ((ballots[e] >> lane) & 1u) {
      const int row = r0 + e * kThreads + tid;
      const int at = before + counts[e * kWarps + warp] +
                     __popc(ballots[e] & below);
      const float* src = Rb + static_cast<size_t>(row) * D;
#pragma unroll
      for (int k = 0; k < D; ++k)
        Db[static_cast<size_t>(k) * Rs + at] = src[k];
      Ib[at] = row;
    }
  }
}

// Rows [0, rows) of a staged tile t (row stride `stride`, the original
// indices at row D under LT) against the candidate x of index i, if it is
// still undecided (todo): a lane walks the first kLaneRows rows for its
// own candidate, then the warp takes those still alive one at a time.
// The lanes of a warp hold consecutive candidates, so lane src holds
// i - lane + src.  Updates todo and dom (dominated).
template <int D, bool LT>
__device__ __forceinline__ void test_tile(const float* t, int stride,
                                          int rows, const float (&x)[D],
                                          int i, bool& todo, bool& dom) {
  const int* si = reinterpret_cast<const int*>(t + D * stride);
  const int lane = threadIdx.x & 31;
  const int lane_end = min(rows, kLaneRows);
  bool d = todo && lane_any<D, LT>(t, si, stride, 0, lane_end, x, i);
  unsigned need = __ballot_sync(
      kFull, todo && !d && rows > lane_end && (!LT || si[lane_end] < i));
  while (need) {
    const int src = __ffs(need) - 1;
    need &= need - 1;
    float y[D];
#pragma unroll
    for (int e = 0; e < D; ++e) y[e] = __shfl_sync(kFull, x[e], src);
    if (warp_any<D, LT>(t, si, stride, lane_end, rows, y, i - lane + src) &&
        lane == src)
      d = true;
  }
  if (d) {
    dom = true;
    todo = false;
  } else if (LT && todo && si[rows - 1] >= i) {
    todo = false;   // every later row lies past the candidate
  }
}

// Grid 2: out[b, i] for the candidates of this CTA: the first kHeld
// lanes of each warp hold one each, consecutive over the CTA's warps.
// Fewer than 32 a warp leave more warps to a block whose candidates walk
// far (the warp form takes its live candidates one at a time).  The
// direct form (kRing false; R fits one tile) stages the references
// themselves, as one tile of stride T = ceil32(R).  The compacted form
// reads batch b's dense rows from dense + b * dense_bstride (0 when
// shared), count[b or 0] of them: the first kLaneRows go to a head of
// stride kLaneRows and the rest through the ring of tiles of
// T = tile_rows(D) rows.
template <int D, bool LT, bool kRing>
__global__ void __launch_bounds__(kRing ? kRingThreads : kDirectThreads)
dominance_walk_kernel(const float* __restrict__ cands,
                      const float* __restrict__ refs,
                      const uint8_t* __restrict__ mask,
                      long long ref_bstride, long long mask_bstride,
                      const float* __restrict__ dense,
                      long long dense_bstride, int Rs,
                      const int* __restrict__ count,
                      uint8_t* __restrict__ out, int batch, int C, int R) {
  constexpr int kNT = kRing ? kRingThreads : kDirectThreads;
  constexpr int kHeld = kRing ? kRingHeld : kDirectHeld;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the batches interleave in launch order, so that the first candidate
  // blocks of every batch (where NoSeq's valid rows lie; the rest are
  // sentinel rows) start first
  const long long b = blockIdx.x % batch;
  const int c0 = static_cast<int>(blockIdx.x / batch) * (kNT / 32) * kHeld;
  const int i = c0 + (tid >> 5) * kHeld + lane;
  const bool valid = lane < kHeld && i < C;
  uint8_t* O = out + b * C;
  const int n = kRing ? count[dense_bstride ? b : 0] : R;

  if (n == 0) {  // no valid reference: nothing is dominated
    if (valid) O[i] = 0;
    return;
  }

  float x[D];
  const float* src = cands + (b * C + (valid ? i : 0)) * D;
#pragma unroll
  for (int e = 0; e < D; ++e) x[e] = valid ? src[e] : 0.f;
  bool todo = valid, dom = false;

  if constexpr (!kRing) {
    // the references themselves, a row a thread, a masked row as NaN in
    // every coordinate
    const float* Rb = refs + b * ref_bstride;
    const uint8_t* Mb = mask + b * mask_bstride;
    const int T = ceil32(R);
    const float nan = __int_as_float(0x7fc00000);
    for (int j = tid; j < R; j += kNT) {
      const bool m = Mb[j] != 0;
      float r[D];
#pragma unroll
      for (int k = 0; k < D; ++k) r[k] = Rb[static_cast<size_t>(j) * D + k];
#pragma unroll
      for (int k = 0; k < D; ++k) smem[k * T + j] = m ? r[k] : nan;
      if (LT) reinterpret_cast<int*>(smem + D * T)[j] = j;
    }
    __syncthreads();
    test_tile<D, LT>(smem, T, R, x, i, todo, dom);
  } else {
    constexpr int T = tile_rows(D);
    constexpr int words = LT ? D + 1 : D;   // rows of a staged tile
    const float* Db = dense + b * dense_bstride;
    // the head: the first kLaneRows dense rows, one load per word
    const int pre = min(n, kLaneRows);
    for (int e = tid; e < words * kLaneRows; e += kNT) {
      const int k = e / kLaneRows, j = e - k * kLaneRows;
      if (j < pre) smem[e] = Db[static_cast<size_t>(k) * Rs + j];
    }
    __syncthreads();
    test_tile<D, LT>(smem, kLaneRows, pre, x, i, todo, dom);

    // the rest through the ring: tile t (rows pre + t * T onwards) goes to
    // stage t % kStages
    float* ring = smem + (D + 1) * kLaneRows;
    const int tiles = (n - pre + T - 1) / T;
    auto issue = [&](int t) {
      float* st = ring + static_cast<size_t>(t % kStages) * (D + 1) * T;
      const int t0 = pre + t * T;
      const int q = (min(T, n - t0) + 3) >> 2;   // 16-byte copies per row
      for (int e = tid; e < words * q; e += kNT) {
        const int k = e / q, c = e - k * q;
        cp_async16(st + k * T + 4 * c,
                   Db + static_cast<size_t>(k) * Rs + t0 + 4 * c);
      }
    };
    if (__syncthreads_or(todo) && tiles > 0) {
      issue(0);
      cp_async_commit();
      if (tiles > 1) issue(1);
      cp_async_commit();
      for (int t = 0; t < tiles; ++t) {
        cp_async_wait<kStages - 1>();   // tile t is in; t + 1 may still fly
        if (!__syncthreads_or(todo)) break;
        test_tile<D, LT>(ring + static_cast<size_t>(t % kStages) * (D + 1) * T,
                         T, min(T, n - pre - t * T), x, i, todo, dom);
        if (t + kStages < tiles) {
          __syncthreads();   // every thread is done with this stage
          issue(t + kStages);
        }
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
  }
  if (valid) O[i] = dom;
}

// -- the wide variant (d > kNarrowD, d at run time) ------------------------

// Does the row at r (its k-th coordinate at r[k * rs]) dominate the
// candidate whose first kChunkD coordinates are x0 and whose k-th lies
// at c[k]?  kChunkD coordinates a step; the compare ends after the first
// step in which the row exceeds the candidate somewhere.  Needs
// d >= kChunkD.
__device__ __forceinline__ bool dominates_wide(const float* r, int rs,
                                               const float (&x0)[kChunkD],
                                               const float* c, int d) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < kChunkD; ++k) {
    const float w = r[k * rs];
    le &= w <= x0[k];
    lt |= w < x0[k];
  }
  for (int k0 = kChunkD; le && k0 < d; k0 += kChunkD) {
#pragma unroll
    for (int u = 0; u < kChunkD; ++u) {
      const int k = k0 + u;
      if (k < d) {
        const float w = r[k * rs];
        le &= w <= c[k];
        lt |= w < c[k];
      }
    }
  }
  return le && lt;
}

// Lane form of lane_any at any d, a row a step.
template <bool LT>
__device__ __forceinline__ bool lane_any_wide(const float* t, const int* idx,
                                              int stride, int lo, int hi,
                                              const float (&x0)[kChunkD],
                                              const float* c, int d, int i) {
  for (int j = lo; j < hi; ++j) {
    if (LT && idx[j] >= i) return false;
    if (dominates_wide(t + j, stride, x0, c, d)) return true;
  }
  return false;
}

// Warp form of warp_any at any d.
template <bool LT>
__device__ __forceinline__ bool warp_any_wide(const float* t, const int* idx,
                                              int stride, int lo, int hi,
                                              const float (&y0)[kChunkD],
                                              const float* c, int d,
                                              int iy) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    if (LT && idx[j0] >= iy) return false;   // no later row counts
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      if (j0 + 32 * u >= hi) break;          // uniform: the step ends early
      const int j = j0 + 32 * u + lane;
      bool ok = j < hi;
      if (LT) ok = ok && idx[j] < iy;
      dom |= ok && dominates_wide(t + j, stride, y0, c, d);
    }
    if (__any_sync(kFull, dom)) return true;
  }
  return false;
}

// test_tile at any d.  The candidate of lane l of this warp is row
// i - lane + l of the batch's candidates cb (row-major, d a row).
template <bool LT>
__device__ __forceinline__ void test_tile_wide(const float* t, int stride,
                                               int rows,
                                               const float (&x0)[kChunkD],
                                               const float* cb, int d, int i,
                                               bool& todo, bool& dom) {
  const int* si = reinterpret_cast<const int*>(t + static_cast<size_t>(d) *
                                                       stride);
  const int lane = threadIdx.x & 31;
  const int lane_end = min(rows, kLaneRows);
  bool dd = todo && lane_any_wide<LT>(t, si, stride, 0, lane_end, x0,
                                      cb + static_cast<size_t>(i) * d, d, i);
  unsigned need = __ballot_sync(
      kFull, todo && !dd && rows > lane_end && (!LT || si[lane_end] < i));
  while (need) {
    const int src = __ffs(need) - 1;
    need &= need - 1;
    const int iy = i - lane + src;
    float y0[kChunkD];
#pragma unroll
    for (int e = 0; e < kChunkD; ++e) y0[e] = __shfl_sync(kFull, x0[e], src);
    if (warp_any_wide<LT>(t, si, stride, lane_end, rows, y0,
                          cb + static_cast<size_t>(iy) * d, d, iy) &&
        lane == src)
      dd = true;
  }
  if (dd) {
    dom = true;
    todo = false;
  } else if (LT && todo && si[rows - 1] >= i) {
    todo = false;   // every later row lies past the candidate
  }
}

// Grid 1 at any d: dominance_compact_kernel with d at run time.
__global__ void __launch_bounds__(kThreads)
dominance_compact_wide_kernel(const float* __restrict__ refs,
                              const uint8_t* __restrict__ mask,
                              long long ref_bstride, long long mask_bstride,
                              int R, int Rs, int d,
                              float* __restrict__ dense,
                              int* __restrict__ count) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCounts = kCompactPer * kWarps;   // one per (pass, warp)
  __shared__ int warp_tot[32];
  __shared__ int counts[kCounts];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * kCompactRows;
  const float* Rb = refs + b * ref_bstride;
  const uint8_t* Mb = mask + b * mask_bstride;
  float* Db = dense + b * (d + 1) * static_cast<long long>(Rs);
  int* Ib = reinterpret_cast<int*>(Db + static_cast<size_t>(d) * Rs);

  int before;
  block_exclusive_sum(count_set_share(Mb, r0), warp_tot, &before);
  unsigned ballots[kCompactPer];
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e) {
    const int row = r0 + e * kThreads + tid;
    ballots[e] = __ballot_sync(kFull, row < R && Mb[row] != 0);
    if (lane == 0) counts[e * kWarps + warp] = __popc(ballots[e]);
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the counts, kCounts / 32 a lane
    constexpr int kEach = kCounts / 32;
    int v[kEach], sum = 0;
#pragma unroll
    for (int q = 0; q < kEach; ++q) sum += v[q] = counts[lane * kEach + q];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kEach; ++q) {
      counts[lane * kEach + q] = run;
      run += v[q];
    }
    if (lane == 31 && blockIdx.x == gridDim.x - 1) count[b] = before + run;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e) {
    if ((ballots[e] >> lane) & 1u) {
      const int row = r0 + e * kThreads + tid;
      const int at = before + counts[e * kWarps + warp] +
                     __popc(ballots[e] & below);
      const float* src = Rb + static_cast<size_t>(row) * d;
      for (int k = 0; k < d; ++k)
        Db[static_cast<size_t>(k) * Rs + at] = src[k];
      Ib[at] = row;
    }
  }
}

// Grid 2 at any d: dominance_walk_kernel with d at run time, each
// candidate's first kChunkD coordinates in registers and the rest read
// from its row; tiles of tile_rows(d) rows.
template <bool LT, bool kRing>
__global__ void __launch_bounds__(kRing ? kRingThreads : kDirectThreads)
dominance_walk_wide_kernel(const float* __restrict__ cands,
                           const float* __restrict__ refs,
                           const uint8_t* __restrict__ mask,
                           long long ref_bstride, long long mask_bstride,
                           const float* __restrict__ dense,
                           long long dense_bstride, int Rs,
                           const int* __restrict__ count,
                           uint8_t* __restrict__ out, int batch, int C, int R,
                           int d) {
  constexpr int kNT = kRing ? kRingThreads : kDirectThreads;
  constexpr int kHeld = kRing ? kRingHeld : kDirectHeld;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long b = blockIdx.x % batch;
  const int c0 = static_cast<int>(blockIdx.x / batch) * (kNT / 32) * kHeld;
  const int i = c0 + (tid >> 5) * kHeld + lane;
  const bool valid = lane < kHeld && i < C;
  uint8_t* O = out + b * C;
  const int n = kRing ? count[dense_bstride ? b : 0] : R;

  if (n == 0) {  // no valid reference: nothing is dominated
    if (valid) O[i] = 0;
    return;
  }

  const float* cb = cands + b * C * d;   // the batch's candidate rows
  float x0[kChunkD];
  const float* src = cb + static_cast<size_t>(valid ? i : 0) * d;
#pragma unroll
  for (int e = 0; e < kChunkD; ++e) x0[e] = valid ? src[e] : 0.f;
  bool todo = valid, dom = false;

  if constexpr (!kRing) {
    // the references themselves, a row a thread, a masked row as NaN in
    // every coordinate
    const float* Rb = refs + b * ref_bstride;
    const uint8_t* Mb = mask + b * mask_bstride;
    const int T = ceil32(R);
    const float nan = __int_as_float(0x7fc00000);
    for (int j = tid; j < R; j += kNT) {
      const bool m = Mb[j] != 0;
      for (int k = 0; k < d; ++k)
        smem[k * T + j] = m ? Rb[static_cast<size_t>(j) * d + k] : nan;
      if (LT) reinterpret_cast<int*>(smem + d * T)[j] = j;
    }
    __syncthreads();
    test_tile_wide<LT>(smem, T, R, x0, cb, d, i, todo, dom);
  } else {
    const int T = tile_rows(d);
    const int words = LT ? d + 1 : d;   // rows of a staged tile
    const float* Db = dense + b * dense_bstride;
    // the head: the first kLaneRows dense rows, one load per word
    const int pre = min(n, kLaneRows);
    for (int e = tid; e < words * kLaneRows; e += kNT) {
      const int k = e / kLaneRows, j = e - k * kLaneRows;
      if (j < pre) smem[e] = Db[static_cast<size_t>(k) * Rs + j];
    }
    __syncthreads();
    test_tile_wide<LT>(smem, kLaneRows, pre, x0, cb, d, i, todo, dom);

    // the rest through the ring: tile t (rows pre + t * T onwards) goes to
    // stage t % kStages
    float* ring = smem + (d + 1) * kLaneRows;
    const int tiles = (n - pre + T - 1) / T;
    auto issue = [&](int t) {
      float* st = ring + static_cast<size_t>(t % kStages) * (d + 1) * T;
      const int t0 = pre + t * T;
      const int q = (min(T, n - t0) + 3) >> 2;   // 16-byte copies per row
      for (int e = tid; e < words * q; e += kNT) {
        const int k = e / q, c = e - k * q;
        cp_async16(st + k * T + 4 * c,
                   Db + static_cast<size_t>(k) * Rs + t0 + 4 * c);
      }
    };
    if (__syncthreads_or(todo) && tiles > 0) {
      issue(0);
      cp_async_commit();
      if (tiles > 1) issue(1);
      cp_async_commit();
      for (int t = 0; t < tiles; ++t) {
        cp_async_wait<kStages - 1>();   // tile t is in; t + 1 may still fly
        if (!__syncthreads_or(todo)) break;
        test_tile_wide<LT>(
            ring + static_cast<size_t>(t % kStages) * (d + 1) * T, T,
            min(T, n - pre - t * T), x0, cb, d, i, todo, dom);
        if (t + kStages < tiles) {
          __syncthreads();   // every thread is done with this stage
          issue(t + kStages);
        }
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
  }
  if (valid) O[i] = dom;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device.  The attribute is set once per device (`done` holds a bit for
// each of the first 64), not on every launch: the call costs host time.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D, bool LT, bool kRing>
cudaError_t launch(const void* cands, const void* refs, const void* mask,
                   void* out, void* scratch, int batch, int C, int R,
                   long long ref_bstride, long long mask_bstride,
                   cudaEvent_t ev_mid, cudaStream_t s) {
  constexpr int kNT = kRing ? kRingThreads : kDirectThreads;
  constexpr int kHeld = kRing ? kRingHeld : kDirectHeld;
  // the form's largest footprint at D, which the attribute allows
  constexpr long long kSmemMost = walk_smem_bytes(D, tile_rows(D), kRing);
  static_assert(kSmemMost <= kSmemLimit, "the walk's CTA does not fit");
  static_assert(tile_rows(D) >= 32, "a tile holds fewer than 32 rows");
  static std::atomic<unsigned long long> smem_allowed{0};
  const long long smem = walk_smem_bytes(D, R, kRing);
  const bool shared = ref_bstride == 0 && mask_bstride == 0;
  const int bc = shared ? 1 : batch;
  const int Rs = (R + 3) / 4 * 4;
  float* dense = static_cast<float*>(scratch);
  int* count = kRing ? reinterpret_cast<int*>(
                           dense + static_cast<size_t>(bc) * (D + 1) * Rs)
                     : nullptr;
  cudaError_t err;
  if constexpr (kRing) {
    // the batches go on grid y, at most kMaxGridY a grid: more are
    // covered by grids over successive slices, each from its first batch
    // on (one entry call, one launch on the count)
    for (int b0 = 0; b0 < bc; b0 += kMaxGridY) {
      const int n = bc - b0 < kMaxGridY ? bc - b0 : kMaxGridY;
      const dim3 grid1((R + kCompactRows - 1) / kCompactRows, n);
      dominance_compact_kernel<D><<<grid1, kThreads, 0, s>>>(
          static_cast<const float*>(refs) + b0 * ref_bstride,
          static_cast<const uint8_t*>(mask) + b0 * mask_bstride,
          ref_bstride, mask_bstride, R, Rs,
          dense + static_cast<size_t>(b0) * (D + 1) * Rs, count + b0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (ev_mid != nullptr) {
    err = cudaEventRecord(ev_mid, s);
    if (err != cudaSuccess) return err;
  }
  err = allow_smem(dominance_walk_kernel<D, LT, kRing>,
                   static_cast<int>(kSmemMost), smem_allowed);
  if (err != cudaSuccess) return err;
  // a 1-D grid over (candidate block, batch), the batch fastest
  constexpr int rows = kNT / 32 * kHeld;
  const long long blocks =
      static_cast<long long>((C + rows - 1) / rows) * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid2(static_cast<unsigned>(blocks));
  dominance_walk_kernel<D, LT, kRing><<<grid2, kNT, smem, s>>>(
      static_cast<const float*>(cands), static_cast<const float*>(refs),
      static_cast<const uint8_t*>(mask), ref_bstride, mask_bstride, dense,
      shared ? 0 : static_cast<long long>(D + 1) * Rs, Rs, count,
      static_cast<uint8_t*>(out), batch, C, R);
  return cudaGetLastError();
}

// launch at any d above kNarrowD.  The walk's limit is raised to
// kSmemLimit once per device (the footprint varies with d; the attribute
// only permits it), and a call whose law exceeds the limit is refused.
template <bool LT, bool kRing>
cudaError_t launch_wide(int d, const void* cands, const void* refs,
                        const void* mask, void* out, void* scratch, int batch,
                        int C, int R, long long ref_bstride,
                        long long mask_bstride, cudaEvent_t ev_mid,
                        cudaStream_t s) {
  constexpr int kNT = kRing ? kRingThreads : kDirectThreads;
  constexpr int kHeld = kRing ? kRingHeld : kDirectHeld;
  static std::atomic<unsigned long long> smem_allowed{0};
  const long long smem = walk_smem_bytes(d, R, kRing);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const bool shared = ref_bstride == 0 && mask_bstride == 0;
  const int bc = shared ? 1 : batch;
  const int Rs = (R + 3) / 4 * 4;
  float* dense = static_cast<float*>(scratch);
  int* count = kRing ? reinterpret_cast<int*>(
                           dense + static_cast<size_t>(bc) * (d + 1) * Rs)
                     : nullptr;
  cudaError_t err;
  if constexpr (kRing) {
    for (int b0 = 0; b0 < bc; b0 += kMaxGridY) {
      const int n = bc - b0 < kMaxGridY ? bc - b0 : kMaxGridY;
      const dim3 grid1((R + kCompactRows - 1) / kCompactRows, n);
      dominance_compact_wide_kernel<<<grid1, kThreads, 0, s>>>(
          static_cast<const float*>(refs) + b0 * ref_bstride,
          static_cast<const uint8_t*>(mask) + b0 * mask_bstride,
          ref_bstride, mask_bstride, R, Rs, d,
          dense + static_cast<size_t>(b0) * (d + 1) * Rs, count + b0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (ev_mid != nullptr) {
    err = cudaEventRecord(ev_mid, s);
    if (err != cudaSuccess) return err;
  }
  err = allow_smem(dominance_walk_wide_kernel<LT, kRing>, kSmemLimit,
                   smem_allowed);
  if (err != cudaSuccess) return err;
  constexpr int rows = kNT / 32 * kHeld;
  const long long blocks =
      static_cast<long long>((C + rows - 1) / rows) * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid2(static_cast<unsigned>(blocks));
  dominance_walk_wide_kernel<LT, kRing><<<grid2, kNT, smem, s>>>(
      static_cast<const float*>(cands), static_cast<const float*>(refs),
      static_cast<const uint8_t*>(mask), ref_bstride, mask_bstride, dense,
      shared ? 0 : static_cast<long long>(d + 1) * Rs, Rs, count,
      static_cast<uint8_t*>(out), batch, C, R, d);
  return cudaGetLastError();
}

}  // namespace

// Launches the dominance test on `stream`; returns the cudaError_t of the
// launch.  Strides are in elements.  scratch is null when R is at most
// one tile (the direct form) and otherwise holds bc * (d + 1) * Rs + bc
// 32-bit words, 16-byte aligned (bc = 1 when references and mask both
// have batch stride 0, else batch; Rs = R rounded up to a multiple of 4):
// the dense rows of each compacted batch, then the counts.  ev_start and
// ev_mid, when not null, are recorded before grid 1 and between the
// grids, for measurement.  The caller checks shapes, types and devices;
// the checks here only keep a bad call from launching.
extern "C" int dominated_mask_launch(const void* cands, const void* refs,
                                     const void* mask, void* out,
                                     void* scratch, int batch, int C, int R,
                                     int d, long long ref_bstride,
                                     long long mask_bstride, int lower_tri,
                                     void* ev_start, void* ev_mid,
                                     void* stream) {
  if (batch < 1 || C < 1 || R < 0 || ref_bstride < 0 ||
      mask_bstride < 0 || d < 1 ||
      (scratch == nullptr) != (R <= tile_rows(d)) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t mid = static_cast<cudaEvent_t>(ev_mid);
  if (ev_start != nullptr) {
    const cudaError_t err =
        cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaErrorInvalidValue;
  const int form = (lower_tri ? 2 : 0) + (scratch != nullptr ? 1 : 0);
#define DOM_ARGS \
  cands, refs, mask, out, scratch, batch, C, R, ref_bstride, mask_bstride, \
      mid, s
#define DOM_CASE(D)                                      \
  case 4 * D:                                            \
    err = launch<D, false, false>(DOM_ARGS);             \
    break;                                               \
  case 4 * D + 1:                                        \
    err = launch<D, false, true>(DOM_ARGS);              \
    break;                                               \
  case 4 * D + 2:                                        \
    err = launch<D, true, false>(DOM_ARGS);              \
    break;                                               \
  case 4 * D + 3:                                        \
    err = launch<D, true, true>(DOM_ARGS);               \
    break;
  if (d > kNarrowD) {
    switch (form) {
      case 0: return static_cast<int>(launch_wide<false, false>(d, DOM_ARGS));
      case 1: return static_cast<int>(launch_wide<false, true>(d, DOM_ARGS));
      case 2: return static_cast<int>(launch_wide<true, false>(d, DOM_ARGS));
      default: return static_cast<int>(launch_wide<true, true>(d, DOM_ARGS));
    }
  }
  switch (4 * d + form) {
    DOM_CASE(1) DOM_CASE(2) DOM_CASE(3) DOM_CASE(4) DOM_CASE(5) DOM_CASE(6)
    DOM_CASE(7) DOM_CASE(8) DOM_CASE(9) DOM_CASE(10) DOM_CASE(11) DOM_CASE(12)
    default:
      break;
  }
#undef DOM_CASE
#undef DOM_ARGS
  return static_cast<int>(err);
}

// The dynamic shared memory of the walk CTA for a call with R references:
// the ring when R is longer than one tile, else one stage of the
// references.  -1 for a d below 1 or a negative R.
extern "C" long long dominated_mask_smem_bytes(int d, int R) {
  if (d < 1 || R < 0) return -1;
  return walk_smem_bytes(d, R, R > tile_rows(d));
}

extern "C" const char* dominated_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
