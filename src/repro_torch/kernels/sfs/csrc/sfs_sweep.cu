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
// false), and the total keep count, which goes on past wcap.  Row i is
// kept when it is valid and neither a live window row nor an earlier row
// of its candidate block dominates it.  Subnormal coordinates compare as
// zeros of their sign, as XLA compares them on the CPU: the build passes
// --ftz=true (kernels/build.py), which flushes the operands of every f32
// comparison, while loads and stores move the rows' bits unchanged.
//
// Design.  One call runs three grids on one stream (kernel.py launches
// them; nothing synchronises the host between them; past kNarrowD three
// more run between B and C, below):
//   A. sweep_seq_kernel over the first K blocks (the wrapper's
//      entry_prefix rows rounded up to whole blocks), one CTA per
//      partition:
//      the sweep as the reference runs it.  It leaves the prefix window
//      W_A and its count c_A.
//   B. sweep_filter_kernel over every later row, a grid of (row tiles x
//      partitions; one grid per kMaxGridY partitions) that fills the card: a row stays alive when it is
//      valid and no live row of W_A dominates it.  The CTA stages W_A in
//      shared memory; a thread holds kFilterPer candidates in registers.
//      It writes one alive byte per row and adds the partition's
//      survivors with atomics.
//   C. sweep_seq_kernel again, from (W_A, c_A), over the alive rows only.
// Why this is exact.  A row that a window member w dominates is dropped
// by the reference, and anything it dominates w dominates too, so it can
// leave the rest of the sweep, the in-block self-test included.  While
// the count stays within wcap, keep(i) reduces to "no earlier valid row
// dominates i", which does not depend on where blocks start: when
// c_A + survivors <= wcap (decided per partition, on the card) C packs
// the survivors into dense blocks.  Otherwise the count after the window
// fills depends on the blocks, and C keeps each survivor in its original
// block.  The two cases differ only in where C ends a block.
//
// sweep_seq_kernel reads the row flags (the mask in A, the alive bytes in
// C) a chunk of kChunk rows at a time, compacts the set rows' indices
// into a shared-memory queue with a CTA-wide scan (order kept), and
// takes candidate blocks off the queue.  A candidate is tested against
// the window rows appended since B (B tested the rest), kept in shared
// memory up to kResidentBytes and read from the output window past that,
// then against the earlier rows of its block; a CTA-wide exclusive scan
// gives each keep its slot, and a plain store (which keeps -0.0) writes
// it when the slot is below wcap.
//
// Both kernels test in two forms, because on skyline data most rows meet
// their first dominator within the first few window rows, a few only
// after hundreds, and B's survivors never: a thread walks the first
// kLaneRows rows for its own candidate, then each warp takes the
// candidates still alive one at a time and tests 32 * kWarpUnroll rows
// per vote, so no warp waits on one slow lane.
//
// What bounds it on this card.  The bytes the function must move (points
// and mask in, window, mask and count out) take about 0.1 ms at
// 3.35 TB/s for N = 10^7, d = 4, and its compares tens of microseconds at
// 67 TFLOP/s f32, so the bytes set the bound.  Stages A and C are
// sequential per partition and run on P SMs; B, which sees all but K
// blocks of every partition, runs on all of them.
//
// The wide variant.  Every d up to kNarrowD has instantiations of its
// own, templates over D that hold candidates in float[D] registers.
// Any wider d runs sweep_seq_wide_kernel and sweep_filter_wide_kernel,
// which take d at run time and follow the same schedule for A and B.
// They hold no candidate in a register array: A and C read it from the
// candidate block they already stage in shared memory, and B keeps its
// first kChunkD coordinates in registers and reads the rest from the
// points in device memory.  A compare tests kChunkD coordinates at a
// time and ends after the first chunk in which the window row exceeds
// the candidate somewhere: on skyline data most window rows fail within
// the first chunk.  The test is a pure predicate, so neither the
// chunking nor where a compare ends changes a bit.
//
// Past kNarrowD skylines hold most of the rows, so C's one CTA a
// partition would walk a window of survivors x skyline on one SM.  The
// wide variant therefore runs the packed branch on three more grids
// that spread it over the card; C keeps only the original branch.  In
// the packed branch row i is kept iff no earlier survivor dominates it
// (the argument above), so:
//   R. sweep_rank_wide_kernel: an exclusive scan of B's alive bytes, in
//      tiles of kRankRows (a count pass, then a pass that adds the
//      counts of the earlier tiles), gives each survivor its rank and
//      writes the survivors coordinate-major into a scratch buffer (row
//      s's k-th coordinate at sv[k * stride + s]).
//   Q. sweep_pairs_wide_kernel: the lower-triangular pair test of the
//      survivors.  Candidate tiles of kPairRows survivors (kPairPer a
//      thread, first kChunkD coordinates in registers), each against the
//      survivors before its end, split into chunks of kPairRows/g
//      references (g, at most kPairMaxSplit, chosen on the card from the
//      survivor count so that the items are at least as many as the
//      CTAs); a persistent grid of kPairWaves CTAs a multiprocessor for
//      each of up to kPairParts partitions walks each partition's items in
//      order, so the references nearest the start of the score order,
//      where most dominators are, come first.  A CTA stages
//      its chunk in tiles, coordinate-major as B does, and each lane walks
//      a tile for all its candidates at once (tile_walk_wide); a reference
//      counts only when it comes before the candidate.  A dominated
//      candidate gets a 1 in its byte of `dom` (only ever set to 1, so
//      plain stores from several CTAs agree), and a candidate already
//      marked when an item starts is skipped.
//   S. sweep_append_wide_kernel: an exclusive scan of the undominated
//      survivors, the same two passes as R, writes each kept row at
//      window[count_in + rank] with plain stores, sets its mask and
//      writes count_out.  The packed branch never passes wcap.
// Every CTA of R, Q, S and C reads the branch of its partition
// (count_in + survivors <= wcap) and returns at once where the other
// branch runs, so the host chooses nothing and reads nothing back.
//
// Shared memory (dynamic; sweep_smem_bytes in kernel.py states the same
// law): A and C use 4*d*block (candidates) + 4*kQueueCap (queue)
// + 4*32 (warp sums) + 4*kSeqThreads (pending flags)
// + 4*d*resident_rows(d, block); B uses 4*d*tile rows, the tile being
// the smaller of filter_tile_rows(d) and the prefix window.  Up to
// kNarrowD the resident window takes kResidentBytes.  Past it, the
// resident rows take what the candidate block leaves of kSmemLimit, at
// most kResidentBytes and at least kLaneRows rows; a (d, block) for
// which even kLaneRows rows do not fit is refused.  B's tile is at least
// kLaneRows rows at any d.  R and S use 4*kRankRows (a tile's ranks)
// + 4*32 (warp sums); Q uses 4*d*filter_tile_rows(d), at most 189,440
// bytes at d = 1,480, the widest d any block takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeqThreads = 512;       // stages A and C; the largest block
constexpr int kFlagsPerThread = 16;    // row flags a thread reads per chunk
constexpr int kChunk = kSeqThreads * kFlagsPerThread;
constexpr int kQueueCap = kChunk + kSeqThreads;  // a chunk + a partial block
constexpr int kResidentBytes = 131072;           // window rows kept in smem
constexpr int kLaneRows = 32;          // rows a lane walks alone, per test
constexpr int kWarpUnroll = 4;         // 32-row steps a warp takes per vote
constexpr int kFilterThreads = 256;              // stage B
constexpr int kFilterPer = 2;                    // candidates per B thread
constexpr int kFilterRows = kFilterThreads * kFilterPer;
constexpr int kFilterTileBytes = 32768;          // W_A rows staged per tile
constexpr int kSmemLimit = 232448;               // per CTA on sm_90
constexpr int kMaxGridY = 65535;                 // a grid's y extent
constexpr int kNarrowD = 12;           // widest d with its own instantiation
constexpr int kChunkD = 8;             // wide compare: coordinates a step
constexpr int kRankThreads = 256;      // grids R and S
constexpr int kRankRows = kRankThreads * kFlagsPerThread;  // flags a CTA
constexpr int kPairPer = 4;            // grid Q: candidates per thread
constexpr int kPairRows = kFilterThreads * kPairPer;  // Q's candidate tile
constexpr int kPairWaves = 4;          // grid Q: CTAs per multiprocessor
constexpr int kPairParts = 8;          // grid Q: partitions that share a wave
constexpr int kPairMaxSplit = 8;       // grid Q: reference chunks a tile

// A and C's shared memory apart from the candidates and resident rows
constexpr long long kSeqFixedBytes =
    4LL * kQueueCap + 4LL * 32 + 4LL * kSeqThreads;

__host__ __device__ constexpr int resident_rows(int d) {
  return kResidentBytes / (4 * d);
}

// The resident window rows of the wide variant at (d, block): what the
// candidate block leaves of the limit, at most kResidentBytes, and at
// least kLaneRows rows (which may not fit; seq_smem_bytes then exceeds
// the limit and the launch is refused).
long long resident_rows_wide(int d, int block) {
  const long long room =
      (kSmemLimit - kSeqFixedBytes - 4LL * d * block) / (4LL * d);
  const long long cap = kResidentBytes / (4LL * d);
  const long long rows = room < cap ? room : cap;
  return rows > kLaneRows ? rows : kLaneRows;
}

// B's tile: kFilterTileBytes of coordinates, at least kLaneRows rows.
__host__ __device__ constexpr int filter_tile_rows(int d) {
  return kFilterTileBytes / (4 * d) > kLaneRows ? kFilterTileBytes / (4 * d)
                                                : kLaneRows;
}

long long seq_smem_bytes(int d, int block) {
  const long long res =
      d <= kNarrowD ? resident_rows(d) : resident_rows_wide(d, block);
  return 4LL * d * block + kSeqFixedBytes + 4LL * d * res;
}

// W_A rows one B tile holds: at most the prefix window, min(prefix, wcap)
int filter_rows(int d, int prefix, int wcap) {
  const int rows = prefix < wcap ? prefix : wcap;
  return filter_tile_rows(d) < rows ? filter_tile_rows(d) : rows;
}

// Shared-memory rows are stored by coordinate (row j's k-th coordinate at
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

template <int D>
__device__ __forceinline__ bool dominates_row(const float* w,
                                              const float (&x)[D]) {
  bool le = true, lt = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    le &= w[k] <= x[k];
    lt |= w[k] < x[k];
  }
  return le && lt;
}

// The first dominator of a candidate is found within a few window rows
// for most candidates and never for a few, so neither one thread per
// candidate (a warp waits for its slowest lane) nor one warp per
// candidate (a warp spends a whole step on a one-row walk) fits.  The
// tests below come in both forms: a lane walks the first kLaneRows rows
// for its own candidate, then the warp takes the candidates still alive
// one at a time, 32 rows per step.

// Lane form: does one of rows [lo, hi) of the table t dominate x?
template <int D>
__device__ __forceinline__ bool lane_any(const float* t, int stride, int lo,
                                         int hi, const float (&x)[D]) {
  for (int j = lo; j < hi; ++j)
    if (dominates_soa<D>(t, stride, j, x)) return true;
  return false;
}

// Warp form (every lane calls it with the same y): rows [lo, hi) of the
// table t, 32 * kWarpUnroll at a time, the loads of a step issued
// together.
template <int D>
__device__ __forceinline__ bool warp_any(const float* t, int stride, int lo,
                                         int hi, const float (&y)[D]) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      dom |= (j < hi) & dominates_soa<D>(t, stride, min(j, hi - 1), y);
    }
    if (__any_sync(0xffffffffu, dom)) return true;
  }
  return false;
}

// Warp form over row-major rows [lo, hi) in device memory.
template <int D>
__device__ __forceinline__ bool warp_any_rows(const float* w, int lo, int hi,
                                              const float (&y)[D]) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const int j = min(j0 + 32 * u + lane, hi - 1);
      dom |= (j0 + 32 * u + lane < hi) &
             dominates_row<D>(w + (size_t)j * D, y);
    }
    if (__any_sync(0xffffffffu, dom)) return true;
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

// The flags of rows off .. off + 15 of F, one byte each in w (those at or
// past n read as 0).  Issued a chunk ahead: nothing reads w until the
// next chunk.
__device__ __forceinline__ void load_flags(const uint8_t* F, int off, int n,
                                           uint32_t (&w)[4]) {
  if (off + kFlagsPerThread <= n &&
      (reinterpret_cast<uintptr_t>(F + off) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(F + off);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = off + 4 * q + b;
        word |= (r < n ? uint32_t(F[r]) : 0u) << (8 * b);
      }
      w[q] = word;
    }
  }
}

// Stages A and C: the sequential sweep of one partition per CTA over the
// rows [r0, r1) whose flag is set, flags F[row - r0] at F = flags +
// p * flag_stride, and writes the count to count_out[p].  With
// count_in == nullptr (stage A) it starts from an empty window and keeps
// the original blocks.  Otherwise (stage C) it starts from count_in[p],
// skips the window rows stage B tested, and packs the survivors into
// dense blocks when count_in[p] + survivors[p] <= wcap.
template <int D>
__global__ void __launch_bounds__(kSeqThreads)
sweep_seq_kernel(const float* __restrict__ pts,
                 const uint8_t* __restrict__ flags, long long flag_stride,
                 int r0, int r1, int npad, float* win,
                 uint8_t* __restrict__ wmask,
                 const int* __restrict__ count_in,
                 const int* __restrict__ survivors,
                 int* __restrict__ count_out, int block, int wcap) {
  constexpr int kRes = resident_rows(D);
  extern __shared__ float smem[];
  float* cand = smem;                                   // D x block
  float* res = cand + block * D;                        // D x kRes
  int* queue = reinterpret_cast<int*>(res + kRes * D);  // kQueueCap
  int* warp_tot = queue + kQueueCap;                    // 32
  int* pend = warp_tot + 32;                            // kSeqThreads

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kSeqThreads / 32;
  const int p = blockIdx.x;
  const float* P = pts + (size_t)p * npad * D;
  const uint8_t* F = flags + (size_t)p * flag_stride;
  float* W = win + (size_t)p * wcap * D;
  uint8_t* WM = wmask + (size_t)p * wcap;

  int count = count_in ? count_in[p] : 0;  // the same in every thread
  const int skip = min(count, wcap);       // window rows B tested
  const bool packed =
      count_in && (long long)count + survivors[p] <= (long long)wcap;
  const int n = r1 - r0;

  uint32_t w[4];
  load_flags(F, tid * kFlagsPerThread, n, w);
  int qlen = 0;  // row indices waiting in the queue
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int off = c0 + tid * kFlagsPerThread;
    int set = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = __vcmpne4(w[q], 0u);  // 0xff per set byte
      set += __popc(w[q]) >> 3;
    }
    uint32_t mine_w[4] = {w[0], w[1], w[2], w[3]};
    if (c0 + kChunk < n) load_flags(F, off + kChunk, n, w);  // the next
    int total;
    int slot = qlen + block_exclusive_sum(set, warp_tot, &total);
#pragma unroll
    for (int k = 0; k < kFlagsPerThread; ++k)
      if ((mine_w[k >> 2] >> (8 * (k & 3))) & 1u)
        queue[slot++] = r0 + off + k;
    qlen += total;
    __syncthreads();
    const bool last = c0 + kChunk >= n;
    if (total == 0 && !last) continue;
    const long long read_end = (long long)r0 + min(c0 + kChunk, n);

    int s = 0;  // the next queued row
    while (s < qlen) {
      // where this candidate block ends: `block` rows of the queue when
      // packed, else the queued rows of the first row's original block
      const int first = queue[s];
      const int lim = min(block, qlen - s);
      const int nb = packed ? lim
                            : __syncthreads_count(
                                  tid < lim && queue[s + tid] / block ==
                                                   first / block);
      const bool ready =
          packed ? (nb == block || last)
                 : (s + nb < qlen || last ||
                    ((long long)(first / block) + 1) * block <= read_end);
      if (!ready) break;  // the block goes on in the next chunk

      const bool mine = tid < nb;
      float x[D];
      if (mine) {
        const float* src = P + (size_t)queue[s + tid] * D;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          x[k] = src[k];
          cand[k * block + tid] = x[k];
        }
      }
      // the window rows appended since stage B: [skip, res_end) resident,
      // [res_end, live) in device memory
      const int live = min(count, wcap);
      const int res_end = min(live, skip + kRes);
      const int lane_end = min(res_end, skip + kLaneRows);
      // (a) each thread: its candidate against the first window rows
      if (mine) pend[tid] = !lane_any<D>(res, kRes, 0, lane_end - skip, x);
      __syncthreads();
      // (b) each warp in turn: the candidates still pending against the
      // rest of the window and the earlier rows of the block
      for (int c = warp; c < nb; c += kWarps) {
        if (!pend[c]) continue;
        float y[D];
#pragma unroll
        for (int k = 0; k < D; ++k) y[k] = cand[k * block + c];
        const bool dom = warp_any<D>(res, kRes, lane_end - skip,
                                     res_end - skip, y) ||
                         warp_any_rows<D>(W, res_end, live, y) ||
                         warp_any<D>(cand, block, 0, c, y);
        if (dom && lane == 0) pend[c] = 0;
      }
      __syncthreads();
      // (c) append at count + prefix; keeps past wcap are counted only
      const bool alive = mine && pend[tid];
      int kept;
      const int prefix = block_exclusive_sum(alive ? 1 : 0, warp_tot, &kept);
      if (alive && count + prefix < wcap) {
        const int at = count + prefix;
#pragma unroll
        for (int k = 0; k < D; ++k) W[(size_t)at * D + k] = x[k];
        WM[at] = 1;
        if (at - skip < kRes) {
#pragma unroll
          for (int k = 0; k < D; ++k) res[k * kRes + at - skip] = x[k];
        }
      }
      count += kept;
      s += nb;
      __syncthreads();
    }

    // carry the rows of an unfinished block to the front of the queue
    const int rest = qlen - s;
    if (s > 0 && rest > 0) {
      const int v = tid < rest ? queue[s + tid] : 0;
      __syncthreads();
      if (tid < rest) queue[tid] = v;
      __syncthreads();
    }
    qlen = rest;
  }
  if (tid == 0) count_out[p] = count;
}

// Stage B: alive[p, row - r0] = mask[p, row] and no live row of the
// prefix window W_A (its first min(count[p], wcap) rows) dominates row;
// survivors[p] += the partition's alive rows.
template <int D>
__global__ void __launch_bounds__(kFilterThreads)
sweep_filter_kernel(const float* __restrict__ pts,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ win,
                    const int* __restrict__ count,
                    uint8_t* __restrict__ alive, long long alive_stride,
                    int* __restrict__ survivors, int npad, int r0, int wcap,
                    int tile_rows) {
  extern __shared__ float tile[];  // D x tile_rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = blockIdx.y;
  const int c0 = r0 + blockIdx.x * kFilterRows;
  const float* P = pts + (size_t)p * npad * D;
  const uint8_t* M = mask + (size_t)p * npad;
  const float* W = win + (size_t)p * wcap * D;
  const int live = min(count[p], wcap);

  float x[kFilterPer][D];
  unsigned todo = 0;  // bit k: candidate k is valid and not yet dominated
#pragma unroll
  for (int k = 0; k < kFilterPer; ++k) {
    const int row = c0 + tid + k * kFilterThreads;
    const bool valid = row < npad && M[row] != 0;
    const float* src = P + (size_t)(valid ? row : 0) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) x[k][e] = valid ? src[e] : 0.f;
    todo |= valid ? 1u << k : 0u;
  }

  for (int t0 = 0; t0 < live; t0 += tile_rows) {
    if (!__syncthreads_or(todo != 0)) break;
    const int rows = min(tile_rows, live - t0);
    for (int e = tid; e < rows * D; e += kFilterThreads)
      tile[(e % D) * tile_rows + e / D] = W[(size_t)t0 * D + e];
    __syncthreads();
    const int lane_end = min(rows, kLaneRows);
#pragma unroll
    for (int k = 0; k < kFilterPer; ++k) {
      bool a = (todo >> k) & 1u;
      if (a) a = !lane_any<D>(tile, tile_rows, 0, lane_end, x[k]);
      unsigned need = __ballot_sync(0xffffffffu, a && rows > lane_end);
      while (need) {
        const int src = __ffs(need) - 1;
        need &= need - 1;
        float y[D];
#pragma unroll
        for (int e = 0; e < D; ++e)
          y[e] = __shfl_sync(0xffffffffu, x[k][e], src);
        if (warp_any<D>(tile, tile_rows, lane_end, rows, y) && lane == src)
          a = false;
      }
      todo = a ? todo : todo & ~(1u << k);
    }
  }

  uint8_t* A = alive + (size_t)p * alive_stride;
#pragma unroll
  for (int k = 0; k < kFilterPer; ++k) {
    const int row = c0 + tid + k * kFilterThreads;
    if (row < npad) A[row - r0] = (todo >> k) & 1u;
  }
  const unsigned n = __reduce_add_sync(0xffffffffu, __popc(todo));
  if ((tid & 31) == 0 && n) atomicAdd(survivors + p, (int)n);
}

// -- the wide variant (d > kNarrowD, d at run time) ------------------------

// Does the row at r (its k-th coordinate at r[k * rs]) dominate the
// candidate whose first kChunkD coordinates are x0 and whose k-th lies
// at c[k * cs]?  kChunkD coordinates a step; the compare ends after the
// first step in which the row exceeds the candidate somewhere.  Needs
// d >= kChunkD.
__device__ __forceinline__ bool dominates_wide(const float* r, int rs,
                                               const float (&x0)[kChunkD],
                                               const float* c, int cs,
                                               int d) {
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
        const float v = c[static_cast<size_t>(k) * cs];
        le &= w <= v;
        lt |= w < v;
      }
    }
  }
  return le && lt;
}

// Lane form: does one of rows [lo, hi) of the table t dominate the
// candidate (x0, c, cs)?
__device__ __forceinline__ bool lane_any_wide(const float* t, int stride,
                                              int lo, int hi,
                                              const float (&x0)[kChunkD],
                                              const float* c, int cs,
                                              int d) {
  for (int j = lo; j < hi; ++j)
    if (dominates_wide(t + j, stride, x0, c, cs, d)) return true;
  return false;
}

// Warp form (every lane calls it with the same candidate): rows [lo, hi)
// of the table t, 32 * kWarpUnroll per vote.
__device__ __forceinline__ bool warp_any_wide(const float* t, int stride,
                                              int lo, int hi,
                                              const float (&y0)[kChunkD],
                                              const float* c, int cs,
                                              int d) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      dom |= j < hi && dominates_wide(t + j, stride, y0, c, cs, d);
    }
    if (__any_sync(0xffffffffu, dom)) return true;
  }
  return false;
}

// Warp form over row-major rows [lo, hi) in device memory.
__device__ __forceinline__ bool warp_any_rows_wide(
    const float* w, int lo, int hi, const float (&y0)[kChunkD],
    const float* c, int cs, int d) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lo; j0 < hi; j0 += 32 * kWarpUnroll) {
    bool dom = false;
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      dom |= j < hi &&
             dominates_wide(w + static_cast<size_t>(j) * d, 1, y0, c, cs, d);
    }
    if (__any_sync(0xffffffffu, dom)) return true;
  }
  return false;
}

// The branch of stage C: does partition p's count stay within wcap?
__device__ __forceinline__ bool packed_branch(const int* count_in,
                                              const int* survivors, int p,
                                              int wcap) {
  return (long long)count_in[p] + survivors[p] <= (long long)wcap;
}

// Stages A and C at any d: sweep_seq_kernel's schedule in the original
// blocks, with the candidates read from the staged candidate block
// (coordinate k of candidate t at cand[k * block + t]) and res_rows
// resident window rows.  As C it returns where the partition packs: the
// grids R, Q and S run that branch.
__global__ void __launch_bounds__(kSeqThreads)
sweep_seq_wide_kernel(const float* __restrict__ pts,
                      const uint8_t* __restrict__ flags,
                      long long flag_stride, int r0, int r1, int npad,
                      float* win, uint8_t* __restrict__ wmask,
                      const int* __restrict__ count_in,
                      const int* __restrict__ survivors,
                      int* __restrict__ count_out, int block, int wcap,
                      int d, int res_rows) {
  extern __shared__ float smem[];
  float* cand = smem;                                          // d x block
  float* res = cand + static_cast<size_t>(block) * d;          // d x res_rows
  int* queue =
      reinterpret_cast<int*>(res + static_cast<size_t>(res_rows) * d);
  int* warp_tot = queue + kQueueCap;                           // 32
  int* pend = warp_tot + 32;                                   // kSeqThreads

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kSeqThreads / 32;
  const int p = blockIdx.x;
  if (count_in && packed_branch(count_in, survivors, p, wcap)) return;
  const float* P = pts + (size_t)p * npad * d;
  const uint8_t* F = flags + (size_t)p * flag_stride;
  float* W = win + (size_t)p * wcap * d;
  uint8_t* WM = wmask + (size_t)p * wcap;

  int count = count_in ? count_in[p] : 0;  // the same in every thread
  const int skip = min(count, wcap);       // window rows B tested
  const int n = r1 - r0;

  uint32_t w[4];
  load_flags(F, tid * kFlagsPerThread, n, w);
  int qlen = 0;  // row indices waiting in the queue
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int off = c0 + tid * kFlagsPerThread;
    int set = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = __vcmpne4(w[q], 0u);  // 0xff per set byte
      set += __popc(w[q]) >> 3;
    }
    uint32_t mine_w[4] = {w[0], w[1], w[2], w[3]};
    if (c0 + kChunk < n) load_flags(F, off + kChunk, n, w);  // the next
    int total;
    int slot = qlen + block_exclusive_sum(set, warp_tot, &total);
#pragma unroll
    for (int k = 0; k < kFlagsPerThread; ++k)
      if ((mine_w[k >> 2] >> (8 * (k & 3))) & 1u)
        queue[slot++] = r0 + off + k;
    qlen += total;
    __syncthreads();
    const bool last = c0 + kChunk >= n;
    if (total == 0 && !last) continue;
    const long long read_end = (long long)r0 + min(c0 + kChunk, n);

    int s = 0;  // the next queued row
    while (s < qlen) {
      // the queued rows of the first row's original block
      const int first = queue[s];
      const int lim = min(block, qlen - s);
      const int nb = __syncthreads_count(
          tid < lim && queue[s + tid] / block == first / block);
      const bool ready =
          s + nb < qlen || last ||
          ((long long)(first / block) + 1) * block <= read_end;
      if (!ready) break;  // the block goes on in the next chunk

      const bool mine = tid < nb;
      float x0[kChunkD];
      if (mine) {
        const float* src = P + (size_t)queue[s + tid] * d;
        for (int k = 0; k < d; ++k) cand[k * block + tid] = src[k];
#pragma unroll
        for (int k = 0; k < kChunkD; ++k) x0[k] = cand[k * block + tid];
      }
      const int live = min(count, wcap);
      const int res_end = min(live, skip + res_rows);
      const int lane_end = min(res_end, skip + kLaneRows);
      // (a) each thread: its candidate against the first window rows
      if (mine)
        pend[tid] = !lane_any_wide(res, res_rows, 0, lane_end - skip, x0,
                                   cand + tid, block, d);
      __syncthreads();
      // (b) each warp in turn: the candidates still pending against the
      // rest of the window and the earlier rows of the block
      for (int c = warp; c < nb; c += kWarps) {
        if (!pend[c]) continue;
        float y0[kChunkD];
#pragma unroll
        for (int k = 0; k < kChunkD; ++k) y0[k] = cand[k * block + c];
        const float* yc = cand + c;
        const bool dom =
            warp_any_wide(res, res_rows, lane_end - skip, res_end - skip, y0,
                          yc, block, d) ||
            warp_any_rows_wide(W, res_end, live, y0, yc, block, d) ||
            warp_any_wide(cand, block, 0, c, y0, yc, block, d);
        if (dom && lane == 0) pend[c] = 0;
      }
      __syncthreads();
      // (c) append at count + prefix; keeps past wcap are counted only
      const bool alive = mine && pend[tid];
      int kept;
      const int prefix = block_exclusive_sum(alive ? 1 : 0, warp_tot, &kept);
      if (alive && count + prefix < wcap) {
        const int at = count + prefix;
        for (int k = 0; k < d; ++k) W[(size_t)at * d + k] = cand[k * block + tid];
        WM[at] = 1;
        if (at - skip < res_rows) {
          for (int k = 0; k < d; ++k)
            res[k * res_rows + at - skip] = cand[k * block + tid];
        }
      }
      count += kept;
      s += nb;
      __syncthreads();
    }

    // carry the rows of an unfinished block to the front of the queue
    const int rest = qlen - s;
    if (s > 0 && rest > 0) {
      const int v = tid < rest ? queue[s + tid] : 0;
      __syncthreads();
      if (tid < rest) queue[tid] = v;
      __syncthreads();
    }
    qlen = rest;
  }
  if (tid == 0) count_out[p] = count;
}

// Grid Q's test: each lane walks the staged rows of the table t (stride
// ts) for all kPairPer candidates it holds at once, loading a row's first
// kChunkD coordinates once for all of them.  Candidate k, its first
// kChunkD coordinates in x0[k] and its e-th at c[k][e * cs], meets rows
// [0, lim[k]) and leaves the walk at its first dominator.  Returns todo
// less the bits of the candidates found dominated.  Unlike B's rows, few
// survivors are dominated past d = 12, so nearly every lane walks the
// whole tile and the lanes of a warp stay together.
__device__ __forceinline__ unsigned tile_walk_wide(
    const float* t, int ts, const float (&x0)[kPairPer][kChunkD],
    const float* const (&c)[kPairPer], int cs, const int (&lim)[kPairPer],
    unsigned todo, int d) {
  int hi = 0;
#pragma unroll
  for (int k = 0; k < kPairPer; ++k)
    hi = (todo >> k) & 1u ? max(hi, lim[k]) : hi;
  for (int j = 0; j < hi && todo; ++j) {
    float w[kChunkD];
#pragma unroll
    for (int e = 0; e < kChunkD; ++e) w[e] = t[e * ts + j];
#pragma unroll
    for (int k = 0; k < kPairPer; ++k) {
      if (!((todo >> k) & 1u) || j >= lim[k]) continue;
      bool le = true, lt = false;
#pragma unroll
      for (int e = 0; e < kChunkD; ++e) {
        le &= w[e] <= x0[k][e];
        lt |= w[e] < x0[k][e];
      }
      for (int k0 = kChunkD; le && k0 < d; k0 += kChunkD) {
#pragma unroll
        for (int u = 0; u < kChunkD; ++u) {
          const int e = k0 + u;
          if (e < d) {
            const float r = t[e * ts + j];
            const float v = c[k][static_cast<size_t>(e) * cs];
            le &= r <= v;
            lt |= r < v;
          }
        }
      }
      if (le && lt) todo &= ~(1u << k);
    }
  }
  return todo;
}

// Stage B at any d: sweep_filter_kernel's schedule, each candidate's
// first kChunkD coordinates in registers and the rest read from its row.
__global__ void __launch_bounds__(kFilterThreads)
sweep_filter_wide_kernel(const float* __restrict__ pts,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ win,
                         const int* __restrict__ count,
                         uint8_t* __restrict__ alive, long long alive_stride,
                         int* __restrict__ survivors, int npad, int r0,
                         int wcap, int tile_rows, int d) {
  extern __shared__ float tile[];  // d x tile_rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = blockIdx.y;
  const int c0 = r0 + blockIdx.x * kFilterRows;
  const float* P = pts + (size_t)p * npad * d;
  const uint8_t* M = mask + (size_t)p * npad;
  const float* W = win + (size_t)p * wcap * d;
  const int live = min(count[p], wcap);

  float x0[kFilterPer][kChunkD];
  unsigned todo = 0;  // bit k: candidate k is valid and not yet dominated
#pragma unroll
  for (int k = 0; k < kFilterPer; ++k) {
    const int row = c0 + tid + k * kFilterThreads;
    const bool valid = row < npad && M[row] != 0;
    const float* src = P + (size_t)(valid ? row : 0) * d;
#pragma unroll
    for (int e = 0; e < kChunkD; ++e) x0[k][e] = valid ? src[e] : 0.f;
    todo |= valid ? 1u << k : 0u;
  }

  for (int t0 = 0; t0 < live; t0 += tile_rows) {
    if (!__syncthreads_or(todo != 0)) break;
    const int rows = min(tile_rows, live - t0);
    for (int e = tid; e < rows * d; e += kFilterThreads)
      tile[(e % d) * tile_rows + e / d] = W[(size_t)t0 * d + e];
    __syncthreads();
    const int lane_end = min(rows, kLaneRows);
#pragma unroll
    for (int k = 0; k < kFilterPer; ++k) {
      const int row = c0 + tid + k * kFilterThreads;
      bool a = (todo >> k) & 1u;
      if (a)
        a = !lane_any_wide(tile, tile_rows, 0, lane_end, x0[k],
                           P + (size_t)row * d, 1, d);
      unsigned need = __ballot_sync(0xffffffffu, a && rows > lane_end);
      while (need) {
        const int src = __ffs(need) - 1;
        need &= need - 1;
        float y0[kChunkD];
#pragma unroll
        for (int e = 0; e < kChunkD; ++e)
          y0[e] = __shfl_sync(0xffffffffu, x0[k][e], src);
        const float* yc = P + (size_t)(row - lane + src) * d;
        if (warp_any_wide(tile, tile_rows, lane_end, rows, y0, yc, 1, d) &&
            lane == src)
          a = false;
      }
      todo = a ? todo : todo & ~(1u << k);
    }
  }

  uint8_t* A = alive + (size_t)p * alive_stride;
#pragma unroll
  for (int k = 0; k < kFilterPer; ++k) {
    const int row = c0 + tid + k * kFilterThreads;
    if (row < npad) A[row - r0] = (todo >> k) & 1u;
  }
  const unsigned n = __reduce_add_sync(0xffffffffu, __popc(todo));
  if ((tid & 31) == 0 && n) atomicAdd(survivors + p, (int)n);
}

// -- the packed branch past kNarrowD: grids R, Q and S ----------------------

// Bit b: entry off + b of F is below n and set (its byte nonzero), or,
// with `unset`, below n and zero.
__device__ __forceinline__ uint32_t flag_bits(const uint8_t* F, int off,
                                              int n, bool unset) {
  uint32_t w[4];
  load_flags(F, off, n, w);
  uint32_t bits = 0;
#pragma unroll
  for (int b = 0; b < kFlagsPerThread; ++b) {
    const bool set = ((w[b >> 2] >> (8 * (b & 3))) & 0xffu) != 0;
    bits |= uint32_t((set != unset) && off + b < n) << b;
  }
  return bits;
}

// The sum of tc[0 .. t) over the CTA.  The caller synchronises between
// two calls (warp_tot).
__device__ __forceinline__ int sum_before(const int* tc, int t,
                                          int* warp_tot) {
  int s = 0;
  for (int u = threadIdx.x; u < t; u += blockDim.x) s += tc[u];
  int total;
  block_exclusive_sum(s, warp_tot, &total);
  return total;
}

// Puts the entries whose bit is set, off + b for bit b, at
// queue[slot ...] in order.
__device__ __forceinline__ void enqueue_bits(uint32_t bits, int off,
                                             int slot, int* queue) {
  for (; bits; bits &= bits - 1) queue[slot++] = off + __ffs(bits) - 1;
}

// Grid R over the alive bytes of partition p (rows r0 + [0, npad - r0)),
// one CTA a tile of kRankRows.  The count pass writes the tile's
// survivors to tiles[t]; the scatter pass writes survivor s (rank
// tiles[0 .. t) + its rank in the tile) to sv[k * stride + s] for each
// coordinate k and clears its byte of dom.
template <bool kScatter>
__global__ void __launch_bounds__(kRankThreads)
sweep_rank_wide_kernel(const float* __restrict__ pts,
                       const uint8_t* __restrict__ alive, long long stride,
                       const int* __restrict__ count_in,
                       const int* __restrict__ survivors,
                       int* __restrict__ tiles, int ntiles,
                       float* __restrict__ sv, uint8_t* __restrict__ dom,
                       int npad, int r0, int wcap, int d) {
  extern __shared__ int ranks[];  // kRankRows + 32 warp sums
  int* warp_tot = ranks + kRankRows;
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int t = blockIdx.x;
  if (!packed_branch(count_in, survivors, p, wcap)) return;
  const int off = t * kRankRows + tid * kFlagsPerThread;
  const uint32_t bits =
      flag_bits(alive + (size_t)p * stride, off, npad - r0, false);
  int cnt;
  const int slot = block_exclusive_sum(__popc(bits), warp_tot, &cnt);
  int* T = tiles + (size_t)p * ntiles;
  if (!kScatter) {
    if (tid == 0) T[t] = cnt;
    return;
  }
  enqueue_bits(bits, off, slot, ranks);
  __syncthreads();
  const int base = sum_before(T, t, warp_tot);
  const float* P = pts + ((size_t)p * npad + r0) * d;
  float* V = sv + (size_t)p * d * stride + base;
  for (int k = 0; k < d; ++k)
    for (int q = tid; q < cnt; q += kRankThreads)
      V[(size_t)k * stride + q] = P[(size_t)ranks[q] * d + k];
  for (int q = tid; q < cnt; q += kRankThreads)
    dom[(size_t)p * stride + base + q] = 0;
}

// Grid Q: dom[s] = 1 where an earlier survivor dominates survivor s, for
// the survivors of partition p, coordinate-major in sv.  A persistent
// grid: each CTA takes the items blockIdx.x, blockIdx.x + gridDim.x, ...
// Item w is (candidate tile c, chunk h): the candidates
// [c * kPairRows, +kPairRows) against the references
// [h * chunk, +chunk), chunk = kPairRows / g, before the tile's end;
// tile c has (c + 1) * g items, so items are numbered along the lower
// triangle.
__global__ void __launch_bounds__(kFilterThreads)
sweep_pairs_wide_kernel(const float* __restrict__ sv, uint8_t* dom,
                        long long stride, const int* __restrict__ count_in,
                        const int* __restrict__ survivors, int wcap,
                        int tile_rows, int d) {
  extern __shared__ float tile[];  // d x tile_rows
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int n = survivors[p];
  if (!packed_branch(count_in, survivors, p, wcap) || n < 2) return;
  const float* V = sv + (size_t)p * d * stride;
  uint8_t* Dm = dom + (size_t)p * stride;
  const long long tiles = (n + kPairRows - 1) / kPairRows;
  const long long tri = tiles * (tiles + 1) / 2;
  int g = 1;
  while (g < kPairMaxSplit && g * tri < gridDim.x) g *= 2;
  const int chunk = kPairRows / g;

  for (long long w = blockIdx.x; w < g * tri; w += gridDim.x) {
    // c: the largest with c (c + 1) / 2 <= w / g
    const long long u = w / g;
    long long c = (long long)((sqrt(8.0 * (double)u + 1.0) - 1.0) * 0.5);
    while (c * (c + 1) / 2 > u) --c;
    while ((c + 1) * (c + 2) / 2 <= u) ++c;
    const int c0 = (int)c * kPairRows;
    const int lo = (int)(w - g * (c * (c + 1) / 2)) * chunk;
    const int hi = min(min(lo + chunk, c0 + kPairRows), n);
    if (lo >= hi) continue;  // past the last survivor: the same in the CTA

    float x0[kPairPer][kChunkD];
    const float* cp[kPairPer];
    unsigned todo = 0;  // bit k: candidate k has references and no mark
#pragma unroll
    for (int k = 0; k < kPairPer; ++k) {
      const int i = c0 + tid + k * kFilterThreads;
      const bool open =
          i < n && i > lo && *reinterpret_cast<volatile const uint8_t*>(
                                 Dm + i) == 0;
      cp[k] = V + (open ? i : 0);
#pragma unroll
      for (int e = 0; e < kChunkD; ++e)
        x0[k][e] = open ? cp[k][(size_t)e * stride] : 0.f;
      todo |= open ? 1u << k : 0u;
    }
    const unsigned opened = todo;

    for (int t0 = lo; t0 < hi; t0 += tile_rows) {
      if (!__syncthreads_or(todo != 0)) break;
      const int rows = min(tile_rows, hi - t0);
      for (int e = tid; e < rows * d; e += kFilterThreads) {
        const int k = e / rows;
        const int r = e - k * rows;
        tile[k * tile_rows + r] = V[(size_t)k * stride + t0 + r];
      }
      __syncthreads();
      int lim[kPairPer];  // only references before the candidate
#pragma unroll
      for (int k = 0; k < kPairPer; ++k)
        lim[k] = max(0, min(rows, c0 + tid + k * kFilterThreads - t0));
      todo = tile_walk_wide(tile, tile_rows, x0, cp, (int)stride, lim, todo,
                            d);
    }
#pragma unroll
    for (int k = 0; k < kPairPer; ++k)
      if ((opened & ~todo) >> k & 1u) Dm[c0 + tid + k * kFilterThreads] = 1;
  }
}

// Grid S over the survivors of partition p, tiles of kRankRows as in R:
// the count pass writes the tile's undominated survivors to tiles[t];
// the scatter pass copies each to window row count_in + its rank, sets
// its mask, and tile 0 writes count_out.
template <bool kScatter>
__global__ void __launch_bounds__(kRankThreads)
sweep_append_wide_kernel(const float* __restrict__ sv,
                         const uint8_t* __restrict__ dom, long long stride,
                         const int* __restrict__ count_in,
                         const int* __restrict__ survivors,
                         int* __restrict__ tiles, int ntiles, float* win,
                         uint8_t* __restrict__ wmask,
                         int* __restrict__ count_out, int wcap, int d) {
  extern __shared__ int ranks[];  // kRankRows + 32 warp sums
  int* warp_tot = ranks + kRankRows;
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int t = blockIdx.x;
  if (!packed_branch(count_in, survivors, p, wcap)) return;
  const int off = t * kRankRows + tid * kFlagsPerThread;
  const uint32_t bits =
      flag_bits(dom + (size_t)p * stride, off, survivors[p], true);
  int cnt;
  const int slot = block_exclusive_sum(__popc(bits), warp_tot, &cnt);
  int* T = tiles + (size_t)p * ntiles;
  if (!kScatter) {
    if (tid == 0) T[t] = cnt;
    return;
  }
  enqueue_bits(bits, off, slot, ranks);
  __syncthreads();
  const int c_in = count_in[p];
  const int base = sum_before(T, t, warp_tot);
  if (t == 0) {
    __syncthreads();
    const int kept = sum_before(T, ntiles, warp_tot);
    if (tid == 0) count_out[p] = c_in + kept;
  }
  const float* V = sv + (size_t)p * d * stride;
  const size_t at = (size_t)p * wcap + c_in + base;
  float* W = win + at * d;  // cnt rows, row-major: one coalesced run
  for (int e = tid; e < cnt * d; e += kRankThreads) {
    const int q = e / d;
    W[e] = V[(size_t)(e - q * d) * stride + ranks[q]];
  }
  for (int q = tid; q < cnt; q += kRankThreads) wmask[at + q] = 1;
}

template <int D>
cudaError_t launch_seq(const void* pts, const void* flags,
                       long long flag_stride, int r0, int r1, int npad,
                       void* win, void* wmask, const void* count_in,
                       const void* survivors, void* count_out, int parts,
                       int block, int wcap, cudaStream_t stream) {
  const long long smem = seq_smem_bytes(D, block);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_seq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_seq_kernel<D><<<parts, kSeqThreads, smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(flags),
      flag_stride, r0, r1, npad, static_cast<float*>(win),
      static_cast<uint8_t*>(wmask), static_cast<const int*>(count_in),
      static_cast<const int*>(survivors), static_cast<int*>(count_out),
      block, wcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_filter(const void* pts, const void* mask, const void* win,
                          const void* count, void* alive,
                          long long alive_stride, void* survivors, int parts,
                          int npad, int r0, int wcap, cudaStream_t stream) {
  const int rows = filter_rows(D, r0, wcap);
  const int smem = 4 * D * rows;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_filter_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // the partitions go on grid y, at most kMaxGridY a grid: more are
  // covered by grids over successive slices, each from its first
  // partition on (one entry call, one launch on the count)
  for (int p0 = 0; p0 < parts; p0 += kMaxGridY) {
    const int n = parts - p0 < kMaxGridY ? parts - p0 : kMaxGridY;
    const dim3 grid((npad - r0 + kFilterRows - 1) / kFilterRows, n);
    sweep_filter_kernel<D><<<grid, kFilterThreads, smem, stream>>>(
        static_cast<const float*>(pts) + (size_t)p0 * npad * D,
        static_cast<const uint8_t*>(mask) + (size_t)p0 * npad,
        static_cast<const float*>(win) + (size_t)p0 * wcap * D,
        static_cast<const int*>(count) + p0,
        static_cast<uint8_t*>(alive) + (size_t)p0 * alive_stride,
        alive_stride, static_cast<int*>(survivors) + p0, npad, r0, wcap,
        rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_seq_wide(int d, const void* pts, const void* flags,
                            long long flag_stride, int r0, int r1, int npad,
                            void* win, void* wmask, const void* count_in,
                            const void* survivors, void* count_out,
                            int parts, int block, int wcap,
                            cudaStream_t stream) {
  const long long smem = seq_smem_bytes(d, block);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_seq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_seq_wide_kernel<<<parts, kSeqThreads, smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(flags),
      flag_stride, r0, r1, npad, static_cast<float*>(win),
      static_cast<uint8_t*>(wmask), static_cast<const int*>(count_in),
      static_cast<const int*>(survivors), static_cast<int*>(count_out),
      block, wcap, d, static_cast<int>(resident_rows_wide(d, block)));
  return cudaGetLastError();
}

cudaError_t launch_filter_wide(int d, const void* pts, const void* mask,
                               const void* win, const void* count,
                               void* alive, long long alive_stride,
                               void* survivors, int parts, int npad, int r0,
                               int wcap, cudaStream_t stream) {
  const int rows = filter_rows(d, r0, wcap);
  const long long smem = 4LL * d * rows;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_filter_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  for (int p0 = 0; p0 < parts; p0 += kMaxGridY) {
    const int n = parts - p0 < kMaxGridY ? parts - p0 : kMaxGridY;
    const dim3 grid((npad - r0 + kFilterRows - 1) / kFilterRows, n);
    sweep_filter_wide_kernel<<<grid, kFilterThreads, smem, stream>>>(
        static_cast<const float*>(pts) + (size_t)p0 * npad * d,
        static_cast<const uint8_t*>(mask) + (size_t)p0 * npad,
        static_cast<const float*>(win) + (size_t)p0 * wcap * d,
        static_cast<const int*>(count) + p0,
        static_cast<uint8_t*>(alive) + (size_t)p0 * alive_stride,
        alive_stride, static_cast<int*>(survivors) + p0, npad, r0, wcap,
        rows, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Grids R and S: a tile's ranks and the warp sums
constexpr long long kRankSmemBytes = 4LL * kRankRows + 4LL * 32;

// Grid Q: one tile of filter_tile_rows(d) survivors
long long pairs_smem_bytes(int d) { return 4LL * d * filter_tile_rows(d); }

// Grid R (grid 0, both passes), Q (1) or S (2, both passes) of the packed
// branch over the rows [r0, npad) of every partition, in slices of
// kMaxGridY partitions on y.  sv holds d x stride floats a partition,
// dom stride bytes, tiles one int per kRankRows rows.
cudaError_t launch_packed_wide(int grid, int d, const void* pts,
                               const void* alive, long long stride,
                               void* sv, void* dom, void* tiles,
                               const void* count_in, const void* survivors,
                               void* win, void* wmask, void* count_out,
                               int parts, int npad, int r0, int wcap,
                               cudaStream_t stream) {
  const int ntiles = (npad - r0 + kRankRows - 1) / kRankRows;
  const long long pair_smem = pairs_smem_bytes(d);
  if (pair_smem > kSmemLimit) return cudaErrorInvalidValue;
  // grid Q: kPairWaves CTAs a multiprocessor for each partition of up to
  // kPairParts, so that one partition's items can take the whole card
  // while the others wait in the queue; past that, the partitions share
  // kPairParts waves
  int gx = 1;
  if (grid == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_pairs_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pair_smem);
    int dev = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long ctas = (long long)sms * kPairWaves *
                           (parts < kPairParts ? parts : kPairParts);
    gx = (int)((ctas + parts - 1) / parts);
  }
  for (int p0 = 0; p0 < parts; p0 += kMaxGridY) {
    const int n = parts - p0 < kMaxGridY ? parts - p0 : kMaxGridY;
    const size_t q = p0;
    const float* P = static_cast<const float*>(pts) + q * npad * d;
    const uint8_t* A = static_cast<const uint8_t*>(alive) + q * stride;
    float* V = static_cast<float*>(sv) + q * d * stride;
    uint8_t* Dm = static_cast<uint8_t*>(dom) + q * stride;
    int* T = static_cast<int*>(tiles) + q * ntiles;
    const int* C = static_cast<const int*>(count_in) + q;
    const int* S = static_cast<const int*>(survivors) + q;
    const dim3 by_tile(ntiles, n);
    if (grid == 0) {
      sweep_rank_wide_kernel<false>
          <<<by_tile, kRankThreads, kRankSmemBytes, stream>>>(
              P, A, stride, C, S, T, ntiles, V, Dm, npad, r0, wcap, d);
      sweep_rank_wide_kernel<true>
          <<<by_tile, kRankThreads, kRankSmemBytes, stream>>>(
              P, A, stride, C, S, T, ntiles, V, Dm, npad, r0, wcap, d);
    } else if (grid == 1) {
      sweep_pairs_wide_kernel<<<dim3(gx, n), kFilterThreads, pair_smem,
                                stream>>>(V, Dm, stride, C, S, wcap,
                                          filter_tile_rows(d), d);
    } else {
      float* W = static_cast<float*>(win) + q * wcap * d;
      uint8_t* WM = static_cast<uint8_t*>(wmask) + q * wcap;
      int* out = static_cast<int*>(count_out) + q;
      sweep_append_wide_kernel<false>
          <<<by_tile, kRankThreads, kRankSmemBytes, stream>>>(
              V, Dm, stride, C, S, T, ntiles, W, WM, out, wcap, d);
      sweep_append_wide_kernel<true>
          <<<by_tile, kRankThreads, kRankSmemBytes, stream>>>(
              V, Dm, stride, C, S, T, ntiles, W, WM, out, wcap, d);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

#define SFS_DISPATCH(CALL)                                              \
  switch (d) {                                                          \
    case 1: return static_cast<int>(CALL(1));                           \
    case 2: return static_cast<int>(CALL(2));                           \
    case 3: return static_cast<int>(CALL(3));                           \
    case 4: return static_cast<int>(CALL(4));                           \
    case 5: return static_cast<int>(CALL(5));                           \
    case 6: return static_cast<int>(CALL(6));                           \
    case 7: return static_cast<int>(CALL(7));                           \
    case 8: return static_cast<int>(CALL(8));                           \
    case 9: return static_cast<int>(CALL(9));                           \
    case 10: return static_cast<int>(CALL(10));                         \
    case 11: return static_cast<int>(CALL(11));                         \
    case 12: return static_cast<int>(CALL(12));                         \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

// Stage A (count_in == survivors == nullptr) or C (both given) of the
// sweep on `stream`; returns the cudaError_t of the launch.  The caller
// checks shapes, types and devices; the checks here only keep a bad call
// from launching.
extern "C" int sfs_sweep_seq_launch(const void* pts, const void* flags,
                                    long long flag_stride, int r0, int r1,
                                    void* win, void* wmask,
                                    const void* count_in,
                                    const void* survivors, void* count_out,
                                    int parts, int npad, int d, int block,
                                    int wcap, void* stream) {
  if (parts < 1 || npad < 1 || block < 1 || block > kSeqThreads ||
      npad % block != 0 || wcap < 0 || r0 < 0 || r0 > r1 || r1 > npad ||
      r0 % block != 0 || flag_stride < r1 - r0 ||
      (count_in == nullptr) != (survivors == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kNarrowD)
    return static_cast<int>(launch_seq_wide(
        d, pts, flags, flag_stride, r0, r1, npad, win, wmask, count_in,
        survivors, count_out, parts, block, wcap, s));
#define SFS_SEQ(D)                                                        \
  launch_seq<D>(pts, flags, flag_stride, r0, r1, npad, win, wmask,       \
                count_in, survivors, count_out, parts, block, wcap, s)
  SFS_DISPATCH(SFS_SEQ)
#undef SFS_SEQ
}

// Stage B of the sweep over rows [r0, npad) on `stream`.
extern "C" int sfs_sweep_filter_launch(const void* pts, const void* mask,
                                       const void* win, const void* count,
                                       void* alive, long long alive_stride,
                                       void* survivors, int parts, int npad,
                                       int d, int r0, int wcap,
                                       void* stream) {
  if (parts < 1 || r0 < 0 || r0 >= npad || wcap < 0 ||
      alive_stride < npad - r0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kNarrowD)
    return static_cast<int>(launch_filter_wide(
        d, pts, mask, win, count, alive, alive_stride, survivors, parts,
        npad, r0, wcap, s));
#define SFS_FILTER(D)                                                    \
  launch_filter<D>(pts, mask, win, count, alive, alive_stride, survivors, \
                   parts, npad, r0, wcap, s)
  SFS_DISPATCH(SFS_FILTER)
#undef SFS_FILTER
}

#undef SFS_DISPATCH

// Grid R (grid 0), Q (1) or S (2) of the packed branch, d > kNarrowD, on
// `stream`, after B and before C.  sv, dom and tiles are the scratch
// launch_packed_wide describes; stride is B's alive stride.
extern "C" int sfs_sweep_packed_launch(int grid, const void* pts,
                                       const void* alive, long long stride,
                                       void* sv, void* dom, void* tiles,
                                       const void* count_in,
                                       const void* survivors, void* win,
                                       void* wmask, void* count_out,
                                       int parts, int npad, int d, int r0,
                                       int wcap, void* stream) {
  if (grid < 0 || grid > 2 || d <= kNarrowD || parts < 1 || r0 < 0 ||
      r0 >= npad || wcap < 0 || stride < npad - r0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_packed_wide(
      grid, d, pts, alive, stride, sv, dom, tiles, count_in, survivors, win,
      wmask, count_out, parts, npad, r0, wcap,
      static_cast<cudaStream_t>(stream)));
}

// The dynamic shared memory a CTA of each grid takes: stage 0 is A and C
// (sweep_seq_kernel), stage 1 is B with a prefix of `prefix` rows, stage
// 2 the grids R and S, stage 3 the grid Q (the last two run past
// kNarrowD only).
extern "C" long long sfs_sweep_smem_bytes(int stage, int d, int block,
                                          int prefix, int wcap) {
  if (d < 1) return -1;
  switch (stage) {
    case 0: return seq_smem_bytes(d, block);
    case 1: return 4LL * d * filter_rows(d, prefix, wcap);
    case 2: return kRankSmemBytes;
    default: return pairs_smem_bytes(d);
  }
}

extern "C" const char* sfs_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
