// Hand-written Hopper (sm_90a) kernels for the counting-semiring sweep
// (shortest-path counting, Brandes stage 1).
//
// Two kernels, one per Pallas kernel of src/repro/kernels/counting/kernel.py,
// and the builder of the operand's live-word index that both read.  The
// state is the pair (dist int32, sigma float32); the operand is the dense
// (k, n) int8 adjacency, row k = out-neighbours of k.  Every entry point
// is a plain C function that launches on the given stream and returns
// cudaGetLastError(); it allocates nothing.
//
// Exactness.  Path counts are integer-valued floats.  While every partial
// sum stays below 2^24 each add is exact, so any summation order gives the
// bits of the TPU kernel's K-tiled MXU sum.  The sums are taken in plain
// f32 on the CUDA cores: TF32 or fp16 tensor cores keep an 11-bit
// significand, exact only up to 2048 paths.
//
// The operand is the largest input by far (n*n bytes, 4.3 GB at n =
// 65,664) and it is almost all zeros on the graphs DAWN runs: K5 and K6
// read only the 16-byte words the live-word index lists.  What bounds
// them is how much of the operand they must read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kListThreads = 256;             // K5 unreached bits, work list
constexpr int kPushThreads = 256;             // K5 push
constexpr int kEpilogueThreads = 256;         // K5 epilogue: 32 x 8
constexpr int kFusedThreads = 512;            // K6: 2 blocks per SM
constexpr int kIndexThreads = 256;            // live-word index: 8 rows

// K5 fused_counting_sweep.
// Replaces _counting_sweep_kernel of src/repro/kernels/counting/kernel.py.
// Bound: bytes — for every operand row k in any row's frontier, the 32 B
// sectors that hold a non-zero byte in a column with an unreached target,
// plus the state.  The TPU kernel multiplies whole (k-block, column-tile)
// operand tiles; at a mid-BFS state almost every k-block is live, so a
// tiled read covers most of the 4.3 GB operand at n = 65,664 while the
// useful adds (one per row and non-zero operand byte) are few.  So the
// kernel reads only the 16-byte words the live-word index lists, each once
// per group of 32 source rows, in K7's node-major design: four launches on
// the stream.
//   1. The unreached bits, node-major: bit b of unr_t[c, r] is dist[r,
//      32 c + b] < 0, from one ballot per 32 columns of a row.
//   2. The work list: one warp per 32 operand rows k (a lane each) and
//      group of 32 source rows builds each k's mask of the group's rows
//      with fsigma[r, k] > 0, and appends one item (k, a chunk of at most
//      `chunk` of row k's live words, the group, the mask) per chunk.
//   3. The push: a warp per item, one lane per source row.  The lanes load
//      the chunk's words once (16 B each) and pass them round by shuffle;
//      a lane whose row has k in its frontier reads the open bits of the
//      word's 16 columns and atomically adds fsigma[r, k] * a into the
//      candidate sum of every open column with a non-zero byte a (Thm 3.2).
//      The unreached bits and the candidates are node-major, (n, Sp) with
//      Sp = S rounded up to 32: the 32 lanes of a column touch one
//      128-byte line, so a warp's test and its adds are one L2 request
//      each instead of 32.
//   4. The epilogue: new = cand > 0 & dist < 0, dist = step and sigma =
//      cand there, through a 32 x 32 shared-memory tile that turns the
//      candidates back to the (S, n) layout.
// The kernel's own per-row tests stand in for the plain version's
// occupancy tables: a k-block with no positive fsigma (f_occ) lists no
// row, and a tile with no unreached target (o_occ) opens no column.  The
// adds sum integers below 2^24, so their order does not matter.
__global__ void __launch_bounds__(kListThreads) unreached_bits_kernel(
    const int32_t* __restrict__ dist, uint32_t* __restrict__ unr_t, int S,
    int Sp, int n) {
  const int lane = threadIdx.x & 31;
  const size_t q = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (q >= (size_t)(n >> 5) * S) return;                 // warp-uniform
  const int c = (int)(q / S), r = (int)(q % S);
  const uint32_t bits = __ballot_sync(
      0xffffffffu, __ldg(dist + (size_t)r * n + 32 * c + lane) < 0);
  if (lane == 0) unr_t[(size_t)c * Sp + r] = bits;
}

__global__ void __launch_bounds__(kListThreads) counting_items_kernel(
    const float* __restrict__ fsigma, const int32_t* __restrict__ woff,
    int4* __restrict__ items, int32_t* __restrict__ nitems, int S, int K,
    int chunk) {
  const int lane = threadIdx.x & 31;
  const int kb32 = (K + 31) >> 5;
  const int G = (S + 31) >> 5;
  const int c = blockIdx.x * (kListThreads / 32) + (threadIdx.x >> 5);
  if (c >= kb32 * G) return;                             // warp-uniform
  const int g = c / kb32;
  const int k = (c - g * kb32) * 32 + lane;
  const int rows = min(32, S - 32 * g);
  uint32_t mask = 0u;
  if (k < K)
    for (int rr = 0; rr < rows; ++rr)
      if (__ldg(fsigma + (size_t)(32 * g + rr) * K + k) > 0.f)
        mask |= 1u << rr;
  int off = 0, len = 0, nch = 0;
  if (mask) {
    off = __ldg(woff + k);
    len = __ldg(woff + k + 1) - off;
    nch = (len + chunk - 1) / chunk;
  }
  int incl = nch;                                        // warp scan
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int wsum = __shfl_sync(0xffffffffu, incl, 31);
  if (!wsum) return;                                     // warp-uniform
  int base = 0;
  if (lane == 31) base = atomicAdd(nitems, wsum);
  base = __shfl_sync(0xffffffffu, base, 31) + incl - nch;
  for (int q = 0; q < nch; ++q)
    items[base + q] = make_int4(k, off + q * chunk,
                                (g << 8) | min(chunk, len - q * chunk),
                                (int)mask);
}

__global__ void __launch_bounds__(kPushThreads) counting_push_kernel(
    const float* __restrict__ fsigma, const int8_t* __restrict__ adj,
    const int32_t* __restrict__ wlist, const uint32_t* __restrict__ unr_t,
    const int4* __restrict__ items, const int32_t* __restrict__ nitems,
    float* __restrict__ cand_t, int K, int n, int Sp) {
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int ni = *nitems;
  for (int i = gwarp; i < ni; i += nwarps) {
    const int4 it = items[i];
    const int k = it.x, len = it.z & 0xff, g = it.z >> 8;
    const int r = 32 * g + lane;
    const bool act = ((uint32_t)it.w >> lane) & 1u;
    const float fsr = act ? __ldg(fsigma + (size_t)r * K + k) : 0.f;
    int widx = 0;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (lane < len) {
      widx = __ldg(wlist + it.y + lane);
      v = __ldg(reinterpret_cast<const uint4*>(adj + (size_t)k * n) + widx);
    }
    for (int q = 0; q < len; ++q) {
      const int w = __shfl_sync(0xffffffffu, widx, q);
      const uint32_t x[4] = {__shfl_sync(0xffffffffu, v.x, q),
                             __shfl_sync(0xffffffffu, v.y, q),
                             __shfl_sync(0xffffffffu, v.z, q),
                             __shfl_sync(0xffffffffu, v.w, q)};
      if (!act) continue;
      const uint32_t open =
          (__ldg(unr_t + (size_t)(w >> 1) * Sp + r) >> ((w & 1) * 16)) &
          0xffffu;
      if (!open) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!x[e]) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int bit = e * 4 + b;
          if (!((open >> bit) & 1u)) continue;
          const float a = (float)(int8_t)((x[e] >> (8 * b)) & 0xffu);
          if (a == 0.f) continue;
          atomicAdd(cand_t + (size_t)(w * 16 + bit) * Sp + r, fsr * a);
        }
      }
    }
  }
}

// K5, fourth pass: new = cand > 0 & unreached, dist = step, sigma = cand
// there.  One block per 32 x 32 tile: the (n, Sp) candidates are read
// along S into shared memory and written out along n, both coalesced.
__global__ void __launch_bounds__(kEpilogueThreads) counting_epilogue_kernel(
    const int32_t* __restrict__ dist, const float* __restrict__ sigma,
    const float* __restrict__ cand_t, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, float* __restrict__ sigma_out, int S,
    int Sp, int n, int step) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += kEpilogueThreads / 32)
    tile[i][tx] = cand_t[(size_t)(j0 + i) * Sp + r0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += kEpilogueThreads / 32) {
    const int r = r0 + i;
    if (r >= S) break;
    const size_t idx = (size_t)r * n + j0 + tx;
    const float c = tile[tx][i];
    const int32_t d = dist[idx];
    const bool nw = c > 0.f && d < 0;
    new_out[idx] = nw ? 1 : 0;
    dist_out[idx] = nw ? step : d;
    sigma_out[idx] = nw ? c : sigma[idx];
  }
}

// The live-word index of the operand (built once per prepared graph; the
// plain version is ref.nonzero_words_ref).  One warp per operand row tests
// 32 16-byte words at a time and ballots the ones holding a non-zero
// byte.  With `offsets` null it writes each row's count into `out`; with
// the offsets (the exclusive prefix sum of those counts) it writes the
// row's live word indices, ascending, into `out` at offsets[row].  Bound:
// bytes — one read of the n*n-byte operand per pass.
__global__ void __launch_bounds__(kIndexThreads) live_words_kernel(
    const uint4* __restrict__ a, int rows, int wpr,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kIndexThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;                               // warp-uniform
  const uint4* p = a + (size_t)row * wpr;
  int pos = offsets ? offsets[row] : 0;
#pragma unroll 4
  for (int w0 = 0; w0 < wpr; w0 += 32) {
    const int w = w0 + lane;
    bool live = false;
    if (w < wpr) {
      const uint4 v = __ldg(p + w);
      live = (v.x | v.y | v.z | v.w) != 0u;
    }
    const uint32_t m = __ballot_sync(0xffffffffu, live);
    if (offsets && live) out[pos + __popc(m & ((1u << lane) - 1u))] = w;
    pos += __popc(m);
  }
  if (!offsets && lane == 0) out[row] = pos;
}

// One barrier across the whole grid of a cooperative launch (every block
// is resident).  bar[0] counts arrivals, bar[1] is the generation; the
// last block to arrive resets the count and bumps the generation.  The
// fences order each block's writes before its arrival and the waiter's
// reads after the release; data written by other blocks is read with
// ld.global.cg (L2), never through a possibly stale L1 line.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// K6 fused_counting_multisweep.
// Replaces _fused_counting_kernel of src/repro/kernels/counting/kernel.py.
// Bound: bytes — each sweep must read, for every operand row k in any
// row's frontier, the 32 B sectors that hold a non-zero byte in a column
// with an unreached target, plus the state.  The TPU design keeps the
// whole int8 operand on chip; at n = 65,664 it is 4.3 GB, against 227 KB
// of shared memory, and rmat16's operand rows hold 21 non-zero 16-byte
// words of 4,104 on average.  So the kernel reads only the words the
// live-word index lists, and reads each listed row ONCE per sweep for all
// S source rows: the launch is one cooperative grid (every block
// resident) over the whole batch, with the (dist, sigma) state, the
// candidate sums and the packed unreached set in global memory (L2) and
// three grid barriers per sweep.  Each sweep
//   1. lists the work: a warp takes 128 operand rows k (4 per lane) and
//      one group of 32 source rows, builds each k's 32-bit mask of the
//      group's frontier rows, and appends one item (k, a chunk of at most
//      `chunk` of row k's live words, the group, the mask) per chunk;
//   2. runs the items, a warp each with one lane per source row: the
//      lanes load the chunk's words once (16 B each) and pass them round
//      by shuffle; a lane whose row holds k in its frontier reads its
//      unreached bits for the word's 16 columns and atomically adds
//      sigma[r, k] * a into the candidate sum of every open column with a
//      non-zero byte a (Thm 3.2);
//   3. runs the epilogue over all rows: new = cand > 0 & unreached,
//      dist = step, sigma = cand there; writes the next frontier into the
//      other frontier buffer (double-buffered), clears the candidates and
//      the found bits, and ORs a per-sweep found flag (Fact 1).
// The atomic adds sum integers below 2^24, so their order does not matter.
// Rows evolve independently, so one tile of all S rows gives the per-tile
// accounting of any tiling (see ref.fused_counting_multisweep_ref).
__global__ void __launch_bounds__(kFusedThreads, 2) fused_counting_kernel(
    const int8_t* __restrict__ frontier, const int8_t* __restrict__ adj,
    const int32_t* __restrict__ woff, const int32_t* __restrict__ wlist,
    const int32_t* __restrict__ dist, const float* __restrict__ sigma,
    int8_t* new_out, int32_t* dist_out, float* sigma_out, int8_t* fa,
    int8_t* fb, float* cand, uint32_t* unr, int4* items, int32_t* counts,
    unsigned* bar, int32_t* prod_out, int32_t* stop_out, int S, int n,
    int chunk, int step0, int n_run) {
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const unsigned nblocks = gridDim.x;
  const int W = n >> 5;                                  // unreached words
  const int G = (S + 31) >> 5;                           // row groups
  const int kblocks = n >> 7;                            // 128 k per warp
  const size_t SW = (size_t)S * W;

  // copy the state into the outputs and pack the unreached set
  for (size_t q = gwarp; q < SW; q += nwarps) {
    const size_t idx = q * 32 + lane;
    const int32_t d = dist[idx];
    dist_out[idx] = d;
    sigma_out[idx] = sigma[idx];
    const uint32_t bits = __ballot_sync(0xffffffffu, d < 0);
    if (lane == 0) unr[q] = bits;
  }
  grid_sync(bar, nblocks);

  const int8_t* cur = frontier;
  int8_t* bufs[2] = {fa, fb};
  int wi = 0;                                            // buffer written next
  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    int32_t* nitems = counts + 2 * t;
    int32_t* found = counts + 2 * t + 1;
    // 1. list the work items of this sweep
    for (int c = gwarp; c < kblocks * G; c += nwarps) {
      const int g = c / kblocks;
      const int k0 = (c - g * kblocks) * 128 + lane * 4;
      const int rows = min(32, S - 32 * g);
      uint32_t mask[4] = {0u, 0u, 0u, 0u};
      for (int rr = 0; rr < rows; ++rr) {
        const uint32_t f4 = __ldcg(reinterpret_cast<const unsigned*>(
            cur + (size_t)(32 * g + rr) * n + k0));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((f4 >> (8 * b)) & 0xffu) mask[b] |= 1u << rr;
      }
      int off[4], len[4], nch[4], tot = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        off[b] = len[b] = nch[b] = 0;
        if (mask[b]) {
          off[b] = __ldg(woff + k0 + b);
          len[b] = __ldg(woff + k0 + b + 1) - off[b];
          nch[b] = (len[b] + chunk - 1) / chunk;
        }
        tot += nch[b];
      }
      int incl = tot;                                    // warp scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int wsum = __shfl_sync(0xffffffffu, incl, 31);
      if (!wsum) continue;                               // warp-uniform
      int base = 0;
      if (lane == 31) base = atomicAdd(nitems, wsum);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - tot;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        for (int q = 0; q < nch[b]; ++q)
          items[base++] = make_int4(k0 + b, off[b] + q * chunk,
                                    (g << 8) | min(chunk, len[b] - q * chunk),
                                    (int)mask[b]);
    }
    grid_sync(bar, nblocks);
    // 2. run the items: scatter sigma[r, k] * A[k, j] into the open columns
    const int ni = __ldcg(nitems);
    for (int i = gwarp; i < ni; i += nwarps) {
      const int4 it = __ldcg(items + i);
      const int k = it.x, len = it.z & 0xff, g = it.z >> 8;
      const int r = 32 * g + lane;
      const bool act = ((uint32_t)it.w >> lane) & 1u;
      const float fsr = act ? __ldcg(sigma_out + (size_t)r * n + k) : 0.f;
      int widx = 0;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (lane < len) {
        widx = __ldg(wlist + it.y + lane);
        v = __ldg(reinterpret_cast<const uint4*>(adj + (size_t)k * n) + widx);
      }
      const uint32_t* urow = unr + (size_t)r * W;
      float* crow = cand + (size_t)r * n;
      for (int q = 0; q < len; ++q) {
        const int w = __shfl_sync(0xffffffffu, widx, q);
        const uint32_t x[4] = {__shfl_sync(0xffffffffu, v.x, q),
                               __shfl_sync(0xffffffffu, v.y, q),
                               __shfl_sync(0xffffffffu, v.z, q),
                               __shfl_sync(0xffffffffu, v.w, q)};
        if (!act) continue;
        const uint32_t open =
            (__ldcg(urow + (w >> 1)) >> ((w & 1) * 16)) & 0xffffu;
        if (!open) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!x[e]) continue;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int bit = e * 4 + b;
            if (!((open >> bit) & 1u)) continue;
            const float a = (float)(int8_t)((x[e] >> (8 * b)) & 0xffu);
            if (a == 0.f) continue;
            atomicAdd(crow + w * 16 + bit, fsr * a);
          }
        }
      }
    }
    grid_sync(bar, nblocks);
    // 3. epilogue over all rows; Fact 1 over the grid
    const int32_t dnew = step0 + 1 + t;
    int8_t* nxt = bufs[wi];
    int mine = 0;
    for (size_t q = gwarp; q < SW; q += nwarps) {
      const size_t idx = q * 32 + lane;
      const uint32_t pend = __ldcg(unr + q);
      bool nw = false;
      if ((pend >> lane) & 1u) {
        const float c = __ldcg(cand + idx);
        if (c != 0.f) cand[idx] = 0.f;
        nw = c > 0.f;
        if (nw) {
          dist_out[idx] = dnew;
          sigma_out[idx] = c;
        }
      }
      nxt[idx] = nw ? 1 : 0;
      const uint32_t fnd = __ballot_sync(0xffffffffu, nw);
      if (fnd) {
        mine = 1;
        if (lane == 0) unr[q] = pend & ~fnd;
      }
    }
    if (__syncthreads_or(mine) && threadIdx.x == 0) atomicOr(found, 1);
    grid_sync(bar, nblocks);
    if (!__ldcg(found)) {                                // grid-uniform
      done = 1;
      break;
    }
    ++prod;
    cur = nxt;
    wi ^= 1;
  }
  // new = the last sweep's discoveries; zeros after a sweep that found
  // nothing (Fact 1) or when no sweep ran
  const bool keep = !done && n_run > 0;
  const size_t n16 = (size_t)S * n / 16;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x)
    reinterpret_cast<uint4*>(new_out)[i] =
        keep ? __ldcg(reinterpret_cast<const uint4*>(cur) + i)
             : make_uint4(0u, 0u, 0u, 0u);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    prod_out[0] = prod;
    stop_out[0] = done;
  }
}

}  // namespace

extern "C" {

// K5.  n a multiple of 32; woff / wlist: the live-word index of adj (k
// rows); `chunk` live words per work item (1..32); unr_t: (n / 32, Sp)
// uint32 scratch, Sp = S rounded up to 32; items: room for (Sp / 32) x
// (the index's work items at `chunk`) int4; nitems: one int32, zeroed;
// cand_t: (n, Sp) float32, zeroed; `blocks_per_sm` push blocks per SM.
int dawn_counting_sweep(const void* fsigma, const void* adj, const void* woff,
                        const void* wlist, const void* dist,
                        const void* sigma, void* new_out, void* dist_out,
                        void* sigma_out, void* unr_t, void* items,
                        void* nitems, void* cand_t, int S, int n, int k,
                        int chunk, int blocks_per_sm, int step,
                        void* stream) {
  if (S < 1 || k < 1 || n < 32 || n % 32 || chunk < 1 || chunk > 32 ||
      blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = (S + 31) / 32, Sp = 32 * G;
  const int per_block = kListThreads / 32;
  const size_t bit_warps = (size_t)(n / 32) * S;
  unreached_bits_kernel<<<(unsigned)((bit_warps + per_block - 1) / per_block),
                          kListThreads, 0, st>>>(
      (const int32_t*)dist, (uint32_t*)unr_t, S, Sp, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int list_warps = G * ((k + 31) / 32);
  counting_items_kernel<<<(list_warps + per_block - 1) / per_block,
                          kListThreads, 0, st>>>(
      (const float*)fsigma, (const int32_t*)woff, (int4*)items,
      (int32_t*)nitems, S, k, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  counting_push_kernel<<<sms * blocks_per_sm, kPushThreads, 0, st>>>(
      (const float*)fsigma, (const int8_t*)adj, (const int32_t*)wlist,
      (const uint32_t*)unr_t, (const int4*)items, (const int32_t*)nitems,
      (float*)cand_t, k, n, Sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  counting_epilogue_kernel<<<dim3(n / 32, G), kEpilogueThreads, 0, st>>>(
      (const int32_t*)dist, (const float*)sigma, (const float*)cand_t,
      (int8_t*)new_out, (int32_t*)dist_out, (float*)sigma_out, S, Sp, n,
      step);
  return (int)cudaGetLastError();
}

// K6.  `chunk` live words per work item (1..32); `blocks_per_sm` blocks
// of the cooperative grid per SM (capped at what the SM holds).  woff /
// wlist: the live-word index of adj; fa, fb: (S, n) int8 frontier
// buffers; cand: (S, n) float32, zeroed; unr: (S, n / 32) uint32; items:
// room for (S / 32 rounded up) x (the index's work items at `chunk`)
// int4; counts: 2 * n_run int32, zeroed; bar: 2 uint32, zeroed; prod,
// stop: one int32 each.
int dawn_fused_counting_multisweep(
    const void* frontier, const void* adj, const void* woff,
    const void* wlist, const void* dist, const void* sigma, void* new_out,
    void* dist_out, void* sigma_out, void* fa, void* fb, void* cand,
    void* unr, void* items, void* counts, void* bar, void* prod, void* stop,
    int S, int n, int chunk, int blocks_per_sm, int step0, int n_run,
    void* stream) {
  if (S < 1 || n < 128 || n % 128 || chunk < 1 || chunk > 32 ||
      blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_counting_kernel, kFusedThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int8_t* a_frontier = (const int8_t*)frontier;
  const int8_t* a_adj = (const int8_t*)adj;
  const int32_t* a_woff = (const int32_t*)woff;
  const int32_t* a_wlist = (const int32_t*)wlist;
  const int32_t* a_dist = (const int32_t*)dist;
  const float* a_sigma = (const float*)sigma;
  int8_t* a_new = (int8_t*)new_out;
  int32_t* a_dist_out = (int32_t*)dist_out;
  float* a_sigma_out = (float*)sigma_out;
  int8_t* a_fa = (int8_t*)fa;
  int8_t* a_fb = (int8_t*)fb;
  float* a_cand = (float*)cand;
  uint32_t* a_unr = (uint32_t*)unr;
  int4* a_items = (int4*)items;
  int32_t* a_counts = (int32_t*)counts;
  unsigned* a_bar = (unsigned*)bar;
  int32_t* a_prod = (int32_t*)prod;
  int32_t* a_stop = (int32_t*)stop;
  void* args[] = {&a_frontier, &a_adj, &a_woff, &a_wlist, &a_dist,
                  &a_sigma, &a_new, &a_dist_out, &a_sigma_out, &a_fa, &a_fb,
                  &a_cand, &a_unr, &a_items, &a_counts, &a_bar, &a_prod,
                  &a_stop, &S, &n, &chunk, &step0, &n_run};
  const int blocks = sms * (per_sm < blocks_per_sm ? per_sm : blocks_per_sm);
  err = cudaLaunchCooperativeKernel((const void*)fused_counting_kernel,
                                    dim3(blocks), dim3(kFusedThreads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The live-word index of a (rows, n) int8 operand.  Count pass (offsets
// null): out (rows,) int32 live words per row.  Fill pass: offsets
// (rows + 1,) int32, out the (offsets[rows],) int32 word list.
int dawn_counting_live_words(const void* adj, const void* offsets, void* out,
                             int rows, int n, void* stream) {
  if (rows < 0 || n < 16 || n % 16) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int per_block = kIndexThreads / 32;
  live_words_kernel<<<(rows + per_block - 1) / per_block, kIndexThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)adj, rows, n / 16, (const int32_t*)offsets,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
