// Hand-written Hopper (sm_90a) kernels for the tropical (min,+) sweep, the
// weighted engine's hot path.
//
// Three kernels, one per Pallas kernel of src/repro/kernels/tropical/kernel.py,
// the builder of the dense operand's live-word index that K7 and K8 read,
// and the builder of the in-lane index that K9 reads.
// The state is dist (S, n) float32 with +inf for "no path yet"; the dense
// operand is W (k, n) float32 with +inf for a non-edge, row k = the
// out-edges of k; the sparse operand is the CSR lane arrays, which K9
// reads through their CSC, the in-lane index.  Every entry
// point is a plain C function that launches on the given stream and returns
// cudaGetLastError(); it allocates nothing.
//
// Exactness.  A candidate is ONE float32 add, dist[s, k] + W[k, j], taken
// with __fadd_rn (round to nearest, never contracted, no flush to zero),
// and the reduction is a min, which is exact and order-free.  So whatever
// order the k are visited in, the bits equal the TPU kernel's and the plain
// versions'.  Weights are >= 0 and the state holds no NaN and no -inf, so a
// candidate is +0.0 or larger and +inf absorbs: x + inf = inf.
//
// Hopper has no tensor-core (min,+), so all three kernels run on the CUDA
// cores.  The dense operand is almost all +inf on the graphs DAWN runs
// (1.82 M edges in 65,664^2 on rmat16), so what bounds them is how much of
// the operand they must read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kListThreads = 256;             // K7 work list
constexpr int kPushThreads = 256;             // K7 push
constexpr int kEpilogueThreads = 256;         // K7 epilogue: 32 x 8
constexpr int kIndexThreads = 256;            // live-word index: 8 rows
constexpr int kFusedThreads = 256;            // K8: 8 warps
constexpr int kRelaxEntryThreads = 256;       // K9 entry: 8 warps
constexpr int kGatherThreads = 512;           // K9 gather: 16 warps
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kRelaxGroups = 4;               // K9: row groups per warp
constexpr int kInLaneThreads = 256;           // K9's in-lane index
constexpr int32_t kInfBits = 0x7f800000;      // +inf as int32

__device__ __forceinline__ float inf_f() { return __int_as_float(kInfBits); }

// torch.isfinite: false for +-inf and NaN (exponent bits all set)
__device__ __forceinline__ bool finite_f(float x) {
  return (__float_as_int(x) & kInfBits) != kInfBits;
}

// The live-word index of the dense operand (built once per prepared
// graph; the plain version is ref.finite_words_ref).  One warp per operand
// row tests 32 16-byte words (4 weights each) at a time and ballots the
// ones holding a finite weight.  With `offsets` null it writes each row's
// count into `out`; with the offsets (the exclusive prefix sum of those
// counts) it writes the row's live word indices, ascending, into `out` at
// offsets[row].  Bound: bytes — one read of the 4 n^2-byte operand per
// pass (17.2 GB at n = 65,664).
__global__ void __launch_bounds__(kIndexThreads) live_words_kernel(
    const float4* __restrict__ w, int rows, int wpr,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kIndexThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;                               // warp-uniform
  const float4* p = w + (size_t)row * wpr;
  int pos = offsets ? offsets[row] : 0;
#pragma unroll 4
  for (int w0 = 0; w0 < wpr; w0 += 32) {
    const int q = w0 + lane;
    bool live = false;
    if (q < wpr) {
      const float4 v = __ldg(p + q);
      live = finite_f(v.x) || finite_f(v.y) || finite_f(v.z) ||
             finite_f(v.w);
    }
    const uint32_t m = __ballot_sync(0xffffffffu, live);
    if (offsets && live) out[pos + __popc(m & ((1u << lane) - 1u))] = q;
    pos += __popc(m);
  }
  if (!offsets && lane == 0) out[row] = pos;
}

// K7 fused_minplus_sweep.
// Replaces _minplus_sweep_kernel of src/repro/kernels/tropical/kernel.py.
// Bound: bytes — for every operand row k where some row's frontier holds a
// finite distance, the 32 B sectors of row k that hold a finite weight,
// plus the state.  The operand is float32 with +inf non-edges, 17.2 GB at
// n = 65,664, and rmat16's rows hold 25 finite 16-byte words of 16,416 on
// average; the useful work (one add and one min per row and finite
// weight) is tiny beside a dense read.  Design: three launches on the
// stream.
//   1. The work list: one warp per 32 operand rows k (a lane each) and
//      group of 32 source rows builds each k's mask of the group's rows
//      with a finite frontier distance (and a live f_occ k-block), and
//      appends one item (k, a chunk of at most `chunk` of row k's live
//      words from the live-word index, the group, the mask) per chunk.
//   2. The push: a warp per item, one lane per source row.  The lanes load
//      the chunk's words once (16 B each, every one holding a finite
//      weight) and pass them round by shuffle; a lane whose row has k in
//      its frontier skips a settled output tile (o_occ), and for each
//      finite weight takes the candidate dist[r, k] + W[k, j] (one
//      __fadd_rn) and atomically mins it into the candidate buffer where
//      it beats dist[r, j] (int32 atomicMin on the float bits:
//      order-preserving for +0.0 .. +inf).  Each listed operand word is
//      read once per group of 32 rows, not once per row tile and column
//      block.  The state it compares with and the candidates are
//      node-major, (n, S): the 32 lanes of a column touch one 128-byte
//      line, so a warp's load and its atomics are one L2 request each
//      instead of 32.
//   3. The epilogue: new = cand < dist, dist = cand there, through a
//      32 x 32 shared-memory tile that turns the candidates back to the
//      (S, n) layout.
// A skipped k-block or output tile contributes nothing, as in the plain
// version's expanded tables; min is exact and order-free, so the bits are
// the plain version's in any order.
__global__ void __launch_bounds__(kListThreads) minplus_items_kernel(
    const float* __restrict__ fdist, const int32_t* __restrict__ woff,
    const uint8_t* __restrict__ f_occ, int4* __restrict__ items,
    int32_t* __restrict__ nitems, int S, int K, int bs, int bk,
    int chunk) {
  const int lane = threadIdx.x & 31;
  const int kb32 = (K + 31) >> 5;
  const int G = (S + 31) >> 5;
  const int c = blockIdx.x * (kListThreads / 32) + (threadIdx.x >> 5);
  if (c >= kb32 * G) return;                             // warp-uniform
  const int g = c / kb32;
  const int k = (c - g * kb32) * 32 + lane;
  const int rows = min(32, S - 32 * g);
  const int gk = K / bk;
  uint32_t mask = 0u;
  if (k < K) {
    for (int rr = 0; rr < rows; ++rr) {
      const int r = 32 * g + rr;
      if (finite_f(__ldg(fdist + (size_t)r * K + k)) &&
          __ldg(f_occ + (size_t)(r / bs) * gk + k / bk))
        mask |= 1u << rr;
    }
  }
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

__global__ void __launch_bounds__(kPushThreads) minplus_push_kernel(
    const float* __restrict__ fdist, const float* __restrict__ w,
    const int32_t* __restrict__ wlist, const float* __restrict__ dist_t,
    const uint8_t* __restrict__ o_occ, const int4* __restrict__ items,
    const int32_t* __restrict__ nitems, int32_t* __restrict__ cand_t,
    int S, int K, int n, int bs, int bn) {
  const float inf = inf_f();
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int gj = n / bn;
  const int ni = *nitems;
  for (int i = gwarp; i < ni; i += nwarps) {
    const int4 it = items[i];
    const int k = it.x, len = it.z & 0xff, g = it.z >> 8;
    const int r = 32 * g + lane;
    const bool act = ((uint32_t)it.w >> lane) & 1u;
    const float fd = act ? __ldg(fdist + (size_t)r * K + k) : inf;
    int widx = 0;
    float4 v = make_float4(inf, inf, inf, inf);
    if (lane < len) {
      widx = __ldg(wlist + it.y + lane);
      v = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * n) + widx);
    }
    for (int q = 0; q < len; ++q) {
      const int j0 = 4 * __shfl_sync(0xffffffffu, widx, q);
      const float wv[4] = {__shfl_sync(0xffffffffu, v.x, q),
                           __shfl_sync(0xffffffffu, v.y, q),
                           __shfl_sync(0xffffffffu, v.z, q),
                           __shfl_sync(0xffffffffu, v.w, q)};
      if (!act || !__ldg(o_occ + (size_t)(r / bs) * gj + j0 / bn)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (wv[e] == inf) continue;
        const size_t idx = (size_t)(j0 + e) * S + r;
        const float c = __fadd_rn(fd, wv[e]);
        if (c < __ldg(dist_t + idx))
          atomicMin(cand_t + idx, __float_as_int(c));
      }
    }
  }
}

// K7, third pass: new = cand < dist, dist = cand there.  One block per
// 32 x 32 tile: the (n, S) candidates are read along S into shared
// memory and written out along n, both coalesced.
__global__ void __launch_bounds__(kEpilogueThreads) minplus_epilogue_kernel(
    const float* __restrict__ dist, const int32_t* __restrict__ cand_t,
    int8_t* __restrict__ new_out, float* __restrict__ dist_out, int S,
    int n) {
  __shared__ int32_t tile[32][33];
  const int j0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += kEpilogueThreads / 32) {
    const int r = r0 + tx;
    tile[i][tx] = r < S ? cand_t[(size_t)(j0 + i) * S + r] : kInfBits;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += kEpilogueThreads / 32) {
    const int r = r0 + i;
    if (r >= S) break;
    const size_t idx = (size_t)r * n + j0 + tx;
    const float a = __int_as_float(tile[tx][i]);
    const float d = dist[idx];
    const bool nw = a < d;
    new_out[idx] = nw ? 1 : 0;
    dist_out[idx] = nw ? a : d;
  }
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

// K8 fused_minplus_multisweep.
// Replaces _fused_minplus_kernel of src/repro/kernels/tropical/kernel.py.
// Bound: bytes — each sweep must read, for every operand row k where some
// row's frontier holds a finite distance, the 32 B sectors of row k that
// hold a finite weight, plus the state.  The TPU design keeps the whole
// (n, n) float32 operand on chip; at n = 65,664 it is 17.2 GB, against
// 227 KB of shared memory, and rmat16's rows hold 25 finite 16-byte words
// of 16,416 on average.  So the kernel runs K7's push inside one
// cooperative grid over the whole batch (every block resident): it reads
// only the words the live-word index lists, each ONCE per sweep for every
// group of 32 source rows, and keeps the state node-major in global memory
// (L2) between three grid barriers per sweep.
//   Entry: dist is transposed to node-major (n, Sp) through a 32 x 32
//      shared-memory tile (Sp = S rounded up to 32, the dead lanes +inf),
//      the frontier becomes one 32-bit row mask per (group, node) (a
//      frontier entry at +inf relaxes nothing, so it is dropped), and the
//      candidates are set to +inf.
//   Each sweep
//   1. lists the work: a warp takes 32 operand rows k (a lane each) of one
//      group of 32 source rows, reads each k's row mask and appends one
//      item (k, a chunk of at most `chunk` of row k's live words, the
//      group, the mask) per chunk; RMAT's hub rows become many chunks on
//      many warps;
//   2. runs the items, a warp each with one lane per source row: the
//      lanes load the chunk's words once (16 B each, every one holding a
//      finite weight) and pass them round by shuffle; a lane whose row
//      holds k in its frontier takes the candidate dist[r, k] + W[k, j]
//      (one __fadd_rn) for each finite weight and atomically mins it into
//      the candidates where it beats dist[r, j] (int32 atomicMin on the
//      float bits: order-preserving for +0.0 .. +inf).  The 32 lanes of a
//      column touch one 128-byte line, so a warp's compare and its atomics
//      are one L2 request each;
//   3. runs the epilogue over the node-major state, a warp per (node,
//      group): new = cand < dist, dist = cand there, the candidate reset
//      to +inf, the next row mask by ballot, and a per-sweep found flag
//      ORed over the grid (Fact 1).
//   Exit: dist back to (S, n) through the tile, and new from the last row
//      masks (zeros after a sweep that found nothing, or when none ran).
// Min is exact and order-free, so the bits equal the plain version's in
// any visiting order.  Rows evolve independently, so one tile of all S
// rows gives the per-tile accounting of any tiling (see
// ref.fused_minplus_multisweep_ref).
__global__ void __launch_bounds__(kFusedThreads, 4) fused_minplus_kernel(
    const int8_t* __restrict__ frontier, const float* __restrict__ w,
    const int32_t* __restrict__ woff, const int32_t* __restrict__ wlist,
    const float* __restrict__ dist, int8_t* __restrict__ new_out,
    float* __restrict__ dist_out, float* dist_t, int32_t* cand_t,
    uint32_t* fmask, int4* items, int32_t* counts, unsigned* bar,
    int32_t* prod_out, int32_t* stop_out, int S, int n, int chunk,
    int n_run) {
  __shared__ float tile[32][33];
  __shared__ uint32_t rows[32];
  const float inf = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bwarps = kFusedThreads / 32;
  const int gwarp = (blockIdx.x * blockDim.x + tid) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const unsigned nblocks = gridDim.x;
  const int G = (S + 31) >> 5;                           // row groups
  const int Sp = G << 5;
  const int nt = n >> 5;                                 // 32-node tiles

  // entry: node-major dist, row masks of the finite frontier, +inf cands
  for (int t = blockIdx.x; t < nt * G; t += gridDim.x) {
    const int g = t / nt, j0 = (t - g * nt) << 5;
    for (int i = warp; i < 32; i += bwarps) {
      const int r = 32 * g + i;
      float d = inf;
      bool live = false;
      if (r < S) {
        const size_t idx = (size_t)r * n + j0 + lane;
        d = dist[idx];
        live = frontier[idx] != 0 && finite_f(d);
      }
      tile[i][lane] = d;
      const uint32_t m = __ballot_sync(0xffffffffu, live);  // over nodes
      if (lane == 0) rows[i] = m;
    }
    __syncthreads();
    for (int i = warp; i < 32; i += bwarps) {
      const int j = j0 + i;
      const size_t idx = (size_t)j * Sp + 32 * g + lane;
      dist_t[idx] = tile[lane][i];
      cand_t[idx] = kInfBits;
      const uint32_t m = __ballot_sync(0xffffffffu, (rows[lane] >> i) & 1u);
      if (lane == 0) fmask[(size_t)g * n + j] = m;
    }
    __syncthreads();
  }
  grid_sync(bar, nblocks);

  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    int32_t* nitems = counts + 2 * t;
    int32_t* found = counts + 2 * t + 1;
    // 1. list the work items of this sweep
    for (int c = gwarp; c < nt * G; c += nwarps) {
      const int g = c / nt;
      const int k = (c - g * nt) * 32 + lane;
      const uint32_t mask = __ldcg(fmask + (size_t)g * n + k);
      int off = 0, len = 0, nch = 0;
      if (mask) {
        off = __ldg(woff + k);
        len = __ldg(woff + k + 1) - off;
        nch = (len + chunk - 1) / chunk;
      }
      int incl = nch;                                    // warp scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int wsum = __shfl_sync(0xffffffffu, incl, 31);
      if (!wsum) continue;                               // warp-uniform
      int base = 0;
      if (lane == 31) base = atomicAdd(nitems, wsum);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - nch;
      for (int q = 0; q < nch; ++q)
        items[base + q] = make_int4(k, off + q * chunk,
                                    (g << 8) | min(chunk, len - q * chunk),
                                    (int)mask);
    }
    grid_sync(bar, nblocks);
    // 2. run the items: min dist[r, k] + W[k, j] into the candidates
    const int ni = __ldcg(nitems);
    for (int i = gwarp; i < ni; i += nwarps) {
      const int4 it = __ldcg(items + i);
      const int k = it.x, len = it.z & 0xff, g = it.z >> 8;
      const int r = 32 * g + lane;
      const bool act = ((uint32_t)it.w >> lane) & 1u;
      const float fd = act ? __ldcg(dist_t + (size_t)k * Sp + r) : inf;
      int widx = 0;
      float4 v = make_float4(inf, inf, inf, inf);
      if (lane < len) {
        widx = __ldg(wlist + it.y + lane);
        v = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * n) + widx);
      }
      for (int q = 0; q < len; ++q) {
        const int j0 = 4 * __shfl_sync(0xffffffffu, widx, q);
        const float wv[4] = {__shfl_sync(0xffffffffu, v.x, q),
                             __shfl_sync(0xffffffffu, v.y, q),
                             __shfl_sync(0xffffffffu, v.z, q),
                             __shfl_sync(0xffffffffu, v.w, q)};
        if (!act) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (wv[e] == inf) continue;
          const size_t idx = (size_t)(j0 + e) * Sp + r;
          const float c = __fadd_rn(fd, wv[e]);
          if (c < __ldcg(dist_t + idx))
            atomicMin(cand_t + idx, __float_as_int(c));
        }
      }
    }
    grid_sync(bar, nblocks);
    // 3. epilogue over the node-major state; Fact 1 over the grid
    int mine = 0;
    for (size_t q = gwarp; q < (size_t)n * G; q += nwarps) {
      const size_t idx = q * 32 + lane;                  // node q / G
      const int32_t cb = __ldcg(cand_t + idx);
      bool nw = false;
      if (cb != kInfBits) {
        cand_t[idx] = kInfBits;
        const float c = __int_as_float(cb);
        if (c < __ldcg(dist_t + idx)) {
          dist_t[idx] = c;
          nw = true;
        }
      }
      const uint32_t m = __ballot_sync(0xffffffffu, nw);
      if (lane == 0) fmask[(q % G) * n + q / G] = m;
      mine |= m != 0u;
    }
    if (__syncthreads_or(mine) && tid == 0) atomicOr(found, 1);
    grid_sync(bar, nblocks);
    if (!__ldcg(found)) {                                // grid-uniform
      done = 1;
      break;
    }
    ++prod;
  }
  // exit: dist back to (S, n); new = the last sweep's row masks, zeros
  // after a sweep that found nothing (they are) or when no sweep ran
  for (int t = blockIdx.x; t < nt * G; t += gridDim.x) {
    const int g = t / nt, j0 = (t - g * nt) << 5;
    for (int i = warp; i < 32; i += bwarps) {
      const int j = j0 + i;
      tile[i][lane] = __ldcg(dist_t + (size_t)j * Sp + 32 * g + lane);
      if (lane == 0)
        rows[i] = n_run > 0 ? __ldcg(fmask + (size_t)g * n + j) : 0u;
    }
    __syncthreads();
    for (int i = warp; i < 32; i += bwarps) {
      const int r = 32 * g + i;
      if (r >= S) break;                                 // warp-uniform
      const size_t idx = (size_t)r * n + j0 + lane;
      dist_out[idx] = tile[lane][i];
      new_out[idx] = (int8_t)((rows[lane] >> i) & 1u);
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) {
    prod_out[0] = prod;
    stop_out[0] = done;
  }
}

// K9's in-lane index (built once per prepared weighted graph; the plain
// version is ref.in_lanes_ref): the CSC of the weighted CSR lanes.  One
// thread per lane, grid-stride.  Count pass (fill = 0): counts[dst] += 1
// for every lane with a weight below +inf (a padded lane is +inf and
// relaxes nothing), counts[n] += 1 for such a lane whose source or target
// lies outside [0, n).  Fill pass (fill = 1): `cur` holds each target's
// first slot (the prefix sum of the counts); the lane takes the next slot
// of its target by atomicAdd and writes its source and weight there.  The
// order within a target is the order the atomics land in, which the
// gather does not depend on (min is order-free).  Bound: bytes — the
// lanes once per pass, the index written once.
__global__ void __launch_bounds__(kInLaneThreads) in_lanes_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ w, int m, int n, int32_t* __restrict__ cur,
    int32_t* __restrict__ out_src, float* __restrict__ out_w, int fill) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < m;
       e += gridDim.x * blockDim.x) {
    const float we = w[e];
    if (!(we < inf_f())) continue;                       // padded lane
    const int s = src[e], j = dst[e];
    if ((unsigned)s >= (unsigned)n || (unsigned)j >= (unsigned)n) {
      if (!fill) atomicAdd(cur + n, 1);
      continue;
    }
    if (!fill) {
      atomicAdd(cur + j, 1);
    } else {
      const int p = atomicAdd(cur + j, 1);
      out_src[p] = s;
      out_w[p] = we;
    }
  }
}

// K9 sparse_relax_sweep, entry pass.
// Replaces _sparse_relax_kernel of src/repro/kernels/tropical/kernel.py
// (with the hub and gather passes below; the bound and the design are
// given at the gather).
// The frontier-masked distances go node-major: fd_t[u, r] = dist[r, u]
// where frontier[r, u] != 0 and the distance is finite, else +inf, in an
// (n, Sp) array (Sp = S rounded up to 32, the dead lanes +inf), through a
// 32 x 128 shared-memory tile (a lane reads 4 nodes of a row: 16 bytes of
// dist, 4 of the frontier); and one bit per (group of 32 rows, node), set
// where any row of the group holds the node in its frontier at a finite
// distance, packed 32 nodes a word: fbits (G, n / 32).  A frontier entry
// at +inf relaxes nothing (inf + w = inf), so dropping it changes no bit
// of the result.  The line of a node whose bit is clear is not written:
// the gather reads only lines whose bit is set.  One block per (128 nodes,
// row group).
__global__ void __launch_bounds__(kRelaxEntryThreads) relax_entry_kernel(
    const int8_t* __restrict__ frontier, const float* __restrict__ dist,
    float* __restrict__ fd_t, uint32_t* __restrict__ fbits, int S, int n) {
  constexpr int kNodes = 128;                   // 4 nodes a lane
  constexpr int kWarps = kRelaxEntryThreads / 32;
  __shared__ float tile[32][kNodes + 1];
  __shared__ uint32_t half[2 * kWarps];         // 16 nodes' bits a warp
  const float inf = inf_f();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kNodes, g = blockIdx.y;
  const int Sp = gridDim.y * 32;
  const bool in = j0 + 4 * lane < n;
#pragma unroll
  for (int i = warp; i < 32; i += kWarps) {
    const int r = 32 * g + i;
    float4 d4 = make_float4(inf, inf, inf, inf);
    char4 f4 = make_char4(0, 0, 0, 0);
    if (r < S && in) {
      const size_t idx = (size_t)r * n + j0 + 4 * lane;
      d4 = *reinterpret_cast<const float4*>(dist + idx);
      f4 = *reinterpret_cast<const char4*>(frontier + idx);
    }
    tile[i][4 * lane] = f4.x && finite_f(d4.x) ? d4.x : inf;
    tile[i][4 * lane + 1] = f4.y && finite_f(d4.y) ? d4.y : inf;
    tile[i][4 * lane + 2] = f4.z && finite_f(d4.z) ? d4.z : inf;
    tile[i][4 * lane + 3] = f4.w && finite_f(d4.w) ? d4.w : inf;
  }
  __syncthreads();
  // each warp writes 16 consecutive nodes' lines; a live entry is finite
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < kNodes / kWarps; ++k) {
    const int jj = warp * (kNodes / kWarps) + k;
    const float v = tile[lane][jj];
    const bool any = __any_sync(0xffffffffu, finite_f(v));
    if (any) {                                           // warp-uniform
      fd_t[(size_t)(j0 + jj) * Sp + 32 * g + lane] = v;
      bits |= 1u << k;
    }
  }
  if (lane == 0) half[warp] = bits;
  __syncthreads();
  if (threadIdx.x < kNodes / 32 && j0 + 32 * (int)threadIdx.x < n)
    fbits[(size_t)g * (n >> 5) + (j0 >> 5) + threadIdx.x] =
        half[2 * threadIdx.x] | (half[2 * threadIdx.x + 1] << 16);
}

// One warp's walk over the in-lanes lo .. hi of one target, for up to
// kRelaxGroups row groups g0 .. g0 + gn - 1 (each a lane per row): a[gg] =
// the min over the lanes of fd_t[src, row] + w.  Each chunk of 32 lanes is
// loaded once for all the groups (coalesced), the next chunk while this
// one is walked; a lane whose source has no row of any of the groups in
// its frontier (fbits) is dropped, the rest are compacted into the warp's
// stage with their groups' bits, and their fd_t lines (one 128-byte line
// per group: its 32 rows of one source) are loaded two lanes at a time,
// up to 2 * kRelaxGroups lines in flight.
__device__ __forceinline__ void relax_walk(
    int lo, int hi, const int32_t* __restrict__ isrc,
    const float* __restrict__ iw, const uint32_t* __restrict__ fbits,
    const float* __restrict__ fd_t, int g0, int gn, int Sp, int nw,
    int2* stage, int lane, float (&a)[kRelaxGroups]) {
  const float inf = inf_f();
  int s_next = 0;
  float w_next = inf;
  if (lo + lane < hi) {
    s_next = __ldg(isrc + lo + lane);
    w_next = __ldg(iw + lo + lane);
  }
  for (int base = lo; base < hi; base += 32) {          // warp-uniform
    const int s = s_next;
    const float w = w_next;
    const bool in = base + lane < hi;
    if (base + 32 + lane < hi) {
      s_next = __ldg(isrc + base + 32 + lane);
      w_next = __ldg(iw + base + 32 + lane);
    }
    uint32_t gm = 0u;                           // groups with s active
#pragma unroll
    for (int gg = 0; gg < kRelaxGroups; ++gg)
      if (in && gg < gn &&
          ((__ldg(fbits + (size_t)(g0 + gg) * nw + (s >> 5)) >> (s & 31)) &
           1u))
        gm |= 1u << gg;
    const uint32_t m = __ballot_sync(0xffffffffu, gm != 0u);
    if (!m) continue;                                    // warp-uniform
    if (gm)
      stage[__popc(m & ((1u << lane) - 1u))] =
          make_int2((s << kRelaxGroups) | (int)gm, __float_as_int(w));
    __syncwarp();
    const int cnt = __popc(m);
    for (int p = 0; p < cnt; p += 2) {
      float d[2][kRelaxGroups];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int2 sw = p + k < cnt ? stage[p + k] : make_int2(0, 0);
        const float* line = fd_t + (size_t)(sw.x >> kRelaxGroups) * Sp +
                            32 * g0 + lane;
#pragma unroll
        for (int gg = 0; gg < kRelaxGroups; ++gg)
          d[k][gg] = (sw.x >> gg) & 1 ? __ldg(line + 32 * gg) : inf;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float wk =
            p + k < cnt ? __int_as_float(stage[p + k].y) : inf;
#pragma unroll
        for (int gg = 0; gg < kRelaxGroups; ++gg) {
          const float c = __fadd_rn(d[k][gg], wk);
          a[gg] = c < a[gg] ? c : a[gg];
        }
      }
    }
    __syncwarp();
  }
}

// K9, hub pass (launched only where the index lists pieces): a target with
// more than the index's `hub` in-lanes (RMAT's hubs: up to 9,729 in-lanes,
// 59,247 in rmat16's lowest 32 ids) is cut into pieces of `hub` lanes,
// listed once per prepared graph in the in-lane index, and every piece is
// walked by a warp of its own anywhere on the card, for up to kRelaxGroups
// row groups; its partial mins go to hpart (P, Sp).  One warp walking a
// whole hub, or one block walking a tile of hubs, would be the launch's
// critical path.
__global__ void __launch_bounds__(kGatherThreads, 4) relax_pieces_kernel(
    const float* __restrict__ fd_t, const uint32_t* __restrict__ fbits,
    const int32_t* __restrict__ isrc, const float* __restrict__ iw,
    const int2* __restrict__ pieces, float* __restrict__ hpart, int P, int S,
    int n) {
  __shared__ int2 stage[kGatherWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kGatherWarps + warp;
  if (p >= P) return;                                    // warp-uniform
  const int G = (S + 31) >> 5, Sp = G << 5;
  const int g0 = blockIdx.y * kRelaxGroups, gn = min(kRelaxGroups, G - g0);
  const int2 pc = __ldg(pieces + p);
  float a[kRelaxGroups];
#pragma unroll
  for (int gg = 0; gg < kRelaxGroups; ++gg) a[gg] = inf_f();
  relax_walk(pc.x, pc.y, isrc, iw, fbits, fd_t, g0, gn, Sp, n >> 5,
             stage[warp], lane, a);
#pragma unroll
  for (int gg = 0; gg < kRelaxGroups; ++gg)
    if (gg < gn) hpart[(size_t)p * Sp + 32 * (g0 + gg) + lane] = a[gg];
}

// K9 sparse_relax_sweep, gather pass.
// Bound: bytes — the state once (frontier and dist in, new and dist out)
// and the lanes of the sources in any row's frontier; an add and a min
// per (row, lane) with an active source.  The TPU kernel scatters every
// lane's candidate into a whole-state accumulator.  A scatter on this card
// costs one L2 request per (lane, row): a 32-byte sector of dist at a
// random column, and an atomic where the candidate wins (rmat16's state
// after 2 sweeps of 128 rows: 148 M pairs, 43 M wins).  A gather over
// each target's in-lanes instead reads one 128-byte fd_t line per
// (in-lane, group of 32 rows) whose source is active (7.2 M there), takes
// the min in a register, and writes each (target, row) once: no atomics,
// no accumulator to fill, no transpose of candidates.
// One block per (tile of 32 targets, up to kRelaxGroups row groups), a
// lane per row.  A warp walks each target of at most `hub` in-lanes for
// all the block's groups at once (its lanes, offsets and frontier bits
// loaded once); for a hub it takes the min of the hub pass's partials
// (hub_first[t] .. hub_first[t + 1] in hpart).  The block then holds the
// mins in shared memory, compares them with dist (copied into shared
// memory by cp.async while the warps walk) and writes new and dist_out
// row-major (32 targets of a row, coalesced).  Min is exact and
// order-free, so the bits equal the plain version's in any order of the
// lanes.
__global__ void __launch_bounds__(kGatherThreads, 3) relax_gather_kernel(
    const float* __restrict__ fd_t, const uint32_t* __restrict__ fbits,
    const int32_t* __restrict__ off, const int32_t* __restrict__ isrc,
    const float* __restrict__ iw, const int32_t* __restrict__ hub_first,
    const float* __restrict__ hpart, const float* __restrict__ dist,
    int8_t* __restrict__ new_out, float* __restrict__ dist_out, int S,
    int n) {
  __shared__ float acc[kRelaxGroups][32][33];   // [group][target][row]
  __shared__ __align__(16) float dbuf[kRelaxGroups * 32][32];  // [row][t]
  __shared__ int2 stage[kGatherWarps][32];
  const float inf = inf_f();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32;
  const int G = (S + 31) >> 5, Sp = G << 5;
  const int g0 = blockIdx.y * kRelaxGroups, gn = min(kRelaxGroups, G - g0);
  const int rows = min(32 * gn, S - 32 * g0);
  // the epilogue's dist rows, copied into shared memory while the warps
  // walk (cp.async: no register waits on them)
  for (int q = threadIdx.x; q < rows * 8; q += kGatherThreads) {
    const int i = q >> 3, c = (q & 7) * 4;
    const float* src = dist + (size_t)(32 * g0 + i) * n + j0 + c;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&dbuf[i][c]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the tile's offsets and first pieces, a target per lane
  const int lo_t = __ldg(off + j0 + lane), hi_t = __ldg(off + j0 + lane + 1);
  const int pf_t = __ldg(hub_first + j0 + lane);
  const int pl_t = __ldg(hub_first + j0 + lane + 1);
  for (int t = warp; t < 32; t += kGatherWarps) {
    const int p0 = __shfl_sync(0xffffffffu, pf_t, t);
    const int p1 = __shfl_sync(0xffffffffu, pl_t, t);
    float a[kRelaxGroups];
#pragma unroll
    for (int gg = 0; gg < kRelaxGroups; ++gg) a[gg] = inf;
    if (p0 == p1) {                                      // warp-uniform
      relax_walk(__shfl_sync(0xffffffffu, lo_t, t),
                 __shfl_sync(0xffffffffu, hi_t, t), isrc, iw, fbits, fd_t,
                 g0, gn, Sp, n >> 5, stage[warp], lane, a);
    } else {
      const float* hp = hpart + 32 * g0 + lane;
      for (int p = p0; p < p1; p += 2) {                 // 2 pieces at once
        float b[2][kRelaxGroups];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int gg = 0; gg < kRelaxGroups; ++gg)
            b[k][gg] = p + k < p1 && gg < gn
                           ? __ldg(hp + (size_t)(p + k) * Sp + 32 * gg)
                           : inf;
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int gg = 0; gg < kRelaxGroups; ++gg)
            a[gg] = b[k][gg] < a[gg] ? b[k][gg] : a[gg];
      }
    }
#pragma unroll
    for (int gg = 0; gg < kRelaxGroups; ++gg) acc[gg][t][lane] = a[gg];
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // new = acc < dist, dist = acc there; row i of the block, target lane
  for (int i = warp; i < rows; i += kGatherWarps) {
    const size_t idx = (size_t)(32 * g0 + i) * n + j0 + lane;
    const float a = acc[i >> 5][lane][i & 31];
    const float d = dbuf[i][lane];
    const bool nw = a < d;
    new_out[idx] = nw ? 1 : 0;
    dist_out[idx] = nw ? a : d;
  }
}

}  // namespace

extern "C" {

// K7.  bn a multiple of 128, bk of 8; dist (S, n) and dist_t, its
// (n, S) transpose; f_occ (S/bs, k/bk) and o_occ (S/bs, n/bn) one byte
// per tile; woff / wlist: the live-word index of w; `chunk` live words
// per work item (1..32); items: room for (S / 32 rounded up) x (the
// index's work items at `chunk`) int4; nitems: one int32, zeroed;
// cand_t: (n, S) int32 holding the bits of +inf; `blocks_per_sm` push
// blocks per SM.
int dawn_minplus_sweep(const void* fdist, const void* w, const void* woff,
                       const void* wlist, const void* dist,
                       const void* dist_t, void* new_out, void* dist_out,
                       const void* f_occ, const void* o_occ, void* items,
                       void* nitems, void* cand_t, int S, int n, int k,
                       int bs, int bn, int bk, int chunk, int blocks_per_sm,
                       void* stream) {
  if (S < 1 || k < 1 || n < 128 || bn % 128 || n % bn || bk % 8 || k % bk ||
      S % bs || chunk < 1 || chunk > 32 || blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int warps = ((S + 31) / 32) * ((k + 31) / 32);
  const int per_block = kListThreads / 32;
  minplus_items_kernel<<<(warps + per_block - 1) / per_block, kListThreads,
                         0, st>>>(
      (const float*)fdist, (const int32_t*)woff, (const uint8_t*)f_occ,
      (int4*)items, (int32_t*)nitems, S, k, bs, bk, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  minplus_push_kernel<<<sms * blocks_per_sm, kPushThreads, 0, st>>>(
      (const float*)fdist, (const float*)w, (const int32_t*)wlist,
      (const float*)dist_t, (const uint8_t*)o_occ, (const int4*)items,
      (const int32_t*)nitems, (int32_t*)cand_t, S, k, n, bs, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  minplus_epilogue_kernel<<<dim3(n / 32, (S + 31) / 32), kEpilogueThreads,
                            0, st>>>(
      (const float*)dist, (const int32_t*)cand_t, (int8_t*)new_out,
      (float*)dist_out, S, n);
  return (int)cudaGetLastError();
}

// The live-word index of a (rows, n) float32 operand.  Count pass
// (offsets null): out (rows,) int32 live words per row.  Fill pass:
// offsets (rows + 1,) int32, out the (offsets[rows],) int32 word list.
int dawn_tropical_live_words(const void* w, const void* offsets, void* out,
                             int rows, int n, void* stream) {
  if (rows < 0 || n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int per_block = kIndexThreads / 32;
  live_words_kernel<<<(rows + per_block - 1) / per_block, kIndexThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float4*)w, rows, n / 4, (const int32_t*)offsets,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// K8.  n a multiple of 32; woff / wlist: the live-word index of w;
// `chunk` live words per work item (1..32); `blocks_per_sm` blocks of the
// cooperative grid per SM (capped at what the SM holds).  dist_t, cand_t:
// (n, Sp) float32 / int32 scratch, Sp = S rounded up to 32; fmask:
// (Sp / 32, n) uint32; items: room for (Sp / 32) x (the index's work items
// at `chunk`) int4; counts: 2 * n_run int32, zeroed; bar: 2 uint32,
// zeroed; prod, stop: one int32 each.
int dawn_fused_minplus_multisweep(
    const void* frontier, const void* w, const void* woff, const void* wlist,
    const void* dist, void* new_out, void* dist_out, void* dist_t,
    void* cand_t, void* fmask, void* items, void* counts, void* bar,
    void* prod, void* stop, int S, int n, int chunk, int blocks_per_sm,
    int n_run, void* stream) {
  if (S < 1 || n < 32 || n % 32 || chunk < 1 || chunk > 32 ||
      blocks_per_sm < 1 || n_run < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_minplus_kernel, kFusedThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int8_t* a_frontier = (const int8_t*)frontier;
  const float* a_w = (const float*)w;
  const int32_t* a_woff = (const int32_t*)woff;
  const int32_t* a_wlist = (const int32_t*)wlist;
  const float* a_dist = (const float*)dist;
  int8_t* a_new = (int8_t*)new_out;
  float* a_dist_out = (float*)dist_out;
  float* a_dist_t = (float*)dist_t;
  int32_t* a_cand_t = (int32_t*)cand_t;
  uint32_t* a_fmask = (uint32_t*)fmask;
  int4* a_items = (int4*)items;
  int32_t* a_counts = (int32_t*)counts;
  unsigned* a_bar = (unsigned*)bar;
  int32_t* a_prod = (int32_t*)prod;
  int32_t* a_stop = (int32_t*)stop;
  void* args[] = {&a_frontier, &a_w, &a_woff, &a_wlist, &a_dist, &a_new,
                  &a_dist_out, &a_dist_t, &a_cand_t, &a_fmask, &a_items,
                  &a_counts, &a_bar, &a_prod, &a_stop, &S, &n, &chunk,
                  &n_run};
  const int blocks = sms * (per_sm < blocks_per_sm ? per_sm : blocks_per_sm);
  err = cudaLaunchCooperativeKernel((const void*)fused_minplus_kernel,
                                    dim3(blocks), dim3(kFusedThreads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K9's in-lane index.  src / dst / w: the m CSR lanes.  Count pass
// (fill 0): cur (n + 1,) int32, zeroed; it gets each target's in-lanes
// below +inf weight, and at cur[n] those whose source or target lies
// outside [0, n).  Fill pass (fill 1): cur (n,) int32 = each target's
// first slot; out_src / out_w: room for the counted lanes.
int dawn_tropical_in_lanes(const void* src, const void* dst, const void* w,
                           void* cur, void* out_src, void* out_w, int m,
                           int n, int fill, void* stream) {
  if (m < 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  int blocks = (m + kInLaneThreads - 1) / kInLaneThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  in_lanes_kernel<<<blocks, kInLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)w, m, n,
      (int32_t*)cur, (int32_t*)out_src, (float*)out_w, fill);
  return (int)cudaGetLastError();
}

// K9.  n a multiple of 32; off / isrc / iw / hub_first / pieces: the
// in-lane index (off, hub_first (n + 1,) int32; pieces (P, 2) int32, the
// lane range of each hub piece); fd_t: (n, Sp) float32 scratch, Sp = S
// rounded up to 32; fbits: (Sp / 32, n / 32) uint32 scratch; hpart:
// (P, Sp) float32 scratch (unused where P = 0); n < 2^27 (a staged
// source id carries its row groups' bits).
int dawn_sparse_relax(const void* frontier, const void* dist,
                      const void* off, const void* isrc, const void* iw,
                      const void* hub_first, const void* pieces, void* fd_t,
                      void* fbits, void* hpart, void* new_out,
                      void* dist_out, int S, int n, int P, void* stream) {
  if (S < 1 || n < 32 || n % 32 || n >= (1 << (31 - kRelaxGroups)) ||
      P < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int G = (S + 31) / 32;
  const int GB = (G + kRelaxGroups - 1) / kRelaxGroups;
  relax_entry_kernel<<<dim3((n + 127) / 128, G), kRelaxEntryThreads, 0, st>>>(
      (const int8_t*)frontier, (const float*)dist, (float*)fd_t,
      (uint32_t*)fbits, S, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    relax_pieces_kernel<<<dim3((P + kGatherWarps - 1) / kGatherWarps, GB),
                          kGatherThreads, 0, st>>>(
        (const float*)fd_t, (const uint32_t*)fbits, (const int32_t*)isrc,
        (const float*)iw, (const int2*)pieces, (float*)hpart, P, S, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  relax_gather_kernel<<<dim3(n / 32, GB), kGatherThreads, 0, st>>>(
      (const float*)fd_t, (const uint32_t*)fbits, (const int32_t*)off,
      (const int32_t*)isrc, (const float*)iw, (const int32_t*)hub_first,
      (const float*)hpart, (const float*)dist, (int8_t*)new_out,
      (float*)dist_out, S, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
