// Hand-written Hopper (sm_90a) kernels for the boolean DAWN sweep.
//
// Four kernels, one per Pallas kernel of src/repro/kernels/bovm/kernel.py,
// and the builder of the index that two of them read.  Packed words
// arrive as int32 tensors carrying the uint32 bit pattern (node 32*w + b
// is bit b of word w) and are read here as uint32_t.  Every entry point is
// a plain C function that launches on the given stream and returns
// cudaGetLastError(); it allocates nothing.
//
// The packed operand at (n, W) holds column j's in-neighbours as words;
// it is the largest input by far (n*n/8 bytes) and almost all of it is
// zero: a column has a few dozen live (non-zero) words on an RMAT graph
// and at most four on a grid, out of W = n/32.  K1 and K2 never read it.
// They read its live-word index (a packed CSC, built once per prepared
// graph by packed_words_kernel): per column the positions and values of
// its live words.  Warps walk the lists of the columns still unreached in
// some row (Thm 3.2), cut into work items, a lane per entry, against the
// frontier staged as per-bit row masks; an item stops once every pending
// row of its column has hit.  K3 still reads the operand itself, through
// a compacted list of the words where its row tile's frontier is active.
// K4 is the int8 tensor-core product of the unpacked (k, n) operand.
// Beside them, pack_frontier_kernel turns the byte frontier into the
// packed words that K1, K2, K3 and the mesh's OR combine take.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIndexThreads = 256;   // index builder: one operand row a warp
constexpr int kPackedThreads = 128;  // K1/K2 sweep: a column a thread
constexpr int kPackedRows = 32;      // K1/K2: source rows a group
constexpr int kEntryLoads = 4;       // K1/K2 sweep: entry loads in flight
constexpr int kWalkThreads = 256;    // K1/K2 walk: a work item a warp
constexpr int kBitLoads = 4;         // K1/K2 walk: row-mask loads in flight
constexpr int kFusedThreads = 1024;  // K3: one CTA per SM
constexpr int kListChunk = 256;      // K3 active words staged per pass
constexpr int kMaskPitch = 33;       // K3 row masks per staged word, padded
constexpr int kScanCols = 2;         // K3 columns a warp scans at once
constexpr int kPackThreads = 256;    // frontier pack: a word a thread
constexpr int kMaxGridY = 65535;

constexpr unsigned kFull = 0xffffffffu;

// The live-word index of the packed operand: per row j of at (n, W), the
// ascending positions w and the values at[j, w] of its non-zero words.
// Bound: bytes (the operand once per pass).  A warp per row reads 32
// words a round and compacts the live ones by ballot.  With offsets null
// it writes the row's live-word count to out_w[j]; with the prefix-summed
// offsets it fills out_w / out_v from offsets[j].
__global__ void __launch_bounds__(kIndexThreads) packed_words_kernel(
    const uint32_t* __restrict__ at, int rows, int W,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ out_w,
    uint32_t* __restrict__ out_v) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kIndexThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;                               // warp-uniform
  const uint32_t* p = at + (size_t)row * W;
  int pos = offsets ? offsets[row] : 0;
#pragma unroll 4
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    const uint32_t v = w < W ? __ldg(p + w) : 0u;
    const uint32_t m = __ballot_sync(kFull, v != 0u);
    if (offsets && v) {
      const int k = pos + __popc(m & ((1u << lane) - 1u));
      out_w[k] = w;
      out_v[k] = v;
    }
    pos += __popc(m);
  }
  if (!offsets && lane == 0) out_w[row] = pos;
}

// The frontier of K1/K2 as row masks: fp (S, W) -> rm (S32 / 32, W, 32),
// rm[g][w][b] the rows of group g (32 rows; S32 = S rounded up to 32,
// rows past S empty) whose word w has bit b set.  An index entry (w, a)
// then hits the rows OR_{b in a} rm[g][w][b]: one 4-byte load per set
// bit of a, where the words themselves would take one per row.  A 32 x 32
// tile (rows x words) per block, a warp per word, one ballot per bit.
// Also zeroes the work-item count that the next launch appends to.
__global__ void __launch_bounds__(1024) stage_frontier_kernel(
    const uint32_t* __restrict__ fp, uint32_t* __restrict__ rm,
    int* __restrict__ count, int S, int W) {
  __shared__ uint32_t tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w0 = blockIdx.x * 32, g = blockIdx.y, r0 = g * 32;
  if ((blockIdx.x | blockIdx.y | tx | ty) == 0) *count = 0;
  tile[ty][tx] = w0 + tx < W && r0 + ty < S
                     ? __ldg(fp + (size_t)(r0 + ty) * W + w0 + tx) : 0u;
  __syncthreads();
  const int w = w0 + ty;                       // warp ty: word w, lane: row
  if (w < W) {
    const uint32_t v = tile[tx][ty];
    uint32_t mine = 0u;
    uint32_t bits = __reduce_or_sync(kFull, v);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const uint32_t m = __ballot_sync(kFull, (v >> b) & 1u);
      if (tx == b) mine = m;
    }
    rm[((size_t)g * W + w) * 32 + tx] = mine;
  }
}

// K1 packed_push_sweep and K2 packed_pull_sweep: one kernel sequence.
// Replaces _packed_push_kernel / _packed_pull_kernel (+ _word_hits) of
// src/repro/kernels/bovm/kernel.py: hits[s, j] = OR_w(f[s, w] & at[j, w]),
// new = hits & unreached, dist = step where new.  The two differ on the
// TPU only in their tiles and in K1's occupancy skips, which are inert;
// here the o_occ skip is finer and comes from data the sweep reads
// anyway: a column whose rows are all reached reads no index entry.
// f_occ is dropped: a frontier word block that is all zero holds no bit,
// so its row masks are zero.
// Bound: bytes.  The state (dist in, new and dist out: 9 B per entry) is
// the floor; beyond it a sweep must see, for each target with an
// unreached row, the live operand words that a missing row's frontier
// selects.  Design: three launches.
//   stage   the frontier as row masks (stage_frontier_kernel);
//   sweep   a thread per (32-row group, column) reads the column's dist
//           once, into registers, and forms its pending mask (rows past S
//           masked).  A column with at most `short_len` index entries is
//           walked by its thread: kEntryLoads entries a round, the row
//           masks of each entry's set bits ORed, until every pending row
//           has hit.  The thread then writes new and dist_out a row at a
//           time, coalesced.  A longer column (an RMAT hub) writes "no
//           hit" the same way, and its list is cut into work items of at
//           most `item` entries, appended by warp-aggregated atomics to
//           one list for the whole sweep;
//   walk    a persistent grid of warps takes the items in turn.  Lane k
//           loads entry (w, a) of a round of 32 and ORs the row masks of
//           the set bits of a, kBitLoads loads at a time (RMAT's words
//           hold one or two bits); a warp OR gives the rows the round
//           hits, and the item stops once every pending row of the column
//           has hit.  The item writes new and dist at the rows it found (a
//           row found twice is written twice, with the same values) and
//           ORs them into the column's mask (an L2 atomic), which later
//           items of the column read first.  One list for the card bounds
//           a hub column's tail and balances graphs whose heavy columns
//           sit together (RMAT's low ids).
__global__ void __launch_bounds__(kPackedThreads) packed_sweep_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ words,
    const uint32_t* __restrict__ values, const uint32_t* __restrict__ rm,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, uint32_t* __restrict__ pend,
    uint32_t* __restrict__ hits, int4* __restrict__ list,
    int* __restrict__ count, int S, int n, int W, int short_len, int item,
    int step) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y, row0 = g * kPackedRows;
  const int rv = min(kPackedRows, S - row0);     // valid rows
  const int j = blockIdx.x * kPackedThreads + threadIdx.x;
  const bool col = j < n;
  int b = 0, e = 0;
  int32_t d[kPackedRows];
  uint32_t p = 0;
  if (col) {
    b = offsets[j];
    e = offsets[j + 1];
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      d[r] = r < rv ? dist[(size_t)(row0 + r) * n + j] : 0;
      p |= (uint32_t)(r < rv && d[r] < 0) << r;
    }
  }
  if (e == b) p = 0;                             // no live word: no hit
  const bool listed = p && e - b > short_len;
  uint32_t h = 0u;
  if (p && !listed) {
    const uint32_t* rg = rm + (size_t)g * W * 32;
    for (int k0 = b; k0 < e && (p & ~h); k0 += kEntryLoads) {
      uint32_t a[kEntryLoads];
      const uint32_t* rw[kEntryLoads];
#pragma unroll
      for (int i = 0; i < kEntryLoads; ++i) {
        const bool in = k0 + i < e;
        a[i] = in ? __ldg(values + k0 + i) : 0u;
        rw[i] = rg + (in ? (size_t)__ldg(words + k0 + i) * 32 : 0);
      }
#pragma unroll
      for (int i = 0; i < kEntryLoads; ++i) {
        uint32_t x = a[i];
        while (x) {
          h |= __ldg(rw[i] + __ffs(x) - 1);
          x &= x - 1;
        }
      }
    }
    h &= p;
  }
  if (col) {
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      if (r < rv) {
        const size_t idx = (size_t)(row0 + r) * n + j;
        const bool nw = (h >> r) & 1u;
        new_out[idx] = nw ? 1 : 0;
        dist_out[idx] = nw ? step : d[r];
      }
    }
  }
  if (listed) {
    pend[(size_t)g * n + j] = p;
    hits[(size_t)g * n + j] = 0u;
  }
  const int items = listed ? (e - b + item - 1) / item : 0;
  int incl = items;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, incl);
  int k = __shfl_sync(kFull, base, 31) + incl - items;
  for (int i = 0; i < items; ++i, ++k) {
    const int k0 = b + i * item;
    list[k] = make_int4(g, j, k0, min(k0 + item, e));
  }
}

__global__ void __launch_bounds__(kWalkThreads) packed_walk_kernel(
    const int4* __restrict__ list, const int* __restrict__ count,
    const uint32_t* __restrict__ rm, const int32_t* __restrict__ words,
    const uint32_t* __restrict__ values, const uint32_t* __restrict__ pend,
    uint32_t* hits, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, int n, int W, int step) {
  const int lane = threadIdx.x & 31;
  const int per_block = kWalkThreads / 32;
  const int warps = gridDim.x * per_block;
  const int total = *count;
  for (int it = blockIdx.x * per_block + (threadIdx.x >> 5); it < total;
       it += warps) {
    const int4 q = __ldg(list + it);             // group, column, entries
    const size_t pj = (size_t)q.x * n + q.y;
    const uint32_t need = __ldg(pend + pj) & ~__ldcg(hits + pj);
    const uint32_t* rg = rm + (size_t)q.x * W * 32;
    uint32_t found = 0;
    for (int kb = q.z; kb < q.w && (need & ~found); kb += 32) {
      const int k = kb + lane;
      uint32_t a = 0u;
      const uint32_t* rw = rg;
      if (k < q.w) {
        rw = rg + (size_t)__ldg(words + k) * 32;
        a = __ldg(values + k);
      }
      uint32_t h = 0u;
      while (__any_sync(kFull, a != 0u)) {
        uint32_t m[kBitLoads];
#pragma unroll
        for (int i = 0; i < kBitLoads; ++i) {
          m[i] = a ? __ldg(rw + __ffs(a) - 1) : 0u;
          a &= a - 1;
        }
#pragma unroll
        for (int i = 0; i < kBitLoads; ++i) h |= m[i];
      }
      found |= __reduce_or_sync(kFull, h) & need;
    }
    if (!found) continue;
    if ((found >> lane) & 1u) {
      const size_t idx = (size_t)(q.x * kPackedRows + lane) * n + q.y;
      new_out[idx] = 1;
      dist_out[idx] = step;
    }
    if (lane == 0) atomicOr(hits + pj, found);
  }
}

// K3 fused_boolean_multisweep.
// Replaces _fused_boolean_kernel (+ _pack_words) of
// src/repro/kernels/bovm/kernel.py.
// Bound: bytes — each sweep reads the operand words its active frontier
// words select, for every unreached target.  The TPU design keeps the
// whole operand on chip; at n = 65,664 it is 539 MB, far beyond one SM, so
// the operand is streamed from L2/HBM every sweep and only the row tile's
// state stays on chip.  Design: one thread block cluster of `C` CTAs (one
// CTA per SM) owns a tile of R (16 or 32) source rows, so at S = 128 the
// card runs C * S / R CTAs, and every operand word a sweep reads serves R
// rows at once.  CTA c owns a slice of ceil(W / C) packed words (32
// columns each): their visited bits and per-column hit masks live in its
// shared memory, and it writes that slice of the next frontier, plus the
// OR over the tile's rows of each next-frontier word, to an L2-resident
// global buffer (double-buffered by sweep parity).  One cluster barrier
// per sweep (barrier.cluster arrive.release / wait.acquire) publishes the
// slices; every CTA then reads the row-OR words, compacts the active ones
// into an ascending list, stages the tile's frontier words for that list
// K words at a time as per-bit row masks, and tests its own columns, two
// per warp at once, all of their K operand loads in one round.  A whole 32-column word whose 32
// targets are visited in every row of the tile is skipped with one test.
// Fact 1 is a cluster-wide OR of per-CTA flags read through distributed
// shared memory.  Tiles are independent: no grid-wide sync.  Rows evolve
// independently, so the tile size does not change any result (see
// ref.fused_boolean_multisweep_ref); rows past S in the last tile are
// masked.

// One cluster barrier with release / acquire semantics: the next-frontier
// slices (global) and the Fact-1 flags (shared) written before it are
// visible to every CTA of the cluster after it.
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Load an int from cluster CTA `rank`'s shared memory at `p`'s offset.
__device__ __forceinline__ int load_peer_int(const int* p, int rank) {
  uint32_t local = (uint32_t)__cvta_generic_to_shared(p), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// For each of kScanCols target columns j0 + col[c] (col[c] < 0: none),
// the rows of pend[c] whose frontier shares a bit with the column's
// in-neighbour words, into out[c].  Called by a whole warp with
// warp-uniform arguments; the results are warp-uniform.  The k-th listed
// active word (k < cnt <= kListChunk) is staged transposed:
// rm[k * kMaskPitch + b] is the mask of tile rows whose word has bit b
// set, so a hit costs one load per set bit of the operand word instead of
// one per pending row.  Each lane issues all of its kListChunk / 32
// operand loads of every column before testing any, so one pass over
// kScanCols columns costs one memory round trip.
__device__ __forceinline__ void scan_listed(
    const uint32_t* __restrict__ at, size_t W, size_t j0, const int* col,
    const uint32_t* pend, const uint32_t* rm, const int* actw,
    const uint32_t* actu, int cnt, int lane, uint32_t* out) {
  constexpr int U = kListChunk / 32;
  uint32_t a[kScanCols][U];
#pragma unroll
  for (int c = 0; c < kScanCols; ++c) {
    const uint32_t* at_row = at + (j0 + max(col[c], 0)) * W;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int k = lane + 32 * i;
      a[c][i] = pend[c] && k < cnt ? __ldg(at_row + actw[k]) & actu[k] : 0u;
    }
  }
#pragma unroll
  for (int c = 0; c < kScanCols; ++c) {
    uint32_t h = 0;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      uint32_t bits = a[c][i];
      const uint32_t* row = rm + (lane + 32 * i) * kMaskPitch;
      while (bits) {
        h |= row[__ffs(bits) - 1];
        bits &= bits - 1;
      }
    }
    out[c] = __reduce_or_sync(kFull, h) & pend[c];
  }
}

template <int R>
__global__ void __launch_bounds__(kFusedThreads, 1) fused_boolean_kernel(
    const uint32_t* __restrict__ fp, const uint32_t* __restrict__ at,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, int32_t* __restrict__ prod_out,
    int32_t* __restrict__ stop_out, uint32_t* fbuf, uint32_t* ubuf, int S,
    int n, int W, int C, int step0, int n_run) {
  static_assert(R == 16 || R == 32, "tile rows");
  static_assert(kFusedThreads == 1024, "one scan warp covers 32 warps");
  extern __shared__ uint32_t smem[];
  __shared__ int nact;
  __shared__ int wsum[kFusedThreads / 32];
  __shared__ int flag[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = blockIdx.x, tile = blockIdx.y;
  const int tiles = gridDim.y;
  const int row0 = tile * R;
  const int rv = min(R, S - row0);                       // valid rows
  const int wc = (W + C - 1) / C;                        // slice pitch
  const int wbeg = rank * wc;
  const int wn = max(0, min(wc, W - wbeg));              // slice words
  uint32_t* vis = smem;                                  // [R][wc]
  uint32_t* hits = vis + R * wc;                         // [wc * 32]
  uint32_t* rm = hits + 32 * wc;              // [kListChunk][kMaskPitch]
  int* actw = reinterpret_cast<int*>(rm + kListChunk * kMaskPitch);  // [W]
  uint32_t* actu = reinterpret_cast<uint32_t*>(actw + W);   // [W]
  const size_t plane = (size_t)S * W;

  // visited bits of the slice, dist copied to dist_out, and the row-OR
  // of the starting frontier's slice words
  for (int q = warp; q < rv * wn; q += nwarps) {
    const int r = q / wn, wl = q % wn;
    const size_t idx =
        (size_t)(row0 + r) * n + (size_t)(wbeg + wl) * 32 + lane;
    const int32_t d = dist[idx];
    dist_out[idx] = d;
    const uint32_t bits = __ballot_sync(kFull, d >= 0);
    if (lane == 0) vis[r * wc + wl] = bits;
  }
  for (int wl = tid; wl < wn; wl += blockDim.x) {
    uint32_t u = 0;
    for (int r = 0; r < rv; ++r) u |= fp[(size_t)(row0 + r) * W + wbeg + wl];
    ubuf[(size_t)tile * W + wbeg + wl] = u;
  }
  cluster_sync_acq_rel();

  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    const uint32_t* cur = t == 0 ? fp : fbuf + (t & 1) * plane;
    uint32_t* nxt = fbuf + ((t + 1) & 1) * plane;
    const uint32_t* ucur = ubuf + ((size_t)(t & 1) * tiles + tile) * W;
    uint32_t* unxt = ubuf + ((size_t)((t + 1) & 1) * tiles + tile) * W;
    const int32_t dnew = step0 + 1 + t;

    // the tile's active words (row-OR words published by every CTA),
    // compacted in ascending order so that a warp's operand loads in
    // scan_listed fall on neighbouring words of the column's row
    for (int i = tid; i < 32 * wn; i += blockDim.x) hits[i] = 0;
    int na = 0;
    for (int w0 = 0; w0 < W; w0 += kFusedThreads) {
      const int w = w0 + tid;
      const uint32_t u = w < W ? __ldcg(ucur + w) : 0u;
      const uint32_t m = __ballot_sync(kFull, u != 0);
      if (lane == 0) wsum[warp] = __popc(m);
      __syncthreads();
      if (warp == 0) {                                   // exclusive scan
        const int v = wsum[lane];
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += x;
        }
        wsum[lane] = incl - v;
        if (lane == 31) nact = incl;
      }
      __syncthreads();
      if (u) {
        const int k = na + wsum[warp] + __popc(m & ((1u << lane) - 1u));
        actw[k] = w;
        actu[k] = u;
      }
      na += nact;
      __syncthreads();
    }
    for (int k0 = 0; k0 < na; k0 += kListChunk) {
      const int cnt = min(kListChunk, na - k0);
      // stage the listed words transposed: lane r reads row r's word,
      // one ballot per bit that some row of the tile has set
      for (int kk = warp; kk < cnt; kk += nwarps) {
        const uint32_t v =
            lane < rv ? __ldcg(cur + (size_t)(row0 + lane) * W + actw[k0 + kk])
                      : 0u;
        uint32_t bits = actu[k0 + kk], mine = 0;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const uint32_t m = __ballot_sync(kFull, (v >> b) & 1u);
          if (lane == b) mine = m;
        }
        rm[kk * kMaskPitch + lane] = mine;
      }
      __syncthreads();
      for (int wl = warp; wl < wn; wl += nwarps) {
        // lane b: the rows for which column 32 * word + b is unreached
        uint32_t pend = 0;
        for (int r = 0; r < rv; ++r)
          pend |= ((~vis[r * wc + wl] >> lane) & 1u) << r;
        uint32_t mine = hits[wl * 32 + lane];
        pend &= ~mine;
        uint32_t cols = __ballot_sync(kFull, pend != 0);
        if (!cols) continue;                             // word visited
        const size_t j0 = (size_t)(wbeg + wl) * 32;
        while (cols) {                   // kScanCols columns at a time
          int col[kScanCols];
          uint32_t pb[kScanCols], h[kScanCols];
#pragma unroll
          for (int c = 0; c < kScanCols; ++c) {
            col[c] = cols ? __ffs(cols) - 1 : -1;
            cols &= cols - 1;
            pb[c] = __shfl_sync(kFull, pend, max(col[c], 0));
            if (col[c] < 0) pb[c] = 0;
          }
          scan_listed(at, W, j0, col, pb, rm, actw + k0, actu + k0, cnt,
                      lane, h);
#pragma unroll
          for (int c = 0; c < kScanCols; ++c)
            if (lane == col[c]) mine |= h[c];
        }
        hits[wl * 32 + lane] = mine;
      }
      __syncthreads();
    }

    // publish the slice of the next frontier, its row-OR words and dist
    int any = 0;
    for (int wl = warp; wl < wn; wl += nwarps) {
      const uint32_t h = hits[wl * 32 + lane];           // new bits only
      const int wj = wbeg + wl;
      uint32_t rows_any = __reduce_or_sync(kFull, h);
      uint32_t word = 0;
      while (rows_any) {
        const int r = __ffs(rows_any) - 1;
        rows_any &= rows_any - 1;
        const uint32_t bits = __ballot_sync(kFull, (h >> r) & 1u);
        if (lane == r) word = bits;
        if ((h >> r) & 1u)
          dist_out[(size_t)(row0 + r) * n + (size_t)wj * 32 + lane] = dnew;
      }
      if (lane < rv) {
        nxt[(size_t)(row0 + lane) * W + wj] = word;
        vis[lane * wc + wl] |= word;
      }
      const uint32_t u = __ballot_sync(kFull, h != 0);
      if (lane == 0) unxt[wj] = u;
      any |= u != 0;
    }
    any = __syncthreads_or(any);
    if (tid == 0) flag[t & 1] = any;
    cluster_sync_acq_rel();
    // Fact 1 over the cluster: did any CTA's slice find a new target?
    if (!__syncthreads_or(load_peer_int(&flag[t & 1], tid % C))) {
      done = 1;
      break;
    }
    ++prod;
  }
  // new = the last sweep's discoveries; zeros after a sweep that found
  // nothing (Fact 1) or when no sweep ran
  const bool keep = !done && n_run > 0;
  const uint32_t* last = fbuf + (n_run & 1) * plane;
  const int quads = wn * 8;                              // 4 columns each
  for (int i = tid; i < rv * quads; i += blockDim.x) {
    const int r = i / quads, q = i % quads;
    const int wj = wbeg + q / 8;
    const uint32_t word =
        keep ? __ldcg(last + (size_t)(row0 + r) * W + wj) : 0u;
    const uint32_t nib = (word >> ((q % 8) * 4)) & 0xfu;
    const uint32_t v = (nib & 1u) | ((nib >> 1) & 1u) << 8 |
                       ((nib >> 2) & 1u) << 16 | ((nib >> 3) & 1u) << 24;
    *reinterpret_cast<uint32_t*>(new_out + (size_t)(row0 + r) * n +
                                 (size_t)wj * 32 + (q % 8) * 4) = v;
  }
  if (rank == 0 && tid == 0) {
    prod_out[tile] = prod;
    stop_out[tile] = done;
  }
  // no CTA leaves while a peer may still read its flags
  cluster_sync_acq_rel();
}

// K4 fused_sweep (the push_f32 control).
// Replaces _fused_sweep_kernel of src/repro/kernels/bovm/kernel.py.
// Bound: bytes of the (k, n) int8 operand (4.3 GB at n = 65,664) on a
// dense frontier; the int8 product itself is 2 * S * k * n operations at
// 1,979 TOP/s.  Design: a masked int8 GEMM on the tensor cores
// (mma.sync m16n8k32 s8 * s8 -> s32; 0/1 products summed exactly, where
// the TPU kernel sums them in f32).  One block owns a 128-column tile for
// all of its <= 128 frontier rows, so each live operand tile is read once
// per 128 rows; row groups of one column tile are adjacent block indices,
// so for S > 128 the second read comes from L2.  Four warps each hold a
// 64 x 64 accumulator tile (fewer shared-memory fragment bytes per mma
// than 32-row warp tiles), A fragments come in by ldmatrix.  The
// contraction runs in 64-byte stages: the frontier tile through a 4-deep
// cp.async ring, the operand through registers one stage ahead.  The
// operand arrives N-major ((k, n), n contiguous) while the mma wants each
// B column K-contiguous, so each thread transposes its 4 rows x 16 columns
// with __byte_perm (a 4 x 4 byte block per four permutes) on the way into
// a double-buffered, XOR-swizzled K-major tile whose fragment loads are
// free of bank conflicts; one barrier per stage.  Dead column tiles
// (o_occ over the block's rows) skip the product; dead k-blocks (f_occ)
// are never loaded.  Rows past S are zero-filled and masked, columns and
// contraction bytes past n and k are zero-filled.
constexpr int kMmaRows = 128;       // frontier rows per block
constexpr int kMmaCols = 128;       // output columns per block
constexpr int kMmaK = 64;           // contraction bytes per stage
constexpr int kMmaStages = 4;
constexpr int kMmaWarpRows = 64;    // rows of one warp's output tile
constexpr int kMmaRowWarps = kMmaRows / kMmaWarpRows;
constexpr int kMmaMTiles = kMmaWarpRows / 16;   // m16 tiles per warp
constexpr int kMmaThreads = kMmaRowWarps * (kMmaCols / 64) * 32;
constexpr int kMmaMinBlocks = 2;    // blocks per SM the registers allow
constexpr int kAPitch = kMmaK + 16;          // bytes per A row (80)
constexpr int kATile = kMmaRows * kAPitch;   // 10,240 B
constexpr int kBtWords = kMmaK / 4;          // words per K-major B column
constexpr int kBtTile = kMmaCols * kMmaK;    // 8,192 B, K-major B
constexpr int kMmaFixedSmem = kMmaStages * kATile + 2 * kBtTile;

// XOR swizzle of the K-major B tile: word (n, kw) lives at
// n * 16 + (kw ^ swz(n)).  A fragment load (8 columns n of one aligned
// group x 4 words kw) then hits 32 distinct banks.
__device__ __forceinline__ int swz(int n) {
  return ((((n >> 1) ^ (n >> 3)) & 3) << 2) | ((n >> 4) & 3);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 16-byte matrices from shared memory, one register each: for
// int8 rows this is the m16n8k32 A fragment (a0..a3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks) int8_mma_kernel(
    const int8_t* __restrict__ f, const int8_t* __restrict__ a,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, const uint8_t* __restrict__ f_occ,
    const uint8_t* __restrict__ o_occ, int S, int n, int k, int bs, int bn,
    int bk, int step) {
  extern __shared__ __align__(16) uint8_t msm[];
  uint32_t* bt = reinterpret_cast<uint32_t*>(msm + kMmaStages * kATile);
  int* live = reinterpret_cast<int*>(msm + kMmaFixedSmem);  // stage list
  __shared__ int nlive;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kMmaRows, col0 = blockIdx.y * kMmaCols;
  const int rows = min(kMmaRows, S - row0);
  const int cols = min(kMmaCols, n - col0);
  const int ti0 = row0 / bs, ti1 = (row0 + rows - 1) / bs;
  const int gj = n / bn, gk = k / bk;
  const int nst = (k + kMmaK - 1) / kMmaK;

  // o_occ: is any target of the block's tiles still unreached?
  int open = 0;
  {
    const int tj0 = col0 / bn, tj1 = (col0 + cols - 1) / bn;
    const int ntj = tj1 - tj0 + 1;
    for (int i = tid; i < (ti1 - ti0 + 1) * ntj; i += kMmaThreads)
      open |= o_occ[(size_t)(ti0 + i / ntj) * gj + tj0 + i % ntj];
  }
  if (tid == 0) nlive = 0;
  open = __syncthreads_or(open);
  // f_occ: the live contraction stages, in any order (integer sums)
  if (open) {
    for (int st = tid; st < nst; st += kMmaThreads) {
      const int kb0 = st * kMmaK / bk;
      const int kb1 = (min(st * kMmaK + kMmaK, k) - 1) / bk;
      int lv = 0;
      for (int ti = ti0; ti <= ti1 && !lv; ++ti)
        for (int kb = kb0; kb <= kb1 && !lv; ++kb)
          lv = f_occ[(size_t)ti * gk + kb];
      if (lv) live[atomicAdd(&nlive, 1)] = st;
    }
  }
  // rows past S stay zero in every A slot
  for (int i = tid; i < kMmaStages * (kMmaRows - rows) * (kAPitch / 4);
       i += kMmaThreads) {
    const int per = (kMmaRows - rows) * (kAPitch / 4);
    const int s = i / per, q = i % per;
    reinterpret_cast<uint32_t*>(msm + s * kATile +
                                rows * kAPitch)[q] = 0u;
  }
  __syncthreads();
  const int nl = nlive;

  // A (frontier rows, K-major) through the cp.async ring
  auto load_a = [&](int st, int slot) {
    uint8_t* as = msm + slot * kATile;
    const int kbase = st * kMmaK;
    for (int c = tid; c < rows * (kMmaK / 16); c += kMmaThreads) {
      const int r = c / (kMmaK / 16), q = c % (kMmaK / 16);
      const int kk = kbase + q * 16;
      const bool ok = kk < k;
      cp_async16(as + r * kAPitch + q * 16,
                 ok ? f + (size_t)(row0 + r) * k + kk : f, ok);
    }
  };
  // B (operand, N-major) through registers: this thread's 4 rows x 16
  // columns of a stage, loaded one stage ahead and stored transposed
  const int bk4 = tid / (kMmaCols / 16), bc = tid % (kMmaCols / 16);
  static_assert(kMmaThreads == (kMmaK / 4) * (kMmaCols / 16), "B units");
  uint4 bv[4];
  auto load_b = [&](int st) {
    const int col = col0 + bc * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kg = st * kMmaK + 4 * bk4 + i;
      bv[i] = kg < k && col < n
                  ? __ldg(reinterpret_cast<const uint4*>(a + (size_t)kg * n +
                                                         col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_b = [&](uint32_t* dst) {
    const uint32_t* w0 = &bv[0].x;
    const uint32_t* w1 = &bv[1].x;
    const uint32_t* w2 = &bv[2].x;
    const uint32_t* w3 = &bv[3].x;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // a 4 x 4 byte block: rows 4 * bk4 + i, columns bc * 16 + 4q + c
      const uint32_t lo01 = __byte_perm(w0[q], w1[q], 0x5140);
      const uint32_t hi01 = __byte_perm(w0[q], w1[q], 0x7362);
      const uint32_t lo23 = __byte_perm(w2[q], w3[q], 0x5140);
      const uint32_t hi23 = __byte_perm(w2[q], w3[q], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int nn = bc * 16 + 4 * q + c;
        dst[nn * kBtWords + (bk4 ^ swz(nn))] = col[c];
      }
    }
  };

  int acc[kMmaMTiles][8][4];
#pragma unroll
  for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  const int wr = warp % kMmaRowWarps, wc = warp / kMmaRowWarps;
  const int g = lane >> 2, tq = lane & 3;
  const int mrows = rows - wr * kMmaWarpRows;            // rows of the warp

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nl) load_a(live[s], s);
    cp_async_commit();
  }
  if (nl > 0) {
    load_b(live[0]);
    store_b(bt);
  }
  if (nl > 1) load_b(live[1]);
  for (int i = 0; i < nl; ++i) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();            // A stage i landed, B stage i stored
    const uint8_t* as = msm + (i % kMmaStages) * kATile;
    const uint32_t* btc = bt + (i & 1) * (kBtTile / 4);
    if (i + 1 < nl) store_b(bt + ((i + 1) & 1) * (kBtTile / 4));
    if (i + 2 < nl) load_b(live[i + 2]);
    if (i + kMmaStages - 1 < nl)
      load_a(live[i + kMmaStages - 1], (i + kMmaStages - 1) % kMmaStages);
    cp_async_commit();
    if (mrows > 0) {
      const uint32_t abase = (uint32_t)__cvta_generic_to_shared(as);
#pragma unroll
      for (int ks = 0; ks < kMmaK / 32; ++ks) {
        const int kw = ks * 8 + tq;
        uint32_t af[kMmaMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kMmaMTiles; ++mt) {
          // lanes 8q..8q+7 address rows of matrix q: (rows +8, k +16)
          const int r = wr * kMmaWarpRows + mt * 16 + (lane & 7) +
                        ((lane >> 3) & 1) * 8;
          ldmatrix_x4(af[mt], abase + r * kAPitch + ks * 32 +
                                  (lane >> 4) * 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int nn = wc * 64 + nt * 8 + g;
          const uint32_t b0 = btc[nn * kBtWords + (kw ^ swz(nn))];
          const uint32_t b1 = btc[nn * kBtWords + ((kw + 4) ^ swz(nn))];
#pragma unroll
          for (int mt = 0; mt < kMmaMTiles; ++mt)
            if (mrows > mt * 16) mma_s8(acc[mt][nt], af[mt], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: new = count > 0 & unreached, dist = step where new
#pragma unroll
  for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr * kMmaWarpRows + mt * 16 + g + half * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wc * 64 + nt * 8 + tq * 2;
        if (c >= cols) continue;
        const size_t idx = (size_t)(row0 + r) * n + col0 + c;
        const int2 d = *reinterpret_cast<const int2*>(dist + idx);
        const bool n0 = acc[mt][nt][half * 2] > 0 && d.x < 0;
        const bool n1 = acc[mt][nt][half * 2 + 1] > 0 && d.y < 0;
        *reinterpret_cast<char2*>(new_out + idx) =
            make_char2(n0 ? 1 : 0, n1 ? 1 : 0);
        *reinterpret_cast<int2*>(dist_out + idx) =
            make_int2(n0 ? step : d.x, n1 ? step : d.y);
      }
    }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Blocks of the persistent K1/K2 walk: as many as the card holds at once.
int walk_blocks(cudaError_t* err) {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev != cached_dev) {
    int sms = 0, per = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, packed_walk_kernel, kWalkThreads, 0);
    if (*err != cudaSuccess) return 0;
    cached_dev = dev;
    cached = sms * per;
  }
  return cached;
}

using FusedKernel = void (*)(const uint32_t*, const uint32_t*,
                             const int32_t*, int8_t*, int32_t*, int32_t*,
                             int32_t*, uint32_t*, uint32_t*, int, int, int,
                             int, int, int);

// The K3 instance for `rows` tile rows, its shared memory and cluster
// size attributes set; nullptr for a tile it does not take.
FusedKernel fused_kernel(int rows, int cluster, int smem, cudaError_t* err) {
  FusedKernel kern = rows == 32   ? fused_boolean_kernel<32>
                     : rows == 16 ? fused_boolean_kernel<16>
                                  : nullptr;
  *err = cudaErrorInvalidValue;
  if (!kern || cluster < 1 || cluster > 16) return nullptr;
  *err = set_smem(kern, (size_t)smem);
  if (*err == cudaSuccess && cluster > 8)
    *err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return *err == cudaSuccess ? kern : nullptr;
}

cudaLaunchConfig_t fused_config(int S, int rows, int cluster, int smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (S + rows - 1) / rows, 1);
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The frontier packed: x (R, n) bytes, row r at x + r * ld -> out (R, W)
// words, W = ceil(n / 32): bit b of word w is set where byte 32 w + b is
// not zero; bits past n are zero.  The same words as the plain
// core.frontier.pack_bits, which widens every entry to int64, shifts it
// and sums 32 of them.  It replaces no TPU kernel: on the TPU XLA fuses
// that arithmetic into the jitted sweep, where PyTorch runs it as three
// passes over 8-byte entries.
// Bound: bytes (the R * n bytes read once, R * W words written once).
// Design: a warp packs 32 consecutive words of a row, 1,024 bytes.  Lane
// k loads 16-byte chunks k and k + 32 of them (each load instruction of
// the warp reads 512 consecutive bytes), turns each chunk into 16 bits in
// registers (per 4 bytes one SIMD compare and one multiply that gathers
// the 4 flags), and two shuffles hand every lane the two halves of its
// word; the warp writes its 32 words in one coalesced store.  No shared
// memory.  The row stride is an argument, so a column slice of a wider
// state (a K-row block's frontier) packs in place.  Where the row pointers
// are 16-byte aligned (kVec) chunks load as vectors; the ragged tail of a
// row, and every chunk where they are not aligned, reads single bytes.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return ((__vcmpne4(v, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

template <bool kVec>
__global__ void __launch_bounds__(kPackThreads) pack_frontier_kernel(
    const uint8_t* __restrict__ x, uint32_t* __restrict__ out, int R, int n,
    int W, long long ld) {
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (w0 >= W) return;                                   // warp-uniform
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const uint8_t* row = x + (size_t)r * ld;
    uint32_t pair = 0u;               // chunk lane (low), lane + 32 (high)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long b = 32LL * w0 + 16LL * (32 * k + lane);
      uint32_t h = 0u;
      if (kVec && b + 16 <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + b));
        h = nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
            nibble(v.w) << 12;
      } else {
        for (int i = 0; i < 16 && b + i < n; ++i)
          h |= (uint32_t)(row[b + i] != 0) << i;
      }
      pair |= h << (16 * k);
    }
    // word w0 + lane is chunks 2 lane and 2 lane + 1: the low halves of
    // lanes 2 lane, 2 lane + 1 for lane < 16, else the high halves of
    // lanes 2 lane - 32, 2 lane - 31
    const uint32_t lo = __shfl_sync(kFull, pair, (2 * lane) & 31);
    const uint32_t hi = __shfl_sync(kFull, pair, (2 * lane + 1) & 31);
    const int sh = lane < 16 ? 0 : 16;
    if (w0 + lane < W)
      out[(size_t)r * W + w0 + lane] =
          (lo >> sh & 0xffffu) | (hi >> sh & 0xffffu) << 16;
  }
}

}  // namespace

extern "C" {

// The frontier x (R, n) bytes, row stride ld bytes, packed into out (R,
// ceil(n / 32)) words.
int dawn_pack_frontier(const void* x, void* out, int R, int n, long long ld,
                       void* stream) {
  if (R < 0 || n < 0 || (R > 1 && ld < n)) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return 0;
  const int W = (n + 31) / 32;
  const dim3 grid((W + kPackThreads - 1) / kPackThreads,
                  R < kMaxGridY ? R : kMaxGridY);
  const bool vec = (uintptr_t)x % 16 == 0 && (R == 1 || ld % 16 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    pack_frontier_kernel<true><<<grid, kPackThreads, 0, st>>>(
        (const uint8_t*)x, (uint32_t*)out, R, n, W, ld);
  else
    pack_frontier_kernel<false><<<grid, kPackThreads, 0, st>>>(
        (const uint8_t*)x, (uint32_t*)out, R, n, W, ld);
  return (int)cudaGetLastError();
}

// K1 / K2.  fp (S, W) the packed frontier; offsets (n + 1), words and
// values the live-word index of the operand (dawn_packed_live_words);
// columns of at most `short_len` entries are walked by one thread, longer
// ones in work items of at most `item` entries.  Scratch: rm (S32 / 32,
// W, 32) int32 (S32 = S rounded up to 32); pend and hits (S32 / 32, n)
// int32; list (>= S32 / 32 * (live words / item + live columns), 4) int32;
// count one int32.  Every scratch part 16-byte aligned.
int dawn_packed_sweep(const void* fp, const void* offsets, const void* words,
                      const void* values, const void* dist, void* new_out,
                      void* dist_out, void* rm, void* pend, void* hits,
                      void* list, void* count, int S, int n, int W,
                      int short_len, int item, int step, void* stream) {
  if (S < 1 || n < 1 || W < 1 || item < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int blocks = walk_blocks(&err);
  if (!blocks) return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  const int G = (S + kPackedRows - 1) / kPackedRows;
  const cudaStream_t st = (cudaStream_t)stream;
  stage_frontier_kernel<<<dim3((W + 31) / 32, G), dim3(32, 32), 0, st>>>(
      (const uint32_t*)fp, (uint32_t*)rm, (int*)count, S, W);
  packed_sweep_kernel<<<dim3((n + kPackedThreads - 1) / kPackedThreads, G),
                        kPackedThreads, 0, st>>>(
      (const int32_t*)offsets, (const int32_t*)words,
      (const uint32_t*)values, (const uint32_t*)rm, (const int32_t*)dist,
      (int8_t*)new_out, (int32_t*)dist_out, (uint32_t*)pend, (uint32_t*)hits,
      (int4*)list, (int*)count, S, n, W, short_len, item, step);
  packed_walk_kernel<<<blocks, kWalkThreads, 0, st>>>(
      (const int4*)list, (const int*)count, (const uint32_t*)rm,
      (const int32_t*)words, (const uint32_t*)values, (const uint32_t*)pend,
      (uint32_t*)hits, (int8_t*)new_out, (int32_t*)dist_out, n, W, step);
  return (int)cudaGetLastError();
}

// The live-word index of the packed operand at (rows, W): with offsets
// null, out (rows) receives each row's live-word count; with the
// prefix-summed offsets (rows + 1), out and values receive the positions
// and values of the live words.
int dawn_packed_live_words(const void* at, const void* offsets, void* out,
                           void* values, int rows, int W, void* stream) {
  if (rows < 0 || W < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int per_block = kIndexThreads / 32;
  packed_words_kernel<<<(rows + per_block - 1) / per_block, kIndexThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)at, rows, W, (const int32_t*)offsets, (int32_t*)out,
      (uint32_t*)values);
  return (int)cudaGetLastError();
}

// `rows` (16 or 32) source rows per cluster of `cluster` (1..16) CTAs;
// `smem` the shared-memory bytes of one CTA for that layout; fbuf (2, S, W)
// and ubuf (2, ceil(S / rows), W) int32 scratch.
int dawn_fused_boolean_multisweep(const void* fp, const void* at,
                                  const void* dist, void* new_out,
                                  void* dist_out, void* prod, void* stop,
                                  void* fbuf, void* ubuf, int S, int n,
                                  int W, int rows, int cluster, int smem,
                                  int step0, int n_run, void* stream) {
  cudaError_t err;
  FusedKernel kern = fused_kernel(rows, cluster, smem, &err);
  if (!kern) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      fused_config(S, rows, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, kern, (const uint32_t*)fp, (const uint32_t*)at,
      (const int32_t*)dist, (int8_t*)new_out, (int32_t*)dist_out,
      (int32_t*)prod, (int32_t*)stop, (uint32_t*)fbuf, (uint32_t*)ubuf, S, n,
      W, cluster, step0, n_run);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many K3 clusters of this shape the card holds at once (into *out).
int dawn_fused_active_clusters(int S, int rows, int cluster, int smem,
                               int* out) {
  cudaError_t err;
  FusedKernel kern = fused_kernel(rows, cluster, smem, &err);
  if (!kern) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fused_config(S, rows, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

int dawn_fused_sweep(const void* f, const void* a, const void* dist,
                     void* new_out, void* dist_out, const void* f_occ,
                     const void* o_occ, int S, int n, int k, int bs, int bn,
                     int bk, int step, void* stream) {
  if (bn % 64 || bk % 32) return (int)cudaErrorInvalidValue;
  const size_t smem =
      kMmaFixedSmem + sizeof(int) * (size_t)((k + kMmaK - 1) / kMmaK);
  cudaError_t err = set_smem(int8_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kMmaRows - 1) / kMmaRows, (n + kMmaCols - 1) / kMmaCols);
  int8_mma_kernel<<<grid, kMmaThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)f, (const int8_t*)a, (const int32_t*)dist,
      (int8_t*)new_out, (int32_t*)dist_out, (const uint8_t*)f_occ,
      (const uint8_t*)o_occ, S, n, k, bs, bn, bk, step);
  return (int)cudaGetLastError();
}

}  // extern "C"
