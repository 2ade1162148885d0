// Hand-written Hopper (sm_90a) kernels for the boolean DAWN sweep.
//
// Four kernels, one per Pallas kernel of src/repro/kernels/bovm/kernel.py.
// Packed words arrive as int32 tensors carrying the uint32 bit pattern
// (node 32*w + b is bit b of word w) and are read here as uint32_t.
// Every entry point is a plain C function that launches on the given
// stream and returns cudaGetLastError(); it allocates nothing.
//
// The packed sweeps share one way of testing a column: a warp tests one
// target column j against the packed frontier rows of its tile
// (scan_column in K1/K2, scan_listed in K3).  It reads only the
// in-neighbour words of j where the tile's frontier has a bit set (a
// compacted list of active words, built per tile in shared memory), tests
// only rows for which j is still unreached (Thm 3.2), and stops once
// every such row has hit (K1/K2 after the round of 32 words, K3 after the
// staged pass of the list in which that happens).  The operand (n, W) is
// the largest input by far (n*n/8 bytes); what bounds these kernels is
// how much of it they must read, and the active-word list makes that read
// proportional to the frontier instead of to n*n.  K4 is the int8
// tensor-core product of the unpacked (k, n) operand.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // per-sweep packed kernels (K1, K2)
constexpr int kChunkWords = 256;     // frontier words staged per pass (K1/K2)
constexpr int kFusedThreads = 1024;  // K3: one CTA per SM
constexpr int kListChunk = 256;      // K3 active words staged per pass
constexpr int kMaskPitch = 33;       // K3 row masks per staged word, padded
constexpr int kScanCols = 2;         // K3 columns a warp scans at once

constexpr unsigned kFull = 0xffffffffu;

// Rows of `pend` (a bitmask over the tile's rows) whose frontier shares a
// bit with the in-neighbour words of one target column.  Called by a whole
// warp with warp-uniform arguments; returns a warp-uniform mask.
//   at_row      in-neighbour words of the column (global), indexed by word
//   fs, ld      the tile's frontier words in shared memory: fs[r * ld + w]
//   actw, actu  the active words of the tile and their OR over rows
__device__ __forceinline__ uint32_t scan_column(
    const uint32_t* __restrict__ at_row, const uint32_t* fs, int ld,
    const int* actw, const uint32_t* actu, int nact, uint32_t pend,
    int lane) {
  uint32_t found = 0;
  for (int base = 0; base < nact; base += 32) {
    const int k = base + lane;
    uint32_t h = 0;
    if (k < nact) {
      const int w = actw[k];
      const uint32_t a = __ldg(at_row + w);
      if (a & actu[k]) {
        uint32_t m = pend & ~found;
        while (m) {
          const int r = __ffs(m) - 1;
          m &= m - 1;
          if (fs[r * ld + w] & a) h |= 1u << r;
        }
      }
    }
    found |= __reduce_or_sync(kFull, h);
    if ((found & pend) == pend) break;
  }
  return found & pend;
}

// K1 packed_push_sweep (kGated) and K2 packed_pull_sweep.
// Replaces _packed_push_kernel / _packed_pull_kernel (+ _word_hits) of
// src/repro/kernels/bovm/kernel.py.
// Bound: bytes.  A sweep must read the in-neighbour words of every
// unreached target where the frontier is active: at most the whole
// (n, W) operand, far less on a sparse frontier.  Design: one block per
// (rows-row group, bn-column tile); the frontier rows are staged in
// shared memory kChunkWords words at a time with their active-word list,
// one warp scans one column at a time, and the occupancy tables skip
// whole output tiles (o_occ) and frontier word blocks (f_occ) before any
// operand word is read.
template <bool kGated>
__global__ void __launch_bounds__(kThreads) packed_sweep_kernel(
    const uint32_t* __restrict__ f, const uint32_t* __restrict__ at,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, const uint8_t* __restrict__ f_occ,
    const uint8_t* __restrict__ o_occ, int n, int W, int rows, int bs,
    int bn, int wk, int step) {
  extern __shared__ uint32_t smem[];
  __shared__ int nact;
  uint32_t* pend = smem;                                 // [bn]
  uint32_t* hits = pend + bn;                            // [bn]
  int* actw = reinterpret_cast<int*>(hits + bn);         // [kChunkWords]
  uint32_t* actu = reinterpret_cast<uint32_t*>(actw + kChunkWords);
  uint32_t* fs = actu + kChunkWords;                     // [rows][kChunkWords]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * bn;
  const int ti = row0 / bs;                              // table row
  const int gj = n / bn, gk = W / wk;
  const bool live = !kGated || o_occ[(size_t)ti * gj + blockIdx.y];

  for (int c = tid; c < bn; c += blockDim.x) {
    pend[c] = 0;
    hits[c] = 0;
  }
  __syncthreads();
  if (live) {
    for (int p = tid; p < rows * bn; p += blockDim.x) {
      const int r = p / bn, c = p % bn;
      if (dist[(size_t)(row0 + r) * n + col0 + c] < 0)
        atomicOr(&pend[c], 1u << r);
    }
    for (int w0 = 0; w0 < W; w0 += kChunkWords) {
      const int cw = min(kChunkWords, W - w0);
      if (tid == 0) nact = 0;
      __syncthreads();
      for (int w = tid; w < cw; w += blockDim.x) {
        const bool gate = !kGated || f_occ[(size_t)ti * gk + (w0 + w) / wk];
        uint32_t u = 0;
        for (int r = 0; r < rows; ++r) {
          const uint32_t v =
              gate ? __ldg(f + (size_t)(row0 + r) * W + w0 + w) : 0u;
          fs[r * kChunkWords + w] = v;
          u |= v;
        }
        if (u) {
          const int k = atomicAdd(&nact, 1);
          actw[k] = w;
          actu[k] = u;
        }
      }
      __syncthreads();
      const int na = nact;
      if (na) {
        for (int c = warp; c < bn; c += nwarps) {
          const uint32_t p = pend[c] & ~hits[c];
          if (!p) continue;
          const uint32_t h = scan_column(at + (size_t)(col0 + c) * W + w0,
                                         fs, kChunkWords, actw, actu, na, p,
                                         lane);
          if (lane == 0 && h) hits[c] |= h;
        }
      }
      __syncthreads();
    }
  }
  // epilogue: new = hit & unreached, dist = step where new
  for (int p = tid; p < rows * bn; p += blockDim.x) {
    const int r = p / bn, c = p % bn;
    const size_t idx = (size_t)(row0 + r) * n + col0 + c;
    const int32_t d = dist[idx];
    const bool nw = ((hits[c] >> r) & 1u) && d < 0;
    new_out[idx] = nw ? 1 : 0;
    dist_out[idx] = nw ? step : d;
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

template <bool kGated>
int launch_packed(const void* f, const void* at, const void* dist,
                  void* new_out, void* dist_out, const void* f_occ,
                  const void* o_occ, int S, int n, int W, int rows, int bs,
                  int bn, int wk, int step, void* stream) {
  const size_t smem =
      sizeof(uint32_t) * (2 * bn + 2 * kChunkWords + rows * kChunkWords);
  cudaError_t err = set_smem(packed_sweep_kernel<kGated>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / rows, n / bn);
  packed_sweep_kernel<kGated><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (const uint32_t*)at, (const int32_t*)dist,
      (int8_t*)new_out, (int32_t*)dist_out, (const uint8_t*)f_occ,
      (const uint8_t*)o_occ, n, W, rows, bs, bn, wk, step);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

int dawn_packed_push_sweep(const void* f, const void* at, const void* dist,
                           void* new_out, void* dist_out, const void* f_occ,
                           const void* o_occ, int S, int n, int W, int rows,
                           int bs, int bn, int wk, int step, void* stream) {
  return launch_packed<true>(f, at, dist, new_out, dist_out, f_occ, o_occ, S,
                             n, W, rows, bs, bn, wk, step, stream);
}

int dawn_packed_pull_sweep(const void* f, const void* at, const void* dist,
                           void* new_out, void* dist_out, int S, int n, int W,
                           int rows, int bs, int bn, int step, void* stream) {
  return launch_packed<false>(f, at, dist, new_out, dist_out, nullptr,
                              nullptr, S, n, W, rows, bs, bn, W, step,
                              stream);
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
