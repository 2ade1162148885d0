// Hand-written Hopper (sm_90a) kernels for the boolean DAWN sweep.
//
// Four kernels, one per Pallas kernel of src/repro/kernels/bovm/kernel.py.
// Packed words arrive as int32 tensors carrying the uint32 bit pattern
// (node 32*w + b is bit b of word w) and are read here as uint32_t.
// Every entry point is a plain C function that launches on the given
// stream and returns cudaGetLastError(); it allocates nothing.
//
// The packed sweeps share one device routine, scan_column: a warp tests
// one target column j against the packed frontier rows of its tile.  It
// reads only the in-neighbour words of j where the tile's frontier has a
// bit set (a compacted list of active words, built per tile in shared
// memory), tests only rows for which j is still unreached (Thm 3.2), and
// stops at the first round in which every such row has hit.  The operand
// (n, W) is the largest input by far (n*n/8 bytes); what bounds these
// kernels is how much of it they must read, and the active-word list
// makes that read proportional to the frontier instead of to n*n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // per-sweep kernels (K1, K2, K4)
constexpr int kChunkWords = 256;     // frontier words staged per pass (K1/K2)
constexpr int kFusedThreads = 1024;  // K3
constexpr int kGemmCols = 64;        // K4 output columns per block
constexpr int kGemmK = 32;           // K4 contraction bytes per stage

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
// whole operand on chip; at n = 65,664 it is 539 MB, far beyond 227 KB of
// shared memory, so here one block owns `rows` (<= 32) source rows and
// keeps only their state on chip: the current and next packed frontier,
// the packed visited set and the active-word list, streaming the operand
// from L2/HBM every sweep.  The caller chooses `rows` and sizes the
// shared memory for this layout (fused_smem_bytes in ../kernel.py).  The
// next frontier is built with shared-memory atomicOr, the Fact-1 check is
// a __syncthreads_or, and distances are written straight to dist_out as
// they are found.  Rows evolve independently, so the tile size does not
// change any result (see ref.fused_boolean_multisweep_ref).
__global__ void __launch_bounds__(kFusedThreads) fused_boolean_kernel(
    const uint32_t* __restrict__ fp, const uint32_t* __restrict__ at,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, int32_t* __restrict__ prod_out,
    int32_t* __restrict__ stop_out, int n, int W, int R, int step0,
    int n_run) {
  extern __shared__ uint32_t smem[];
  __shared__ int nact;
  uint32_t* cur = smem;                                  // [R][W]
  uint32_t* nxt = cur + R * W;                           // [R][W]
  uint32_t* vis = nxt + R * W;                           // [R][W]
  int* actw = reinterpret_cast<int*>(vis + R * W);       // [W]
  uint32_t* actu = reinterpret_cast<uint32_t*>(actw + W);  // [W]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row0 = blockIdx.x * R;

  for (int i = tid; i < R * W; i += blockDim.x)
    cur[i] = fp[(size_t)row0 * W + i];
  // copy dist -> dist_out and pack the visited set, one word per warp step
  for (int q = warp; q < R * W; q += nwarps) {
    const int r = q / W, w = q % W;
    const size_t idx = (size_t)(row0 + r) * n + (size_t)w * 32 + lane;
    const int32_t d = dist[idx];
    dist_out[idx] = d;
    const uint32_t bits = __ballot_sync(kFull, d >= 0);
    if (lane == 0) vis[q] = bits;
  }

  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    if (tid == 0) nact = 0;
    __syncthreads();
    for (int w = tid; w < W; w += blockDim.x) {
      uint32_t u = 0;
      for (int r = 0; r < R; ++r) {
        u |= cur[r * W + w];
        nxt[r * W + w] = 0;
      }
      if (u) {
        const int k = atomicAdd(&nact, 1);
        actw[k] = w;
        actu[k] = u;
      }
    }
    __syncthreads();
    const int na = nact;
    const int32_t dnew = step0 + 1 + t;
    if (na) {
      for (int j = warp; j < n; j += nwarps) {
        const int wj = j >> 5;
        const uint32_t bj = 1u << (j & 31);
        uint32_t pend = 0;
        for (int r = 0; r < R; ++r)
          if (!(vis[r * W + wj] & bj)) pend |= 1u << r;
        if (!pend) continue;
        const uint32_t h = scan_column(at + (size_t)j * W, cur, W, actw,
                                       actu, na, pend, lane);
        if (lane < R && ((h >> lane) & 1u)) {
          dist_out[(size_t)(row0 + lane) * n + j] = dnew;
          atomicOr(&nxt[lane * W + wj], bj);
        }
      }
    }
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < R * W; i += blockDim.x) {
      const uint32_t v = nxt[i];
      if (v) {
        mine = 1;
        vis[i] |= v;
      }
    }
    if (!__syncthreads_or(mine)) {
      done = 1;
      break;
    }
    ++prod;
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // new = the last sweep's discoveries; zeros after a sweep that found
  // nothing (Fact 1) or when no sweep ran
  const bool keep = !done && n_run > 0;
  for (int i = tid; i < R * n; i += blockDim.x) {
    const int r = i / n, j = i % n;
    const int8_t v = keep ? (int8_t)((cur[r * W + (j >> 5)] >> (j & 31)) & 1u)
                          : (int8_t)0;
    new_out[(size_t)(row0 + r) * n + j] = v;
  }
  if (tid == 0) {
    prod_out[blockIdx.x] = prod;
    stop_out[blockIdx.x] = done;
  }
}

// K4 fused_sweep (the push_f32 control).
// Replaces _fused_sweep_kernel of src/repro/kernels/bovm/kernel.py.
// Bound: operations on the dense int8 product when the frontier is dense,
// else bytes of the (k, n) int8 operand.  Design: a plain tiled int8
// GEMM on the CUDA cores — a (tm x 64) output tile per block, 32-byte
// contraction stages through shared memory (the operand stage stored
// transposed so each thread reads one packed column word), __dp4a with
// int32 accumulation (exact, where the TPU kernel sums 0/1 products in
// f32), and the same f_occ / o_occ tile skip and epilogue.
template <int kRowsPerThread>
__global__ void __launch_bounds__(kThreads) int8_sweep_kernel(
    const int8_t* __restrict__ f, const int8_t* __restrict__ a,
    const int32_t* __restrict__ dist, int8_t* __restrict__ new_out,
    int32_t* __restrict__ dist_out, const uint8_t* __restrict__ f_occ,
    const uint8_t* __restrict__ o_occ, int n, int k, int bs, int bn, int bk,
    int step) {
  constexpr int kGroups = kThreads / kGemmCols;          // 4 row groups
  constexpr int TM = kRowsPerThread * kGroups;
  constexpr int KW = kGemmK / 4;                         // words per stage
  __shared__ int32_t fs[TM][KW];
  __shared__ int32_t as[kGemmCols][KW + 1];

  const int tid = threadIdx.x;
  const int col = tid % kGemmCols, rg = tid / kGemmCols;
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * kGemmCols;
  const int ti = row0 / bs, tj = col0 / bn;
  const int gj = n / bn, gk = k / bk;
  int acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0;

  if (o_occ[(size_t)ti * gj + tj]) {
    for (int kb = 0; kb < gk; ++kb) {
      if (!f_occ[(size_t)ti * gk + kb]) continue;
      for (int k0 = kb * bk; k0 < (kb + 1) * bk; k0 += kGemmK) {
        for (int i = tid; i < TM * KW; i += kThreads) {
          const int r = i / KW, q = i % KW;
          fs[r][q] = *reinterpret_cast<const int32_t*>(
              f + (size_t)(row0 + r) * k + k0 + q * 4);
        }
        for (int i = tid; i < kGemmK * (kGemmCols / 4); i += kThreads) {
          const int kk = i / (kGemmCols / 4), cq = i % (kGemmCols / 4);
          const int32_t v = *reinterpret_cast<const int32_t*>(
              a + (size_t)(k0 + kk) * n + col0 + cq * 4);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            reinterpret_cast<int8_t*>(&as[cq * 4 + b][kk / 4])[kk % 4] =
                (int8_t)(v >> (8 * b));
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < KW; ++q) {
          const int av = as[col][q];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i] = __dp4a(fs[rg * kRowsPerThread + i][q], av, acc[i]);
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const size_t idx =
        (size_t)(row0 + rg * kRowsPerThread + i) * n + col0 + col;
    const int32_t d = dist[idx];
    const bool nw = acc[i] > 0 && d < 0;
    new_out[idx] = nw ? 1 : 0;
    dist_out[idx] = nw ? step : d;
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

// `rows` source rows per block (1..32, dividing S); `smem` the block's
// shared-memory bytes for that tile.
int dawn_fused_boolean_multisweep(const void* fp, const void* at,
                                  const void* dist, void* new_out,
                                  void* dist_out, void* prod, void* stop,
                                  int S, int n, int W, int rows, int smem,
                                  int step0, int n_run, void* stream) {
  if (rows < 1 || rows > 32 || S % rows) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(fused_boolean_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  fused_boolean_kernel<<<S / rows, kFusedThreads, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)fp, (const uint32_t*)at, (const int32_t*)dist,
      (int8_t*)new_out, (int32_t*)dist_out, (int32_t*)prod, (int32_t*)stop,
      n, W, rows, step0, n_run);
  return (int)cudaGetLastError();
}

int dawn_fused_sweep(const void* f, const void* a, const void* dist,
                     void* new_out, void* dist_out, const void* f_occ,
                     const void* o_occ, int S, int n, int k, int tm, int bs,
                     int bn, int bk, int step, void* stream) {
  if (bn % kGemmCols || bk % kGemmK || S % tm)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S / tm, n / kGemmCols);
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* f8 = (const int8_t*)f;
  const int8_t* a8 = (const int8_t*)a;
  const int32_t* d = (const int32_t*)dist;
  int8_t* nw = (int8_t*)new_out;
  int32_t* dout = (int32_t*)dist_out;
  const uint8_t* fo = (const uint8_t*)f_occ;
  const uint8_t* oo = (const uint8_t*)o_occ;
  switch (tm) {
    case 32:
      int8_sweep_kernel<8><<<grid, kThreads, 0, st>>>(f8, a8, d, nw, dout, fo,
                                                       oo, n, k, bs, bn, bk,
                                                       step);
      break;
    case 16:
      int8_sweep_kernel<4><<<grid, kThreads, 0, st>>>(f8, a8, d, nw, dout, fo,
                                                       oo, n, k, bs, bn, bk,
                                                       step);
      break;
    case 8:
      int8_sweep_kernel<2><<<grid, kThreads, 0, st>>>(f8, a8, d, nw, dout, fo,
                                                       oo, n, k, bs, bn, bk,
                                                       step);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
