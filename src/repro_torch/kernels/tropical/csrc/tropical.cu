// Hand-written Hopper (sm_90a) kernels for the tropical (min,+) sweep, the
// weighted engine's hot path.
//
// Three kernels, one per Pallas kernel of src/repro/kernels/tropical/kernel.py,
// and the builder of the dense operand's live-word index that K7 reads.
// The state is dist (S, n) float32 with +inf for "no path yet"; the dense
// operand is W (k, n) float32 with +inf for a non-edge, row k = the
// out-edges of k; the sparse operand is the CSR lane arrays.  Every entry
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
constexpr int kFusedThreads = 1024;           // K8
constexpr int kListCap = 4096;                // K8: active k per chunk
constexpr int kBitsThreads = 256;             // K8 first pass
constexpr int kRelaxThreads = 256;            // K9
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

// K8, first pass: one bit per 16-byte operand word that holds a finite
// weight (bit b of word q of row k covers W[k, 4 (32 q + b) .. + 4]).
// One block per operand row; one warp tests 32 words and ballots.  It
// reads the operand once (17.2 GB at n = 65,664, ~5 ms at the HBM rate).
__global__ void __launch_bounds__(kBitsThreads) finite_words_kernel(
    const float4* __restrict__ w, uint32_t* __restrict__ bits, int n4,
    int bw) {
  const float inf = inf_f();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float4* row = w + (size_t)blockIdx.x * n4;
  for (int q = warp; q < bw; q += nwarps) {
    const int i = q * 32 + lane;
    bool live = false;
    if (i < n4) {
      const float4 v = __ldg(row + i);
      live = v.x != inf || v.y != inf || v.z != inf || v.w != inf;
    }
    const uint32_t m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) bits[(size_t)blockIdx.x * bw + q] = m;
  }
}

// K8 fused_minplus_multisweep.
// Replaces _fused_minplus_kernel of src/repro/kernels/tropical/kernel.py.
// Bound: bytes — each sweep must read, for every source row, the operand
// rows of its frontier.  The TPU design keeps the whole (n, n) float32
// operand on chip; at n = 65,664 it is 17.2 GB, against 227 KB of shared
// memory.  So, as in K6, one block owns R (<= 8) source rows and keeps
// their state in the output buffers in global memory (no other block
// touches those rows, so no grid-wide sync is needed), with only a list of
// active k on chip.  Unlike counting, no target is ever settled by a mask,
// so a listed operand row would have to be read whole (256 KB at full
// width, for every frontier entry of every sweep).  Instead the first pass
// above marks the 16-byte words that hold a finite weight, and a listed
// row costs its n / 32 bytes of bits plus its finite words.  Each sweep it
//   1. lists, chunk by chunk, the k where any of its rows' frontier is
//      set, with the mask of those rows;
//   2. walks each listed row's bits (one warp per row), loads each finite
//      word, and for every listed source row r with a finite dist[r, k]
//      atomically mins the candidate dist[r, k] + W[k, j] into the
//      candidate buffer where it beats dist[r, j] (int32 atomicMin on the
//      float bits: order-preserving for +0.0 .. +inf);
//   3. runs the epilogue over its rows: new = cand < dist, dist = cand
//      there, writes the next frontier into the other frontier buffer
//      (double-buffered), resets the candidates to +inf, and tests Fact 1
//      with __syncthreads_or.
// Rows evolve independently, so R does not change any result (see
// ref.fused_minplus_multisweep_ref).
__global__ void __launch_bounds__(kFusedThreads) fused_minplus_kernel(
    const int8_t* frontier, const float* __restrict__ w,
    const uint32_t* __restrict__ wbits, const float* __restrict__ dist,
    int8_t* __restrict__ new_out, float* dist_out, int8_t* fa, int8_t* fb,
    int32_t* cand, int32_t* __restrict__ prod_out,
    int32_t* __restrict__ stop_out, int n, int R, int n_run) {
  __shared__ int list[kListCap];                         // k << 8 | mask
  __shared__ int nlist;

  const float inf = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bw = n >> 7;                                 // bit words per row
  const int row0 = blockIdx.x * R;
  const size_t base = (size_t)row0 * n;
  float* dout = dist_out + base;
  int32_t* cnd = cand + base;

  for (int i = tid; i < R * n; i += blockDim.x) dout[i] = dist[base + i];
  __syncthreads();

  const int8_t* cur = frontier + base;
  int8_t* bufs[2] = {fa + base, fb + base};
  int wi = 0;                                            // buffer written next
  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    // 1-2. relax the frontier's operand rows, one chunk of k at a time
    for (int k0 = 0; k0 < n; k0 += kListCap) {
      if (tid == 0) nlist = 0;
      __syncthreads();
      const int kend = min(n, k0 + kListCap);
      for (int kk = k0 + tid; kk < kend; kk += blockDim.x) {
        int mask = 0;
        for (int r = 0; r < R; ++r)
          if (cur[(size_t)r * n + kk]) mask |= 1 << r;
        if (mask) list[atomicAdd(&nlist, 1)] = (kk << 8) | mask;
      }
      __syncthreads();
      const int na = nlist;
      for (int i = warp; i < na; i += nwarps) {
        const int kk = list[i] >> 8, mask = list[i] & 0xff;
        float fd[8];
        bool any = false;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          fd[r] = (r < R && ((mask >> r) & 1)) ? dout[(size_t)r * n + kk]
                                               : inf;
          any |= fd[r] != inf;
        }
        if (!any) continue;                              // warp-uniform
        const float4* wrow =
            reinterpret_cast<const float4*>(w + (size_t)kk * n);
        const uint32_t* brow = wbits + (size_t)kk * bw;
        for (int q = lane; q < bw; q += 32) {
          uint32_t m = brow[q];
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            const int c4 = q * 32 + b;
            const float4 v = __ldg(wrow + c4);
            const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (wv[e] == inf) continue;
              const int j = c4 * 4 + e;
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                if (fd[r] == inf) continue;
                const float c = __fadd_rn(fd[r], wv[e]);
                const size_t idx = (size_t)r * n + j;
                if (c < dout[idx]) atomicMin(&cnd[idx], __float_as_int(c));
              }
            }
          }
        }
      }
      __syncthreads();
    }
    // 3. epilogue over the block's rows; Fact 1 per block
    int8_t* nxt = bufs[wi];
    int mine = 0;
    for (int i = tid; i < R * n; i += blockDim.x) {
      const int32_t cb = cnd[i];
      bool nw = false;
      if (cb != kInfBits) {
        cnd[i] = kInfBits;
        const float c = __int_as_float(cb);
        if (c < dout[i]) {
          dout[i] = c;
          nw = true;
        }
      }
      nxt[i] = nw ? 1 : 0;
      mine |= nw;
    }
    if (!__syncthreads_or(mine)) {
      done = 1;
      break;
    }
    ++prod;
    cur = nxt;
    wi ^= 1;
  }
  // new = the last sweep's improvements; zeros after a sweep that found
  // nothing (Fact 1) or when no sweep ran
  const bool keep = !done && n_run > 0;
  for (int i = tid; i < R * n; i += blockDim.x)
    new_out[base + i] = keep ? cur[i] : (int8_t)0;
  if (tid == 0) {
    prod_out[blockIdx.x] = prod;
    stop_out[blockIdx.x] = done;
  }
}

// K9 sparse_relax_sweep, first pass.
// Replaces _sparse_relax_kernel of src/repro/kernels/tropical/kernel.py.
// Bound: bytes — the frontier, the state in and out, and the CSR lanes
// of the nodes in any row's frontier.  The TPU kernel relaxes every lane
// for every row and masks; here one warp takes 32 consecutive nodes u of
// one row s, ballots which are in the frontier, and for each walks u's
// out-lanes indptr[u] .. indptr[u + 1] (lanes in CSR order) lane-strided:
// the candidate dist[s, u] + w[e] is atomically min'd into acc[s, dst[e]]
// (int32 atomicMin on the float bits, acc initialised to +inf) where it
// beats dist[s, dst[e]].  Lanes of nodes outside the frontier are never
// read.
__global__ void __launch_bounds__(kRelaxThreads) sparse_relax_kernel(
    const int8_t* __restrict__ frontier, const float* __restrict__ dist,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ dst,
    const float* __restrict__ w, int32_t* __restrict__ acc, int S, int n) {
  const float inf = inf_f();
  const int lane = threadIdx.x & 31;
  const size_t gw = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int wpr = (n + 31) >> 5;                         // warps per row
  if (gw >= (size_t)S * wpr) return;                     // warp-uniform
  const int s = (int)(gw / wpr);
  const int u0 = (int)(gw % wpr) * 32;
  const size_t rowb = (size_t)s * n;
  const int u = u0 + lane;
  const bool act = u < n && frontier[rowb + u] != 0;
  uint32_t mask = __ballot_sync(0xffffffffu, act);
  while (mask) {
    const int b = __ffs(mask) - 1;
    mask &= mask - 1;
    const int uu = u0 + b;
    const float du = dist[rowb + uu];
    if (du == inf) continue;                             // warp-uniform
    const int end = indptr[uu + 1];
    for (int e = indptr[uu] + lane; e < end; e += 32) {
      const float c = __fadd_rn(du, w[e]);
      const int j = dst[e];
      if (c < dist[rowb + j]) atomicMin(acc + rowb + j, __float_as_int(c));
    }
  }
}

// K9, second pass: new = acc < dist, dist = acc there.
__global__ void __launch_bounds__(kRelaxThreads) relax_epilogue_kernel(
    const float* __restrict__ dist, const int32_t* __restrict__ acc,
    int8_t* __restrict__ new_out, float* __restrict__ dist_out,
    size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const float a = __int_as_float(acc[i]);
    const float d = dist[i];
    const bool nw = a < d;
    new_out[i] = nw ? 1 : 0;
    dist_out[i] = nw ? a : d;
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

// `rows` source rows per block (1..8, dividing S); n a multiple of 128.
// wbits: (n, n / 128) uint32 scratch; fa, fb: (S, n) int8 frontier
// buffers; cand: (S, n) int32 holding the bits of +inf.
int dawn_fused_minplus_multisweep(const void* frontier, const void* w,
                                  void* wbits, const void* dist,
                                  void* new_out, void* dist_out, void* fa,
                                  void* fb, void* cand, void* prod,
                                  void* stop, int S, int n, int rows,
                                  int n_run, void* stream) {
  if (rows < 1 || rows > 8 || S % rows || n % 128 || n >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n4 = n / 4, bw = n / 128;
  finite_words_kernel<<<n, kBitsThreads, 0, st>>>(
      (const float4*)w, (uint32_t*)wbits, n4, bw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_minplus_kernel<<<S / rows, kFusedThreads, 0, st>>>(
      (const int8_t*)frontier, (const float*)w, (const uint32_t*)wbits,
      (const float*)dist, (int8_t*)new_out, (float*)dist_out, (int8_t*)fa,
      (int8_t*)fb, (int32_t*)cand, (int32_t*)prod, (int32_t*)stop, n, rows,
      n_run);
  return (int)cudaGetLastError();
}

// indptr: (n + 1,) int32 lane offsets of each node's out-lanes, dst / w:
// the lanes in that order; acc: (S, n) int32 holding the bits of +inf.
int dawn_sparse_relax(const void* frontier, const void* dist,
                      const void* indptr, const void* dst, const void* w,
                      void* acc, void* new_out, void* dist_out, int S, int n,
                      void* stream) {
  if (S < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t warps = (size_t)S * ((n + 31) / 32);
  const size_t blocks = (warps * 32 + kRelaxThreads - 1) / kRelaxThreads;
  sparse_relax_kernel<<<(unsigned)blocks, kRelaxThreads, 0, st>>>(
      (const int8_t*)frontier, (const float*)dist, (const int32_t*)indptr,
      (const int32_t*)dst, (const float*)w, (int32_t*)acc, S, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)S * n;
  size_t eblocks = (total + kRelaxThreads - 1) / kRelaxThreads;
  if (eblocks > 132 * 32) eblocks = 132 * 32;
  relax_epilogue_kernel<<<(unsigned)eblocks, kRelaxThreads, 0, st>>>(
      (const float*)dist, (const int32_t*)acc, (int8_t*)new_out,
      (float*)dist_out, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
