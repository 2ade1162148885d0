// Hand-written Hopper (sm_90a) kernels for the tropical (min,+) sweep, the
// weighted engine's hot path.
//
// Three kernels, one per Pallas kernel of src/repro/kernels/tropical/kernel.py.
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

constexpr int kThreads = 256;                 // K7: 8 warps
constexpr int kWarpCols = 128;                // K7: 4 columns per lane
constexpr int kBlockCols = kThreads / 32 * kWarpCols;  // 1024
constexpr int kUnrollK = 8;                   // K7: operand rows per batch
constexpr int kFusedThreads = 1024;           // K8
constexpr int kListCap = 4096;                // K8: active k per chunk
constexpr int kBitsThreads = 256;             // K8 first pass
constexpr int kRelaxThreads = 256;            // K9
constexpr int32_t kInfBits = 0x7f800000;      // +inf as int32

__device__ __forceinline__ float inf_f() { return __int_as_float(kInfBits); }

// K7 fused_minplus_sweep.
// Replaces _minplus_sweep_kernel of src/repro/kernels/tropical/kernel.py.
// Bound: bytes of the live operand tiles.  Each (row tile, k-block) pair
// whose f_occ is set reads bk operand rows across the block's columns in
// float32, 4x the bytes of the int8 counting operand; the useful work (one
// add and one min per row and finite weight) is tiny beside it.  Design:
// K5's.  One block per (TM source rows, 1,024 columns); one warp owns one
// 128-column output tile, so the settled-bound o_occ skip is warp-uniform;
// the TM x bk frontier distances of a live k-block are staged in shared
// memory and read as a broadcast; each lane loads one 16-byte word (4
// columns) per k row, eight rows in flight, and spends no arithmetic on a
// word whose four weights are +inf.  A skipped tile keeps its +inf
// accumulator, so the epilogue leaves dist as it was and writes new = 0.
template <int TM>
__global__ void __launch_bounds__(kThreads) minplus_sweep_kernel(
    const float* __restrict__ fdist, const float* __restrict__ w,
    const float* __restrict__ dist, int8_t* __restrict__ new_out,
    float* __restrict__ dist_out, const uint8_t* __restrict__ f_occ,
    const uint8_t* __restrict__ o_occ, int n, int k, int bs, int bn,
    int bk) {
  extern __shared__ float fs[];                          // [TM][bk]
  const float inf = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int wcol0 = blockIdx.y * kBlockCols + warp * kWarpCols;
  const bool in_range = wcol0 < n;
  const int ti = row0 / bs;
  const int gj = n / bn, gk = k / bk;
  const bool warp_live =
      in_range && o_occ[(size_t)ti * gj + wcol0 / bn] != 0;
  const int col = wcol0 + lane * 4;

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[r][b] = inf;

  if (__syncthreads_or(warp_live)) {
    for (int kb = 0; kb < gk; ++kb) {
      if (!f_occ[(size_t)ti * gk + kb]) continue;        // block-uniform
      const int k0 = kb * bk;
      __syncthreads();                                   // stage consumed
      for (int i = tid; i < TM * bk; i += kThreads) {
        const int r = i / bk, c = i % bk;
        fs[i] = fdist[(size_t)(row0 + r) * k + k0 + c];
      }
      __syncthreads();
      if (!warp_live) continue;
      const float* wp = w + (size_t)k0 * n + col;
      for (int kk = 0; kk < bk; kk += kUnrollK) {
        float4 v[kUnrollK];
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              wp + (size_t)(kk + u) * n));
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
          if (v[u].x == inf && v[u].y == inf && v[u].z == inf &&
              v[u].w == inf)
            continue;
          const float wv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float f = fs[r * bk + kk + u];
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[r][b] = fminf(acc[r][b], __fadd_rn(f, wv[b]));
          }
        }
      }
    }
  }
  if (!in_range) return;
  // epilogue: new = cand < dist; dist = cand there
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const size_t idx = (size_t)(row0 + r) * n + col;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float d = dist[idx + b];
      const bool nw = acc[r][b] < d;
      new_out[idx + b] = nw ? 1 : 0;
      dist_out[idx + b] = nw ? acc[r][b] : d;
    }
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int TM>
int launch_minplus(const void* fdist, const void* w, const void* dist,
                   void* new_out, void* dist_out, const void* f_occ,
                   const void* o_occ, int S, int n, int k, int bs, int bn,
                   int bk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * TM * bk;
  cudaError_t err = set_smem(minplus_sweep_kernel<TM>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / TM, (n + kBlockCols - 1) / kBlockCols);
  minplus_sweep_kernel<TM><<<grid, kThreads, smem, stream>>>(
      (const float*)fdist, (const float*)w, (const float*)dist,
      (int8_t*)new_out, (float*)dist_out, (const uint8_t*)f_occ,
      (const uint8_t*)o_occ, n, k, bs, bn, bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tm` source rows per block (16, 8, 4, 2 or 1, dividing bs); bn a
// multiple of 128, bk a multiple of 8.  f_occ (S/bs, k/bk) and o_occ
// (S/bs, n/bn) are one byte per tile.
int dawn_minplus_sweep(const void* fdist, const void* w, const void* dist,
                       void* new_out, void* dist_out, const void* f_occ,
                       const void* o_occ, int S, int n, int k, int tm,
                       int bs, int bn, int bk, void* stream) {
  if (bn % kWarpCols || bk % kUnrollK || bs % tm || S % tm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tm) {
    case 16:
      return launch_minplus<16>(fdist, w, dist, new_out, dist_out, f_occ,
                                o_occ, S, n, k, bs, bn, bk, st);
    case 8:
      return launch_minplus<8>(fdist, w, dist, new_out, dist_out, f_occ,
                               o_occ, S, n, k, bs, bn, bk, st);
    case 4:
      return launch_minplus<4>(fdist, w, dist, new_out, dist_out, f_occ,
                               o_occ, S, n, k, bs, bn, bk, st);
    case 2:
      return launch_minplus<2>(fdist, w, dist, new_out, dist_out, f_occ,
                               o_occ, S, n, k, bs, bn, bk, st);
    case 1:
      return launch_minplus<1>(fdist, w, dist, new_out, dist_out, f_occ,
                               o_occ, S, n, k, bs, bn, bk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
