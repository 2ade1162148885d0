// Hand-written Hopper (sm_90a) kernels for the counting-semiring sweep
// (shortest-path counting, Brandes stage 1).
//
// Two kernels, one per Pallas kernel of src/repro/kernels/counting/kernel.py.
// The state is the pair (dist int32, sigma float32); the operand is the
// dense (k, n) int8 adjacency, row k = out-neighbours of k.  Every entry
// point is a plain C function that launches on the given stream and
// returns cudaGetLastError(); it allocates nothing.
//
// Exactness.  Path counts are integer-valued floats.  While every partial
// sum stays below 2^24 each add is exact, so any summation order gives the
// bits of the TPU kernel's K-tiled MXU sum.  The sums are taken in plain
// f32 on the CUDA cores: TF32 or fp16 tensor cores keep an 11-bit
// significand, exact only up to 2048 paths.
//
// The operand is the largest input by far (n*n bytes, 4.3 GB at n =
// 65,664) and it is almost all zeros on the graphs DAWN runs: both kernels
// read it in 4- or 16-byte words and spend no arithmetic on a zero word,
// so what bounds them is how much of the operand they must read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // K5: 8 warps
constexpr int kWarpCols = 128;                // K5: 4 columns per lane
constexpr int kBlockCols = kThreads / 32 * kWarpCols;  // 1024
constexpr int kUnrollK = 8;                   // K5: operand rows per batch
constexpr int kFusedThreads = 1024;           // K6
constexpr int kListCap = 4096;                // K6: active k per chunk
constexpr int kChunkBytes = 16;               // K6: operand bytes per load

// K5 fused_counting_sweep.
// Replaces _counting_sweep_kernel of src/repro/kernels/counting/kernel.py.
// Bound: bytes of the live operand tiles.  Each (row tile, k-block) pair
// whose f_occ is set reads bk operand rows across the block's columns;
// at a mid-BFS state almost every k-block is live, so a sweep reads most
// of the 4.3 GB operand, and the useful adds (one per non-zero operand
// byte and row) are few.  Design: one block per (TM source rows, 1,024
// columns); one warp owns one 128-column output tile, so the o_occ skip
// is warp-uniform; the TM x bk frontier-masked sigma of a live k-block
// is staged in shared memory and read as a broadcast; each lane loads one
// 32-bit operand word (4 columns) per k row, eight rows in flight, and
// adds only where a byte is non-zero.  Row tiles are the fastest grid
// index, so the blocks that read the same operand columns run together
// and share them through L2.
template <int TM>
__global__ void __launch_bounds__(kThreads) counting_sweep_kernel(
    const float* __restrict__ fsigma, const int8_t* __restrict__ adj,
    const int32_t* __restrict__ dist, const float* __restrict__ sigma,
    int8_t* __restrict__ new_out, int32_t* __restrict__ dist_out,
    float* __restrict__ sigma_out, const uint8_t* __restrict__ f_occ,
    const uint8_t* __restrict__ o_occ, int n, int k, int bs, int bn, int bk,
    int step) {
  extern __shared__ float fs[];                          // [TM][bk]
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
    for (int b = 0; b < 4; ++b) acc[r][b] = 0.f;

  if (__syncthreads_or(warp_live)) {
    for (int kb = 0; kb < gk; ++kb) {
      if (!f_occ[(size_t)ti * gk + kb]) continue;        // block-uniform
      const int k0 = kb * bk;
      __syncthreads();                                   // stage consumed
      for (int i = tid; i < TM * bk; i += kThreads) {
        const int r = i / bk, c = i % bk;
        fs[i] = fsigma[(size_t)(row0 + r) * k + k0 + c];
      }
      __syncthreads();
      if (!warp_live) continue;
      const int8_t* a = adj + (size_t)k0 * n + col;
      for (int kk = 0; kk < bk; kk += kUnrollK) {
        uint32_t w[kUnrollK];
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u)
          w[u] = __ldg(reinterpret_cast<const uint32_t*>(
              a + (size_t)(kk + u) * n));
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
          if (!w[u]) continue;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float v = (float)(int8_t)((w[u] >> (8 * b)) & 0xffu);
            if (v == 0.f) continue;
#pragma unroll
            for (int r = 0; r < TM; ++r)
              acc[r][b] = fmaf(fs[r * bk + kk + u], v, acc[r][b]);
          }
        }
      }
    }
  }
  if (!in_range) return;
  // epilogue: new = acc > 0 & unreached; dist = step, sigma = acc there
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const size_t idx = (size_t)(row0 + r) * n + col;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int32_t d = dist[idx + b];
      const bool nw = acc[r][b] > 0.f && d < 0;
      new_out[idx + b] = nw ? 1 : 0;
      dist_out[idx + b] = nw ? step : d;
      sigma_out[idx + b] = nw ? acc[r][b] : sigma[idx + b];
    }
  }
}

// K6 fused_counting_multisweep.
// Replaces _fused_counting_kernel of src/repro/kernels/counting/kernel.py.
// Bound: bytes — each sweep must read the operand rows of the frontier,
// in the columns that still hold an unreached target.  The TPU design
// keeps the whole int8 operand on chip; at n = 65,664 it is 4.3 GB, and
// even one 8-row tile of (dist, sigma, frontier) is 4.7 MB, against
// 227 KB of shared memory.  So one block owns R (<= 8) source rows and
// keeps their state in the output buffers in global memory (no other
// block touches those rows, so no grid-wide sync is needed); on chip it
// keeps only the packed unreached set of its rows (R x n/32 words) and a
// list of active k.  Each sweep it
//   1. lists, chunk by chunk, the k where any of its rows' frontier is
//      set, with the mask of those rows;
//   2. streams each listed operand row in 16-byte words (one warp per
//      row), loads only the words that hold an unreached target of a
//      listed row (Thm 3.2), and atomically adds sigma[r, k] into the
//      candidate buffer at every non-zero operand byte;
//   3. runs the epilogue over its rows: new = cand > 0 & unreached,
//      dist = step, sigma = cand there, writes the next frontier into the
//      other frontier buffer (double-buffered), clears the candidates and
//      the found bits, and tests Fact 1 with __syncthreads_or.
// The atomic adds sum integers below 2^24, so their order does not matter.
// Rows evolve independently, so R does not change any result (see
// ref.fused_counting_multisweep_ref).
__global__ void __launch_bounds__(kFusedThreads) fused_counting_kernel(
    const int8_t* frontier, const int8_t* __restrict__ adj,
    const int32_t* __restrict__ dist, const float* __restrict__ sigma,
    int8_t* __restrict__ new_out, int32_t* __restrict__ dist_out,
    float* __restrict__ sigma_out, int8_t* fa, int8_t* fb,
    float* __restrict__ cand,
    int32_t* __restrict__ prod_out, int32_t* __restrict__ stop_out, int n,
    int R, int step0, int n_run) {
  extern __shared__ uint32_t unr[];                      // [R][W]
  __shared__ int list[kListCap];                         // k << 8 | mask
  __shared__ int nlist;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = n >> 5;
  const int nchunks = n / kChunkBytes;
  const int row0 = blockIdx.x * R;
  const size_t base = (size_t)row0 * n;

  // copy the state into the outputs and pack the unreached set
  for (int q = warp; q < R * W; q += nwarps) {
    const size_t idx = base + (size_t)q * 32 + lane;     // q = r * W + w
    const int32_t d = dist[idx];
    dist_out[idx] = d;
    sigma_out[idx] = sigma[idx];
    const uint32_t bits = __ballot_sync(0xffffffffu, d < 0);
    if (lane == 0) unr[q] = bits;
  }
  __syncthreads();

  const int8_t* cur = frontier + base;
  int8_t* bufs[2] = {fa + base, fb + base};
  int wi = 0;                                            // buffer written next
  float* cnd = cand + base;
  int prod = 0, done = 0;
  for (int t = 0; t < n_run; ++t) {
    // 1-2. scatter the frontier's path counts, one chunk of k at a time
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
        float fsr[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          fsr[r] = (r < R && ((mask >> r) & 1))
                       ? sigma_out[(size_t)(row0 + r) * n + kk] : 0.f;
        const uint4* arow =
            reinterpret_cast<const uint4*>(adj + (size_t)kk * n);
        for (int c = lane; c < nchunks; c += 32) {
          // unreached targets of the listed rows in these 16 columns
          uint32_t open[8];
          uint32_t any = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            open[r] = (r < R && ((mask >> r) & 1))
                          ? (unr[r * W + (c >> 1)] >> ((c & 1) * 16)) & 0xffffu
                          : 0u;
            any |= open[r];
          }
          if (!any) continue;
          const uint4 v = __ldg(arow + c);
          const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!words[q]) continue;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int bit = q * 4 + b;
              if (!((any >> bit) & 1u)) continue;
              const float a = (float)(int8_t)((words[q] >> (8 * b)) & 0xffu);
              if (a == 0.f) continue;
              const int j = c * kChunkBytes + bit;
#pragma unroll
              for (int r = 0; r < 8; ++r)
                if ((open[r] >> bit) & 1u)
                  atomicAdd(&cnd[(size_t)r * n + j], fsr[r] * a);
            }
          }
        }
      }
      __syncthreads();
    }
    // 3. epilogue over the block's rows; Fact 1 per block
    const int32_t dnew = step0 + 1 + t;
    int8_t* nxt = bufs[wi];
    int mine = 0;
    for (int q = warp; q < R * W; q += nwarps) {
      const size_t idx = (size_t)q * 32 + lane;
      const uint32_t pend = unr[q];
      bool nw = false;
      if ((pend >> lane) & 1u) {
        const float c = cnd[idx];
        if (c != 0.f) cnd[idx] = 0.f;
        nw = c > 0.f;
        if (nw) {
          dist_out[base + idx] = dnew;
          sigma_out[base + idx] = c;
        }
      }
      nxt[idx] = nw ? 1 : 0;
      const uint32_t found = __ballot_sync(0xffffffffu, nw);
      if (found) {
        mine = 1;
        if (lane == 0) unr[q] = pend & ~found;
      }
    }
    if (!__syncthreads_or(mine)) {
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
  for (int i = tid; i < R * n; i += blockDim.x)
    new_out[base + i] = keep ? cur[i] : (int8_t)0;
  if (tid == 0) {
    prod_out[blockIdx.x] = prod;
    stop_out[blockIdx.x] = done;
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
int launch_counting(const void* fs, const void* adj, const void* dist,
                    const void* sigma, void* new_out, void* dist_out,
                    void* sigma_out, const void* f_occ, const void* o_occ,
                    int S, int n, int k, int bs, int bn, int bk, int step,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * TM * bk;
  cudaError_t err = set_smem(counting_sweep_kernel<TM>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / TM, (n + kBlockCols - 1) / kBlockCols);
  counting_sweep_kernel<TM><<<grid, kThreads, smem, stream>>>(
      (const float*)fs, (const int8_t*)adj, (const int32_t*)dist,
      (const float*)sigma, (int8_t*)new_out, (int32_t*)dist_out,
      (float*)sigma_out, (const uint8_t*)f_occ, (const uint8_t*)o_occ, n, k,
      bs, bn, bk, step);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tm` source rows per block (16, 8, 4, 2 or 1, dividing bs); bn a
// multiple of 128, bk a multiple of 8.
int dawn_counting_sweep(const void* fs, const void* adj, const void* dist,
                        const void* sigma, void* new_out, void* dist_out,
                        void* sigma_out, const void* f_occ, const void* o_occ,
                        int S, int n, int k, int tm, int bs, int bn, int bk,
                        int step, void* stream) {
  if (bn % kWarpCols || bk % kUnrollK || bs % tm || S % tm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tm) {
    case 16:
      return launch_counting<16>(fs, adj, dist, sigma, new_out, dist_out,
                                 sigma_out, f_occ, o_occ, S, n, k, bs, bn, bk,
                                 step, st);
    case 8:
      return launch_counting<8>(fs, adj, dist, sigma, new_out, dist_out,
                                sigma_out, f_occ, o_occ, S, n, k, bs, bn, bk,
                                step, st);
    case 4:
      return launch_counting<4>(fs, adj, dist, sigma, new_out, dist_out,
                                sigma_out, f_occ, o_occ, S, n, k, bs, bn, bk,
                                step, st);
    case 2:
      return launch_counting<2>(fs, adj, dist, sigma, new_out, dist_out,
                                sigma_out, f_occ, o_occ, S, n, k, bs, bn, bk,
                                step, st);
    case 1:
      return launch_counting<1>(fs, adj, dist, sigma, new_out, dist_out,
                                sigma_out, f_occ, o_occ, S, n, k, bs, bn, bk,
                                step, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `rows` source rows per block (1..8, dividing S); `smem` the block's
// dynamic shared-memory bytes (the packed unreached set, rows * n / 8).
// fa, fb: (S, n) int8 frontier buffers; cand: (S, n) float32, zeroed.
int dawn_fused_counting_multisweep(const void* frontier, const void* adj,
                                   const void* dist, const void* sigma,
                                   void* new_out, void* dist_out,
                                   void* sigma_out, void* fa, void* fb,
                                   void* cand, void* prod, void* stop, int S,
                                   int n, int rows, int smem, int step0,
                                   int n_run, void* stream) {
  if (rows < 1 || rows > 8 || S % rows || n % 128 || n >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  // the active-k list is static shared memory: opt in above 48 KB in all
  cudaError_t err = cudaFuncSetAttribute(
      fused_counting_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  fused_counting_kernel<<<S / rows, kFusedThreads, smem,
                          (cudaStream_t)stream>>>(
      (const int8_t*)frontier, (const int8_t*)adj, (const int32_t*)dist,
      (const float*)sigma, (int8_t*)new_out, (int32_t*)dist_out,
      (float*)sigma_out, (int8_t*)fa, (int8_t*)fb, (float*)cand,
      (int32_t*)prod, (int32_t*)stop, n, rows, step0, n_run);
  return (int)cudaGetLastError();
}

}  // extern "C"
