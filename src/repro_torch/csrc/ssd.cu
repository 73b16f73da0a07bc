// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).  Plain C interface,
// loaded with ctypes by repro_torch/kernels/ssd/kernel.py.  All tensors are
// float32 and contiguous:
//
//   x (B, NC, L, H, P)   dt, cum (B, NC, L, H)   Bm, Cm (B, NC, L, N)
//   y (B, NC, L, H, P)   states (B, NC, H, P, N)  (optional: null skips it)
//
// For each batch row b and head h, with S_0 = 0 and chunk k:
//
//   y[l]  = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m      (intra)
//         + exp(cum_l) C_l . S_k                                    (carried)
//   S_k+1 = S_k exp(cum_{L-1}) + sum_l B_l exp(cum_{L-1} - cum_l) dt_l x_l
//
// and states[b, k, h] = S_k, the chunk-entry state.
//
// Replaces the Pallas kernel repro/kernels/ssd/kernel.py::ssd_chunk_scan
// (bodies _ssd_kernel and _ssd_kernel_with_states).
//
// Bound on this card: at the serving slice's shape (B=8, NC=8, L=256, H=24,
// P=64, N=128) the call moves ~221 MB (0.066 ms at 3.35 TB/s) and needs
// ~20 GFLOP for the causal half of each L x L block (0.30 ms at 67 TFLOP/s
// float32), so operations bound it.
//
// Design.  The TPU carries S in VMEM scratch across an ordered grid.  Here
// one block of 256 threads owns one (batch, head) and loops over the chunks
// itself, with S (P x N, at most 64 x 128 floats) resident in shared memory
// for the whole sequence: no carry crosses blocks, so blocks run in any
// order.  A chunk of L=256 cannot be staged whole (B or C alone is 128 KB),
// so the intra-chunk form is tiled 64 x 64: for each query tile of rows l,
// the key tiles m0 <= l0 are visited in order; tiles wholly above the
// diagonal are skipped, and on the diagonal tile the entries m > l are set
// to zero without evaluating exp (cum_l - cum_m is large and positive there
// and would overflow).  Each thread holds a 4 x 4 register tile (rows
// ty + 16 i, columns tx + 16 j) of G = C B^T, then of y; the state update
// holds a 4 x 8 tile of S.  B and C are shared across heads; each head's
// block recomputes C B^T for itself (twice the FLOPs of the W x product at
// P=64, N=128) rather than sharing it across a head tile: a head tile would
// need one S per head in shared memory, which does not fit at P=64, N=128.
//
// Every output element is written once by one thread, with no atomics, so
// two runs give the same bits.  Shared-memory rows of B, C and S have an odd
// stride (N | 1) so the 16 lanes that read 16 different rows hit 16 banks.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // rows of a query or key tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int MAX_L = 256;
constexpr int MAX_P = 64;         // Xs and S are sized for P = 64, zero past P
constexpr int MAX_N = 128;
constexpr int WS = TILE + 1;      // row stride of Ws

__host__ __device__ inline int row_stride(int N) { return N | 1; }

size_t smem_floats(int L, int N) {
  const int ns = row_stride(N);
  return (size_t)2 * TILE * ns      // Cs, Bs
         + (size_t)MAX_P * ns       // S
         + (size_t)TILE * MAX_P     // Xs
         + (size_t)TILE * WS        // Ws
         + 2 * (size_t)L;           // cum, dt of this head in this chunk
}

// Copies `rows` rows of N floats (row stride N in device memory) into shared
// memory with row stride ns; rows in [rows, TILE) are zero.
__device__ inline void load_rows(float* dst, const float* __restrict__ src, int rows, int N,
                                 int ns) {
  for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
    const int r = e / N;
    const int k = e - r * N;
    dst[r * ns + k] = (r < rows) ? src[(size_t)r * N + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ cum, const float* __restrict__ bm,
                      const float* __restrict__ cm, float* __restrict__ y,
                      float* __restrict__ states, int NC, int L, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ns = row_stride(N);
  float* Cs = smem;                  // (TILE, ns)   C rows of the query tile
  float* Bs = Cs + TILE * ns;        // (TILE, ns)   B rows of the key tile
  float* S = Bs + TILE * ns;         // (MAX_P, ns)  carried state S[p][n]
  float* Xs = S + MAX_P * ns;        // (TILE, MAX_P) x rows of the key tile
  float* Ws = Xs + TILE * MAX_P;     // (TILE, WS)   masked weights W[l][m]
  float* cum_s = Ws + TILE * WS;     // (L)
  float* dt_s = cum_s + L;           // (L)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tiles = (L + TILE - 1) / TILE;

  for (int e = tid; e < MAX_P * ns; e += THREADS) S[e] = 0.0f;

  for (int c = 0; c < NC; ++c) {
    const size_t row0 = ((size_t)b * NC + c) * L;  // row (b, c, l = 0) of dt/cum/B/C
    __syncthreads();  // the last chunk's state update is in S; its reads are done
    for (int l = tid; l < L; l += THREADS) {
      cum_s[l] = cum[(row0 + l) * H + h];
      dt_s[l] = dt[(row0 + l) * H + h];
    }
    if (states != nullptr) {
      float* st = states + (((size_t)b * NC + c) * H + h) * P * N;
      for (int e = tid; e < P * N; e += THREADS) st[e] = S[(e / N) * ns + e % N];
    }

    // ---- y for each query tile: intra-chunk form, then the carried state ----
    for (int lt = 0; lt < tiles; ++lt) {
      const int l0 = lt * TILE;
      load_rows(Cs, cm + (row0 + l0) * N, min(TILE, L - l0), N, ns);
      float acc[4][4] = {};
      for (int mt = 0; mt <= lt; ++mt) {  // key tiles above the diagonal are skipped
        const int m0 = mt * TILE;
        const int mrows = min(TILE, L - m0);
        load_rows(Bs, bm + (row0 + m0) * N, mrows, N, ns);
        for (int e = tid; e < TILE * MAX_P; e += THREADS) {
          const int m = e / MAX_P;
          const int p = e - m * MAX_P;
          Xs[e] = (m < mrows && p < P) ? x[((row0 + m0 + m) * H + h) * P + p] : 0.0f;
        }
        __syncthreads();  // Cs, Bs, Xs, cum_s, dt_s are loaded

        float g[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ns + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ns + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + tx + 16 * j;
            // Mask before exp: only m <= l (< L) is evaluated.
            const float w =
                (m <= l && l < L) ? g[i][j] * expf(cum_s[l] - cum_s[m]) * dt_s[m] : 0.0f;
            Ws[(ty + 16 * i) * WS + tx + 16 * j] = w;
          }
        }
        __syncthreads();  // Ws is complete

#pragma unroll 4
        for (int m = 0; m < TILE; ++m) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * WS + m];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[m * MAX_P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
        __syncthreads();  // the next key tile may overwrite Bs, Xs, Ws
      }

      // carried state: y[l][p] += exp(cum_l) * sum_n C[l][n] S[p][n]
      float inter[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ns + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = S[(tx + 16 * j) * ns + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        if (l >= L) continue;
        const float sd = expf(cum_s[l]);
        float* y_row = y + ((row0 + l) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y_row[p] = acc[i][j] + inter[i][j] * sd;
        }
      }
      __syncthreads();  // the next query tile may overwrite Cs
    }

    // ---- state update: S <- S exp(cum_last) + sum_l (indec_l x_l)^T B_l ----
    const float cum_last = cum_s[L - 1];
    float sacc[4][8] = {};  // S[p = ty + 16 i][n = tx + 16 j]
    for (int lt = 0; lt < tiles; ++lt) {
      const int l0 = lt * TILE;
      const int rows = min(TILE, L - l0);
      load_rows(Bs, bm + (row0 + l0) * N, rows, N, ns);
      for (int e = tid; e < TILE * MAX_P; e += THREADS) {
        const int m = e / MAX_P;
        const int p = e - m * MAX_P;
        float v = 0.0f;
        if (m < rows && p < P) {
          const int l = l0 + m;
          v = x[((row0 + l) * H + h) * P + p] * (expf(cum_last - cum_s[l]) * dt_s[l]);
        }
        Xs[e] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int m = 0; m < TILE; ++m) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[m * MAX_P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          bv[j] = (n < N) ? Bs[m * ns + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
      __syncthreads();
    }
    const float cd = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) S[p * ns + n] = S[p * ns + n] * cd + sacc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes above the kernel's limits.  At N = 128 a
// block needs 131 KB of shared memory, so the launch opts in above 48 KB.
int ssd_chunk_scan_fwd(const float* x, const float* dt, const float* cum, const float* bm,
                       const float* cm, float* y, float* states, int B, int NC, int L, int H,
                       int P, int N, void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N || B < 1 || NC < 1 ||
      H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_chunk_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, dt, cum, bm, cm, y,
                                                                      states, NC, L, H, P, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
