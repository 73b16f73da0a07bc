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


// ===========================================================================
// Backward
// ===========================================================================
//
// Replaces the Pallas kernel repro/kernels/ssd/kernel.py::ssd_chunk_scan_bwd
// (body _ssd_bwd_kernel).  From the entry states S_k that the forward wrote
// and the cotangent dy, one reverse pass over the chunks gives
// (dx, ddt, dcum, dB, dC); cum is an input of its own, so dcum is returned
// and the caller's cumsum carries it on to dt and A.  With
//
//   G[l][m] = C_l . B_m,   decay[l][m] = exp(cum_l - cum_m) (m <= l, else 0),
//   W = G decay dt_m,   dW[l][m] = dy_l . x_m,   Q = dW G decay,
//   indec_l = exp(cum_last - cum_l) dt_l,   and dS the cotangent of S_k+1,
//
// each head of chunk k contributes
//
//   dx_m   = sum_l W[l][m] dy_l                        + indec_m (dS B_m)
//   ddt_m  = sum_l Q[l][m]                             + g_m exp(cum_last - cum_m)
//   dcum_l = sum_m Q[l][m] dt_m - dt_l sum_m Q[m][l]   + e_l C_l . (dy_l S_k)
//            - g_l indec_l  (+ the last row's term below)
//   dC_l   = sum_m dW[l][m] decay dt_m B_m             + e_l (dy_l S_k)
//   dB_m   = sum_l dW[l][m] decay dt_m C_l             + indec_m (x_m dS)
//
// with e_l = exp(cum_l) and g_l = x_l . (dS B_l).  The last row's dcum
// gains (dS . S_k) exp(cum_last) + sum_l g_l indec_l, and the carry becomes
// dS <- dS exp(cum_last) + sum_l (e_l dy_l)^T C_l.
//
// Design.  The TPU takes all heads of a chunk in one grid step, because dB
// and dC are sums over heads and full-H blocks write each once.  Here all
// heads' dS (24 x 64 x 128 floats) would not fit in a block's shared memory,
// so one block of 256 threads owns one (batch, head), as in the forward,
// and walks the chunks last to first with dS (P x N) and S_k resident in
// shared memory.  It writes its head's share of dB and dC to scratch
// (B, NC, H, L, N); a second kernel sums the shares over the heads in head
// order.  No atomics anywhere, so two runs give the same bits.  Within a
// chunk the intra-chunk form is tiled 64 x 64 like the forward: key tiles
// outer, query tiles at or below the diagonal inner, dx and dB of the key
// tile held in registers, dC of the query tile added to in device memory
// (each element by one thread).  Entries above the diagonal are set to zero
// before exp is evaluated.  Then one pass over 64-row tiles adds the
// carried-state and state-update terms.  Row sums over p or n are taken
// across the 16 lanes of a half-warp with shuffles.
//
// Bound on this card: at the training slice's shape (B=8, NC=8, L=256,
// H=24, P=64, N=128) the function moves ~0.39 GB (inputs and outputs once:
// 0.12 ms at 3.35 TB/s) and needs ~41 GFLOP for the causal pairs and the
// four carried-state products of 2NP a row (U = (e dy) S, V = B dS^T,
// Z = x dS and the dS update; C . U and x . V are 2N and 2P): 0.61 ms at
// 67 TFLOP/s float32, so operations bound it.  The kernel executes
// ~78 GFLOP, since each head recomputes C B^T and forms its own dB and dC
// shares, and it moves another ~0.8 GB through the head-share scratch.

constexpr int XS = MAX_P + 1;     // row stride of the x and dy tiles: m varies across lanes

size_t bwd_smem_floats(int L, int N) {
  const int ns = row_stride(N);
  return (size_t)2 * TILE * ns      // Cs, Bs
         + (size_t)2 * MAX_P * ns   // S, dS
         + (size_t)2 * TILE * XS    // Xs, Ys
         + (size_t)3 * TILE * WS    // Ws, Ds, Qs
         + 5 * (size_t)L            // cum, dt, ddt, dcum, g indec
         + THREADS;                 // one partial sum per thread
}

// Rows [0, rows) of head h, P floats each, starting at row `row` of a
// (rows, H, P) array, into a (TILE, XS) tile, each row times exp(cum_s[r])
// when `scale` is set; zero past `rows` and past P.
__device__ inline void load_head_rows(float* dst, const float* __restrict__ src, size_t row,
                                      int rows, int H, int h, int P, const float* scale) {
  for (int e = threadIdx.x; e < TILE * MAX_P; e += THREADS) {
    const int r = e / MAX_P;
    const int p = e - r * MAX_P;
    float v = 0.0f;
    if (r < rows && p < P) {
      v = src[((row + r) * H + h) * P + p];
      if (scale != nullptr) v *= expf(scale[r]);
    }
    dst[r * XS + p] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ cum, const float* __restrict__ bm,
                          const float* __restrict__ cm, const float* __restrict__ states,
                          const float* __restrict__ dy, float* __restrict__ dx,
                          float* __restrict__ ddt, float* __restrict__ dcum,
                          float* __restrict__ db_part, float* __restrict__ dc_part, int NC,
                          int L, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ns = row_stride(N);
  float* Cs = smem;                  // (TILE, ns)   C rows
  float* Bs = Cs + TILE * ns;        // (TILE, ns)   B rows
  float* S = Bs + TILE * ns;         // (MAX_P, ns)  entry state S_k
  float* dS = S + MAX_P * ns;        // (MAX_P, ns)  cotangent of S_k+1, then of S_k
  float* Xs = dS + MAX_P * ns;       // (TILE, XS)   x rows
  float* Ys = Xs + TILE * XS;        // (TILE, XS)   dy rows (times e_l in the carried pass)
  float* Ws = Ys + TILE * XS;        // (TILE, WS)   W[l][m]
  float* Ds = Ws + TILE * WS;        // (TILE, WS)   dW decay dt_m: this head's dG
  float* Qs = Ds + TILE * WS;        // (TILE, WS)   Q[l][m]
  float* cum_s = Qs + TILE * WS;     // (L)
  float* dt_s = cum_s + L;           // (L)
  float* ddt_s = dt_s + L;           // (L)
  float* dcum_s = ddt_s + L;         // (L)
  float* gi_s = dcum_s + L;          // (L)  g_l indec_l
  float* red = gi_s + L;             // (THREADS)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tiles = (L + TILE - 1) / TILE;

  // Entries past P or N stay zero in S and dS for the whole run.
  for (int e = tid; e < MAX_P * ns; e += THREADS) {
    S[e] = 0.0f;
    dS[e] = 0.0f;  // the last chunk's exit state has no cotangent
  }

  for (int c = NC - 1; c >= 0; --c) {
    const size_t row0 = ((size_t)b * NC + c) * L;   // row (b, c, l = 0) of dt/cum/B/C
    const size_t head = ((size_t)b * NC + c) * H + h;  // (b, c, h) of states and shares
    float* dbp = db_part + head * L * N;            // (L, N): this head's share of dB
    float* dcp = dc_part + head * L * N;
    __syncthreads();  // the last chunk is done with every shared array
    for (int l = tid; l < L; l += THREADS) {
      cum_s[l] = cum[(row0 + l) * H + h];
      dt_s[l] = dt[(row0 + l) * H + h];
      ddt_s[l] = 0.0f;
      dcum_s[l] = 0.0f;
    }
    const float* st = states + head * P * N;
    for (int e = tid; e < P * N; e += THREADS) S[(e / N) * ns + e % N] = st[e];

    // ---- intra-chunk form, transposed: key tiles m outer, query tiles l >= m inner ----
    for (int mt = 0; mt < tiles; ++mt) {
      const int m0 = mt * TILE;
      const int mrows = min(TILE, L - m0);
      load_rows(Bs, bm + (row0 + m0) * N, mrows, N, ns);
      load_head_rows(Xs, x, row0 + m0, mrows, H, h, P, nullptr);
      float dxa[4][4] = {};  // dx[m = ty + 16 i][p = tx + 16 j] of this key tile
      float dba[4][8] = {};  // dB[m = ty + 16 i][n = tx + 16 j] of this key tile
      for (int lt = mt; lt < tiles; ++lt) {
        const int l0 = lt * TILE;
        const int lrows = min(TILE, L - l0);
        load_rows(Cs, cm + (row0 + l0) * N, lrows, N, ns);
        load_head_rows(Ys, dy, row0 + l0, lrows, H, h, P, nullptr);
        __syncthreads();  // tiles, cum_s, dt_s and S are loaded

        // G and dW at [l = ty + 16 i][m = tx + 16 j]
        float g[4][4] = {};
        float dw[4][4] = {};
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
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          float yv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty + 16 * i) * XS + p];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[(tx + 16 * j) * XS + p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dw[i][j] = fmaf(yv[i], xv[j], dw[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + tx + 16 * j;
            float wv = 0.0f, dv = 0.0f, qv = 0.0f;
            if (m <= l && l < L) {  // mask before exp: only m <= l is evaluated
              const float dec = expf(cum_s[l] - cum_s[m]);
              wv = g[i][j] * dec * dt_s[m];
              dv = dw[i][j] * dec * dt_s[m];
              qv = dw[i][j] * g[i][j] * dec;
            }
            const int e = (ty + 16 * i) * WS + tx + 16 * j;
            Ws[e] = wv;
            Ds[e] = dv;
            Qs[e] = qv;
          }
        }
        __syncthreads();  // Ws, Ds, Qs are complete

        // Row and column sums of Q: thread r owns row l0 + r and column m0 + r
        // (the same index on the diagonal tile, so one writer each).
        if (tid < TILE) {
          float row = 0.0f, col = 0.0f;
          for (int k = 0; k < TILE; ++k) {
            if (m0 + k < L) row = fmaf(Qs[tid * WS + k], dt_s[m0 + k], row);
            col += Qs[k * WS + tid];
          }
          if (l0 + tid < L) dcum_s[l0 + tid] += row;
          if (m0 + tid < L) {
            ddt_s[m0 + tid] += col;
            dcum_s[m0 + tid] -= col * dt_s[m0 + tid];
          }
        }

        // dx[m][p] += sum_l W[l][m] dy[l][p];  dB[m][n] += sum_l dG[l][m] C[l][n]
        for (int r = 0; r < lrows; ++r) {
          float wv[4], dv[4], yv[4], cv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            wv[i] = Ws[r * WS + ty + 16 * i];
            dv[i] = Ds[r * WS + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) yv[j] = Ys[r * XS + tx + 16 * j];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            cv[j] = (n < N) ? Cs[r * ns + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) dxa[i][j] = fmaf(wv[i], yv[j], dxa[i][j]);
#pragma unroll
            for (int j = 0; j < 8; ++j) dba[i][j] = fmaf(dv[i], cv[j], dba[i][j]);
          }
        }

        // dC[l][n] (+)= sum_m dG[l][m] B[m][n]: written at the first key tile
        float dca[4][8] = {};
        for (int m = 0; m < mrows; ++m) {
          float dv[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i] = Ds[(ty + 16 * i) * WS + m];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            bv[j] = (n < N) ? Bs[m * ns + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dca[i][j] = fmaf(dv[i], bv[j], dca[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
          if (l >= L) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            if (n >= N) continue;
            float* out = dcp + (size_t)l * N + n;
            *out = (mt == 0) ? dca[i][j] : *out + dca[i][j];
          }
        }
        __syncthreads();  // the next query tile may overwrite Cs, Ys, Ws, Ds, Qs
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) dx[((row0 + m) * H + h) * P + p] = dxa[i][j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) dbp[(size_t)m * N + n] = dba[i][j];
        }
      }
    }

    // ---- the carried state and the state update, transposed, 64 rows at a time ----
    const float cum_last = cum_s[L - 1];
    float fa[4][8] = {};  // sum_l (e_l dy_l)^T C_l at [p = ty + 16 i][n = tx + 16 j]
    for (int t = 0; t < tiles; ++t) {
      const int l0 = t * TILE;
      const int rows = min(TILE, L - l0);
      load_rows(Cs, cm + (row0 + l0) * N, rows, N, ns);
      load_rows(Bs, bm + (row0 + l0) * N, rows, N, ns);
      load_head_rows(Xs, x, row0 + l0, rows, H, h, P, nullptr);
      load_head_rows(Ys, dy, row0 + l0, rows, H, h, P, cum_s + l0);
      __syncthreads();

      float cu[4] = {}, gx[4] = {};  // C_l . U_l and x_l . V_l, this thread's share
      {  // U = (e dy) S: dC += U
        float u[4][8] = {};
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          float yv[4], sv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty + 16 * i) * XS + p];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            sv[j] = (n < N) ? S[p * ns + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) u[i][j] = fmaf(yv[i], sv[j], u[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            if (n >= N) continue;
            cu[i] = fmaf(Cs[r * ns + n], u[i][j], cu[i]);
            if (r < rows) dcp[(size_t)(l0 + r) * N + n] += u[i][j];
          }
        }
      }
      {  // V = B dS^T: dx += indec V
        float v[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float bv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty + 16 * i) * ns + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = dS[(tx + 16 * j) * ns + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[i][j] = fmaf(bv[i], sv[j], v[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          const float indec = (r < rows) ? expf(cum_last - cum_s[l0 + r]) * dt_s[l0 + r] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            gx[i] = fmaf(Xs[r * XS + p], v[i][j], gx[i]);
            if (r < rows && p < P) dx[((row0 + l0 + r) * H + h) * P + p] += indec * v[i][j];
          }
        }
      }
      {  // Z = x dS: dB += indec Z
        float z[4][8] = {};
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          float xv[4], sv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * XS + p];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            sv[j] = (n < N) ? dS[p * ns + n] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) z[i][j] = fmaf(xv[i], sv[j], z[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          if (r >= rows) continue;
          const float indec = expf(cum_last - cum_s[l0 + r]) * dt_s[l0 + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            if (n < N) dbp[(size_t)(l0 + r) * N + n] += indec * z[i][j];
          }
        }
      }
      // Sum cu and gx over the 16 lanes that share a row (one half-warp).
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          cu[i] += __shfl_xor_sync(0xffffffffu, cu[i], off);
          gx[i] += __shfl_xor_sync(0xffffffffu, gx[i], off);
        }
        const int r = ty + 16 * i;
        if (tx == 0 && r < rows) {
          const int l = l0 + r;
          const float in_decay = expf(cum_last - cum_s[l]);
          const float gi = gx[i] * in_decay * dt_s[l];
          ddt_s[l] += gx[i] * in_decay;
          dcum_s[l] += cu[i] - gi;
          gi_s[l] = gi;
        }
      }
      // sum_l (e_l dy_l)^T C_l over this tile's rows
      for (int r = 0; r < rows; ++r) {
        float yv[4], cv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = Ys[r * XS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          cv[j] = (n < N) ? Cs[r * ns + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) fa[i][j] = fmaf(yv[i], cv[j], fa[i][j]);
      }
      __syncthreads();  // the next tile may overwrite Cs, Bs, Xs, Ys
    }

    // ---- the last row's dcum term; then dS <- dS exp(cum_last) + fa ----
    float part = 0.0f;
    for (int e = tid; e < MAX_P * ns; e += THREADS) part = fmaf(dS[e], S[e], part);
    red[tid] = part;
    __syncthreads();  // every partial is in red, every read of dS is done
    const float cd = expf(cum_last);
    if (tid == 0) {
      float sdot = 0.0f, gsum = 0.0f;
      for (int k = 0; k < THREADS; ++k) sdot += red[k];
      for (int l = 0; l < L; ++l) gsum += gi_s[l];
      dcum_s[L - 1] += sdot * cd + gsum;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dS[p * ns + n] = fmaf(dS[p * ns + n], cd, fa[i][j]);
      }
    }
    __syncthreads();  // ddt_s and dcum_s are complete
    for (int l = tid; l < L; l += THREADS) {
      ddt[(row0 + l) * H + h] = ddt_s[l];
      dcum[(row0 + l) * H + h] = dcum_s[l];
    }
  }
}

// dB and dC (B, NC, L, N): the heads' shares (B, NC, H, L, N) summed in
// head order, one thread per output element.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ db_part,
                                      const float* __restrict__ dc_part,
                                      float* __restrict__ db, float* __restrict__ dc, int H,
                                      int LN, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t bc = idx / LN;
  const size_t e = idx - bc * LN;
  const float* pb = db_part + bc * H * LN + e;
  const float* pc = dc_part + bc * H * LN + e;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(size_t)h * LN];
    sc += pc[(size_t)h * LN];
  }
  db[idx] = sb;
  dc[idx] = sc;
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

// The backward: dx, ddt, dcum (the shapes of x, dt, cum), db, dc (B, NC, L, N),
// from states (B, NC, H, P, N) and dy (B, NC, L, H, P).  db_part and dc_part
// are scratch of B * NC * H * L * N floats each.  Returns the first CUDA
// error of the two launches (0 on success), or cudaErrorInvalidValue for
// shapes above the kernel's limits.  At L = 256, N = 128 a block needs
// 221 KB of shared memory, so the launch opts in above 48 KB.
int ssd_chunk_scan_bwd(const float* x, const float* dt, const float* cum, const float* bm,
                       const float* cm, const float* states, const float* dy, float* dx,
                       float* ddt, float* dcum, float* db, float* dc, float* db_part,
                       float* dc_part, int B, int NC, int L, int H, int P, int N,
                       void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N || B < 1 || NC < 1 ||
      H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_chunk_scan_bwd_kernel<<<dim3(H, B), THREADS, smem, s>>>(
      x, dt, cum, bm, cm, states, dy, dx, ddt, dcum, db_part, dc_part, NC, L, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * NC * L * N;
  const int block = 256;
  ssd_bwd_reduce_kernel<<<(unsigned)((total + block - 1) / block), block, 0, s>>>(
      db_part, dc_part, db, dc, H, L * N, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
