// GRU recurrence over precomputed input gates, forward and residual backward,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/gru_scan/kernel.py.  All tensors are float32 and
// contiguous:
//
//   x_gates (C, B, T, 3N)   w_hh (C, N, 3N)   b_hh (C, 3N)
//   h_seq   (C, B, T, N)    dy   (C, B, T, N)
//
// with gate order (r, z, n):  gh = h W_hh + b_hh,  r = sigmoid(xr + hr),
// z = sigmoid(xz + hz),  n = tanh(xn + r * hn),  h' = (1 - z) n + z h,  h0 = 0.
//
// Grid: (batch tiles, C).  A block holds `rows` batch rows and one thread per
// (row, hidden unit), so blockDim.x = rows * N.  Rows >= B are masked: they
// load nothing, store nothing and contribute zero to the weight cotangents.
//
// Shared-memory rows of W_hh are padded to 3N + 1 floats.  The forward reads
// W[k][g*N + j] with j varying across a warp (consecutive words); the
// backward reads W[j][m] with j varying (stride 3N + 1, odd for even N, so
// no two lanes of a warp hit one bank).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Replaces the Pallas kernel repro/kernels/gru_scan/kernel.py::gru_scan
// (body _gru_kernel).
//
// Bound on this card: the paper's shape (B=128, T=24, N=32) moves 1.59 MB
// (0.47 us at 3.35 TB/s) and does ~20 MFLOP (0.30 us at 67 TFLOP/s fp32), so
// the roofline says bytes; in practice the 24 dependent steps bound it: each
// step is a (rows, N) x (N, 3N) product that cannot start before the last one
// ends.
//
// What the design does about it: W_hh and b_hh are loaded into shared memory
// once per block, h lives in shared memory double-buffered (step t reads
// h_{t-1} from one buffer and writes h_t into the other), so each step costs
// one __syncthreads and no round trip through device memory; x_gates is read
// and h_seq written exactly once.  Small tiles (rows = 256 / N) put many
// blocks in flight so the latency of one block's chain hides behind others.
__global__ void gru_scan_fwd_kernel(const float* __restrict__ xg,
                                    const float* __restrict__ w_hh,
                                    const float* __restrict__ b_hh,
                                    float* __restrict__ h_seq,
                                    int B, int T, int N, int rows) {
  extern __shared__ float smem[];
  const int n3 = 3 * N;
  const int ws = n3 + 1;                  // padded row stride of W in smem
  float* w = smem;                        // (N, ws)
  float* bias = w + N * ws;               // (3N)
  float* hbuf = bias + n3;                // (2, rows, N)

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* wc = w_hh + (size_t)c * N * n3;
  const float* bc = b_hh + (size_t)c * n3;
  for (int e = tid; e < N * n3; e += nthreads) w[(e / n3) * ws + e % n3] = wc[e];
  for (int e = tid; e < n3; e += nthreads) bias[e] = bc[e];

  const int b = tid / N;                  // row within the tile
  const int j = tid % N;                  // hidden unit
  const int row = blockIdx.x * rows + b;  // batch row
  const bool valid = row < B;
  hbuf[b * N + j] = 0.0f;                 // h0 = 0 in buffer 0
  __syncthreads();

  const float* x_row = xg + ((size_t)c * B + row) * T * n3;
  float* h_row = h_seq + ((size_t)c * B + row) * T * N;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* hp = hbuf + cur * rows * N + b * N;
    float hr = bias[j], hz = bias[N + j], hn = bias[2 * N + j];
    for (int k = 0; k < N; ++k) {
      const float hk = hp[k];
      const float* wk = w + k * ws;
      hr = fmaf(hk, wk[j], hr);
      hz = fmaf(hk, wk[N + j], hz);
      hn = fmaf(hk, wk[2 * N + j], hn);
    }
    float xr = 0.0f, xz = 0.0f, xn = 0.0f;
    if (valid) {
      const float* x_t = x_row + (size_t)t * n3;
      xr = x_t[j];
      xz = x_t[N + j];
      xn = x_t[2 * N + j];
    }
    const float r = sigmoidf(xr + hr);
    const float z = sigmoidf(xz + hz);
    const float cand = tanhf(xn + r * hn);
    const float h_new = (1.0f - z) * cand + z * hp[j];
    hbuf[(cur ^ 1) * rows * N + b * N + j] = h_new;
    if (valid) h_row[(size_t)t * N + j] = h_new;
    cur ^= 1;
    __syncthreads();
  }
}

// Replaces the Pallas kernel repro/kernels/gru_scan/kernel.py::gru_scan_bwd
// (body _gru_bwd_kernel).
//
// Bound on this card: at the paper's shape it moves 3.17 MB (0.95 us) and
// does ~59 MFLOP (0.89 us), so bytes bound it on paper; in practice the 24
// dependent reverse steps do, each needing two block-wide barriers.
//
// What the design does about it: one reverse pass, no forward recompute --
// the gates of step t are rebuilt from h_{t-1} read out of the residual
// h_seq.  W_hh stays in shared memory; dh stays in a register of the thread
// that owns (row, unit); h_{t-1} and d_gh are double-buffered in shared
// memory so each step needs two barriers and no third.  The Pallas kernel
// summed dW/db across batch tiles by revisiting one output block in grid
// order, which is a race when blocks run concurrently: here each block
// accumulates its tile's dW/db in shared memory (every entry owned by one
// thread, summed over rows in order and over t in reverse order) and writes
// it to a per-tile partial, and gru_scan_bwd_reduce_kernel sums the partials
// in tile order.  No atomics, so two runs give the same bits.
__global__ void gru_scan_bwd_kernel(const float* __restrict__ xg,
                                    const float* __restrict__ w_hh,
                                    const float* __restrict__ b_hh,
                                    const float* __restrict__ h_seq,
                                    const float* __restrict__ dy,
                                    float* __restrict__ dxg,
                                    float* __restrict__ partial,  // (C, tiles, N+1, 3N)
                                    int B, int T, int N, int rows) {
  extern __shared__ float smem[];
  const int n3 = 3 * N;
  const int ws = n3 + 1;
  const int nacc = (N + 1) * n3;          // dW rows, then db as row N
  float* w = smem;                        // (N, ws)
  float* bias = w + N * ws;               // (3N)
  float* acc = bias + n3;                 // (N+1, 3N)
  float* hpb = acc + nacc;                // (2, rows, N)   h_{t-1}
  float* dgb = hpb + 2 * rows * N;        // (2, rows, 3N)  d_gh

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* wc = w_hh + (size_t)c * N * n3;
  const float* bc = b_hh + (size_t)c * n3;
  for (int e = tid; e < N * n3; e += nthreads) w[(e / n3) * ws + e % n3] = wc[e];
  for (int e = tid; e < n3; e += nthreads) bias[e] = bc[e];
  for (int e = tid; e < nacc; e += nthreads) acc[e] = 0.0f;

  const int b = tid / N;
  const int j = tid % N;
  const int row = blockIdx.x * rows + b;
  const bool valid = row < B;
  const size_t base = (size_t)c * B + row;
  const float* x_row = xg + base * T * n3;
  const float* h_row = h_seq + base * T * N;
  const float* dy_row = dy + base * T * N;
  float* dx_row = dxg + base * T * n3;

  float dh = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float* hp = hpb + (s & 1) * rows * N;
    float* dg = dgb + (s & 1) * rows * n3;
    hp[b * N + j] = (valid && t > 0) ? h_row[(size_t)(t - 1) * N + j] : 0.0f;
    __syncthreads();  // h_{t-1} of every row is in shared memory

    const float* hpr = hp + b * N;
    float hr = bias[j], hz = bias[N + j], hn = bias[2 * N + j];
    for (int k = 0; k < N; ++k) {
      const float hk = hpr[k];
      const float* wk = w + k * ws;
      hr = fmaf(hk, wk[j], hr);
      hz = fmaf(hk, wk[N + j], hz);
      hn = fmaf(hk, wk[2 * N + j], hn);
    }
    float xr = 0.0f, xz = 0.0f, xn = 0.0f, dyt = 0.0f;
    if (valid) {
      const float* x_t = x_row + (size_t)t * n3;
      xr = x_t[j];
      xz = x_t[N + j];
      xn = x_t[2 * N + j];
      dyt = dy_row[(size_t)t * N + j];
    }
    const float r = sigmoidf(xr + hr);
    const float z = sigmoidf(xz + hz);
    const float cand = tanhf(xn + r * hn);

    const float dh_total = dyt + dh;
    const float dz = dh_total * (hpr[j] - cand);
    const float da_n = dh_total * (1.0f - z) * (1.0f - cand * cand);
    const float da_r = da_n * hn * r * (1.0f - r);
    const float da_z = dz * z * (1.0f - z);
    if (valid) {
      float* dx_t = dx_row + (size_t)t * n3;
      dx_t[j] = da_r;
      dx_t[N + j] = da_z;
      dx_t[2 * N + j] = da_n;
    }
    // Masked rows have dy = 0 and dh = 0, so every term they add is 0.
    dg[b * n3 + j] = da_r;
    dg[b * n3 + N + j] = da_z;
    dg[b * n3 + 2 * N + j] = da_n * r;
    __syncthreads();  // d_gh of every row is in shared memory

    // dh_{t-1} = dh_total * z + d_gh W_hh^T  (row j of W, padded stride).
    const float* dgr = dg + b * n3;
    const float* wj = w + j * ws;
    float dsum = 0.0f;
    for (int m = 0; m < n3; ++m) dsum = fmaf(dgr[m], wj[m], dsum);
    dh = dh_total * z + dsum;

    // dW += h_{t-1}^T d_gh, db += sum_rows d_gh; each entry owned by one thread.
    for (int e = tid; e < nacc; e += nthreads) {
      const int k = e / n3;
      const int m = e % n3;
      float v = 0.0f;
      if (k < N) {
        for (int bb = 0; bb < rows; ++bb) v = fmaf(hp[bb * N + k], dg[bb * n3 + m], v);
      } else {
        for (int bb = 0; bb < rows; ++bb) v += dg[bb * n3 + m];
      }
      acc[e] += v;
    }
    // The next step writes the other buffers; the step after waits behind the
    // next step's first barrier, so no third barrier is needed here.
  }

  float* out = partial + ((size_t)c * gridDim.x + blockIdx.x) * nacc;
  for (int e = tid; e < nacc; e += nthreads) out[e] = acc[e];
}

// Sums the per-tile partials of gru_scan_bwd_kernel in tile order.
__global__ void gru_scan_bwd_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dw,
                                           float* __restrict__ db,
                                           int tiles, int N) {
  const int n3 = 3 * N;
  const int nacc = (N + 1) * n3;
  const int c = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nacc) return;
  const float* p = partial + (size_t)c * tiles * nacc + e;
  float v = 0.0f;
  for (int i = 0; i < tiles; ++i) v += p[(size_t)i * nacc];
  if (e < N * n3) {
    dw[(size_t)c * N * n3 + e] = v;
  } else {
    db[(size_t)c * n3 + (e - N * n3)] = v;
  }
}

size_t fwd_smem_bytes(int N, int rows) {
  return sizeof(float) * ((size_t)N * (3 * N + 1) + 3 * N + 2 * rows * N);
}

size_t bwd_smem_bytes(int N, int rows) {
  return sizeof(float) *
         ((size_t)N * (3 * N + 1) + 3 * N + (size_t)(N + 1) * 3 * N + 2 * rows * N + 2 * rows * 3 * N);
}

// Above 48 KB a block gets shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Both entry points return the launch's cudaGetLastError() (0 on success).
// At N = 64 (the wrapper's largest), the backward needs 106 KB of shared memory.
int gru_scan_fwd(const float* xg, const float* w_hh, const float* b_hh, float* h_seq,
                 int C, int B, int T, int N, int rows, void* stream) {
  const size_t smem = fwd_smem_bytes(N, rows);
  cudaError_t err = allow_smem(gru_scan_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + rows - 1) / rows, C);
  gru_scan_fwd_kernel<<<grid, rows * N, smem, (cudaStream_t)stream>>>(xg, w_hh, b_hh, h_seq,
                                                                       B, T, N, rows);
  return (int)cudaGetLastError();
}

int gru_scan_bwd(const float* xg, const float* w_hh, const float* b_hh, const float* h_seq,
                 const float* dy, float* dxg, float* partial, float* dw, float* db,
                 int C, int B, int T, int N, int rows, void* stream) {
  const size_t smem = bwd_smem_bytes(N, rows);
  cudaError_t err = allow_smem(gru_scan_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + rows - 1) / rows;
  dim3 grid(tiles, C);
  gru_scan_bwd_kernel<<<grid, rows * N, smem, (cudaStream_t)stream>>>(
      xg, w_hh, b_hh, h_seq, dy, dxg, partial, B, T, N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nacc = (N + 1) * 3 * N;
  dim3 rgrid((nacc + 255) / 256, C);
  gru_scan_bwd_reduce_kernel<<<rgrid, 256, 0, (cudaStream_t)stream>>>(partial, dw, db, tiles, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
