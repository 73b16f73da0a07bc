// GRU recurrence over precomputed input gates, forward and residual backward,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/gru_scan/kernel.py.  All tensors are contiguous:
//
//   x_gates (C, B, T, 3N)   w_hh (C, N, 3N)   b_hh (C, 3N)
//   h_seq   (C, B, T, N)    dy   (C, B, T, N)
//
// with gate order (r, z, n):  gh = h W_hh + b_hh,  r = sigmoid(xr + hr),
// z = sigmoid(xz + hz),  n = tanh(xn + r * hn),  h' = (1 - z) n + z h,  h0 = 0.
//
// x_gates, h_seq, dy and dx_gates are float32, bfloat16 or float16 (the
// activation type TX, one for all four); w_hh and b_hh arrive as float32, and
// dW_hh and db_hh leave as float32 sums.  Every load is widened to float32,
// every product and activation is float32, the carried h (forward) and dh
// (backward) stay float32 between steps, and only what is stored to h_seq and
// dx_gates is rounded to TX, as the reference does.
//
// Up to N = 64 both recurrences, the forward and the backward's reverse one,
// run one warp per (client, batch row), RECUR_WARPS rows a block, on the grid
// (row blocks, C): lane j owns hidden unit j and, above N = 32, unit j + 32,
// and the lanes exchange a step's vector through a per-warp strip of shared
// memory behind one __syncwarp.  Above N = 64 the wide variants take over: a
// block takes a tile of batch rows of one client, keeps the tile's h (or d_gh)
// in shared memory behind one __syncthreads a step, and keeps W_hh resident
// in shared memory where it fits beside the tile (else reads it from L2).
// The backward then sums dW_hh and db_hh over slices of the B*T rows and
// sums the slices' partials in order.  Rows >= B are masked: they load
// nothing, store nothing and contribute zero to the weight cotangents.  The
// client axis runs on grid y in launches of at most 65,535 clients each.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Activations in and out of float32 (round to nearest even on the way out).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename TX> __device__ __forceinline__ TX from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }
template <typename TX> constexpr bool is_f32 = std::is_same<TX, float>::value;

// Copies `total` floats into shared memory, dst[e] = value(e), with BATCH
// independent loads in flight a thread before their stores: the block waits
// for device memory once a batch, not once an element.
template <int BATCH, typename V, typename F>
__device__ __forceinline__ void fill_shared(V* dst, int total, F value) {
  for (int base = threadIdx.x; base < total; base += BATCH * blockDim.x) {
    V v[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int e = base + q * blockDim.x;
      v[q] = e < total ? value(e) : V{};
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int e = base + q * blockDim.x;
      if (e < total) dst[e] = v[q];
    }
  }
}

constexpr int RECUR_WARPS = 4;  // batch rows (one warp each) a block of the recurrences

// Stages client c's W_hh (N, 3N) and b_hh (3N) in shared memory, padded to
// NP = 32 U units a gate with zeros: w[k*WS + g*NP + i] = W_hh[k][g*N + i]
// (WS = 3 NP + 1, an odd row stride, so lanes reading rows j hit 32 banks)
// and bias[g*NP + i] = b_hh[g*N + i].  The caller's __syncthreads publishes
// them.
template <int U>
__device__ __forceinline__ void stage_weights(float* w, float* bias, const float* wc,
                                              const float* bc, int N) {
  constexpr int NP = 32 * U;
  constexpr int MP = 3 * NP;
  constexpr int WS = MP + 1;
  const int n3 = 3 * N;
  if (N % 4 == 0 && ((size_t)wc & 15) == 0) {
    // Zero the padding, then scatter W_hh read as float4 (a float4 never
    // straddles a row or a gate when 4 | N); the two write disjoint words.
    for (int e = threadIdx.x; e < NP * WS; e += blockDim.x) {
      const int k = e / WS, m = e % WS;
      if (k >= N || m >= MP || m % NP >= N) w[e] = 0.0f;
    }
    const float4* wc4 = reinterpret_cast<const float4*>(wc);
    const int nvec = N * n3 / 4;
    for (int base = threadIdx.x; base < nvec; base += 8 * blockDim.x) {
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = base + q * blockDim.x;
        v[q] = e < nvec ? wc4[e] : float4{};
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = base + q * blockDim.x;
        if (e < nvec) {
          const int k = 4 * e / n3, m = 4 * e % n3;
          float* d = w + k * WS + (m / N) * NP + m % N;
          d[0] = v[q].x; d[1] = v[q].y; d[2] = v[q].z; d[3] = v[q].w;
        }
      }
    }
  } else {
    fill_shared<8>(w, NP * WS, [=](int e) {
      const int k = e / WS, m = e % WS, g = m / NP, i = m % NP;
      return (k < N && m < MP && i < N) ? wc[k * n3 + g * N + i] : 0.0f;
    });
  }
  fill_shared<4>(bias, MP, [=](int m) {
    const int g = m / NP, i = m % NP;
    return i < N ? bc[g * N + i] : 0.0f;
  });
}

// The sum of P partial sums, pairwise.
template <int P>
__device__ __forceinline__ float sum_parts(const float (&a)[P]) {
  float s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = a[p];
#pragma unroll
  for (int half = P / 2; half > 0; half /= 2)
#pragma unroll
    for (int p = 0; p < half; ++p) s[p] += s[p + half];
  return s[0];
}

constexpr int FWD_PARTS = 4;  // partial sums a gate: the dependent FMA chain is NP / FWD_PARTS long
constexpr int FWD_AHEAD = 3;  // steps whose x_gates are in flight ahead of the one computed
static_assert(FWD_PARTS >= 2 && (FWD_PARTS & (FWD_PARTS - 1)) == 0, "sum_parts sums pairwise");

// Replaces the Pallas kernel repro/kernels/gru_scan/kernel.py::gru_scan
// (body _gru_kernel).
//
// Bound on this card: the paper's shape (B=128, T=24, N=32) moves 1.59 MB
// (0.47 us at 3.35 TB/s) and does ~20 MFLOP (0.30 us at 67 TFLOP/s fp32), so
// the roofline says bytes; in practice the 24 dependent steps of a row bound
// it: each is a (1, N) x (N, 3N) product and three activations that cannot
// start before the step before has ended.
//
// What the design does about it: one warp per (client, batch row), lane j
// owning hidden unit j and, above N = 32, unit j + 32 (U units a lane), so a
// step needs no block-wide barrier.  At U = 1 each lane holds its three
// columns of W_hh (96 floats) and its three biases in registers, loaded
// straight from device memory with every load issued before the first wait,
// so the kernel has no __syncthreads at all; at U = 2, W_hh sits in shared
// memory behind one __syncthreads before the loop.  h_t passes between lanes
// through a per-warp strip of shared memory behind one __syncwarp a step (two
// strips by step parity), read back as float4 broadcasts; each gate's sum
// runs in FWD_PARTS partial sums, which shortens the dependent FMA chain, and
// the r and z gates' x_gates start one of them, which takes an add off it.
// The x_gates of step t + FWD_AHEAD are loaded at the end of step t into a
// slot that nothing reads before then (the loop is unrolled over named
// slots, so no register still waiting on its load is copied), through a
// pointer that moves one step a load, and h_t goes straight to h_seq.
// W_hh, b_hh and each lane's units are padded to NP = 32
// U with zeros, so a padded unit carries exact zeros through every step.
// The activations are the plain version's (expf, tanhf, IEEE division): the
// backward rebuilds the gates from h_seq with the same functions.
//
// What bounds it as built: the latency of one step's chain, ~0.3 us at
// C = 1 for the ~216 instructions one warp issues (96 FFMA of the product,
// then the two expf, two IEEE divides and the tanhf in sequence), and ~2 us
// fixed a launch; at C = 35, 159 registers leave 12 warps an SM, so the
// 4,480 row warps run in ~2.8 waves, and every warp first reads its 12 KB of
// W_hh columns from L2 (PERF.md has the times from
// tools/time_gru_kernels.py --steps).
template <typename TX, int U>
__global__ void __launch_bounds__(32 * RECUR_WARPS)
gru_scan_fwd_kernel(const TX* __restrict__ xg, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, TX* __restrict__ h_seq,
                    int B, int T, int N) {
  constexpr int NP = 32 * U;
  constexpr int MP = 3 * NP;
  constexpr int WS = MP + 1;
  extern __shared__ __align__(16) float smem[];
  float* w = smem;             // U = 2: (NP, WS), then the bias (MP)
  float* strips = smem + (U == 1 ? 0 : NP * WS + MP);  // (RECUR_WARPS, 2, NP): h by step parity

  const int n3 = 3 * N;
  const int c = blockIdx.y;
  const float* wc = w_hh + (size_t)c * N * n3;
  const float* bc = b_hh + (size_t)c * n3;
  if constexpr (U > 1) {
    stage_weights<U>(w, w + NP * WS, wc, bc, N);
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RECUR_WARPS + warp;
  if (row >= B) return;        // masked rows: no barrier follows
  float* strip = strips + warp * 2 * NP;
  const size_t base = (size_t)c * B + row;
  const TX* x_row = xg + base * T * n3;
  TX* h_row = h_seq + base * T * N;

  int unit[U];
  bool valid[U];
  float bz[3][U];
  float wcol[U == 1 ? 3 : 1][U == 1 ? NP : 1];  // U = 1: W_hh[k][g*N + lane], padded
#pragma unroll
  for (int u = 0; u < U; ++u) {
    unit[u] = u * 32 + lane;
    valid[u] = unit[u] < N;
  }
  if constexpr (U == 1) {
#pragma unroll
    for (int g = 0; g < 3; ++g) bz[g][0] = valid[0] ? bc[g * N + lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wcol[g][k] = (valid[0] && k < N) ? wc[k * n3 + g * N + lane] : 0.0f;
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < 3; ++g) bz[g][u] = w[NP * WS + g * NP + unit[u]];
  }

  struct Inputs { float x[3][U]; };   // x_gates of one step
  const TX* x_next[U];         // this lane's x_gates of the next step loaded
  TX* h_next[U];               // and its h_seq entry of the next step stored
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x_next[u] = x_row + unit[u];
    h_next[u] = h_row + unit[u];
  }
  auto load = [&](int t, Inputs& in) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = valid[u] && t < T;
#pragma unroll
      for (int g = 0; g < 3; ++g) in.x[g][u] = ok ? to_f32(x_next[u][g * N]) : 0.0f;
      x_next[u] += n3;
    }
  };

  // Step t on `in` (its x_gates), which then takes step t + FWD_AHEAD's.
  float h[U];                  // h_{t-1} of this lane's units
  auto step = [&](int t, Inputs& in) {
    const float4* hp = reinterpret_cast<const float4*>(strip + (t & 1) * NP);  // h_{t-1}
    float* hs = strip + ((t + 1) & 1) * NP;                                   // h_t
    float a[3][U][FWD_PARTS] = {};  // partial sums of x + b + h W for r and z, b + h W for n
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < 3; ++g) a[g][u][0] = bz[g][u];
      a[0][u][1] = in.x[0][u];
      a[1][u][1] = in.x[1][u];
    }
#pragma unroll
    for (int k4 = 0; k4 < NP / 4; ++k4) {
      const float4 v = hp[k4];
      const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * k4 + q, p = k % FWD_PARTS;
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if constexpr (U == 1) {
              a[g][u][p] = fmaf(hk[q], wcol[g][k], a[g][u][p]);
            } else {
              a[g][u][p] = fmaf(hk[q], w[k * WS + g * NP + unit[u]], a[g][u][p]);
            }
          }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float r = sigmoidf(sum_parts(a[0][u]));
      const float z = sigmoidf(sum_parts(a[1][u]));
      const float cand = tanhf(in.x[2][u] + r * sum_parts(a[2][u]));
      h[u] = (1.0f - z) * cand + z * h[u];
      hs[unit[u]] = h[u];
      if (valid[u]) *h_next[u] = from_f32<TX>(h[u]);
      h_next[u] += N;
    }
    __syncwarp();              // h_t of every lane is in the strip
    load(t + FWD_AHEAD, in);
  };

#pragma unroll
  for (int u = 0; u < U; ++u) {
    h[u] = 0.0f;
    strip[unit[u]] = 0.0f;     // h_{-1} = 0, in the strip step 0 reads
  }
  __syncwarp();
  Inputs slot[FWD_AHEAD];
#pragma unroll
  for (int s = 0; s < FWD_AHEAD; ++s) load(s, slot[s]);
  for (int t0 = 0; t0 < T; t0 += FWD_AHEAD) {
#pragma unroll
    for (int s = 0; s < FWD_AHEAD; ++s) {
      if (t0 + s >= T) break;
      step(t0 + s, slot[s]);
    }
  }
}

// Replaces the Pallas kernel repro/kernels/gru_scan/kernel.py::gru_scan_bwd
// (body _gru_bwd_kernel), in two stages: this reverse recurrence, then
// gru_bwd_dw_kernel and gru_scan_bwd_reduce_kernel for dW_hh and db_hh.
//
// Bound on this card: at the paper's shape (B=128, T=24, N=32) the function
// moves 3.17 MB (0.95 us at 3.35 TB/s) and does ~59 MFLOP (0.89 us), so bytes
// bound it on paper; in practice the 24 dependent reverse steps of a row do.
//
// What the design does about it: one warp per (client, batch row), lane j
// owning hidden unit j and, above N = 32, unit j + 32 (U units a lane), so a
// step needs no block-wide barrier: one __syncthreads comes before the time
// loop, after W_hh and b_hh are loaded into shared memory, and none inside
// it.  Each step forms the gate cotangents from the step's gates, writes
// dx_gates and dgn = r * da_n (the n-part of d_gh; its r- and z-parts are
// those of dx_gates), and carries dh_{t-1} = dh z + d_gh W^T in a register.
// d_gh passes between lanes through a per-warp strip of shared memory
// behind one __syncwarp a step (two strips by step parity), read back as
// float4 broadcasts; at U = 1 each lane holds its row of W_hh in registers,
// so the product on the chain reads only the strip.  Off the chain: step
// t-1's gates are rebuilt from h_{t-2} (from the residual h_seq, published
// in the same strip) between step t's exchange and its product, and the
// inputs of step t-3 are loaded at the end of step t into registers that
// nothing reads before step t-2 (the loop is unrolled by three over named
// slots, so no register still waiting on its load is copied).  dW no longer
// waits in the time loop: it depends on no later step, so the second stage
// sums it in parallel.  W_hh, b_hh and each lane's units are padded to
// NP = 32 U with zeros, so a padded unit carries exact zeros through every
// step.
//
// What bounds it as built: a step's ~630 instructions (U = 1) issued by one
// warp scheduler, and the fixed cost of loading W_hh before the first step
// (PERF.md has the times, per step and per launch, from
// tools/time_gru_kernels.py --steps).
template <typename TX, int U>
__global__ void __launch_bounds__(32 * RECUR_WARPS)
gru_bwd_recur_kernel(const TX* __restrict__ xg, const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, const TX* __restrict__ h_seq,
                     const TX* __restrict__ dy, TX* __restrict__ dxg,
                     float* __restrict__ dgn, int B, int T, int N) {
  constexpr int NP = 32 * U;
  constexpr int MP = 3 * NP;
  constexpr int WS = MP + 1;   // odd row stride: lanes reading rows j hit 32 banks
  constexpr int SP = MP + NP;  // a strip: d_gh of step t, then h_{t-2}
  extern __shared__ __align__(16) float smem[];
  float* w = smem;             // (NP, WS): w[k*WS + g*NP + i] = W_hh[k][g*N + i]
  float* bias = w + NP * WS;   // (MP)
  float* strips = bias + MP;   // (RECUR_WARPS, 2, SP): by step parity

  const int n3 = 3 * N;
  const int c = blockIdx.y;
  stage_weights<U>(w, bias, w_hh + (size_t)c * N * n3, b_hh + (size_t)c * n3, N);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RECUR_WARPS + warp;
  if (row >= B) return;        // masked rows: no barrier follows
  float* strip = strips + warp * 2 * SP;
  const size_t base = (size_t)c * B + row;
  const TX* x_row = xg + base * T * n3;
  const TX* h_row = h_seq + base * T * N;
  const TX* dy_row = dy + base * T * N;
  TX* dx_row = dxg + base * T * n3;
  float* dgn_row = dgn + base * T * (is_f32<TX> ? N : n3);  // dgn, or all of d_gh below float32

  int unit[U];
  bool valid[U];
  float bz[3][U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    unit[u] = u * 32 + lane;
    valid[u] = unit[u] < N;
#pragma unroll
    for (int g = 0; g < 3; ++g) bz[g][u] = bias[g * NP + unit[u]];
  }
  float wrow[U == 1 ? MP : 1];  // U = 1: row `lane` of W_hh, padded
  if constexpr (U == 1) {
#pragma unroll
    for (int m = 0; m < MP; ++m) wrow[m] = w[lane * WS + m];
  }

  struct Inputs { float x[3][U], dy[U], hp[U]; };   // step t: x_t, dy_t, h_{t-1}
  struct Gates { float r[U], z[U], cand[U], hn[U]; };
  auto load = [&](int t, Inputs& in) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = valid[u] && t >= 0;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        in.x[g][u] = ok ? to_f32(x_row[(size_t)t * n3 + g * N + unit[u]]) : 0.0f;
      in.dy[u] = ok ? to_f32(dy_row[(size_t)t * N + unit[u]]) : 0.0f;
      in.hp[u] = (ok && t > 0) ? to_f32(h_row[(size_t)(t - 1) * N + unit[u]]) : 0.0f;
    }
  };
  // The gates of the step whose inputs are `in`; `hs` holds its h_{t-1} of
  // every unit, written by the lanes before a __syncwarp, read as float4
  // broadcasts (all loads independent, one wait).
  auto gates = [&](const Inputs& in, const float* hs, Gates& out) {
    float a[3][U];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) a[g][u] = bz[g][u];
    const float4* h4 = reinterpret_cast<const float4*>(hs);
#pragma unroll
    for (int k4 = 0; k4 < NP / 4; ++k4) {
      const float4 v = h4[k4];
      const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wk = w + (4 * k4 + q) * WS;
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int u = 0; u < U; ++u) a[g][u] = fmaf(hk[q], wk[g * NP + unit[u]], a[g][u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      out.r[u] = sigmoidf(in.x[0][u] + a[0][u]);
      out.z[u] = sigmoidf(in.x[1][u] + a[1][u]);
      out.cand[u] = tanhf(in.x[2][u] + out.r[u] * a[2][u]);
      out.hn[u] = a[2][u];
    }
  };

  // One step of the reverse loop: the chain of step t on `cur` (its inputs)
  // and gt (its gates), then step t-1's gates from `next`; cur's registers
  // then take step t-3's inputs.  The loop below names the three slots in
  // turn, so every load lands where it is read two steps later and no
  // register waiting on a load is ever copied.
  Inputs slot[3];
  Gates gt;
  float dh[U];
  auto publish_h = [&](const Inputs& in, float* hs) {
#pragma unroll
    for (int u = 0; u < U; ++u) hs[unit[u]] = in.hp[u];
  };
  auto step = [&](int t, Inputs& cur, Inputs& next) {
    float* st = strip + (t & 1) * SP;
    TX* dx_t = dx_row + (size_t)t * n3;
    float dht[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float r = gt.r[u], z = gt.z[u], cand = gt.cand[u];
      dht[u] = cur.dy[u] + dh[u];
      const float da_n = dht[u] * (1.0f - z) * (1.0f - cand * cand);
      const float da_r = da_n * gt.hn[u] * r * (1.0f - r);
      const float da_z = dht[u] * (cur.hp[u] - cand) * z * (1.0f - z);
      st[unit[u]] = da_r;
      st[NP + unit[u]] = da_z;
      st[2 * NP + unit[u]] = da_n * r;
      if (valid[u]) {
        dx_t[unit[u]] = from_f32<TX>(da_r);
        dx_t[N + unit[u]] = from_f32<TX>(da_z);
        dx_t[2 * N + unit[u]] = from_f32<TX>(da_n);
        if constexpr (is_f32<TX>) {
          dgn_row[(size_t)t * N + unit[u]] = da_n * r;
        } else {   // the dW stage sums float32 d_gh, not dx_gates rounded to TX
          float* g = dgn_row + (size_t)t * n3;
          g[unit[u]] = da_r;
          g[N + unit[u]] = da_z;
          g[2 * N + unit[u]] = da_n * r;
        }
      }
    }
    publish_h(next, st + MP);
    __syncwarp();              // d_gh of step t and h_{t-2} of every lane are in the strip

    Gates gn;                  // step t-1's gates, off the chain
    gates(next, st + MP, gn);

    float dsum[U];
    if constexpr (U == 1) {
      const float4* s4 = reinterpret_cast<const float4*>(st);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < MP / 4; ++q) {
        const float4 v = s4[q];
        acc[0] = fmaf(v.x, wrow[4 * q], acc[0]);
        acc[1] = fmaf(v.y, wrow[4 * q + 1], acc[1]);
        acc[2] = fmaf(v.z, wrow[4 * q + 2], acc[2]);
        acc[3] = fmaf(v.w, wrow[4 * q + 3], acc[3]);
      }
      dsum[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) dsum[u] = 0.0f;
#pragma unroll 8
      for (int m = 0; m < MP; ++m) {
        const float v = st[m];
#pragma unroll
        for (int u = 0; u < U; ++u) dsum[u] = fmaf(v, w[unit[u] * WS + m], dsum[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dh[u] = dht[u] * gt.z[u] + dsum[u];
    gt = gn;
    load(t - 3, cur);
  };

  load(T - 1, slot[0]);
  load(T - 2, slot[1]);
  load(T - 3, slot[2]);
  float* first = strip + (T & 1) * SP + MP;   // a parity step T-1 does not write
  publish_h(slot[0], first);
  __syncwarp();
  gates(slot[0], first, gt);
#pragma unroll
  for (int u = 0; u < U; ++u) dh[u] = 0.0f;
  for (int t = T - 1; t >= 0; t -= 3) {
    step(t, slot[0], slot[1]);
    if (t < 1) break;
    step(t - 1, slot[1], slot[2]);
    if (t < 2) break;
    step(t - 2, slot[2], slot[0]);
  }
}

// Stage 2 of the backward: dW_hh = sum_{b,t} h_{t-1}^T d_gh and db_hh =
// sum_{b,t} d_gh for each client (h_{-1} = 0), over the B*T rows (b, t) in
// slices of S consecutive rows, one block a slice.  The block stages its
// slice in shared memory, as float4 where 4 | N: h_{t-1} with a 1 appended,
// so that db is row N of the product, and d_gh = (dx_r, dx_z, dgn).  Each
// thread sums one 4 x 4 tile of the (N+1, 3N) product over the slice's rows
// in order, two float4 reads a row, and writes it to the slice's partial;
// gru_scan_bwd_reduce_kernel sums the partials in slice order.  No atomics,
// so two runs give the same bits.
__global__ void gru_bwd_dw_kernel(const float* __restrict__ h_seq, const float* __restrict__ dxg,
                                  const float* __restrict__ dgn, float* __restrict__ partial,
                                  int B, int T, int N, int S) {
  extern __shared__ __align__(16) float smem[];
  const int n3 = 3 * N;
  const int kq = (N + 4) / 4;   // float4 groups of the N + 1 product rows
  const int mq = (n3 + 3) / 4;  // float4 groups of the 3N columns
  float* hs = smem;             // (S, 4 kq)
  float* gs = hs + S * 4 * kq;  // (S, 4 mq)
  const int c = blockIdx.y;
  const int total = B * T;
  const int r0 = blockIdx.x * S;
  const size_t cbase = (size_t)c * total;
  if (N % 4 == 0 && (((size_t)h_seq | (size_t)dxg | (size_t)dgn) & 15) == 0) {
    const float4* h4g = reinterpret_cast<const float4*>(h_seq);
    const float4* x4g = reinterpret_cast<const float4*>(dxg);
    const float4* n4g = reinterpret_cast<const float4*>(dgn);
    const int nq = N / 4;
    fill_shared<8>(reinterpret_cast<float4*>(hs), S * kq, [=](int e) {
      const int r = r0 + e / kq, q = e % kq;
      if (r >= total) return float4{};
      if (q == nq) return float4{1.0f, 0.0f, 0.0f, 0.0f};
      return r % T > 0 ? h4g[(cbase + r - 1) * nq + q] : float4{};
    });
    fill_shared<8>(reinterpret_cast<float4*>(gs), S * mq, [=](int e) {
      const int r = r0 + e / mq, q = e % mq;
      if (r >= total) return float4{};
      return q < 2 * nq ? x4g[(cbase + r) * 3 * nq + q] : n4g[(cbase + r) * nq + q - 2 * nq];
    });
  } else {
    fill_shared<8>(hs, S * 4 * kq, [=](int e) {
      const int r = r0 + e / (4 * kq), k = e % (4 * kq);
      if (r >= total || k > N) return 0.0f;
      if (k == N) return 1.0f;
      return r % T > 0 ? h_seq[(cbase + r - 1) * N + k] : 0.0f;
    });
    fill_shared<8>(gs, S * 4 * mq, [=](int e) {
      const int r = r0 + e / (4 * mq), m = e % (4 * mq);
      if (r >= total || m >= n3) return 0.0f;
      return m < 2 * N ? dxg[(cbase + r) * n3 + m] : dgn[(cbase + r) * N + m - 2 * N];
    });
  }
  __syncthreads();

  const int tk = threadIdx.x / mq, tm = threadIdx.x % mq;
  const int rows = min(S, total - r0);
  const float4* h4 = reinterpret_cast<const float4*>(hs);
  const float4* g4 = reinterpret_cast<const float4*>(gs);
  float acc[4][4] = {};
  for (int rr = 0; rr < rows; ++rr) {
    const float4 hv = h4[rr * kq + tk];
    const float4 gv = g4[rr * mq + tm];
    const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ha[a], ga[b], acc[a][b]);
  }
  float* out = partial + ((size_t)c * gridDim.x + blockIdx.x) * (N + 1) * n3;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * tk + a, m = 4 * tm + b;
      if (k <= N && m < n3) out[k * n3 + m] = acc[a][b];
    }
}

// Stage 2 of the backward for any N and any activation type (the float32
// kernel above runs up to N = 64): dW_hh and db_hh over the B*T rows in
// slices of R consecutive rows.  A block takes one slice and one tile of the
// (N+1, 3N) product, kqt x mqt float4 groups (up to N = 64 the whole
// product), and stages the slice in chunks of S rows in shared memory, as
// float4 where 4 | N: h_{t-1} with a 1 appended, so that db is row N of the
// product, and d_gh = (g_rz[:, :2N], g_n): dx_gates and dgn in float32, or
// the recurrence's float32 d_gh below float32.  Each thread sums one 4 x 4
// tile of the product over the slice's rows in order, two float4 reads a
// row, and writes it to the slice's partial; gru_scan_bwd_reduce_kernel sums
// the partials in slice order.  No atomics, so two runs give the same bits.
// TILED (above N = 64): tiles of kqt x mqt groups, and R / S chunks a slice;
// otherwise one tile, one chunk (R = S), up to (17 x 48) threads at N = 64.
template <typename TH, bool TILED>
__global__ void __launch_bounds__(TILED ? 256 : 1024)
gru_bwd_dw_any_kernel(const TH* __restrict__ h_seq, const float* __restrict__ g_rz,
                  const float* __restrict__ g_n, int rz_stride, int n_stride,
                  float* __restrict__ partial, int B, int T, int N, int S, int R,
                  int kqt_, int mqt_) {
  extern __shared__ __align__(16) float smem[];
  const int n3 = 3 * N;
  const int kq = (N + 4) / 4;   // float4 groups of the N + 1 product rows
  const int mq = (n3 + 3) / 4;  // float4 groups of the 3N columns
  const int kqt = TILED ? kqt_ : kq, mqt = TILED ? mqt_ : mq;
  const int tiles_m = TILED ? (mq + mqt - 1) / mqt : 1;
  const int tiles = TILED ? ((kq + kqt - 1) / kqt) * tiles_m : 1;
  const int slice = TILED ? blockIdx.x / tiles : blockIdx.x;
  const int tile = TILED ? blockIdx.x % tiles : 0;
  const int k0 = TILED ? (tile / tiles_m) * kqt : 0, m0 = TILED ? (tile % tiles_m) * mqt : 0;
  float* hs = smem;             // (S, 4 kqt)
  float* gs = hs + S * 4 * kqt; // (S, 4 mqt)
  const int c = blockIdx.y;
  const int total = B * T;
  const int r_begin = slice * R, r_end = min(total, r_begin + R);
  const size_t cbase = (size_t)c * total;
  const int nq = N / 4;
  const bool h_vec = is_f32<TH> && N % 4 == 0 && ((size_t)h_seq & 15) == 0;
  const bool g_vec = N % 4 == 0 && rz_stride % 4 == 0 && n_stride % 4 == 0 &&
                     (((size_t)g_rz | (size_t)g_n) & 15) == 0;
  const int tk = threadIdx.x / mqt, tm = threadIdx.x % mqt;
  float acc[4][4] = {};
  const int chunks = TILED ? (r_end - r_begin + S - 1) / S : 1;
  for (int ch = 0; ch < chunks; ++ch) {
    const int r0 = r_begin + ch * S;
    if (ch > 0) __syncthreads();   // every thread is done with the last chunk
    if (h_vec) {
      const float4* h4g = reinterpret_cast<const float4*>(h_seq);
      fill_shared<8>(reinterpret_cast<float4*>(hs), S * kqt, [=](int e) {
        const int r = r0 + e / kqt, q = k0 + e % kqt;
        if (r >= r_end || q >= kq) return float4{};
        if (q == nq) return float4{1.0f, 0.0f, 0.0f, 0.0f};
        return r % T > 0 ? h4g[(cbase + r - 1) * nq + q] : float4{};
      });
    } else {
      fill_shared<8>(hs, S * 4 * kqt, [=](int e) {
        const int r = r0 + e / (4 * kqt), k = 4 * k0 + e % (4 * kqt);
        if (r >= r_end || k > N) return 0.0f;
        if (k == N) return 1.0f;
        return r % T > 0 ? to_f32(h_seq[(cbase + r - 1) * N + k]) : 0.0f;
      });
    }
    if (g_vec) {
      const float4* rz4 = reinterpret_cast<const float4*>(g_rz);
      const float4* n4 = reinterpret_cast<const float4*>(g_n);
      const int rzq = rz_stride / 4, nsq = n_stride / 4;
      fill_shared<8>(reinterpret_cast<float4*>(gs), S * mqt, [=](int e) {
        const int r = r0 + e / mqt, q = m0 + e % mqt;
        if (r >= r_end || q >= mq) return float4{};
        return q < 2 * nq ? rz4[(cbase + r) * rzq + q] : n4[(cbase + r) * nsq + q - 2 * nq];
      });
    } else {
      fill_shared<8>(gs, S * 4 * mqt, [=](int e) {
        const int r = r0 + e / (4 * mqt), m = 4 * m0 + e % (4 * mqt);
        if (r >= r_end || m >= n3) return 0.0f;
        return m < 2 * N ? g_rz[(cbase + r) * rz_stride + m]
                         : g_n[(cbase + r) * n_stride + m - 2 * N];
      });
    }
    __syncthreads();

    const int rows = min(S, r_end - r0);
    const float4* h4 = reinterpret_cast<const float4*>(hs);
    const float4* g4 = reinterpret_cast<const float4*>(gs);
    for (int rr = 0; rr < rows; ++rr) {
      const float4 hv = h4[rr * kqt + tk];
      const float4 gv = g4[rr * mqt + tm];
      const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ha[a], ga[b], acc[a][b]);
    }
  }
  const int slices = gridDim.x / tiles;
  float* out = partial + ((size_t)c * slices + slice) * (N + 1) * n3;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * (k0 + tk) + a, m = 4 * (m0 + tm) + b;
      if (k <= N && m < n3) out[(size_t)k * n3 + m] = acc[a][b];
    }
}

// ---------------------------------------------------------------------------
// The wide recurrences, N > 64.
//
// A block takes a tile of TB = RB * RG batch rows of one client, WIDE_THREADS
// threads at most; a thread owns work items (unit i, group of RB rows) and
// computes, for each of its RB rows, unit i's three gate sums as float32
// products over k, W_hh's row k read once for the RB rows.  The tile's h
// (forward) or h_{t-1} and d_gh (backward) live in shared memory, two
// buffers by step parity, so a step needs one __syncthreads.  W_hh is
// resident in shared memory (RES) when it fits beside the tile under the
// opt-in limit, and is read from L2 otherwise; where even the tile does not
// fit, its buffers live in `scratch`, device memory of the block's own.
// ---------------------------------------------------------------------------

constexpr int NARROW = 64;         // the warp-per-row kernels' largest N (kernel.py's NARROW)
constexpr int WIDE_THREADS = 256;

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// The block's tile buffers: after W_hh in shared memory (RES), at the start
// of shared memory, or the block's slice of `scratch` (`per_block` floats).
__device__ __forceinline__ float* tile_buffers(float* smem, bool res, size_t w_floats,
                                               float* scratch, size_t per_block) {
  if (scratch != nullptr)
    return scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * per_block;
  return smem + (res ? round4(w_floats) : 0);
}

// Replaces, above N = 64, the Pallas kernel
// repro/kernels/gru_scan/kernel.py::gru_scan (body _gru_kernel).
//
// Bound on this card: at the ARC cohort's shape at N = 128 (C=35, B=128,
// T=24) the product alone is 10.6 GFLOP (0.16 ms at 67 TFLOP/s fp32) beside
// 73 MB moved (0.02 ms), so operations bound it.  Each step of a row still
// waits for the step before, so the tile is the unit of parallelism: C x
// ceil(B / TB) blocks, each T steps of a (TB, N) x (N, 3N) product.
//
// What the design does about it: W_hh stays resident in shared memory (at
// N = 128, 192 KB of the 227 KB) and each value read feeds RB = 8 rows, h
// comes as float4 broadcasts, and x_gates of the step are loaded before the
// product so their latency hides behind it.  h_{t-1} of a thread's own units
// is read back from the tile buffer, so nothing is carried in registers
// across a step and the thread may own any number of units.
template <typename TX, int RB, bool RES>
__global__ void __launch_bounds__(WIDE_THREADS)
gru_scan_fwd_wide_kernel(const TX* __restrict__ xg, const float* __restrict__ w_hh,
                         const float* __restrict__ b_hh, TX* __restrict__ h_seq,
                         float* __restrict__ scratch, int B, int T, int N, int RG) {
  extern __shared__ __align__(16) float smem[];
  const int n3 = 3 * N, NQ = (int)round4(N), TB = RB * RG;
  const int c = blockIdx.y, row0 = blockIdx.x * TB;
  const float* wc = w_hh + (size_t)c * N * n3;
  const float* bc = b_hh + (size_t)c * n3;
  const float* W = wc;
  if constexpr (RES) {
    fill_shared<8>(smem, N * n3, [=](int e) { return wc[e]; });
    W = smem;
  }
  float* buf = tile_buffers(smem, RES, (size_t)N * n3, scratch, 2 * (size_t)TB * NQ);
  for (int e = threadIdx.x; e < 2 * TB * NQ; e += blockDim.x) buf[e] = 0.0f;
  __syncthreads();

  const int items = N * RG;
  for (int t = 0; t < T; ++t) {
    const float* hp = buf + (t & 1) * TB * NQ;        // h_{t-1} of the tile
    float* hn = buf + ((t + 1) & 1) * TB * NQ;         // h_t
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it % N, r0 = (it / N) * RB;
      float xv[3][RB], a[3][RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int row = row0 + r0 + rb;
        const TX* x = xg + (((size_t)c * B + row) * T + t) * n3 + i;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xv[g][rb] = row < B ? to_f32(x[g * N]) : 0.0f;
          a[g][rb] = bc[g * N + i];
        }
      }
      int k = 0;
      for (; k + 4 <= N; k += 4) {
        float4 hv[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          hv[rb] = *reinterpret_cast<const float4*>(hp + (r0 + rb) * NQ + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wk = W + (size_t)(k + q) * n3 + i;
          const float w0 = wk[0], w1 = wk[N], w2 = wk[2 * N];
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            const float hk = q == 0 ? hv[rb].x : q == 1 ? hv[rb].y : q == 2 ? hv[rb].z : hv[rb].w;
            a[0][rb] = fmaf(hk, w0, a[0][rb]);
            a[1][rb] = fmaf(hk, w1, a[1][rb]);
            a[2][rb] = fmaf(hk, w2, a[2][rb]);
          }
        }
      }
      for (; k < N; ++k) {
        const float* wk = W + (size_t)k * n3 + i;
        const float w0 = wk[0], w1 = wk[N], w2 = wk[2 * N];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float hk = hp[(r0 + rb) * NQ + k];
          a[0][rb] = fmaf(hk, w0, a[0][rb]);
          a[1][rb] = fmaf(hk, w1, a[1][rb]);
          a[2][rb] = fmaf(hk, w2, a[2][rb]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int row = row0 + r0 + rb;
        if (row >= B) continue;   // masked rows keep h = 0 in the tile
        const float r = sigmoidf(xv[0][rb] + a[0][rb]);
        const float z = sigmoidf(xv[1][rb] + a[1][rb]);
        const float cand = tanhf(xv[2][rb] + r * a[2][rb]);
        const float h = (1.0f - z) * cand + z * hp[(r0 + rb) * NQ + i];
        hn[(r0 + rb) * NQ + i] = h;
        h_seq[(((size_t)c * B + row) * T + t) * N + i] = from_f32<TX>(h);
      }
    }
    __syncthreads();   // h_t of the tile is in hn
  }
}

// Replaces, above N = 64, the Pallas kernel
// repro/kernels/gru_scan/kernel.py::gru_scan_bwd (body _gru_bwd_kernel): its
// reverse recurrence; gru_bwd_dw_kernel then sums dW_hh and db_hh.
//
// Bound on this card: at the ARC cohort's shape at N = 128 the recurrence's
// two products a step (the gate rebuild h_{t-1} W_hh and d_gh W_hh^T) are
// 21 GFLOP, the whole backward with the dW stage's h^T d_gh 32 GFLOP (0.48 ms
// at 67 TFLOP/s fp32): operations bound it.
//
// What the design does about it: step t, for each of a thread's items, (A)
// rebuilds the step's gates from h_{t-1} in the tile buffer, forms the gate
// cotangents with dh carried in the tile's dh buffer (the item's own cells),
// stores dx_gates and the float32 d_gh output, and publishes d_gh; h_{t-2}
// for step t-1, loaded before (A) and x_gates and dy before each product,
// wait behind the products; h_{t-2} goes to the other h buffer; one
// __syncthreads; then (B) adds d_gh W_hh^T to dh.  At N = 128, W_hh and a
// tile of 4 rows fill the 227 KB: two groups of RB = 2 rows, 256 threads.  W_hh is resident with an
// odd row stride WS, so the lanes of (B), reading column-wise down their own
// rows, hit distinct banks, and (A) reads rows across lanes.
template <typename TX, int RB, bool RES>
__global__ void __launch_bounds__(WIDE_THREADS)
gru_bwd_recur_wide_kernel(const TX* __restrict__ xg, const float* __restrict__ w_hh,
                          const float* __restrict__ b_hh, const TX* __restrict__ h_seq,
                          const TX* __restrict__ dy, TX* __restrict__ dxg,
                          float* __restrict__ dgo, float* __restrict__ scratch,
                          int B, int T, int N, int RG) {
  extern __shared__ __align__(16) float smem[];
  const int n3 = 3 * N, NQ = (int)round4(N), MQ = (int)round4(n3), TB = RB * RG;
  const int WS = RES ? (n3 | 1) : n3;          // W_hh's row stride where it is read
  const int gw = is_f32<TX> ? N : n3;          // dgo's row: dgn, or all of d_gh below float32
  const int c = blockIdx.y, row0 = blockIdx.x * TB;
  const float* wc = w_hh + (size_t)c * N * n3;
  const float* bc = b_hh + (size_t)c * n3;
  const float* W = wc;
  if constexpr (RES) {
    fill_shared<8>(smem, N * WS, [=](int e) {
      const int k = e / WS, m = e % WS;
      return m < n3 ? wc[(size_t)k * n3 + m] : 0.0f;
    });
    W = smem;
  }
  float* dg = tile_buffers(smem, RES, (size_t)N * WS, scratch,
                           (size_t)TB * (2 * MQ + 3 * NQ));   // (2, TB, MQ): d_gh by parity
  float* hb = dg + 2 * TB * MQ;                                // (2, TB, NQ): h_{t-1} by parity
  float* dh = hb + 2 * TB * NQ;                                // (TB, NQ): dh carried
  for (int e = threadIdx.x; e < TB * (2 * MQ + 3 * NQ); e += blockDim.x) dg[e] = 0.0f;
  __syncthreads();
  // h_{t-1} of step t into hb[t & 1] (zero at t = 0 and on masked rows),
  // HQ elements a thread at a time: all loads issued, then all stores.
  // `first` of them may come preloaded in `held` (load_held).
  constexpr int HQ = 4;
  auto h_at = [&](int t, int e) {
    const int r = e / N, k = e % N, row = row0 + r;
    return (t > 0 && row < B) ? to_f32(h_seq[(((size_t)c * B + row) * T + t - 1) * N + k])
                              : 0.0f;
  };
  auto load_held = [&](int t, float (&held)[HQ]) {
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      held[q] = e < TB * N ? h_at(t, e) : 0.0f;
    }
  };
  auto store_h = [&](int t, const float (&held)[HQ]) {
    float* dst = hb + (t & 1) * TB * NQ;
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      if (e < TB * N) dst[(e / N) * NQ + e % N] = held[q];
    }
    for (int base = threadIdx.x + HQ * blockDim.x; base < TB * N; base += HQ * blockDim.x) {
      float v[HQ];
#pragma unroll
      for (int q = 0; q < HQ; ++q) {
        const int e = base + q * blockDim.x;
        v[q] = e < TB * N ? h_at(t, e) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < HQ; ++q) {
        const int e = base + q * blockDim.x;
        if (e < TB * N) dst[(e / N) * NQ + e % N] = v[q];
      }
    }
  };
  float held[HQ];
  load_held(T - 1, held);
  store_h(T - 1, held);
  __syncthreads();

  const int items = N * RG;
  for (int t = T - 1; t >= 0; --t) {
    const float* hp = hb + (t & 1) * TB * NQ;
    float* dgt = dg + (t & 1) * TB * MQ;
    // h_{t-2}, for step t-1, is loaded now and stored after (A): its
    // latency hides behind the products.
    if (t > 0) load_held(t - 1, held);
    // (A) the step's gates and cotangents
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it % N, r0 = (it / N) * RB;
      float a[3][RB], xv[3][RB], dyv[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {   // the step's inputs, loaded before the product
        const int row = row0 + r0 + rb;
        const size_t at = ((size_t)c * B + row) * T + t;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xv[g][rb] = row < B ? to_f32(xg[at * n3 + g * N + i]) : 0.0f;
          a[g][rb] = bc[g * N + i];
        }
        dyv[rb] = row < B ? to_f32(dy[at * N + i]) : 0.0f;
      }
      int k = 0;
      for (; k + 4 <= N; k += 4) {
        float4 hv[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          hv[rb] = *reinterpret_cast<const float4*>(hp + (r0 + rb) * NQ + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wk = W + (size_t)(k + q) * WS + i;
          const float w0 = wk[0], w1 = wk[N], w2 = wk[2 * N];
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            const float hk = q == 0 ? hv[rb].x : q == 1 ? hv[rb].y : q == 2 ? hv[rb].z : hv[rb].w;
            a[0][rb] = fmaf(hk, w0, a[0][rb]);
            a[1][rb] = fmaf(hk, w1, a[1][rb]);
            a[2][rb] = fmaf(hk, w2, a[2][rb]);
          }
        }
      }
      for (; k < N; ++k) {
        const float* wk = W + (size_t)k * WS + i;
        const float w0 = wk[0], w1 = wk[N], w2 = wk[2 * N];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float hk = hp[(r0 + rb) * NQ + k];
          a[0][rb] = fmaf(hk, w0, a[0][rb]);
          a[1][rb] = fmaf(hk, w1, a[1][rb]);
          a[2][rb] = fmaf(hk, w2, a[2][rb]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int row = row0 + r0 + rb;
        if (row >= B) continue;   // masked rows keep d_gh = 0 in the tile
        const size_t at = ((size_t)c * B + row) * T + t;
        const float r = sigmoidf(xv[0][rb] + a[0][rb]);
        const float z = sigmoidf(xv[1][rb] + a[1][rb]);
        const float cand = tanhf(xv[2][rb] + r * a[2][rb]);
        const float hprev = hp[(r0 + rb) * NQ + i];
        const float dht = dyv[rb] + dh[(r0 + rb) * NQ + i];
        const float da_n = dht * (1.0f - z) * (1.0f - cand * cand);
        const float da_r = da_n * a[2][rb] * r * (1.0f - r);
        const float da_z = dht * (hprev - cand) * z * (1.0f - z);
        float* d = dgt + (r0 + rb) * MQ;
        d[i] = da_r;
        d[N + i] = da_z;
        d[2 * N + i] = da_n * r;
        TX* dx = dxg + at * n3 + i;
        dx[0] = from_f32<TX>(da_r);
        dx[N] = from_f32<TX>(da_z);
        dx[2 * N] = from_f32<TX>(da_n);
        float* o = dgo + at * gw + i;
        if constexpr (is_f32<TX>) {
          o[0] = da_n * r;
        } else {
          o[0] = da_r;
          o[N] = da_z;
          o[2 * N] = da_n * r;
        }
        dh[(r0 + rb) * NQ + i] = dht * z;
      }
    }
    if (t > 0) store_h(t - 1, held);
    __syncthreads();   // d_gh of step t and h_{t-2} are in the tile
    // (B) dh_{t-1} = dh_t z + d_gh W_hh^T, on each item's own cells of dh
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it % N, r0 = (it / N) * RB;
      const float* wi = W + (size_t)i * WS;
      float s[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) s[rb] = 0.0f;
      int m = 0;
      for (; m + 4 <= n3; m += 4) {
        const float w0 = wi[m], w1 = wi[m + 1], w2 = wi[m + 2], w3 = wi[m + 3];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float4 v = *reinterpret_cast<const float4*>(dgt + (r0 + rb) * MQ + m);
          s[rb] = fmaf(v.x, w0, s[rb]);
          s[rb] = fmaf(v.y, w1, s[rb]);
          s[rb] = fmaf(v.z, w2, s[rb]);
          s[rb] = fmaf(v.w, w3, s[rb]);
        }
      }
      for (; m < n3; ++m) {
        const float w = wi[m];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) s[rb] = fmaf(dgt[(r0 + rb) * MQ + m], w, s[rb]);
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) dh[(r0 + rb) * NQ + i] += s[rb];
    }
  }
}

// Sums the per-slice partials of gru_bwd_dw_kernel in slice order, eight
// loads in flight a thread.
__global__ void gru_scan_bwd_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dw,
                                           float* __restrict__ db,
                                           int slices, int N) {
  const int n3 = 3 * N;
  const int nacc = (N + 1) * n3;
  const int c = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nacc) return;
  const float* p = partial + (size_t)c * slices * nacc + e;
  float v = 0.0f;
  int i = 0;
  for (; i + 8 <= slices; i += 8) {
    float part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = p[(size_t)(i + q) * nacc];
#pragma unroll
    for (int q = 0; q < 8; ++q) v += part[q];
  }
  for (; i < slices; ++i) v += p[(size_t)i * nacc];
  if (e < N * n3) {
    dw[(size_t)c * N * n3 + e] = v;
  } else {
    db[(size_t)c * n3 + (e - N * n3)] = v;
  }
}

size_t fwd_smem_bytes(int U) {
  const size_t np = 32 * U, mp = 3 * np;
  return sizeof(float) * ((U == 1 ? 0 : np * (mp + 1) + mp) + 2 * RECUR_WARPS * np);
}

size_t recur_smem_bytes(int U) {
  const size_t mp = 3 * 32 * U;
  return sizeof(float) * (32 * U * (mp + 1) + mp + 2 * RECUR_WARPS * (mp + 32 * U));
}

size_t dw_smem_bytes(int kqt, int mqt, int S) {
  return sizeof(float) * (size_t)S * 4 * (kqt + mqt);
}

// Above 48 KB a block gets shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr int MAX_GRID_Y = 65535;  // clients a launch: the client axis is grid y

// Calls launch(c0, cn) for consecutive runs of at most MAX_GRID_Y clients,
// c0 the first; 0 or the first CUDA error.
template <typename F>
int over_clients(int C, F launch) {
  for (int c0 = 0; c0 < C; c0 += MAX_GRID_Y) {
    const int err = launch(c0, C - c0 < MAX_GRID_Y ? C - c0 : MAX_GRID_Y);
    if (err != 0) return err;
  }
  return 0;
}

// Launches a warp-per-row kernel on the grid (row blocks, C), RECUR_WARPS
// rows a block, on `stream`; 0 or the CUDA error.
template <typename K, typename... A>
int launch_rows(K kernel, size_t smem, int C, int B, cudaStream_t stream, A... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + RECUR_WARPS - 1) / RECUR_WARPS, C);
  kernel<<<grid, 32 * RECUR_WARPS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// How a wide recurrence cuts its work: RB rows an item, RG row groups a
// block (a tile of RB * RG rows), `threads` a block, W_hh resident or not,
// the dynamic shared memory, and the floats of device-memory scratch a block
// needs when the tile's buffers do not fit in shared memory (else 0).
struct WidePlan {
  int rb, rg, threads;
  bool resident;
  size_t smem, scratch_per_block;
  int row_blocks(int B) const { return (B + rb * rg - 1) / (rb * rg); }
};

WidePlan wide_plan(int N, int B, bool bwd) {
  int dev = 0, optin = 48 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t limit = (size_t)optin;
  const size_t n3 = 3 * (size_t)N, nq = round4(N), mq = round4(n3);
  const size_t per_row = bwd ? 2 * mq + 3 * nq : 2 * nq;               // tile floats a row
  const size_t w_floats = round4(bwd ? (size_t)N * (n3 | 1) : (size_t)N * n3);
  // Rows an item: each W_hh value read feeds rb rows.  The backward's
  // resident tile has room for 4 rows at N = 128, which it spends on two
  // groups of 2 (8 warps, not 4); read from L2, W_hh goes to 4 rows.
  const int rb_res = bwd ? (B >= 2 ? 2 : 1) : (B >= 8 ? 8 : 1);
  const int rb_l2 = bwd ? (B >= 4 ? 4 : 1) : (B >= 8 ? 8 : 1);
  const int units = (N + 31) / 32 * 32;
  auto groups = [&](int rb) {   // row groups a block: threads for every unit of each
    int rg = WIDE_THREADS / units;
    rg = rg < 1 ? 1 : rg;
    const int most = (B + rb - 1) / rb;
    return rg > most ? most : rg;
  };
  auto threads = [&](int g) {
    const int t = (N * g + 31) / 32 * 32;
    return t < WIDE_THREADS ? t : WIDE_THREADS;
  };
  for (int g = groups(rb_res); g >= 1; g /= 2) {   // W_hh resident beside the largest tile
    const size_t bytes = 4 * (w_floats + (size_t)rb_res * g * per_row);
    if (bytes <= limit) return {rb_res, g, threads(g), true, bytes, 0};
  }
  const int rb = rb_l2, rg = groups(rb_l2);
  if (4 * (size_t)rb * rg * per_row <= limit)
    return {rb, rg, threads(rg), false, 4 * (size_t)rb * rg * per_row, 0};
  if (4 * per_row <= limit) return {1, 1, threads(1), false, 4 * per_row, 0};
  return {1, 1, threads(1), false, 0, per_row};
}

// Launches wide kernel `kernel` on the grid (row blocks, cn clients).
template <typename K, typename... A>
int launch_wide(K kernel, const WidePlan& p, int cn, int B, cudaStream_t stream, A... args) {
  const cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.row_blocks(B), cn), p.threads, p.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Floats of scratch the wide recurrence needs for C clients (0 up to N = 64,
// and wherever the tile fits in shared memory).
long long wide_scratch_floats(int C, int B, int N, bool bwd) {
  if (N <= NARROW) return 0;
  const WidePlan p = wide_plan(N, B, bwd);
  const int cn = C < MAX_GRID_Y ? C : MAX_GRID_Y;
  return (long long)p.scratch_per_block * p.row_blocks(B) * cn;
}

template <typename TX>
int launch_fwd(const TX* xg, const float* w_hh, const float* b_hh, TX* h_seq, float* scratch,
               int C, int B, int T, int N, cudaStream_t stream) {
  const size_t xs = (size_t)B * T * 3 * N, hs = (size_t)B * T * N, ws = (size_t)N * 3 * N;
  const WidePlan p = N > NARROW ? wide_plan(N, B, false) : WidePlan{};
  if (p.scratch_per_block > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return over_clients(C, [&](int c0, int cn) {
    const TX* x = xg + c0 * xs;
    const float* w = w_hh + c0 * ws;
    const float* b = b_hh + c0 * 3 * (size_t)N;
    TX* h = h_seq + c0 * hs;
    if (N <= 32)
      return launch_rows(gru_scan_fwd_kernel<TX, 1>, fwd_smem_bytes(1), cn, B, stream,
                         x, w, b, h, B, T, N);
    if (N <= NARROW)
      return launch_rows(gru_scan_fwd_kernel<TX, 2>, fwd_smem_bytes(2), cn, B, stream,
                         x, w, b, h, B, T, N);
    if (p.rb == 8)
      return p.resident
          ? launch_wide(gru_scan_fwd_wide_kernel<TX, 8, true>, p, cn, B, stream, x, w, b, h,
                        scratch, B, T, N, p.rg)
          : launch_wide(gru_scan_fwd_wide_kernel<TX, 8, false>, p, cn, B, stream, x, w, b, h,
                        scratch, B, T, N, p.rg);
    return p.resident
        ? launch_wide(gru_scan_fwd_wide_kernel<TX, 1, true>, p, cn, B, stream, x, w, b, h,
                      scratch, B, T, N, p.rg)
        : launch_wide(gru_scan_fwd_wide_kernel<TX, 1, false>, p, cn, B, stream, x, w, b, h,
                      scratch, B, T, N, p.rg);
  });
}

// The backward's reverse recurrence: dx_gates, and dgo (float32: dgn (C, B,
// T, N) for float32 activations, all of d_gh (C, B, T, 3N) below).
template <typename TX>
int launch_recur(const TX* xg, const float* w_hh, const float* b_hh, const TX* h_seq,
                 const TX* dy, TX* dxg, float* dgo, float* scratch, int C, int B, int T, int N,
                 cudaStream_t stream) {
  const size_t xs = (size_t)B * T * 3 * N, hs = (size_t)B * T * N, ws = (size_t)N * 3 * N;
  const size_t gs = is_f32<TX> ? hs : xs;
  const WidePlan p = N > NARROW ? wide_plan(N, B, true) : WidePlan{};
  if (p.scratch_per_block > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return over_clients(C, [&](int c0, int cn) {
    const TX* x = xg + c0 * xs;
    const float* w = w_hh + c0 * ws;
    const float* b = b_hh + c0 * 3 * (size_t)N;
    const TX* h = h_seq + c0 * hs;
    const TX* d = dy + c0 * hs;
    TX* dx = dxg + c0 * xs;
    float* g = dgo + c0 * gs;
    if (N <= 32)
      return launch_rows(gru_bwd_recur_kernel<TX, 1>, recur_smem_bytes(1), cn, B, stream,
                         x, w, b, h, d, dx, g, B, T, N);
    if (N <= NARROW)
      return launch_rows(gru_bwd_recur_kernel<TX, 2>, recur_smem_bytes(2), cn, B, stream,
                         x, w, b, h, d, dx, g, B, T, N);
    if (p.resident && p.rb == 2)
      return launch_wide(gru_bwd_recur_wide_kernel<TX, 2, true>, p, cn, B, stream, x, w, b, h,
                         d, dx, g, scratch, B, T, N, p.rg);
    if (!p.resident && p.rb == 4)
      return launch_wide(gru_bwd_recur_wide_kernel<TX, 4, false>, p, cn, B, stream, x, w, b, h,
                         d, dx, g, scratch, B, T, N, p.rg);
    return p.resident
        ? launch_wide(gru_bwd_recur_wide_kernel<TX, 1, true>, p, cn, B, stream, x, w, b, h,
                      d, dx, g, scratch, B, T, N, p.rg)
        : launch_wide(gru_bwd_recur_wide_kernel<TX, 1, false>, p, cn, B, stream, x, w, b, h,
                      d, dx, g, scratch, B, T, N, p.rg);
  });
}

// dW/db over slices of R rows: d_gh's r- and z-parts from g_rz (row stride
// rz_stride), its n-part from g_n (row stride n_stride).  Float32 up to N =
// 64 (g_rz = dx_gates, g_n = dgn) runs gru_bwd_dw_kernel, a block the whole
// (N+1, 3N) product over a slice of R <= 64 rows; otherwise
// gru_bwd_dw_any_kernel, above N = 64 in tiles of 16 x 16 float4 groups and
// chunks of up to 64 rows.
template <typename TH>
int launch_dw(const TH* h_seq, const float* g_rz, const float* g_n, int rz_stride, int n_stride,
              float* partial, float* dw, float* db, int C, int B, int T, int N, int R,
              cudaStream_t stream) {
  const int kq = (N + 4) / 4, mq = (3 * N + 3) / 4;
  const bool tiled = N > NARROW;
  const int kqt = tiled ? 16 : kq, mqt = tiled ? 16 : mq;
  const int S = R < 64 ? R : 64;
  const size_t smem = dw_smem_bytes(kqt, mqt, S);
  cudaError_t err = tiled ? allow_smem(gru_bwd_dw_any_kernel<TH, true>, smem)
                          : allow_smem(gru_bwd_dw_any_kernel<TH, false>, smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (B * T + R - 1) / R;
  const int tiles = ((kq + kqt - 1) / kqt) * ((mq + mqt - 1) / mqt);
  const int nacc = (N + 1) * 3 * N;
  const size_t rows = (size_t)B * T;
  return over_clients(C, [&](int c0, int cn) {
    const TH* h = h_seq + c0 * rows * N;
    const float* gz = g_rz + c0 * rows * rz_stride;
    const float* gn = g_n + c0 * rows * n_stride;
    float* part = partial + (size_t)c0 * slices * nacc;
    const dim3 grid(slices * tiles, cn);
    if (tiled) {
      gru_bwd_dw_any_kernel<TH, true><<<grid, kqt * mqt, smem, stream>>>(
          h, gz, gn, rz_stride, n_stride, part, B, T, N, S, R, kqt, mqt);
    } else if constexpr (is_f32<TH>) {
      gru_bwd_dw_kernel<<<grid, kqt * mqt, smem, stream>>>(h, gz, gn, part, B, T, N, S);
    } else {
      gru_bwd_dw_any_kernel<TH, false><<<grid, kqt * mqt, smem, stream>>>(
          h, gz, gn, rz_stride, n_stride, part, B, T, N, S, R, kqt, mqt);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gru_scan_bwd_reduce_kernel<<<dim3((nacc + 255) / 256, cn), 256, 0, stream>>>(
        part, dw + (size_t)c0 * 3 * N * N, db + (size_t)c0 * 3 * N, slices, N);
    return (int)cudaGetLastError();
  });
}

template <typename TX>
int launch_bwd(const TX* xg, const float* w_hh, const float* b_hh, const TX* h_seq,
               const TX* dy, TX* dxg, float* dgo, float* partial, float* dw, float* db,
               float* scratch, int C, int B, int T, int N, int R, cudaStream_t stream) {
  const int err = launch_recur(xg, w_hh, b_hh, h_seq, dy, dxg, dgo, scratch, C, B, T, N, stream);
  if (err != 0) return err;
  if constexpr (is_f32<TX>) {
    return launch_dw(h_seq, dxg, dgo, 3 * N, N, partial, dw, db, C, B, T, N, R, stream);
  } else {
    return launch_dw(h_seq, dgo, dgo + 2 * N, 3 * N, 3 * N, partial, dw, db, C, B, T, N, R,
                     stream);
  }
}

// Calls f with a null pointer of the activation type that `dtype` names:
// 0 float32, 1 bfloat16, 2 float16.
template <typename F>
int with_dtype(int dtype, F f) {
  switch (dtype) {
    case 0: return f(static_cast<float*>(nullptr));
    case 1: return f(static_cast<__nv_bfloat16*>(nullptr));
    case 2: return f(static_cast<__half*>(nullptr));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every entry point returns its launches' first cudaGetLastError() (0 on
// success).  `dtype` names the activation type (0 float32, 1 bfloat16, 2
// float16); `scratch` is null unless gru_wide_scratch asks for floats.
int gru_scan_fwd(const void* xg, const float* w_hh, const float* b_hh, void* h_seq,
                 float* scratch, int C, int B, int T, int N, int dtype, void* stream) {
  return with_dtype(dtype, [&](auto tag) {
    using TX = std::remove_pointer_t<decltype(tag)>;
    return launch_fwd(static_cast<const TX*>(xg), w_hh, b_hh, static_cast<TX*>(h_seq), scratch,
                      C, B, T, N, (cudaStream_t)stream);
  });
}

// The backward: the recurrence, then dW/db over slices of R rows.  dgo
// (float32; (C, B, T, N) for float32 activations, (C, B, T, 3N) below) and
// partial (C, slices, N+1, 3N) are scratch; dw and db are float32.
int gru_scan_bwd(const void* xg, const float* w_hh, const float* b_hh, const void* h_seq,
                 const void* dy, void* dxg, float* dgo, float* partial, float* dw, float* db,
                 float* scratch, int C, int B, int T, int N, int R, int dtype, void* stream) {
  return with_dtype(dtype, [&](auto tag) {
    using TX = std::remove_pointer_t<decltype(tag)>;
    return launch_bwd(static_cast<const TX*>(xg), w_hh, b_hh, static_cast<const TX*>(h_seq),
                      static_cast<const TX*>(dy), static_cast<TX*>(dxg), dgo, partial, dw, db,
                      scratch, C, B, T, N, R, (cudaStream_t)stream);
  });
}

// Writes to *floats the floats of scratch a wide recurrence needs (bwd: the
// backward's), or 0; returns 0 or the CUDA error of the device query.
int gru_wide_scratch(int C, int B, int N, int bwd, long long* floats) {
  *floats = wide_scratch_floats(C, B, N, bwd != 0);
  return (int)cudaGetLastError();
}

// Each stage of the float32 backward alone, for checks and timing.
int gru_bwd_recur(const float* xg, const float* w_hh, const float* b_hh, const float* h_seq,
                  const float* dy, float* dxg, float* dgn, float* scratch, int C, int B, int T,
                  int N, void* stream) {
  return launch_recur(xg, w_hh, b_hh, h_seq, dy, dxg, dgn, scratch, C, B, T, N,
                      (cudaStream_t)stream);
}

int gru_bwd_dw(const float* h_seq, const float* dxg, const float* dgn, float* partial,
               float* dw, float* db, int C, int B, int T, int N, int R, void* stream) {
  return launch_dw(h_seq, dxg, dgn, 3 * N, N, partial, dw, db, C, B, T, N, R,
                   (cudaStream_t)stream);
}

}  // extern "C"
