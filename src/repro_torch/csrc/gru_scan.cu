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
// Both recurrences, the forward and the backward's reverse one, run one warp
// per (client, batch row), RECUR_WARPS rows a block, on the grid (row
// blocks, C): lane j owns hidden unit j and, above N = 32, unit j + 32, and
// the lanes exchange a step's vector through a per-warp strip of shared
// memory behind one __syncwarp.  The backward then sums dW_hh and db_hh over
// slices of the B*T rows and sums the slices' partials in order.  Rows >= B
// are masked: they load nothing, store nothing and contribute zero to the
// weight cotangents.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

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
template <int U>
__global__ void __launch_bounds__(32 * RECUR_WARPS)
gru_scan_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, float* __restrict__ h_seq,
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
  const float* x_row = xg + base * T * n3;
  float* h_row = h_seq + base * T * N;

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
  const float* x_next[U];      // this lane's x_gates of the next step loaded
  float* h_next[U];            // and its h_seq entry of the next step stored
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
      for (int g = 0; g < 3; ++g) in.x[g][u] = ok ? x_next[u][g * N] : 0.0f;
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
      if (valid[u]) *h_next[u] = h[u];
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
template <int U>
__global__ void __launch_bounds__(32 * RECUR_WARPS)
gru_bwd_recur_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, const float* __restrict__ h_seq,
                     const float* __restrict__ dy, float* __restrict__ dxg,
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
  const float* x_row = xg + base * T * n3;
  const float* h_row = h_seq + base * T * N;
  const float* dy_row = dy + base * T * N;
  float* dx_row = dxg + base * T * n3;
  float* dgn_row = dgn + base * T * N;

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
      for (int g = 0; g < 3; ++g) in.x[g][u] = ok ? x_row[(size_t)t * n3 + g * N + unit[u]] : 0.0f;
      in.dy[u] = ok ? dy_row[(size_t)t * N + unit[u]] : 0.0f;
      in.hp[u] = (ok && t > 0) ? h_row[(size_t)(t - 1) * N + unit[u]] : 0.0f;
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
    float* dx_t = dx_row + (size_t)t * n3;
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
        dx_t[unit[u]] = da_r;
        dx_t[N + unit[u]] = da_z;
        dx_t[2 * N + unit[u]] = da_n;
        dgn_row[(size_t)t * N + unit[u]] = da_n * r;
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

size_t dw_smem_bytes(int N, int S) {
  return sizeof(float) * (size_t)S * 4 * ((N + 4) / 4 + (3 * N + 3) / 4);
}

// Above 48 KB a block gets shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// The backward's two stages, each on the stream given; 0 or the first CUDA error.
int launch_recur(const float* xg, const float* w_hh, const float* b_hh, const float* h_seq,
                 const float* dy, float* dxg, float* dgn, int C, int B, int T, int N,
                 cudaStream_t stream) {
  if (N <= 32) {
    return launch_rows(gru_bwd_recur_kernel<1>, recur_smem_bytes(1), C, B, stream, xg, w_hh,
                       b_hh, h_seq, dy, dxg, dgn, B, T, N);
  }
  return launch_rows(gru_bwd_recur_kernel<2>, recur_smem_bytes(2), C, B, stream, xg, w_hh, b_hh,
                     h_seq, dy, dxg, dgn, B, T, N);
}

int launch_dw(const float* h_seq, const float* dxg, const float* dgn, float* partial, float* dw,
              float* db, int C, int B, int T, int N, int S, cudaStream_t stream) {
  const size_t smem = dw_smem_bytes(N, S);
  cudaError_t err = allow_smem(gru_bwd_dw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (B * T + S - 1) / S;
  const int threads = ((N + 4) / 4) * ((3 * N + 3) / 4);
  gru_bwd_dw_kernel<<<dim3(slices, C), threads, smem, stream>>>(h_seq, dxg, dgn, partial,
                                                                B, T, N, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nacc = (N + 1) * 3 * N;
  gru_scan_bwd_reduce_kernel<<<dim3((nacc + 255) / 256, C), 256, 0, stream>>>(partial, dw, db,
                                                                             slices, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns its launches' first cudaGetLastError() (0 on success).
int gru_scan_fwd(const float* xg, const float* w_hh, const float* b_hh, float* h_seq,
                 int C, int B, int T, int N, void* stream) {
  if (N <= 32) {
    return launch_rows(gru_scan_fwd_kernel<1>, fwd_smem_bytes(1), C, B, (cudaStream_t)stream,
                       xg, w_hh, b_hh, h_seq, B, T, N);
  }
  return launch_rows(gru_scan_fwd_kernel<2>, fwd_smem_bytes(2), C, B, (cudaStream_t)stream, xg,
                     w_hh, b_hh, h_seq, B, T, N);
}

// The backward: the recurrence (RECUR_WARPS rows a block), then dW/db over
// slices of S rows.  dgn (C, B, T, N) and partial (C, slices, N+1, 3N) are
// scratch.
int gru_scan_bwd(const float* xg, const float* w_hh, const float* b_hh, const float* h_seq,
                 const float* dy, float* dxg, float* dgn, float* partial, float* dw, float* db,
                 int C, int B, int T, int N, int S, void* stream) {
  const int err = launch_recur(xg, w_hh, b_hh, h_seq, dy, dxg, dgn, C, B, T, N,
                               (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_dw(h_seq, dxg, dgn, partial, dw, db, C, B, T, N, S, (cudaStream_t)stream);
}

// Each stage alone, for checks and timing.
int gru_bwd_recur(const float* xg, const float* w_hh, const float* b_hh, const float* h_seq,
                  const float* dy, float* dxg, float* dgn, int C, int B, int T, int N,
                  void* stream) {
  return launch_recur(xg, w_hh, b_hh, h_seq, dy, dxg, dgn, C, B, T, N, (cudaStream_t)stream);
}

int gru_bwd_dw(const float* h_seq, const float* dxg, const float* dgn, float* partial,
               float* dw, float* db, int C, int B, int T, int N, int S, void* stream) {
  return launch_dw(h_seq, dxg, dgn, partial, dw, db, C, B, T, N, S, (cudaStream_t)stream);
}

}  // extern "C"
