// Mamba2 SSD chunked scan, forward and backward, for Hopper (sm_90a).  Plain
// C interface, loaded with ctypes by repro_torch/kernels/ssd/kernel.py.  All
// tensors are contiguous:
//
//   x, dy (B, NC, L, H, P)   dt, cum (B, NC, L, H)   Bm, Cm (B, NC, L, N)
//   states, dS (B, NC, H, P, N)   G, dG (B, NC, L, L)
//
// x, dt, cum, Bm, Cm and dy, and the outputs y, dx, ddt, dcum, dB and dC,
// are float32, bfloat16 or float16 (the storage type T, one for all of
// them); the entry states, G, dG and the dS carries are always float32.
// Every load of a T tensor is widened to float32 on its way into shared
// memory, every product, exp, mask and decay is float32, and each output is
// rounded to T once, at its store, as the reference does.
//
// Replaces the Pallas kernels repro/kernels/ssd/kernel.py::ssd_chunk_scan
// (bodies _ssd_kernel and _ssd_kernel_with_states) and ::ssd_chunk_scan_bwd
// (body _ssd_bwd_kernel).
//
// For each batch row b, chunk k and head h, with S_0 = 0:
//
//   y[l]  = sum_{m <= l} G[l][m] exp(cum_l - cum_m) dt_m x_m + e_l C_l . S_k
//   S_k+1 = S_k exp(cum_last) + sum_l indec_l x_l^T B_l
//
// with G = C B^T (shared by the heads), e_l = exp(cum_l) and indec_l =
// exp(cum_last - cum_l) dt_l.  The backward, with dS_k the cotangent of
// S_k+1, W = G decay dt_m, dW = dy x^T, Q = dW G decay, V = B dS^T and
// g_l = x_l . V_l:
//
//   dx_m   = sum_l W[l][m] dy_l + indec_m V_m
//   ddt_m  = sum_l Q[l][m] + g_m exp(cum_last - cum_m)
//   dcum_l = sum_m Q[l][m] dt_m - dt_l sum_m Q[m][l] + e_l dy_l . (C S_k^T)_l
//            - g_l indec_l  (+ <dS_k, S_k+1> on the last row)
//   dC_l   = sum_h [sum_m dG_h[l][m] B_m + e_l dy_l S_k]
//   dB_m   = sum_h [sum_l dG_h[l][m] C_l + indec_m x_m dS_k]
//   dS_k-1 = dS_k exp(cum_last) + sum_l (e_l dy_l)^T C_l
//
// where dG_h = dW decay dt_m.  The last row's dcum term is written
// <dS_k, S_k+1>: it equals <dS_k, S_k> exp(cum_last) + sum_l g_l indec_l,
// since S_k+1 = S_k exp(cum_last) + sum_l indec_l x_l^T B_l.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s float32 on the CUDA
// cores, 495 TFLOP/s TF32 on the tensor cores).  At the slice's shape (B=8,
// NC=8, L=256, H=24, P=64, N=128) the forward moves ~221 MB (0.066 ms) and
// needs ~21 GFLOP (0.30 ms at 67 TFLOP/s); the backward moves ~0.39 GB
// (0.12 ms) and needs ~41 GFLOP (0.61 ms).  Operations bound both.  Here
// every tile product runs on the tensor cores in 3xTF32, three TF32 products
// per product (at most 165 TFLOP/s), so the arithmetic these kernels run is
// bound at ~0.13 ms forward and ~0.25 ms backward (chip_smoke.py prints both
// bounds).  In bfloat16 and float16 the bytes halve and the arithmetic, all
// float32, stays: operations bound them further still.
//
// Design.  The chunked algorithm (arXiv:2405.21060, section 6): per-chunk
// work in parallel, only the P x N state carry in sequence.
//
//   forward   1. ssd_cb_kernel       G = C B^T, causal 64 x 64 tiles, once per
//                                    (batch, chunk), into scratch (B, NC, L, L)
//             2. ssd_local_kernel    sum_l indec_l x_l^T B_l for each (b, k, h)
//                                    into `states`
//             3. ssd_pass_kernel     S_k+1 = S_k exp(cum_last) + local_k, in
//                                    place: `states` becomes the entry states
//             4. ssd_y_kernel        y for each (b, k, h, 64-row query tile)
//   backward  1. ssd_cb_kernel       G, as forward 1
//             2. ssd_local_kernel    F_k = sum_l (e_l dy_l)^T C_l into scratch
//             3. ssd_pass_kernel     the reverse carry: F becomes dS in place
//             4. ssd_bwd_head_kernel dx, ddt, dcum for each (b, k, h, tile)
//             5. ssd_bwd_dg_kernel   dG = sum_h dW_h decay_h dt_h per causal
//                                    tile, over the heads in order, into G's
//                                    scratch
//             6. ssd_bwd_dbc_kernel  dC = dG B + [e dy]_(L x HP) [S]_(HP x N),
//                                    dB = dG^T C + [indec x]_(L x HP) [dS]_(HP x N),
//                                    the heads summed inside a block in order
//
// What this does about the earlier design's limits:
//
//   1. One block per (batch, head) walking the chunks gave 192 blocks.  Here
//      the chunk-local work runs over (b, k, h, tile): 6,144 blocks for y and
//      for the backward's per-head terms at the slice's shape; only the
//      elementwise state passes walk the chunks.
//   2. C B^T is formed once per (batch, chunk) and read by every head.
//   3. No head shares of dB and dC: the backward sums the heads inside a
//      block, recomputing dW_h = dy_h x_h^T in ssd_bwd_dg_kernel, and no
//      output is ever read back and added to in device memory.  Scratch is
//      G (B NC L^2 floats) and dS (B NC H P N floats): 67 MB at the slice's
//      shape, against the 403 MB of head shares it replaces.
//   4. Every tile product is mma.sync.m16n8k8 on TF32 operands in 3xTF32:
//      each operand is split into hi = tf32(a) and lo = tf32(a - hi), and
//      lo*hi + hi*lo + hi*hi is summed in float32, which keeps float32
//      accuracy.  exp, masks, row and column sums and decays stay float32 on
//      the CUDA cores.  Tiles are staged with cp.async (16-byte copies where
//      rows allow, else 4-byte), double-buffered, in 64-column rows whose
//      4-float groups are XOR-swizzled by the row, so that both fragment
//      access patterns (lanes along rows, or along columns) hit 32 banks.
//      A 16-bit tile goes through registers instead (16-byte loads of 8
//      elements, widened, stored as two float4), so it is staged when issued.
//   5. Below float32 every tile product is exact (warp_mma_exact): one
//      operand is a 16-bit input's, exact in TF32, the other is split into
//      three TF32 parts, and each 8-deep step is added on the CUDA cores.
//      3xTF32 and the tensor cores' long accumulation chains leave ~8e-5 of
//      max|dB| at zamba2's shape, several 16-bit last places; this path
//      stays within one of the float64 answer.  The float32 kernels keep
//      3xTF32, their earlier bits.
//
// Any shape.  Up to L = 256, P = 64 and N = 128 every launch is the one the
// kernels had when those were their limits.  Above them:
//
//   - P is taken in 64-column tiles: a "virtual head" (h, p-tile) on the grid
//     of the local, y and head kernels, and one more step a head in the dG
//     and dB/dC kernels, whose products sum over P.  ddt and dcum sum over P
//     too: above P = 64 the head kernel writes one float32 partial a p-tile
//     and ssd_sum_parts_kernel adds them in order and rounds once.
//   - N is taken in 64-column halves, any number of them: G's product runs
//     them through a two-stage ring, and the local kernel takes 128 columns
//     of the state a block (a grid axis of column groups).
//   - The per-row arrays (the local kernel's row scales, the y and head
//     kernels' cum and dt rows) are sized from L at launch in dynamic shared
//     memory, never below the 256 rows they had; the head kernel's arrays
//     fill its shared memory at L = 16,320, the longest chunk taken.
//   - Grid y and z hold at most 65,535: the (batch, chunk) rows, and the
//     batch rows and chunks of the local and pass kernels, run in launches
//     of at most 65,535 each, the kernels offset by the run's first row (the
//     state pass by whole batch rows, so a carry never crosses a launch).
//
// Sums are taken in a fixed order and there are no atomics, so two runs give
// the same bits.  Entries above the diagonal, and past L, are set to zero
// before exp is evaluated (cum_l - cum_m is large and positive there).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;         // rows of a tile; columns of a shared tile
constexpr int TILE_FLOATS = TILE * TILE;
constexpr int THREADS = 256;     // 8 warps
constexpr int MIN_ROWS = 256;    // the per-row arrays' least length (floats)
constexpr int MAX_GRID = 65535;  // grid y and z
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on this card

__host__ __device__ __forceinline__ int tiles_of(int L) { return (L + TILE - 1) / TILE; }
__host__ __device__ __forceinline__ int p_tiles(int P) { return (P + TILE - 1) / TILE; }
__host__ __device__ __forceinline__ int n_groups(int N) { return (N + 2 * TILE - 1) / (2 * TILE); }
// Length of the per-row arrays of a chunk of L rows.
__host__ __device__ __forceinline__ int rows_of(int L) {
  return tiles_of(L) * TILE > MIN_ROWS ? tiles_of(L) * TILE : MIN_ROWS;
}

// T tensors in and out of float32 (round to nearest even on the way out).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

// ---------------------------------------------------------------------------
// Shared tiles: 64 rows of 64 floats.  Element (r, c) lives at
// r * 64 + (c ^ swz(r)); swz permutes 4-float groups (bits 2-4 of c), so a
// 16-byte copy stays whole.  A fragment read with lanes (g, t) = (lane / 4,
// lane % 4) at (r0 + g, c0 + t) or at (r0 + t, c0 + g), r0 and c0 multiples
// of 8, touches 32 different banks either way.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int at(int r, int c) { return r * TILE + (c ^ swz(r)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, rows) and columns [0, cols) of a row-major matrix (row stride `ld`
// floats) into a shared tile, zero elsewhere.  16-byte copies when every row
// start is 16-byte aligned and cols is a multiple of 4.
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, size_t ld,
                                          int rows, int cols) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) && (ld % 4 == 0) &&
                   (cols % 4 == 0);
  if (vec) {
    for (int e = threadIdx.x; e < TILE * TILE / 4; e += THREADS) {
      const int r = e >> 4;
      const int c = (e & 15) << 2;
      float* dst = tile + at(r, c);
      if (r < rows && c < cols) {
        cp_async16(dst, src + r * ld + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e >> 6;
      const int c = e & 63;
      float* dst = tile + at(r, c);
      if (r < rows && c < cols) {
        cp_async4(dst, src + r * ld + c);
      } else {
        *dst = 0.f;
      }
    }
  }
}

// The same from a 16-bit matrix, through registers, widened to float32: 8
// elements (16 bytes) a load when rows start 16-byte aligned and cols is a
// multiple of 8, else one at a time.  The tile is written when this returns.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, size_t ld,
                                          int rows, int cols) {
  static_assert(sizeof(T) == 2, "16-bit tiles only");
  const bool vec = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) && (ld % 8 == 0) &&
                   (cols % 8 == 0);
  if (vec) {
    for (int e = threadIdx.x; e < TILE * TILE / 8; e += THREADS) {
      const int r = e >> 3;
      const int c = (e & 7) << 3;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (r < rows && c < cols) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ld + c);
        const T* v = reinterpret_cast<const T*>(&raw);
        lo = make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]), to_f32(v[3]));
        hi = make_float4(to_f32(v[4]), to_f32(v[5]), to_f32(v[6]), to_f32(v[7]));
      }
      *reinterpret_cast<float4*>(tile + at(r, c)) = lo;
      *reinterpret_cast<float4*>(tile + at(r, c + 4)) = hi;
    }
  } else {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e >> 6;
      const int c = e & 63;
      tile[at(r, c)] = (r < rows && c < cols) ? to_f32(src[r * ld + c]) : 0.f;
    }
  }
}

// `count` values with stride `ld` into vec[0, 64), zero past count.
__device__ __forceinline__ void load_vec(float* vec, const float* __restrict__ src, size_t ld,
                                         int count) {
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    if (e < count) {
      cp_async4(vec + e, src + e * ld);
    } else {
      vec[e] = 0.f;
    }
  }
}
template <typename T>
__device__ __forceinline__ void load_vec(float* vec, const T* __restrict__ src, size_t ld,
                                         int count) {
  for (int e = threadIdx.x; e < TILE; e += THREADS) vec[e] = e < count ? to_f32(src[e * ld]) : 0.f;
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores.  mma.m16n8k8 fragments, lane = 4 g + t:
//   A (16 x 8):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (t, g)  b1 (t + 4, g)                   (k, n)
//   D (16 x 8):  d0 (g, 2t) d1 (g, 2t + 1) d2 (g + 8, 2t) d3 (g + 8, 2t + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc (16 rows x 8 NT columns) += A (16 x 64) B (64 x 8 NT), over k
// in [0, 64) by steps of 8.  fa(r, k) gives A at row r in [0, 16); fb(k, n)
// gives B at column n in [0, 8 NT).  Small products first: lo*hi, hi*lo, then
// hi*hi, each over all NT tiles in turn, so that NT independent products lie
// between two into one accumulator.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], FA fa, FB fb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < TILE; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(fa(g, k0 + t), ah[0], al[0]);
    split_tf32(fa(g + 8, k0 + t), ah[1], al[1]);
    split_tf32(fa(g, k0 + t + 4), ah[2], al[2]);
    split_tf32(fa(g + 8, k0 + t + 4), ah[3], al[3]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(fb(k0 + t, 8 * j + g), bh[j][0], bl[j][0]);
      split_tf32(fb(k0 + t + 4, 8 * j + g), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j]);
  }
}

// Row and column, within the warp's 16 x 8 NT output, of accumulator entry
// acc[j][i].
__device__ __forceinline__ int acc_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int acc_col(int j, int i) {
  return 8 * j + 2 * (threadIdx.x & 3) + (i & 1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// The three TF32 parts of v, smallest first: lo + mid + hi carries all 24 bits
// of v (hi = tf32(v), mid = tf32(v - hi), lo = tf32(v - hi - mid), each
// difference exact in float32).
__device__ __forceinline__ void split3_tf32(float v, uint32_t (&part)[3]) {
  uint32_t unused;
  split_tf32(v, part[2], part[1]);
  split_tf32((v - __uint_as_float(part[2])) - __uint_as_float(part[1]), part[0], unused);
}

// The TF32 parts of v in P registers: P = 1 for a value that TF32 holds
// exactly (a 16-bit input's), P = 3 otherwise.
template <int P>
__device__ __forceinline__ void tf32_parts(float v, uint32_t (&part)[P]) {
  if constexpr (P == 1) {
    part[0] = __float_as_uint(v);
  } else {
    split3_tf32(v, part);
  }
}

// One warp, below float32: acc += A B as warp_mma, with every product exact.
// The storage type's values are exact in TF32 (bfloat16 and float16 carry
// at most 11 significant bits), so at most one operand needs parts: kSplit
// 0 takes both whole (16-bit inputs both), 1 splits B and 2 splits A into
// three TF32 parts, and each part's product is exact in the float32 sum.
// Each 8-deep step sums on the tensor cores into a fresh accumulator,
// smallest parts first, and is added to acc on the CUDA cores (round to
// nearest): a long chain of tensor-core additions loses a little at each
// one, always the same way.  No product is dropped, unlike 3xTF32's lo*lo.
template <int kSplit, int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma_exact(float (&acc)[NT][4], FA fa, FB fb) {
  constexpr int PA = kSplit == 2 ? 3 : 1, PB = kSplit == 1 ? 3 : 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < TILE; k0 += 8) {
    uint32_t a[4][PA], b[NT][2][PB];
    tf32_parts<PA>(fa(g, k0 + t), a[0]);
    tf32_parts<PA>(fa(g + 8, k0 + t), a[1]);
    tf32_parts<PA>(fa(g, k0 + t + 4), a[2]);
    tf32_parts<PA>(fa(g + 8, k0 + t + 4), a[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tf32_parts<PB>(fb(k0 + t, 8 * j + g), b[j][0]);
      tf32_parts<PB>(fb(k0 + t + 4, 8 * j + g), b[j][1]);
    }
    float d[NT][4];
    zero(d);
#pragma unroll
    for (int pa = 0; pa < PA; ++pa)
#pragma unroll
      for (int pb = 0; pb < PB; ++pb)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t af[4] = {a[0][pa], a[1][pa], a[2][pa], a[3][pa]};
          const uint32_t bf[2] = {b[j][0][pb], b[j][1][pb]};
          mma_tf32(d[j], af, bf);
        }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += d[j][i];
  }
}

// acc += A B: in the float32 kernels warp_mma (3xTF32, their earlier bits);
// below float32 warp_mma_exact<kSplit>, kSplit naming the operand that is not
// a 16-bit input's (1: B, 2: A, 0: neither).
template <typename T, int kSplit, int NT, typename FA, typename FB>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], FA fa, FB fb) {
  if constexpr (std::is_same<T, float>::value) {
    warp_mma<NT>(acc, fa, fb);
  } else {
    warp_mma_exact<kSplit, NT>(acc, fa, fb);
  }
}

// The causal tile pair (lt, mt), mt <= lt, of index p in row order.
__device__ __forceinline__ void pair_of(int p, int& lt, int& mt) {
  lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= p) ++lt;
  mt = p - lt * (lt + 1) / 2;
}

// Warp w of 8 owns rows 16 (w % 4) and columns 32 (w / 4) of a 64 x 64 output
// (4 accumulator tiles of 8 columns), or columns 64 (w / 4) of a 64 x 128
// output (8 tiles).
__device__ __forceinline__ int warp_row0() { return 16 * ((threadIdx.x >> 5) & 3); }
__device__ __forceinline__ int warp_col0(int width) {
  return (width / 2) * (threadIdx.x >> 7);
}

// ===========================================================================
// Forward 1 and backward 1: G = C B^T, one causal 64 x 64 tile (lt, mt) of one
// (batch, chunk) per block.  grid (tiles (tiles + 1) / 2, rows of the run).
// The depth N is staged in 64-column halves through a two-stage ring, the
// next half in flight while one is used.  kBackward only names the launch (a
// profile tells the two apart).
// ===========================================================================

template <typename T, bool kBackward>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ G,
              int L, int N, int row0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // per stage: C tile, B tile
  int lt, mt;
  pair_of(blockIdx.x, lt, mt);
  const size_t bc = (size_t)row0 + blockIdx.y;
  const int l0 = lt * TILE, m0 = mt * TILE;
  const int lrows = min(TILE, L - l0), mrows = min(TILE, L - m0);
  const int halves = (N + TILE - 1) / TILE;
  auto issue = [&](int hf) {
    float* cs = smem + 2 * (hf & 1) * TILE_FLOATS;
    const int cols = min(TILE, N - hf * TILE);
    load_tile(cs, cm + (bc * L + l0) * N + hf * TILE, N, lrows, cols);
    load_tile(cs + TILE_FLOATS, bm + (bc * L + m0) * N + hf * TILE, N, mrows, cols);
    cp_commit();
  };
  issue(0);
  const int rm = warp_row0(), cn = warp_col0(TILE);
  float acc[4][4];
  zero(acc);
  for (int hf = 0; hf < halves; ++hf) {
    if (hf + 1 < halves) {
      issue(hf + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* cs = smem + 2 * (hf & 1) * TILE_FLOATS;
    const float* bs = cs + TILE_FLOATS;
    tile_mma<T, 0>(acc, [&](int r, int k) { return cs[at(rm + r, k)]; },
                   [&](int k, int n) { return bs[at(cn + n, k)]; });
    if (hf + 2 < halves) __syncthreads();  // the next issue overwrites this stage
  }
  float* gt = G + bc * L * L;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = rm + acc_row(i), m = cn + acc_col(j, i);
      if (l < lrows && m < mrows) gt[(size_t)(l0 + l) * L + m0 + m] = acc[j][i];
    }
}

// ===========================================================================
// Forward 2 and backward 2: out[b, k, h] (P x N) = sum_l s_l X_l^T Y_l for the
// chunks k in [c0, c0 + gridDim.y).  Forward: X = x, Y = B, s = indec (the
// chunk-local state); backward: X = dy, Y = C, s = e (the carry F_k).
// grid (H x p-tiles x column groups, chunks, batch rows of the run): a block
// forms 64 rows p and 128 columns n of one head's output.  Over l by 64-row
// tiles, double-buffered.
// ===========================================================================

template <typename T, bool kBackward>
__global__ void __launch_bounds__(THREADS)
ssd_local_kernel(const T* __restrict__ xs_src, const T* __restrict__ dt,
                 const T* __restrict__ cum, const T* __restrict__ ys_src,
                 float* __restrict__ out, int NC, int L, int H, int P, int N, int c0, int b0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x (X, Y half 0, Y half 1)
  float* scale = smem + 6 * TILE_FLOATS;          // (rows_of(L))
  const int groups = p_tiles(P) * n_groups(N);
  const int h = blockIdx.x / groups;
  const int p0 = (blockIdx.x % groups) / n_groups(N) * TILE;
  const int n0 = (blockIdx.x % n_groups(N)) * 2 * TILE;
  const int c = c0 + blockIdx.y;
  const size_t bc = ((size_t)b0 + blockIdx.z) * NC + c;
  const int tiles = tiles_of(L);
  const int prow = min(TILE, P - p0), ncols = min(2 * TILE, N - n0);
  const int halves = (ncols + TILE - 1) / TILE;

  auto issue = [&](int kt) {
    float* st = smem + (kt & 1) * 3 * TILE_FLOATS;
    const int rows = min(TILE, L - kt * TILE);
    const size_t row = bc * L + kt * TILE;
    load_tile(st, xs_src + (row * H + h) * P + p0, (size_t)H * P, rows, prow);
    for (int hf = 0; hf < halves; ++hf)
      load_tile(st + (1 + hf) * TILE_FLOATS, ys_src + row * N + n0 + hf * TILE, N, rows,
                min(TILE, ncols - hf * TILE));
    cp_commit();
  };
  issue(0);
  const float cum_last = to_f32(cum[(bc * L + L - 1) * H + h]);
  for (int l = threadIdx.x; l < rows_of(L); l += THREADS) {
    float s = 0.f;
    if (l < L) {
      const float cl = to_f32(cum[(bc * L + l) * H + h]);
      s = kBackward ? expf(cl) : expf(cum_last - cl) * to_f32(dt[(bc * L + l) * H + h]);
    }
    scale[l] = s;
  }

  const int rm = warp_row0(), cn = warp_col0(2 * TILE);
  float acc[8][4];
  zero(acc);
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {
      issue(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xt = smem + (kt & 1) * 3 * TILE_FLOATS;
    const float* yt = xt + (1 + cn / TILE) * TILE_FLOATS;
    const float* sc = scale + kt * TILE;
    if (cn < ncols)  // warp-uniform: the second half exists only for 64 < ncols
      tile_mma<T, 2>(acc, [&](int r, int k) { return sc[k] * xt[at(k, rm + r)]; },
                     [&](int k, int n) { return yt[at(k, n)]; });
    __syncthreads();
  }
  float* o = out + (bc * H + h) * P * N + (size_t)p0 * N + n0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = rm + acc_row(i), n = cn + acc_col(j, i);
      if (p < prow && n < ncols) o[(size_t)p * N + n] = acc[j][i];
    }
}

// ===========================================================================
// Forward 3 and backward 3: the carry, elementwise over P N, in place.  For
// each (b, h) and element, in chunk order (reversed for the backward):
// v = buf[k]; buf[k] = s; s = s exp(cum_last of k) + v, from s = 0.  The
// forward turns chunk-local states into entry states S_k; the backward turns
// F_k into dS_k.  The last chunk visited is only written (its v is unused).
// grid (ceil(P N / 256), H, batch rows of the run).
// ===========================================================================

template <typename T, bool kBackward>
__global__ void __launch_bounds__(THREADS)
ssd_pass_kernel(float* __restrict__ buf, const T* __restrict__ cum, int NC, int L, int H,
                int PN, int b0) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y;
  const size_t b = (size_t)b0 + blockIdx.z;
  auto chunk = [&](int i) { return kBackward ? NC - 1 - i : i; };
  float s = 0.f;
  // Eight chunks' loads are issued before their stores, so they overlap.
  for (int i0 = 0; i0 < NC; i0 += 8) {
    float v[8], cd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k, c = chunk(i);
      const bool more = i + 1 < NC;
      v[k] = more ? buf[((b * NC + c) * H + h) * PN + e] : 0.f;
      cd[k] = more ? expf(to_f32(cum[((b * NC + c) * L + L - 1) * H + h])) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k;
      if (i < NC) {
        buf[((b * NC + chunk(i)) * H + h) * PN + e] = s;
        s = fmaf(s, cd[k], v[k]);
      }
    }
  }
}

// ===========================================================================
// Forward 4: y for one (batch, chunk, head, 64-row query tile t) and 64
// columns p of P.  grid (tiles, H x p-tiles, rows of the run).  One pipeline
// of steps, each staged while the one before is used: first the carried term
// C S_k^T, one step per half of N (C and S_k), then scaled by e_l; then one
// step per key tile j <= t (G[t][j] and x_j): y += (G decay dt_m) x_j, the
// weights formed in place of G before the product.  Four tiles of shared
// memory, so three blocks share an SM.
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_y_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ cum,
             const T* __restrict__ cm, const float* __restrict__ G,
             const float* __restrict__ states, T* __restrict__ y, int L, int H, int P, int N,
             int row0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x 2 tiles
  const int LR = rows_of(L);
  float* cum_s = smem + 4 * TILE_FLOATS;           // (LR)
  float* dt_s = cum_s + LR;                        // (LR)
  const int t = blockIdx.x;
  const int h = blockIdx.y / p_tiles(P);
  const int p0 = (blockIdx.y % p_tiles(P)) * TILE;
  const int prow = min(TILE, P - p0);
  const size_t bc = (size_t)row0 + blockIdx.z;
  const int l0 = t * TILE;
  const int lrows = min(TILE, L - l0);
  const int halves = (N + TILE - 1) / TILE;
  const int steps = halves + t + 1;

  auto issue = [&](int st) {
    float* buf = smem + 2 * (st & 1) * TILE_FLOATS;
    if (st < halves) {
      const int cols = min(TILE, N - st * TILE);
      load_tile(buf, cm + (bc * L + l0) * N + st * TILE, N, lrows, cols);
      load_tile(buf + TILE_FLOATS, states + ((bc * H + h) * P + p0) * N + st * TILE, N, prow,
                cols);
    } else {
      const int j = st - halves;
      const int rows = min(TILE, L - j * TILE);
      load_tile(buf, G + bc * L * L + (size_t)l0 * L + j * TILE, L, lrows, rows);
      load_tile(buf + TILE_FLOATS, x + ((bc * L + j * TILE) * H + h) * P + p0, (size_t)H * P,
                rows, prow);
    }
    cp_commit();
  };
  issue(0);
  for (int l = threadIdx.x; l < LR; l += THREADS) {
    cum_s[l] = l < L ? to_f32(cum[(bc * L + l) * H + h]) : 0.f;
    dt_s[l] = l < L ? to_f32(dt[(bc * L + l) * H + h]) : 0.f;
  }

  const int rm = warp_row0(), cn = warp_col0(TILE);
  float acc[4][4];
  zero(acc);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* buf = smem + 2 * (st & 1) * TILE_FLOATS;
    const float* other = buf + TILE_FLOATS;
    if (st < halves) {
      tile_mma<T, 1>(acc, [&](int r, int k) { return buf[at(rm + r, k)]; },
                     [&](int k, int n) { return other[at(cn + n, k)]; });
      if (st == halves - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] *= expf(cum_s[l0 + rm + acc_row(i)]);
      }
    } else {
      const int m0 = (st - halves) * TILE;
      // W = G decay dt_m, in place of G, each entry once.
      for (int e = threadIdx.x; e < TILE_FLOATS; e += THREADS) {
        const int gl = l0 + (e >> 6), gm = m0 + (e & 63);
        float* w = buf + at(e >> 6, e & 63);
        // Mask before exp: only m <= l < L is evaluated.
        *w = (gm <= gl && gl < L) ? *w * expf(cum_s[gl] - cum_s[gm]) * dt_s[gm] : 0.f;
      }
      __syncthreads();
      tile_mma<T, 2>(acc, [&](int r, int k) { return buf[at(rm + r, k)]; },
                     [&](int k, int n) { return other[at(k, cn + n)]; });
    }
    __syncthreads();  // the next step may overwrite this stage
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = rm + acc_row(i), p = cn + acc_col(j, i);
      if (l < lrows && p < prow)
        y[((bc * L + l0 + l) * H + h) * P + p0 + p] = from_f32<T>(acc[j][i]);
    }
}

// Sum over the 4 lanes of a quad (the lanes that share an accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ===========================================================================
// Backward 4: dx, ddt and dcum of one (batch, chunk, head) on the 64 rows of
// tile t and 64 columns p of P.  grid (tiles, H x p-tiles, rows of the run).
// One pipeline of steps, each step's tiles staged while the step before is
// used:
//
// Phase 1, the carried state: V = B_t dS^T and Z = C_t S_k^T (64 x P, depth
// N), one step per half of N for each.  dx starts at indec V; g_l = x_l . V_l
// and z_l = dy_l . Z_l are row sums.  The block of the last tile also forms
// <dS_k, S_k+1> for the last row's dcum.
//
// Phase 2, the intra-chunk form: for j = 0 .. tiles - 1 the tile pair (j, t)
// if j >= t (tile t as keys: dx += W^T dy_j and the column sums of Q) and
// (t, j) if j <= t (tile t as queries: the row sums of Q dt_m).  Each pair
// forms dW = dy x^T on the tensor cores, then Q and W from G[l][m] in
// registers, W written in place of G.  Every block does `tiles` dW
// products, so the blocks of a chunk are balanced.  Six tiles of shared
// memory (101 KB), so two blocks share an SM.
//
// Every sum over p here (dW, g, z, <dS_k, S_k+1>) covers the block's 64
// columns: above P = 64 ddt and dcum leave as float32 partials, one a
// p-tile, in ddt_part and dcum_part ((rows, L, H, p-tiles)), for
// ssd_sum_parts_kernel.
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_head_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ cum, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ states,
                    const float* __restrict__ ds, const float* __restrict__ G,
                    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ddt,
                    T* __restrict__ dcum, float* __restrict__ ddt_part,
                    float* __restrict__ dcum_part, int NC, int L, int H, int P, int N,
                    int row0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x 2 tiles
  const int LR = rows_of(L);
  float* xt = smem + 4 * TILE_FLOATS;     // x rows of tile t
  float* yt = xt + TILE_FLOATS;           // dy rows of tile t
  float* cum_s = yt + TILE_FLOATS;        // (LR)
  float* dt_s = cum_s + LR;               // (LR)
  float* red_g = dt_s + LR;               // (2, 64)  g_l halves
  float* red_z = red_g + 2 * TILE;        // (2, 64)  z_l halves
  float* red_r = red_z + 2 * TILE;        // (2, 64)  a pair's row sums, by column half
  float* red_c = red_r + 2 * TILE;        // (4, 64)  a pair's column sums, by row quarter
  float* row_q = red_c + 4 * TILE;        // (64)  sum_m Q[l][m] dt_m
  float* col_q = row_q + TILE;            // (64)  sum_l Q[l][m]
  float* wred = col_q + TILE;             // (8)

  const int t = blockIdx.x;
  const int PT = p_tiles(P);
  const int h = blockIdx.y / PT, pt = blockIdx.y % PT;
  const int p0 = pt * TILE, prow = min(TILE, P - p0);
  const size_t bc = (size_t)row0 + blockIdx.z;
  const int c = (int)(bc % NC);
  const int tiles = tiles_of(L);
  const int halves = (N + TILE - 1) / TILE;
  const int l0 = t * TILE;
  const int lrows = min(TILE, L - l0);
  const size_t head = bc * H + h;  // (b, k, h) of states and dS
  const size_t prows = (size_t)p0 * N;  // this block's rows p of a state
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int carried = 2 * halves;  // phase-1 steps: (B, dS) per half, then (C, S) per half
  const int steps = carried + tiles;

  auto stage = [&](int st) { return smem + 2 * (st & 1) * TILE_FLOATS; };
  auto issue = [&](int st) {
    float* buf = stage(st);
    if (st < carried) {
      const bool zs = st >= halves;
      const int hf = st % halves;
      const int cols = min(TILE, N - hf * TILE);
      load_tile(buf, (zs ? cm : bm) + (bc * L + l0) * N + hf * TILE, N, lrows, cols);
      load_tile(buf + TILE_FLOATS, (zs ? states : ds) + head * P * N + prows + hf * TILE, N,
                prow, cols);
    } else {
      const int j = st - carried;
      const int lt = j >= t ? j : t, mt = j >= t ? t : j;
      load_tile(buf, G + bc * L * L + (size_t)lt * TILE * L + mt * TILE, L,
                min(TILE, L - lt * TILE), min(TILE, L - mt * TILE));
      if (j != t)  // keys after t need dy_j; queries before t need x_j
        load_tile(buf + TILE_FLOATS,
                  (j > t ? dy : x) + ((bc * L + j * TILE) * H + h) * P + p0, (size_t)H * P,
                  min(TILE, L - j * TILE), prow);
    }
    cp_commit();
  };
  load_tile(xt, x + ((bc * L + l0) * H + h) * P + p0, (size_t)H * P, lrows, prow);
  load_tile(yt, dy + ((bc * L + l0) * H + h) * P + p0, (size_t)H * P, lrows, prow);
  issue(0);  // x and dy of tile t join the first step's group
  for (int l = threadIdx.x; l < LR; l += THREADS) {
    cum_s[l] = l < L ? to_f32(cum[(bc * L + l) * H + h]) : 0.f;
    dt_s[l] = l < L ? to_f32(dt[(bc * L + l) * H + h]) : 0.f;
  }
  if (threadIdx.x < TILE) {
    row_q[threadIdx.x] = 0.f;
    col_q[threadIdx.x] = 0.f;
  }
  // <dS_k, S_k+1>: the last row's dcum term (dS of the last chunk is zero).
  const bool has_last = t == tiles - 1 && c + 1 < NC;
  if (has_last) {
    const float* a = ds + head * P * N + prows;
    const float* s_next = states + (head + H) * P * N + prows;
    float part = 0.f;
    for (int e = threadIdx.x; e < prow * N; e += THREADS) part = fmaf(a[e], s_next[e], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) wred[warp] = part;
  }

  const int rm = warp_row0(), cn = warp_col0(TILE);
  float vacc[4][4], zacc[4][4], dxa[4][4];
  zero(vacc);
  zero(zacc);
  float last_dot = 0.f;
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* buf = stage(st);
    const float* other = buf + TILE_FLOATS;
    if (st < carried) {
      // ---- phase 1 ----
      auto fa = [&](int r, int k) { return buf[at(rm + r, k)]; };
      auto fb = [&](int k, int n) { return other[at(cn + n, k)]; };
      if (st < halves)
        tile_mma<T, 1>(vacc, fa, fb);
      else
        tile_mma<T, 1>(zacc, fa, fb);
      if (st == carried - 1) {
        if (has_last)
          for (int w = 0; w < THREADS / 32; ++w) last_dot += wred[w];
        const float cum_last = cum_s[L - 1];
        float gp[2] = {0.f, 0.f}, zp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rm + acc_row(i), p = cn + acc_col(j, i);
            const int l = l0 + r;
            gp[i >> 1] = fmaf(xt[at(r, p)], vacc[j][i], gp[i >> 1]);
            zp[i >> 1] = fmaf(yt[at(r, p)], zacc[j][i], zp[i >> 1]);
            dxa[j][i] = expf(cum_last - cum_s[l]) * dt_s[l] * vacc[j][i];  // dt_s is 0 past L
          }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          gp[q] = quad_sum(gp[q]);
          zp[q] = quad_sum(zp[q]);
          if ((lane & 3) == 0) {
            const int r = rm + (lane >> 2) + 8 * q;
            red_g[(warp >> 2) * TILE + r] = gp[q];
            red_z[(warp >> 2) * TILE + r] = zp[q];
          }
        }
      }
    } else {
      // ---- phase 2: the pair (j, t) and/or (t, j) ----
      const int j = st - carried;
      const bool keys = j >= t;     // tile t as the key tile of pair (j, t)
      const bool queries = j <= t;  // tile t as the query tile of pair (t, j)
      const int lt = keys ? j : t, mt = keys ? t : j;
      const float* dyq = j > t ? other : yt;  // dy rows of the query tile
      const float* xk = j < t ? other : xt;   // x rows of the key tile
      float dw[4][4];
      zero(dw);
      tile_mma<T, 0>(dw, [&](int r, int k) { return dyq[at(rm + r, k)]; },
                     [&](int k, int n) { return xk[at(cn + n, k)]; });
      float rp[2] = {0.f, 0.f};
      float cp[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        cp[jj][0] = 0.f;
        cp[jj][1] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rm + acc_row(i), m = cn + acc_col(jj, i);
          const int gl = lt * TILE + r, gm = mt * TILE + m;
          float* gv = buf + at(r, m);  // G, then W: each entry read and written by one thread
          // Mask before exp: only m <= l < L is evaluated.
          const float dec = (gm <= gl && gl < L) ? expf(cum_s[gl] - cum_s[gm]) : 0.f;
          const float q = dw[jj][i] * *gv * dec;
          cp[jj][i & 1] += q;
          rp[i >> 1] = fmaf(q, dt_s[gm], rp[i >> 1]);
          if (keys) *gv = *gv * dec * dt_s[gm];
        }
      }
      if (queries) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          rp[q] = quad_sum(rp[q]);
          if ((lane & 3) == 0) red_r[(warp >> 2) * TILE + rm + (lane >> 2) + 8 * q] = rp[q];
        }
      }
      if (keys) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int b2 = 0; b2 < 2; ++b2) {
            float v = cp[jj][b2];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) red_c[(warp & 3) * TILE + cn + 8 * jj + 2 * lane + b2] = v;
          }
      }
      __syncthreads();  // W and the partial sums are complete
      if (threadIdx.x < TILE) {
        const int r = threadIdx.x;
        if (queries) row_q[r] += red_r[r] + red_r[TILE + r];
        if (keys)
          col_q[r] += ((red_c[r] + red_c[TILE + r]) + red_c[2 * TILE + r]) + red_c[3 * TILE + r];
      }
      if (keys)  // dx[m][p] += sum_l W[l][m] dy[l][p]
        tile_mma<T, 2>(dxa, [&](int r, int k) { return buf[at(k, rm + r)]; },
                       [&](int k, int n) { return dyq[at(k, cn + n)]; });
    }
    __syncthreads();  // the next step may overwrite this stage and the partial sums
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rm + acc_row(i), p = cn + acc_col(j, i);
      if (r < lrows && p < prow)
        dx[((bc * L + l0 + r) * H + h) * P + p0 + p] = from_f32<T>(dxa[j][i]);
    }
  if (threadIdx.x < lrows) {
    const int r = threadIdx.x;
    const int l = l0 + r;
    const float g = red_g[r] + red_g[TILE + r];
    const float z = red_z[r] + red_z[TILE + r];
    const float in_decay = expf(cum_s[L - 1] - cum_s[l]);
    float dc = row_q[r] - dt_s[l] * col_q[r] + expf(cum_s[l]) * z - g * in_decay * dt_s[l];
    if (l == L - 1) dc += last_dot;
    const size_t o = (bc * L + l) * H + h;
    if (PT == 1) {
      ddt[o] = from_f32<T>(col_q[r] + g * in_decay);
      dcum[o] = from_f32<T>(dc);
    } else {
      ddt_part[o * PT + pt] = col_q[r] + g * in_decay;
      dcum_part[o * PT + pt] = dc;
    }
  }
}

// ===========================================================================
// Backward 4, above P = 64: ddt and dcum as the sums of their p-tiles'
// float32 partials, in p-tile order, rounded once.  A grid-stride loop over
// the (rows, L, H) entries.
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_sum_parts_kernel(const float* __restrict__ ddt_part, const float* __restrict__ dcum_part,
                     T* __restrict__ ddt, T* __restrict__ dcum, size_t count, int PT) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < count;
       i += (size_t)gridDim.x * THREADS) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < PT; ++q) {
      a += ddt_part[i * PT + q];
      b += dcum_part[i * PT + q];
    }
    ddt[i] = from_f32<T>(a);
    dcum[i] = from_f32<T>(b);
  }
}

// ===========================================================================
// Backward 5: dG[l][m] = sum_h dW_h[l][m] decay_h[l][m] dt_h[m] on one causal
// tile (lt, mt) of one (batch, chunk), the heads in order, over G's scratch.
// grid (tiles (tiles + 1) / 2, rows of the run).  A stage holds one head's
// dy rows of the query tile, x rows of the key tile (64 columns of P: above
// P = 64 a head takes one step a p-tile) and their cum and dt.
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dg_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ cum,
                  const T* __restrict__ dy, float* __restrict__ dG, int L, int H, int P,
                  int row0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x (dy, x tiles; cum_l, cum_m, dt_m)
  constexpr int STAGE = 2 * TILE_FLOATS + 3 * TILE;
  int lt, mt;
  pair_of(blockIdx.x, lt, mt);
  const size_t bc = (size_t)row0 + blockIdx.y;
  const int l0 = lt * TILE, m0 = mt * TILE;
  const int lrows = min(TILE, L - l0), mrows = min(TILE, L - m0);
  const int PT = p_tiles(P);
  const int steps = H * PT;  // (head, p-tile) in order

  auto issue = [&](int hv) {
    float* st = smem + (hv & 1) * STAGE;
    const int h = hv / PT, p0 = (hv % PT) * TILE, prow = min(TILE, P - p0);
    load_tile(st, dy + ((bc * L + l0) * H + h) * P + p0, (size_t)H * P, lrows, prow);
    load_tile(st + TILE_FLOATS, x + ((bc * L + m0) * H + h) * P + p0, (size_t)H * P, mrows, prow);
    load_vec(st + 2 * TILE_FLOATS, cum + (bc * L + l0) * H + h, H, lrows);
    load_vec(st + 2 * TILE_FLOATS + TILE, cum + (bc * L + m0) * H + h, H, mrows);
    load_vec(st + 2 * TILE_FLOATS + 2 * TILE, dt + (bc * L + m0) * H + h, H, mrows);
    cp_commit();
  };
  issue(0);
  const int rm = warp_row0(), cn = warp_col0(TILE);
  float acc[4][4];
  zero(acc);
  for (int hv = 0; hv < steps; ++hv) {
    if (hv + 1 < steps) {
      issue(hv + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (hv & 1) * STAGE;
    const float* dys = st;
    const float* xs = st + TILE_FLOATS;
    const float* cl = st + 2 * TILE_FLOATS;
    const float* cmv = cl + TILE;
    const float* dtm = cmv + TILE;
    float dw[4][4];
    zero(dw);
    tile_mma<T, 0>(dw, [&](int r, int k) { return dys[at(rm + r, k)]; },
                   [&](int k, int n) { return xs[at(cn + n, k)]; });
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rm + acc_row(i), m = cn + acc_col(j, i);
        // Mask before exp: only m <= l < L is evaluated.
        if (m0 + m <= l0 + r && r < lrows) acc[j][i] += dw[j][i] * expf(cl[r] - cmv[m]) * dtm[m];
      }
    __syncthreads();  // the next head may overwrite this stage
  }
  float* out = dG + bc * L * L;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rm + acc_row(i), m = cn + acc_col(j, i);
      if (r < lrows && m < mrows) out[(size_t)(l0 + r) * L + m0 + m] = acc[j][i];
    }
}

// ===========================================================================
// Backward 6: dC or dB on the 64 rows of tile t and 64 columns (half nh) of
// N, of one (batch, chunk).  grid (tiles x halves x 2, rows of the run).
//
//   dC_t = sum_{j <= t} dG[t][j] B_j + sum_h (e_h dy_h,t) S_h
//   dB_t = sum_{j >= t} dG[j][t]^T C_j + sum_h (indec_h x_h,t) dS_h
//
// One step per tile j, then one per head in order (above P = 64, one per
// (head, p-tile): the depth of the second sum), each staged while the one
// before is used; the heads' row scales e or indec are formed when a step's
// cum and dt arrive.
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ cum,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ states, const float* __restrict__ ds,
                   const float* __restrict__ dG, const T* __restrict__ dy, T* __restrict__ db,
                   T* __restrict__ dc, int NC, int L, int H, int P, int N, int row0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x (A, B tiles; cum, dt rows)
  constexpr int STAGE = 2 * TILE_FLOATS + 2 * TILE;
  const int halves = (N + TILE - 1) / TILE;
  const int tiles = tiles_of(L);
  const int PT = p_tiles(P);
  const bool want_db = blockIdx.x & 1;
  const int nh = (blockIdx.x >> 1) % halves;
  const int t = (blockIdx.x >> 1) / halves;
  const size_t bc = (size_t)row0 + blockIdx.y;
  const int l0 = t * TILE;
  const int lrows = min(TILE, L - l0);
  const int ncols = min(TILE, N - nh * TILE);
  const int j0 = want_db ? t : 0;              // intra steps: tiles j0 .. j0 + intra - 1
  const int intra = want_db ? tiles - t : t + 1;
  const int steps = intra + H * PT;

  auto issue = [&](int s) {
    float* st = smem + (s & 1) * STAGE;
    if (s < intra) {
      const int j = j0 + s;
      const int jrows = min(TILE, L - j * TILE);
      if (want_db)  // dG[j][t]: rows l of tile j, columns m of tile t
        load_tile(st, dG + bc * L * L + (size_t)j * TILE * L + l0, L, jrows, lrows);
      else          // dG[t][j]: rows l of tile t, columns m of tile j
        load_tile(st, dG + bc * L * L + (size_t)l0 * L + j * TILE, L, lrows, jrows);
      load_tile(st + TILE_FLOATS, (want_db ? cm : bm) + (bc * L + j * TILE) * N + nh * TILE, N,
                jrows, ncols);
    } else {
      const int hv = s - intra;
      const int h = hv / PT, p0 = (hv % PT) * TILE, prow = min(TILE, P - p0);
      load_tile(st, (want_db ? x : dy) + ((bc * L + l0) * H + h) * P + p0, (size_t)H * P, lrows,
                prow);
      load_tile(st + TILE_FLOATS,
                (want_db ? ds : states) + ((bc * H + h) * P + p0) * N + nh * TILE, N, prow,
                ncols);
      load_vec(st + 2 * TILE_FLOATS, cum + (bc * L + l0) * H + h, H, lrows);
      load_vec(st + 2 * TILE_FLOATS + TILE, dt + (bc * L + l0) * H + h, H, lrows);
    }
    cp_commit();
  };
  issue(0);
  const int rm = warp_row0(), cn = warp_col0(TILE);
  const int g = (threadIdx.x & 31) >> 2;
  float acc[4][4];
  zero(acc);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (s & 1) * STAGE;
    const float* bs = as + TILE_FLOATS;
    auto fb = [&](int k, int n) { return bs[at(k, cn + n)]; };
    if (s < intra) {
      if (want_db)
        tile_mma<T, 2>(acc, [&](int r, int k) { return as[at(k, rm + r)]; }, fb);
      else
        tile_mma<T, 2>(acc, [&](int r, int k) { return as[at(rm + r, k)]; }, fb);
    } else {
      // This thread's A rows rm + g and rm + g + 8, scaled by e or indec.
      const int h = (s - intra) / PT;
      const float* cv = as + 2 * TILE_FLOATS;
      const float* dv = cv + TILE;
      const float cum_last = to_f32(cum[(bc * L + L - 1) * H + h]);
      float sc[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = rm + g + 8 * q;
        sc[q] = want_db ? expf(cum_last - cv[r]) * dv[r] : expf(cv[r]);
      }
      if constexpr (std::is_same<T, float>::value) {
        warp_mma<4>(acc, [&](int r, int k) { return (r < 8 ? sc[0] : sc[1]) * as[at(rm + r, k)]; },
                    fb);
      } else {
        // The scale is a row's: the product of the raw 16-bit rows (exact)
        // and S or dS, then scaled into acc.
        float part[4][4];
        zero(part);
        warp_mma_exact<1>(part, [&](int r, int k) { return as[at(rm + r, k)]; }, fb);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += sc[i >> 1] * part[j][i];
      }
    }
    __syncthreads();  // the next step may overwrite this stage
  }
  T* out = want_db ? db : dc;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rm + acc_row(i), n = cn + acc_col(j, i);
      if (r < lrows && n < ncols)
        out[(bc * L + l0 + r) * N + nh * TILE + n] = from_f32<T>(acc[j][i]);
    }
}

// ---------------------------------------------------------------------------
// Launches.  Each returns the first CUDA error (0 on success).
// ---------------------------------------------------------------------------

constexpr size_t kCbSmem = 4 * TILE_FLOATS * sizeof(float);
constexpr size_t kDgSmem = 2 * (2 * TILE_FLOATS + 3 * TILE) * sizeof(float);
constexpr size_t kDbcSmem = 2 * (2 * TILE_FLOATS + 2 * TILE) * sizeof(float);
size_t local_smem(int L) { return (6 * TILE_FLOATS + rows_of(L)) * sizeof(float); }
size_t y_smem(int L) { return (4 * TILE_FLOATS + 2 * rows_of(L)) * sizeof(float); }
size_t head_smem(int L) {
  return (6 * TILE_FLOATS + 2 * rows_of(L) + 12 * TILE + 8) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The head kernel's shared memory bounds L (16,320); grid y of the y and
// head kernels bounds H times the p-tiles.
bool shapes_ok(int B, int NC, int L, int H, int P, int N) {
  return L >= 1 && P >= 1 && N >= 1 && B >= 1 && NC >= 1 && H >= 1 &&
         head_smem(L) <= MAX_SMEM && (long long)H * p_tiles(P) <= MAX_GRID &&
         (long long)B * NC <= 0x7fffffff;
}

// f(first, count) for the runs of at most MAX_GRID of `total`, in order.
template <typename F>
cudaError_t in_runs(long long total, F f) {
  for (long long first = 0; first < total; first += MAX_GRID) {
    const cudaError_t err = f((int)first, (int)(total - first < MAX_GRID ? total - first : MAX_GRID));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cb(const T* bm, const T* cm, float* G, int B, int NC, int L, int N,
                      bool backward, cudaStream_t s) {
  const auto kernel = backward ? ssd_cb_kernel<T, true> : ssd_cb_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, kCbSmem);
  if (err != cudaSuccess) return err;
  const int tl = tiles_of(L);
  return in_runs((long long)B * NC, [&](int r0, int rows) {
    kernel<<<dim3(tl * (tl + 1) / 2, rows), THREADS, kCbSmem, s>>>(bm, cm, G, L, N, r0);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_local(const T* xs, const T* dt, const T* cum, const T* ys, float* out, int B,
                         int NC, int L, int H, int P, int N, int c0, int chunks, bool backward,
                         cudaStream_t s) {
  if (chunks <= 0) return cudaSuccess;
  const auto kernel = backward ? ssd_local_kernel<T, true> : ssd_local_kernel<T, false>;
  const size_t smem = local_smem(L);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int gx = H * p_tiles(P) * n_groups(N);
  return in_runs(B, [&](int b0, int bs) {
    return in_runs(chunks, [&](int k0, int ks) {
      kernel<<<dim3(gx, ks, bs), THREADS, smem, s>>>(xs, dt, cum, ys, out, NC, L, H, P, N,
                                                     c0 + k0, b0);
      return cudaGetLastError();
    });
  });
}

template <typename T>
cudaError_t launch_pass(float* buf, const T* cum, int B, int NC, int L, int H, int PN,
                        bool reverse, cudaStream_t s) {
  const auto kernel = reverse ? ssd_pass_kernel<T, true> : ssd_pass_kernel<T, false>;
  return in_runs(B, [&](int b0, int bs) {
    kernel<<<dim3((PN + THREADS - 1) / THREADS, H, bs), THREADS, 0, s>>>(buf, cum, NC, L, H, PN,
                                                                         b0);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_y(const T* x, const T* dt, const T* cum, const T* cm, const float* G,
                     const float* states, T* y, int B, int NC, int L, int H, int P, int N,
                     cudaStream_t s) {
  const size_t smem = y_smem(L);
  cudaError_t err = allow_smem(ssd_y_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  return in_runs((long long)B * NC, [&](int r0, int rows) {
    ssd_y_kernel<T><<<dim3(tiles_of(L), H * p_tiles(P), rows), THREADS, smem, s>>>(
        x, dt, cum, cm, G, states, y, L, H, P, N, r0);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_head(const T* x, const T* dt, const T* cum, const T* bm, const T* cm,
                        const float* states, const float* ds, const float* G, const T* dy,
                        T* dx, T* ddt, T* dcum, float* parts, int B, int NC, int L, int H,
                        int P, int N, cudaStream_t s) {
  const size_t smem = head_smem(L);
  cudaError_t err = allow_smem(ssd_bwd_head_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int PT = p_tiles(P);
  const size_t count = (size_t)B * NC * L * H;  // entries of ddt and of dcum
  if (PT > 1 && parts == nullptr) return cudaErrorInvalidValue;
  float* dcum_part = PT > 1 ? parts + count * PT : nullptr;
  err = in_runs((long long)B * NC, [&](int r0, int rows) {
    ssd_bwd_head_kernel<T><<<dim3(tiles_of(L), H * PT, rows), THREADS, smem, s>>>(
        x, dt, cum, bm, cm, states, ds, G, dy, dx, ddt, dcum, parts, dcum_part, NC, L, H, P, N,
        r0);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || PT == 1) return err;
  const size_t blocks = (count + THREADS - 1) / THREADS;
  ssd_sum_parts_kernel<T><<<(unsigned)(blocks < (1u << 20) ? blocks : (1u << 20)), THREADS, 0,
                            s>>>(parts, dcum_part, ddt, dcum, count, PT);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dg(const T* x, const T* dt, const T* cum, const T* dy, float* dG, int B,
                      int NC, int L, int H, int P, cudaStream_t s) {
  cudaError_t err = allow_smem(ssd_bwd_dg_kernel<T>, kDgSmem);
  if (err != cudaSuccess) return err;
  const int tl = tiles_of(L);
  return in_runs((long long)B * NC, [&](int r0, int rows) {
    ssd_bwd_dg_kernel<T><<<dim3(tl * (tl + 1) / 2, rows), THREADS, kDgSmem, s>>>(
        x, dt, cum, dy, dG, L, H, P, r0);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_dbc(const T* x, const T* dt, const T* cum, const T* bm, const T* cm,
                       const float* states, const float* ds, const float* dG, const T* dy,
                       T* db, T* dc, int B, int NC, int L, int H, int P, int N,
                       cudaStream_t s) {
  cudaError_t err = allow_smem(ssd_bwd_dbc_kernel<T>, kDbcSmem);
  if (err != cudaSuccess) return err;
  const int halves = (N + TILE - 1) / TILE;
  return in_runs((long long)B * NC, [&](int r0, int rows) {
    ssd_bwd_dbc_kernel<T><<<dim3(tiles_of(L) * halves * 2, rows), THREADS, kDbcSmem, s>>>(
        x, dt, cum, bm, cm, states, ds, dG, dy, db, dc, NC, L, H, P, N, r0);
    return cudaGetLastError();
  });
}

// Calls f with a null pointer of the storage type that `dtype` names:
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

#define SSD_TRY(call)                      \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
#define SSD_CHECK_SHAPES(B, NC, L, H, P, N) \
  if (!shapes_ok(B, NC, L, H, P, N)) return (int)cudaErrorInvalidValue
// The storage type T of the dtype code, and pointer p as a T pointer.
#define SSD_T std::remove_pointer_t<decltype(tag)>
#define SSD_AS(p) static_cast<SSD_T*>(p)
#define SSD_AS_C(p) static_cast<const SSD_T*>(p)

extern "C" {

// Every entry point returns its launches' first cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape or dtype code the kernels do
// not take.  `dtype` names the storage type of the x, dt, cum, B, C and dy
// tensors and of the outputs (0 float32, 1 bfloat16, 2 float16); the states,
// G, dS and the parts are float32.

// 1 if the kernels take these sizes, 0 if not (shapes_ok): the wrappers ask
// before they allocate and launch, so that a shape refused here raises there.
int ssd_takes_shape(int B, int NC, int L, int H, int P, int N) {
  return shapes_ok(B, NC, L, H, P, N) ? 1 : 0;
}

// The forward: y (B, NC, L, H, P) and the entry states (B, NC, H, P, N),
// which the caller allocates even when it does not keep them; g is scratch of
// B NC L L floats.  Four launches (more for more than 65,535 rows).
int ssd_chunk_scan_fwd(const void* x, const void* dt, const void* cum, const void* bm,
                       const void* cm, void* y, float* states, float* g, int B, int NC, int L,
                       int H, int P, int N, int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  cudaStream_t s = (cudaStream_t)stream;
  return with_dtype(dtype, [&](auto tag) -> int {
    SSD_TRY(launch_cb(SSD_AS_C(bm), SSD_AS_C(cm), g, B, NC, L, N, false, s));
    SSD_TRY(launch_local(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(bm), states, B, NC,
                         L, H, P, N, 0, NC - 1, false, s));
    SSD_TRY(launch_pass(states, SSD_AS_C(cum), B, NC, L, H, P * N, false, s));
    SSD_TRY(launch_y(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(cm), g, states,
                     SSD_AS(y), B, NC, L, H, P, N, s));
    return 0;
  });
}

// The backward: dx, ddt, dcum (the shapes of x, dt, cum), db, dc (B, NC, L, N)
// from the entry states and dy.  g is scratch of B NC L L floats (G, then dG)
// and ds of B NC H P N floats (the carries F, then dS); above P = 64, parts
// is scratch of 2 B NC L H ceil(P / 64) floats (null otherwise).  Six
// launches (seven above P = 64; more for more than 65,535 rows).
int ssd_chunk_scan_bwd(const void* x, const void* dt, const void* cum, const void* bm,
                       const void* cm, const float* states, const void* dy, void* dx, void* ddt,
                       void* dcum, void* db, void* dc, float* g, float* ds, float* parts, int B,
                       int NC, int L, int H, int P, int N, int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  cudaStream_t s = (cudaStream_t)stream;
  return with_dtype(dtype, [&](auto tag) -> int {
    SSD_TRY(launch_cb(SSD_AS_C(bm), SSD_AS_C(cm), g, B, NC, L, N, true, s));
    SSD_TRY(launch_local(SSD_AS_C(dy), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(cm), ds, B, NC, L,
                         H, P, N, 1, NC - 1, true, s));
    SSD_TRY(launch_pass(ds, SSD_AS_C(cum), B, NC, L, H, P * N, true, s));
    SSD_TRY(launch_head(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(bm), SSD_AS_C(cm),
                        states, ds, g, SSD_AS_C(dy), SSD_AS(dx), SSD_AS(ddt), SSD_AS(dcum),
                        parts, B, NC, L, H, P, N, s));
    SSD_TRY(launch_dg(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(dy), g, B, NC, L, H, P,
                      s));
    SSD_TRY(launch_dbc(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(bm), SSD_AS_C(cm),
                       states, ds, g, SSD_AS_C(dy), SSD_AS(db), SSD_AS(dc), B, NC, L, H, P, N,
                       s));
    return 0;
  });
}

// The stages one launch each (in runs above 65,535 rows), so that each can be
// held against its plain version (kernel.py's stage wrappers).  Not on the
// main path.

int ssd_stage_cb(const void* bm, const void* cm, float* g, int B, int NC, int L, int N,
                 int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, 1, 1, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_cb(SSD_AS_C(bm), SSD_AS_C(cm), g, B, NC, L, N, false,
                          (cudaStream_t)stream);
  });
}

// Every chunk's sum_l s_l X_l^T Y_l: backward = 0 for (x, B, indec), 1 for
// (dy, C, e).
int ssd_stage_local(const void* xs, const void* dt, const void* cum, const void* ys, float* out,
                    int B, int NC, int L, int H, int P, int N, int backward, int dtype,
                    void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_local(SSD_AS_C(xs), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(ys), out, B, NC,
                             L, H, P, N, 0, NC, backward != 0, (cudaStream_t)stream);
  });
}

int ssd_stage_pass(float* buf, const void* cum, int B, int NC, int L, int H, int P, int N,
                   int reverse, int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_pass(buf, SSD_AS_C(cum), B, NC, L, H, P * N, reverse != 0,
                            (cudaStream_t)stream);
  });
}

int ssd_stage_y(const void* x, const void* dt, const void* cum, const void* cm, const float* g,
                const float* states, void* y, int B, int NC, int L, int H, int P, int N,
                int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_y(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(cm), g, states,
                         SSD_AS(y), B, NC, L, H, P, N, (cudaStream_t)stream);
  });
}

int ssd_stage_head(const void* x, const void* dt, const void* cum, const void* bm,
                   const void* cm, const float* states, const float* ds, const float* g,
                   const void* dy, void* dx, void* ddt, void* dcum, float* parts, int B, int NC,
                   int L, int H, int P, int N, int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_head(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(bm),
                            SSD_AS_C(cm), states, ds, g, SSD_AS_C(dy), SSD_AS(dx), SSD_AS(ddt),
                            SSD_AS(dcum), parts, B, NC, L, H, P, N, (cudaStream_t)stream);
  });
}

int ssd_stage_dg(const void* x, const void* dt, const void* cum, const void* dy, float* dg,
                 int B, int NC, int L, int H, int P, int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, 1);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_dg(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(dy), dg, B, NC, L,
                          H, P, (cudaStream_t)stream);
  });
}

int ssd_stage_dbc(const void* x, const void* dt, const void* cum, const void* bm,
                  const void* cm, const float* states, const float* ds, const float* dg,
                  const void* dy, void* db, void* dc, int B, int NC, int L, int H, int P, int N,
                  int dtype, void* stream) {
  SSD_CHECK_SHAPES(B, NC, L, H, P, N);
  return with_dtype(dtype, [&](auto tag) -> int {
    return (int)launch_dbc(SSD_AS_C(x), SSD_AS_C(dt), SSD_AS_C(cum), SSD_AS_C(bm), SSD_AS_C(cm),
                           states, ds, dg, SSD_AS_C(dy), SSD_AS(db), SSD_AS(dc), B, NC, L, H, P,
                           N, (cudaStream_t)stream);
  });
}

}  // extern "C"
