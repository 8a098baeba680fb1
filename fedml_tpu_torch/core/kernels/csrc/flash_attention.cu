// Causal flash attention with a key-padding mask, forward and backward, for
// Hopper (sm_90a). Built by core/kernels/build.py with nvcc into a shared
// library with a plain C interface; bound with ctypes by
// core/kernels/flash_attention.py.
//
// Replaces the three Pallas TPU kernels of fedml_tpu/llm/attention.py:
//   B2 flash_fwd_kernel  <- _flash_fwd_kernel  (:121, launched :285)
//   B3 flash_dq_kernel   <- _flash_dq_kernel   (:176, launched :323)
// (bf16 runs the tensor-core kernels flash_{fwd,dq,dkv}_mma_kernel)
//   B4 flash_dkv_kernel  <- _flash_dkv_kernel  (:213, launched :342)
//
// Semantics (the same as the TPU kernels'): scale = 1/sqrt(d); key k is
// live for query q iff k <= q, k < s and mask[b, k] > 0 (a null mask means
// every key is real). Probabilities are gated on `live`, not only on the
// exp, so a query with no live key gets O = 0 exactly, LSE = -1e30 +
// log(1e-30), and adds nothing to any gradient; a masked key gets
// dK = dV = 0 exactly. D = rowsum(dO*O) is computed outside the kernels.
// All sums are in f32; outputs are rounded once.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [b, s, h, d] (row stride h*d),
// read in place with strides, so the [b*h, s, d] transposes of the TPU
// wrapper are not made. LSE is [b, h, s] f32, D is [b, s, h] f32.
//
// What bounds them on this card: attention's arithmetic intensity grows
// with the sequence. At the FedLLM round's shape (s 256, d 64) the ideal
// forward is bytes-bound (~8.5 MB bf16 against ~0.5 GFLOP); at s 1024-4096
// with d 128 it is bound by operations, and then only the tensor cores
// (989 TFLOP/s bf16) reach the bound. Common to every kernel here: the
// [s, s] scores never reach device memory in either direction (each CTA
// keeps its 64-row tile of Q, or of K/V in B4, and streams 64-row tiles of
// the other operand through shared memory, recomputing P from LSE in the
// backward), causal tiles past the diagonal are skipped, and the backward
// is split into a dQ kernel (one CTA per q tile) and a dK/dV kernel (one CTA
// per kv tile), so no two CTAs write one output: no atomics, a fixed loop
// order, and the backward is bitwise reproducible.
//
// Two designs, chosen by dtype alone (one kernel per (kernel, dtype) pair):
//
// * bfloat16 B2, B3 and B4: tensor cores (flash_fwd_mma_kernel,
//   flash_dq_mma_kernel, flash_dkv_mma_kernel). 4 warps per CTA, each
//   owning 16 of the CTA's 64 rows; every product is mma.sync m16n8k16 bf16 with f32 sums
//   (mma_tile.cuh); operands reach registers through ldmatrix from bf16
//   tiles whose 16-byte chunks are XOR-swizzled (no bank conflicts); the
//   streamed tiles are double-buffered with cp.async, tile t+1 in flight
//   while tile t computes. The head width is padded with zeros to DP in
//   {16, 32, 64, 128} in shared memory only. The scale is applied to the
//   f32 scores (Q is not pre-scaled in bf16: 1/sqrt(128) is not a power of
//   two). P (and dS in B3 and B4) is rounded to bf16 as the left operand of
//   the second product, as FlashAttention-2/3 do; S, the softmax statistics and
//   every sum stay f32. No wgmma, TMA, warp specialisation or persistent
//   CTAs yet: those are the next levers.
// * float32 B2-B4: CUDA cores (flash_fwd_kernel, flash_dq_kernel,
//   flash_dkv_kernel), f32 FMA, Q pre-scaled in f32, 256
//   threads per CTA, each owning a 4x4 block of the 64x64 score tile and a
//   4 x ceil(d/16) block of its output rows; tiles staged in shared memory
//   as f32 rows padded to d+1 floats, so that a row group's 16 lanes read 16
//   banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int TILE = 64;       // rows of the resident tile and of the streamed one
constexpr int THREADS = 256;   // 16 row groups (ty) x 16 column lanes (tx)
constexpr int PLD = TILE + 1;  // padded row of a [TILE][TILE] score tile
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Offset of element (b, row, h, 0) of a [B, S, H, D] tensor.
__device__ __forceinline__ size_t row_off(int b, int row, int h, int S, int H, int D) {
  return ((static_cast<size_t>(b) * S + row) * H + h) * static_cast<size_t>(D);
}

// Tile rows [r0, r0 + TILE) of head h of batch b into shared memory as f32
// times `mul`, rows past S as zeros. Row stride in shared memory: D + 1.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b, int h, int r0,
                          int S, int H, int D, float mul) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, c = i - r * D, row = r0 + r;
    dst[r * ld + c] = row < S ? to_f(src[row_off(b, row, h, S, H, D) + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool key_real(const float* __restrict__ mask, int b, int kp, int S) {
  return kp < S && (mask == nullptr || mask[static_cast<size_t>(b) * S + kp] > 0.f);
}

// s[r][c] = A[ty*4 + r] . B[tx + 16c] over D, both tiles [TILE][D+1] in
// shared memory.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B,
                                         int ty, int tx, int D) {
  const int ld = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int kk = 0; kk < D; ++kk) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * ld + kk];
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = B[(tx + 16 * c) * ld + kk];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
  }
}

// ---------------------------------------------------------------- B2 ----
// One CTA per (b*h, q tile): online softmax over the kv tiles 0..qt.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + TILE * ld;
  float* Vs = Ks + TILE * ld;
  float* Ps = Vs + TILE * ld;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Qs, q, b, h, q0, S, H, D, scale);
  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  // causal: kv tiles after this q tile's last row see nothing of it
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, h, k0, S, H, D, 1.f);
    load_tile(Vs, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot(s, Qs, Ks, ty, tx, D);
    bool kreal[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) kreal[c] = key_real(mask, b, k0 + tx + 16 * c, S);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        live[c] = kreal[c] && k0 + tx + 16 * c <= qp;
        s[r][c] = live[c] ? s[r][c] : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty * 4 + r) * PLD + tx + 16 * c] = p;
        ps += p;
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + row_sum16(ps);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < TILE; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? Vs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty * 4 + r) * PLD + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const size_t base = row_off(b, qp, h, S, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[base + col] = from_f<T>(acc[r][c] / den);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * S + qp] = m[r] + logf(den);
  }
}

// ---------------------------------------------------------------- B3 ----
// One CTA per (b*h, q tile): dQ = scale * sum over kv tiles 0..qt of dS.K,
// dS = P * (dO.V^T - D), P = live ? exp(Q.K^T - LSE) : 0.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ mask, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                T* __restrict__ dq, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Gs = Qs + TILE * ld;  // dO
  float* Ks = Gs + TILE * ld;
  float* Vs = Ks + TILE * ld;
  float* Ss = Vs + TILE * ld;  // dS
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(Qs, q, b, h, q0, S, H, D, scale);
  load_tile(Gs, dout, b, h, q0, S, H, D, 1.f);
  float row_lse[4], row_dd[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    row_lse[r] = qp < S ? lse[static_cast<size_t>(bh) * S + qp] : 0.f;
    row_dd[r] = qp < S ? dd[(static_cast<size_t>(b) * S + qp) * H + h] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile(Ks, k, b, h, k0, S, H, D, 1.f);
    load_tile(Vs, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, ty, tx, D);
    tile_dot(dp, Gs, Vs, ty, tx, D);
    bool kreal[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) kreal[c] = key_real(mask, b, k0 + tx + 16 * c, S);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = qp < S && kreal[c] && k0 + tx + 16 * c <= qp;
        const float p = live ? expf(s[r][c] - row_lse[r]) : 0.f;
        Ss[(ty * 4 + r) * PLD + tx + 16 * c] = p * (dp[r][c] - row_dd[r]);
      }
    }
    __syncthreads();
    for (int j = 0; j < TILE; ++j) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        kk[c] = col < D ? Ks[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = Ss[(ty * 4 + r) * PLD + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(ds, kk[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= S) continue;
    const size_t base = row_off(b, qp, h, S, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dq[base + col] = from_f<T>(acc[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------- B4 ----
// One CTA per (b*h, kv tile): dV = sum over q tiles kt.. of P^T.dO and
// dK = sum of dS^T.(scale*Q).
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mask, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + TILE * ld;
  float* Qs = Vs + TILE * ld;
  float* Gs = Qs + TILE * ld;  // dO
  float* Ps = Gs + TILE * ld;  // P [q][key]
  float* Ss = Ps + TILE * PLD; // dS [q][key]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_q = (S + TILE - 1) / TILE;

  load_tile(Ks, k, b, h, k0, S, H, D, 1.f);
  load_tile(Vs, v, b, h, k0, S, H, D, 1.f);
  bool kreal[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) kreal[c] = key_real(mask, b, k0 + tx + 16 * c, S);
  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // causal: q tiles before this kv tile see none of it
  for (int qt = kt; qt < n_q; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile(Qs, q, b, h, q0, S, H, D, scale);
    load_tile(Gs, dout, b, h, q0, S, H, D, 1.f);
    __syncthreads();
    // score phase: rows are queries ty*4 + r, columns keys tx + 16c
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, ty, tx, D);
    tile_dot(dp, Gs, Vs, ty, tx, D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      const float row_lse = qp < S ? lse[static_cast<size_t>(bh) * S + qp] : 0.f;
      const float row_dd = qp < S ? dd[(static_cast<size_t>(b) * S + qp) * H + h] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = qp < S && kreal[c] && k0 + tx + 16 * c <= qp;
        const float p = live ? expf(s[r][c] - row_lse) : 0.f;
        Ps[(ty * 4 + r) * PLD + tx + 16 * c] = p;
        Ss[(ty * 4 + r) * PLD + tx + 16 * c] = p * (dp[r][c] - row_dd);
      }
    }
    __syncthreads();
    // accumulate phase: rows are keys ty*4 + r, columns d = tx + 16c
    for (int j = 0; j < TILE; ++j) {
      float g[DC], qq[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        g[c] = col < D ? Gs[j * ld + col] : 0.f;
        qq[c] = col < D ? Qs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[j * PLD + ty * 4 + r];
        const float ds = Ss[j * PLD + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[r][c] = fmaf(p, g[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(ds, qq[c], acc_k[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= S) continue;
    const size_t base = row_off(b, kp, h, S, H, D);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[base + col] = from_f<T>(acc_k[r][c]);
        dv[base + col] = from_f<T>(acc_v[r][c]);
      }
    }
  }
}

// ------------------------------------------------- tensor-core kernels ----
namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int MMA_THREADS = 128;  // 4 warps x 16 of the CTA's 64 rows
constexpr float LOG2E = 1.4426950408889634f;

// Offset of row 0 of head h of batch b in a [B, S, H, D] tensor; its rows
// are H*D apart.
__device__ __forceinline__ size_t head_off(int b, int h, int S, int H, int D) {
  return (static_cast<size_t>(b) * S * H + h) * static_cast<size_t>(D);
}

// B2 in bf16. One CTA per (b*h, 64-row q tile), the longest rows first.
// Q stays in registers as A fragments; K/V tiles stream through a two-stage
// cp.async ring. Per kv tile: S = Q.K^T on the tensor cores, the causal
// mask (diagonal tile) and key padding as a 32-bit live mask per thread,
// the online softmax in f32 (each thread owns rows g and g+8 of its warp's
// 16 and reduces over its quad), then P as bf16 A fragments straight from
// the S accumulators, O += P.V with V through ldmatrix.trans. The epilogue
// stages O through the warp's own rows of the Q tile for 16-byte stores.
// Registers at DP 128: Q 32, O 64, S 32 per thread.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int S, int H, int D,
                     float scale, int vec) {
  constexpr int KC = DP / 16;  // 16-deep steps over the head width
  constexpr int NO = DP / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE * DP;      // 2 stages
  bf16* Vs = Ks + 2 * TILE * DP;  // 2 stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  const size_t ld = static_cast<size_t>(H) * D, base = head_off(b, h, S, H, D);
  const bool vv = vec != 0;

  mt::load_tile<DP, TILE, MMA_THREADS>(Qs, q + base, q0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Ks, k + base, 0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Vs, v + base, 0, S, ld, D, vv);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    mt::ldmatrix_x4(qa[kc], mt::a_frag_addr<DP>(mt::smem_u32(Qs), 16 * warp, 2 * kc, lane));
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;           // scores to base-2 exponents
  const int row0 = q0 + 16 * warp + g;     // this thread's rows: row0, row0 + 8

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) {  // the next tile, into the stage the previous one used
      mt::load_tile<DP, TILE, MMA_THREADS>(Ks + (st ^ 1) * TILE * DP, k + base, (kt + 1) * TILE,
                                           S, ld, D, vv);
      mt::load_tile<DP, TILE, MMA_THREADS>(Vs + (st ^ 1) * TILE * DP, v + base, (kt + 1) * TILE,
                                           S, ld, D, vv);
    }
    mt::cp_async_commit();
    const uint32_t Kt = mt::smem_u32(Ks + st * TILE * DP);
    const uint32_t Vt = mt::smem_u32(Vs + st * TILE * DP);

    float s[8][4];  // S of rows (g, g+8) x keys 8n + 2t + {0, 1}
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        mt::ldmatrix_x4(bk, mt::bt_frag_addr<DP>(Kt, 16 * np, 2 * kc, lane));
        mt::mma_bf16(s[2 * np], qa[kc], bk[0], bk[1]);
        mt::mma_bf16(s[2 * np + 1], qa[kc], bk[2], bk[3]);
      }

    // bit 4n + i of `live` gates s[n][i]. Tiles before the diagonal hold
    // only keys < q0 <= every row, all < S: only the key mask applies.
    uint32_t live = 0xffffffffu;
    if (kt == qt || mask != nullptr) {
      live = 0u;
      const int k0 = kt * TILE;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + 8 * n + 2 * t + j;
          const bool real = key_real(mask, b, kp, S);
          live |= static_cast<uint32_t>(real && kp <= row0) << (4 * n + j);
          live |= static_cast<uint32_t>(real && kp <= row0 + 8) << (4 * n + 2 + j);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if ((live >> (4 * n + 2 * r + j)) & 1u) mx = fmaxf(mx, s[n][2 * r + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m == mx == NEG_INF (no live key yet) gives alpha = 1 on a zero row
      const float alpha = exp2f((m[r] - mx) * c);
      const float mc = mx * c;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 2 * r + j;
          const float p = ((live >> (4 * n + i)) & 1u) ? exp2f(fmaf(s[n][i], c, -mc)) : 0.f;
          s[n][i] = p;
          rs += p;
        }
      l[r] = l[r] * alpha + rs;  // this thread's share; the quad sums at the end
      m[r] = mx;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // 16 keys at a time
      uint32_t pa[4];
      mt::acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        mt::ldmatrix_x4_trans(bv, mt::b_frag_addr<DP>(Vt, 16 * kc, 2 * dp, lane));
        mt::mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mt::mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

  bf16* Os = Qs;  // this warp's 16 rows of the Q tile, free since the prologue
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f), inv = 1.f / den;
    const int tr = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(Os + mt::tile_off<DP>(tr, n) + 2 * t) =
          mt::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    const int qp = row0 + 8 * r;
    if (t == 0 && qp < S)
      lse[static_cast<size_t>(bh) * S + qp] = (m[r] == NEG_INF ? NEG_INF : m[r] * scale) + logf(den);
  }
  __syncwarp();
  mt::store_rows<DP>(o + base, Os, 16 * warp, q0 + 16 * warp, S, ld, D, vv, lane);
}

// B4 in bf16. One CTA per (b*h, 64-row kv tile), from the diagonal q tile
// on; each of the 4 warps owns 16 key rows. K and V are loaded once and
// read from shared memory as A fragments; Q, dO and their LSE and D rows
// stream through a two-stage cp.async ring. Each step computes the
// transposed quantities directly, so nothing is transposed through shared
// memory:
//   S^T = K.Q^T (scaled in f32), P^T = live ? exp(S^T - LSE[q]) : 0,
//   dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T o (dP^T - D[q]), dK += dS^T.Q,
// P^T and dS^T becoming bf16 A fragments in registers, dO and Q read through
// ldmatrix.trans; dK is scaled once at the end.
// Registers: dK and dV take 64 f32 each per thread at DP 128. With S^T and
// dP^T of all 64 queries of a tile beside them (32 each), ptxas reached its
// 255 and spilled; so a warp takes the tile's queries 32 at a time (a loop
// that is not unrolled, S^T and dP^T 16 registers each), and the 16-deep
// steps of S^T's and dP^T's products are unrolled 2 at a time, which keeps
// ptxas from hoisting all of their fragment loads. Splitting the queries
// between two warps instead (8 warps, a reduction at the end) spills
// nothing either, but fits one CTA per SM, not two, and ran slower at the
// hot loop's shape. chip_smoke.py fails if ptxas reports a spill here.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int S, int H, int D, float scale, int vec) {
  constexpr int KC = DP / 16;
  constexpr int NO = DP / 8;
  constexpr int KU = KC < 2 ? KC : 2;  // 16-deep steps unrolled together
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE * DP;
  bf16* Qs = Vs + TILE * DP;                                 // 2 stages
  bf16* Gs = Qs + 2 * TILE * DP;                             // dO, 2 stages
  float* Ls = reinterpret_cast<float*>(Gs + 2 * TILE * DP);  // LSE rows, 2 stages
  float* Ds = Ls + 2 * TILE;                                 // D rows, 2 stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kt = blockIdx.y, k0 = kt * TILE, n_q = gridDim.y;
  const size_t ld = static_cast<size_t>(H) * D, base = head_off(b, h, S, H, D);
  const bool vv = vec != 0;

  // q tile `qt` (Q, dO, LSE and D rows) into stage `st`
  auto load_q = [&](int qt, int st) {
    mt::load_tile<DP, TILE, MMA_THREADS>(Qs + st * TILE * DP, q + base, qt * TILE, S, ld, D, vv);
    mt::load_tile<DP, TILE, MMA_THREADS>(Gs + st * TILE * DP, dout + base, qt * TILE, S, ld, D,
                                         vv);
    const int i = threadIdx.x & (TILE - 1), qp = qt * TILE + i;
    const bool in = qp < S;
    if (threadIdx.x < TILE)
      mt::cp_async4(Ls + st * TILE + i, in ? lse + static_cast<size_t>(bh) * S + qp : lse, in);
    else
      mt::cp_async4(Ds + st * TILE + i, in ? dd + (static_cast<size_t>(b) * S + qp) * H + h : dd,
                    in);
  };
  mt::load_tile<DP, TILE, MMA_THREADS>(Ks, k + base, k0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Vs, v + base, k0, S, ld, D, vv);
  load_q(kt, 0);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();

  const uint32_t sK = mt::smem_u32(Ks), sV = mt::smem_u32(Vs);
  int kr[2];
  bool kreal[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = k0 + 16 * warp + g + 8 * r;
    kreal[r] = key_real(mask, b, kr[r], S);
  }
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  const float c = scale * LOG2E;

  for (int qt = kt; qt < n_q; ++qt) {
    const int st = (qt - kt) & 1;
    if (qt + 1 < n_q) load_q(qt + 1, st ^ 1);
    mt::cp_async_commit();
    const uint32_t Qt = mt::smem_u32(Qs + st * TILE * DP);
    const uint32_t Gt = mt::smem_u32(Gs + st * TILE * DP);

#pragma unroll 1
    for (int c0 = 0; c0 < TILE; c0 += 32) {  // the tile's queries, 32 at a time
      const float* Lt = Ls + st * TILE + c0;
      const float* Dt = Ds + st * TILE + c0;
      const int q0 = qt * TILE + c0;

      float sT[4][4];  // S^T, then P^T: key rows (g, g+8) x queries q0 + 8n + 2t + {0, 1}
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sT[n][i] = 0.f;
#pragma unroll 1
      for (int k2 = 0; k2 < KC; k2 += KU)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          uint32_t ka[4];
          mt::ldmatrix_x4(ka, mt::a_frag_addr<DP>(sK, 16 * warp, 2 * (k2 + u), lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4];
            mt::ldmatrix_x4(bq, mt::bt_frag_addr<DP>(Qt, c0 + 16 * np, 2 * (k2 + u), lane));
            mt::mma_bf16(sT[2 * np], ka, bq[0], bq[1]);
            mt::mma_bf16(sT[2 * np + 1], ka, bq[2], bq[3]);
          }
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = 8 * n + 2 * t + j, qp = q0 + qi;
          const float l2 = Lt[qi] * LOG2E;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool live = kreal[r] && kr[r] <= qp && qp < S;
            sT[n][2 * r + j] = live ? exp2f(fmaf(sT[n][2 * r + j], c, -l2)) : 0.f;
          }
        }

#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // dV += P^T.dO, 16 queries at a time
        uint32_t pa[4];
        mt::acc_to_a(pa, sT[2 * kc], sT[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bg[4];
          mt::ldmatrix_x4_trans(bg, mt::b_frag_addr<DP>(Gt, c0 + 16 * kc, 2 * dp, lane));
          mt::mma_bf16(dva[2 * dp], pa, bg[0], bg[1]);
          mt::mma_bf16(dva[2 * dp + 1], pa, bg[2], bg[3]);
        }
      }

      float dpT[4][4];  // dP^T, then dS^T, in the layout of sT
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dpT[n][i] = 0.f;
#pragma unroll 1
      for (int k2 = 0; k2 < KC; k2 += KU)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          uint32_t va[4];
          mt::ldmatrix_x4(va, mt::a_frag_addr<DP>(sV, 16 * warp, 2 * (k2 + u), lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bg[4];
            mt::ldmatrix_x4(bg, mt::bt_frag_addr<DP>(Gt, c0 + 16 * np, 2 * (k2 + u), lane));
            mt::mma_bf16(dpT[2 * np], va, bg[0], bg[1]);
            mt::mma_bf16(dpT[2 * np + 1], va, bg[2], bg[3]);
          }
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dq = Dt[8 * n + 2 * t + j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + j;
            dpT[n][i] = sT[n][i] * (dpT[n][i] - dq);
          }
        }

#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // dK += dS^T.Q
        uint32_t sa[4];
        mt::acc_to_a(sa, dpT[2 * kc], dpT[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bq[4];
          mt::ldmatrix_x4_trans(bq, mt::b_frag_addr<DP>(Qt, c0 + 16 * kc, 2 * dp, lane));
          mt::mma_bf16(dka[2 * dp], sa, bq[0], bq[1]);
          mt::mma_bf16(dka[2 * dp + 1], sa, bq[2], bq[3]);
        }
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();
  }

  // dK (scaled once) and dV through this warp's rows of the K and V tiles,
  // then out with 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(Ks + mt::tile_off<DP>(row, n) + 2 * t) =
          mt::pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(Vs + mt::tile_off<DP>(row, n) + 2 * t) =
          mt::pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
  __syncwarp();
  mt::store_rows<DP>(dk + base, Ks, 16 * warp, k0 + 16 * warp, S, ld, D, vv, lane);
  mt::store_rows<DP>(dv + base, Vs, 16 * warp, k0 + 16 * warp, S, ld, D, vv, lane);
}

// B3 in bf16. One CTA per (b*h, 64-row q tile), the longest rows first, as
// in B2; each of the 4 warps owns 16 query rows. The Q and dO tiles stay in
// shared memory for the whole loop and each thread keeps its two rows' LSE
// and D; K/V tiles 0..qt stream through a two-stage cp.async ring. Per kv
// tile, 32 keys at a time:
//   S = Q.K^T and dP = dO.V^T (K and V as B operands read without a
//   transpose), P = live ? exp(S*scale - LSE) : 0, dS = P o (dP - D) in f32,
//   dQ += dS.K with dS rounded to bf16 as the A fragment and K read through
//   ldmatrix.trans; dQ is scaled once at the end and rounded once.
// Registers at DP 128: dQ takes 64 f32 per thread. Keeping Q's and dO's A
// fragments resident (32 + 32) beside S and dP of a whole 64-key tile (32 +
// 32) would pass ptxas's 255, so the fragments are read from shared memory
// at each 16-deep step (as B4 reads K and V) and a tile's keys are taken 32
// at a time (S and dP 16 registers each), in a loop that is not unrolled.
// chip_smoke.py fails if ptxas reports a spill here.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq, int S, int H, int D,
                    float scale, int vec) {
  constexpr int KC = DP / 16;
  constexpr int NO = DP / 8;
  constexpr int KU = KC < 2 ? KC : 2;  // 16-deep steps unrolled together
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + TILE * DP;      // dO
  bf16* Ks = Gs + TILE * DP;      // 2 stages
  bf16* Vs = Ks + 2 * TILE * DP;  // 2 stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  const size_t ld = static_cast<size_t>(H) * D, base = head_off(b, h, S, H, D);
  const bool vv = vec != 0;

  mt::load_tile<DP, TILE, MMA_THREADS>(Qs, q + base, q0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Gs, dout + base, q0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Ks, k + base, 0, S, ld, D, vv);
  mt::load_tile<DP, TILE, MMA_THREADS>(Vs, v + base, 0, S, ld, D, vv);
  mt::cp_async_commit();

  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float l2[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    l2[r] = qp < S ? lse[static_cast<size_t>(bh) * S + qp] * LOG2E : 0.f;
    drow[r] = qp < S ? dd[(static_cast<size_t>(b) * S + qp) * H + h] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float c = scale * LOG2E;
  const uint32_t sQ = mt::smem_u32(Qs), sG = mt::smem_u32(Gs);
  mt::cp_async_wait<0>();
  __syncthreads();

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) {  // the next tile, into the stage the previous one used
      mt::load_tile<DP, TILE, MMA_THREADS>(Ks + (st ^ 1) * TILE * DP, k + base, (kt + 1) * TILE,
                                           S, ld, D, vv);
      mt::load_tile<DP, TILE, MMA_THREADS>(Vs + (st ^ 1) * TILE * DP, v + base, (kt + 1) * TILE,
                                           S, ld, D, vv);
    }
    mt::cp_async_commit();
    const uint32_t Kt = mt::smem_u32(Ks + st * TILE * DP);
    const uint32_t Vt = mt::smem_u32(Vs + st * TILE * DP);

#pragma unroll 1
    for (int c0 = 0; c0 < TILE; c0 += 32) {  // the tile's keys, 32 at a time
      float s[4][4], dp[4][4];  // rows (g, g+8) x keys k0 + c0 + 8n + 2t + {0, 1}
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll 1
      for (int k2 = 0; k2 < KC; k2 += KU)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int kc = k2 + u;
          uint32_t qa[4], ga[4];
          mt::ldmatrix_x4(qa, mt::a_frag_addr<DP>(sQ, 16 * warp, 2 * kc, lane));
          mt::ldmatrix_x4(ga, mt::a_frag_addr<DP>(sG, 16 * warp, 2 * kc, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bk[4], bv[4];
            mt::ldmatrix_x4(bk, mt::bt_frag_addr<DP>(Kt, c0 + 16 * np, 2 * kc, lane));
            mt::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            mt::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
            mt::ldmatrix_x4(bv, mt::bt_frag_addr<DP>(Vt, c0 + 16 * np, 2 * kc, lane));
            mt::mma_bf16(dp[2 * np], ga, bv[0], bv[1]);
            mt::mma_bf16(dp[2 * np + 1], ga, bv[2], bv[3]);
          }
        }

      // dS in place of dP. Keys of tiles before the diagonal are < q0 <= every
      // row and < S: only the key mask applies there.
      const bool all_live = kt < qt && mask == nullptr;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = kt * TILE + c0 + 8 * n + 2 * t + j;
          const bool real = all_live || key_real(mask, b, kp, S);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + j, qp = row0 + 8 * r;
            const bool live = all_live || (real && kp <= qp && qp < S);
            const float p = live ? exp2f(fmaf(s[n][i], c, -l2[r])) : 0.f;
            dp[n][i] = p * (dp[n][i] - drow[r]);
          }
        }

#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // dQ += dS.K, 16 keys at a time
        uint32_t sa[4];
        mt::acc_to_a(sa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t bk[4];
          mt::ldmatrix_x4_trans(bk, mt::b_frag_addr<DP>(Kt, c0 + 16 * kc, 2 * dc, lane));
          mt::mma_bf16(acc[2 * dc], sa, bk[0], bk[1]);
          mt::mma_bf16(acc[2 * dc + 1], sa, bk[2], bk[3]);
        }
      }
    }
    mt::cp_async_wait<0>();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

  // dQ (scaled once) through this warp's own rows of the Q tile, which only
  // this warp read, then out with 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(Qs + mt::tile_off<DP>(tr, n) + 2 * t) =
          mt::pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
  __syncwarp();
  mt::store_rows<DP>(dq + base, Qs, 16 * warp, q0 + 16 * warp, S, ld, D, vv, lane);
}

// Shared memory of each kernel, in bytes.
size_t fwd_smem(int D) { return sizeof(float) * (3 * TILE * (D + 1) + TILE * PLD); }
size_t dq_smem(int D) { return sizeof(float) * (4 * TILE * (D + 1) + TILE * PLD); }
size_t dkv_smem(int D) { return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * PLD); }

// Raise a kernel's dynamic shared-memory cap to what it needs (above 48 KB
// it must be asked for). Returns the CUDA error, or success.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int B, int S, int H, int D, float scale, cudaStream_t st) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_fwd_kernel<T, DC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(o), static_cast<float*>(lse), S, H, D,
      scale);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* dd, void* dq, int B, int S,
                      int H, int D, float scale, cudaStream_t st) {
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(flash_dq_kernel<T, DC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_dq_kernel<T, DC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<T*>(dq), S, H,
      D, scale);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* dd, void* dk, void* dv,
                       int B, int S, int H, int D, float scale, cudaStream_t st) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, DC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_dkv_kernel<T, DC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, D, scale);
  return cudaGetLastError();
}

// The tensor-core kernels' shared memory: B2 a Q tile and two stages of
// K and V; B4 K, V and two stages of Q, dO and their LSE and D rows.
template <int DP>
size_t fwd_mma_smem() { return sizeof(bf16) * 5 * TILE * DP; }
template <int DP>
size_t dkv_mma_smem() { return sizeof(bf16) * 6 * TILE * DP + sizeof(float) * 4 * TILE; }
// B3: Q and dO tiles and two stages of K and V.
template <int DP>
size_t dq_mma_smem() { return sizeof(bf16) * 6 * TILE * DP; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int DP>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                           void* o, void* lse, int B, int S, int H, int D, float scale,
                           cudaStream_t st) {
  const size_t smem = fwd_mma_smem<DP>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_fwd_mma_kernel<DP><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(o), static_cast<float*>(lse), S, H, D,
      scale, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* lse, const void* dd, void* dk, void* dv,
                           int B, int S, int H, int D, float scale, cudaStream_t st) {
  const size_t smem = dkv_mma_smem<DP>();
  cudaError_t err = allow_smem(flash_dkv_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dk) && aligned16(dv);
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_dkv_mma_kernel<DP><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, D, scale, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* mask,
                          const void* dout, const void* lse, const void* dd, void* dq, int B,
                          int S, int H, int D, float scale, cudaStream_t st) {
  const size_t smem = dq_mma_smem<DP>();
  cudaError_t err = allow_smem(flash_dq_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dq);
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_dq_mma_kernel<DP><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd), static_cast<bf16*>(dq), S, H,
      D, scale, vec);
  return cudaGetLastError();
}

// Columns per thread of the SIMT kernels: ceil(d / 16), rounded up to 1, 2,
// 4 or 8.
int col_chunks(int D) { return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8; }

// Head width of the tensor-core kernels' tiles: d rounded up to 16, 32, 64
// or 128.
int head_pad(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

bool bad_size(int B, int S, int H, int D) {
  return B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 || (S + TILE - 1) / TILE > 65535;
}

#define SIMT_DISPATCH(LAUNCH, T, ...)              \
  do {                                             \
    const int dc = col_chunks(D);                  \
    if (dc == 1) return LAUNCH<T, 1>(__VA_ARGS__); \
    if (dc == 2) return LAUNCH<T, 2>(__VA_ARGS__); \
    if (dc == 4) return LAUNCH<T, 4>(__VA_ARGS__); \
    return LAUNCH<T, 8>(__VA_ARGS__);              \
  } while (0)

#define MMA_DISPATCH(LAUNCH, ...)                \
  do {                                           \
    const int dp = head_pad(D);                  \
    if (dp == 16) return LAUNCH<16>(__VA_ARGS__); \
    if (dp == 32) return LAUNCH<32>(__VA_ARGS__); \
    if (dp == 64) return LAUNCH<64>(__VA_ARGS__); \
    return LAUNCH<128>(__VA_ARGS__);             \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null. Returns a cudaError_t.
// B2: float32 on the CUDA cores, bfloat16 on the tensor cores.
int flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
              void* lse, int B, int S, int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) SIMT_DISPATCH(launch_fwd, float, q, k, v, mask, o, lse, B, S, H, D, scale, st);
  if (dtype == 1) MMA_DISPATCH(launch_fwd_mma, q, k, v, mask, o, lse, B, S, H, D, scale, st);
  return cudaErrorInvalidValue;
}

// B3: float32 on the CUDA cores, bfloat16 on the tensor cores.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* lse, const void* dd, void* dq, int B, int S,
                 int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    SIMT_DISPATCH(launch_dq, float, q, k, v, mask, dout, lse, dd, dq, B, S, H, D, scale, st);
  if (dtype == 1)
    MMA_DISPATCH(launch_dq_mma, q, k, v, mask, dout, lse, dd, dq, B, S, H, D, scale, st);
  return cudaErrorInvalidValue;
}

// B4: float32 on the CUDA cores, bfloat16 on the tensor cores.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, const void* lse, const void* dd, void* dk, void* dv, int B,
                  int S, int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    SIMT_DISPATCH(launch_dkv, float, q, k, v, mask, dout, lse, dd, dk, dv, B, S, H, D, scale,
                  st);
  if (dtype == 1)
    MMA_DISPATCH(launch_dkv_mma, q, k, v, mask, dout, lse, dd, dk, dv, B, S, H, D, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
