// Causal flash attention with a key-padding mask, forward and backward, for
// Hopper (sm_90a). Built by core/kernels/build.py with nvcc into a shared
// library with a plain C interface; bound with ctypes by
// core/kernels/flash_attention.py.
//
// Replaces the three Pallas TPU kernels of fedml_tpu/llm/attention.py:
//   B2 flash_fwd_kernel  <- _flash_fwd_kernel  (:121, launched :285)
//   B3 flash_dq_kernel   <- _flash_dq_kernel   (:176, launched :323)
//   B4 flash_dkv_kernel  <- _flash_dkv_kernel  (:213, launched :342)
//
// Semantics (the same as the TPU kernels'): scale = 1/sqrt(d); Q is
// pre-scaled in f32; key k is live for query q iff k <= q, k < s and
// mask[b, k] > 0 (a null mask means every key is real). Probabilities are
// gated on `live`, not only on the exp, so a query with no live key gets
// O = 0 exactly, LSE = -1e30 + log(1e-30), and adds nothing to any gradient;
// a masked key gets dK = dV = 0 exactly. D = rowsum(dO*O) is computed
// outside the kernels. All sums are in f32; outputs are rounded once.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [b, s, h, d] (row stride h*d),
// read in place with strides, so the [b*h, s, d] transposes of the TPU
// wrapper are not made. LSE is [b, h, s] f32, D is [b, s, h] f32.
//
// What bounds them on this card: attention's arithmetic intensity grows
// with the sequence. At the FedLLM round's shape (s 256, d 64) the ideal
// forward is bytes-bound (~8.5 MB bf16 against ~0.5 GFLOP); at s 1024-4096
// with d 128 it is bound by operations, and then only the tensor cores
// (989 TFLOP/s bf16) reach the bound. What this design does about it: the
// [s, s] scores never reach device memory in either direction (each CTA
// keeps its 64-row tile of Q, or of K/V in B4, and one streamed 64-row tile
// of the other operand in shared memory as f32, recomputing P from LSE in
// the backward), causal tiles past the diagonal are skipped, and the
// backward is split into a dQ kernel (one CTA per q tile) and a dK/dV kernel
// (one CTA per kv tile), so no two CTAs write one output: no atomics, and
// the backward is bitwise reproducible. This first version multiplies on
// the CUDA cores in f32 (FMA), 256 threads per CTA, each thread owning a
// 4x4 block of the 64x64 score tile and a 4 x ceil(d/16) block of its
// output rows; shared rows are padded to d+1 floats so that the 16 lanes of
// a row group read 16 banks. Tensor cores (mma.sync / wgmma), TMA loads and
// a pipelined ring of tiles are the levers of a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// Columns per thread: ceil(d / 16), rounded up to 1, 2, 4 or 8.
int col_chunks(int D) { return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8; }

bool bad_size(int B, int S, int H, int D) {
  return B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 128 || (S + TILE - 1) / TILE > 65535;
}

#define FLASH_DISPATCH(LAUNCH, ...)                                              \
  do {                                                                           \
    const int dc = col_chunks(D);                                                \
    if (dtype == 0) {                                                            \
      if (dc == 1) return LAUNCH<float, 1>(__VA_ARGS__);                         \
      if (dc == 2) return LAUNCH<float, 2>(__VA_ARGS__);                         \
      if (dc == 4) return LAUNCH<float, 4>(__VA_ARGS__);                         \
      return LAUNCH<float, 8>(__VA_ARGS__);                                      \
    }                                                                            \
    if (dtype == 1) {                                                            \
      if (dc == 1) return LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__);                 \
      if (dc == 2) return LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__);                 \
      if (dc == 4) return LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__);                 \
      return LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__);                              \
    }                                                                            \
    return cudaErrorInvalidValue;                                                \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null. Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
              void* lse, int B, int S, int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, mask, o, lse, B, S, H, D, scale, st);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* lse, const void* dd, void* dq, int B, int S,
                 int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, mask, dout, lse, dd, dq, B, S, H, D, scale, st);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, const void* lse, const void* dd, void* dk, void* dv, int B,
                  int S, int H, int D, float scale, int dtype, void* stream) {
  if (bad_size(B, S, H, D)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, mask, dout, lse, dd, dk, dv, B, S, H, D, scale, st);
}

}  // extern "C"
