// Fused ResNet BasicBlock forward for Hopper (sm_90a):
//
//   conv3x3(stride s) -> GN -> ReLU -> conv3x3 -> GN -> (+x | 1x1 proj -> GN)
//   -> ReLU
//
// Replaces the Pallas TPU kernel fedml_tpu/core/kernels/conv_block.py::
// _block_kernel (launched by _pallas_block). Same function: NHWC activations,
// HWIO weights, GroupNorm with f32 one-pass statistics
// var = max(0, E[x^2] - E[x]^2) per (sample, group), f32 accumulation, output
// in x's type (f32 or bf16).
//
// What bounds it on this card: at ResNet-56's shapes a block moves about
// 2 MB (bf16, batch 32) and does about 0.3 GFLOP, so an ideal kernel is
// bound by device-memory bytes, and the unfused chain (conv, GN, ReLU, conv,
// GN, add, ReLU as separate launches) moves every intermediate through HBM
// several times. Both designs below keep every intermediate on chip, so
// each activation is read once and written once.
//
// Two designs, chosen by dtype alone:
//
// * bfloat16: conv_block_mma_kernel, tensor cores in thread-block clusters.
//   A cluster of C CTAs (1-8, chosen by the wrapper so that n x C fills the
//   card's 132 SMs while each CTA keeps at least one output row) covers one
//   sample; CTA rank r owns the band of output rows [r*ho/C, (r+1)*ho/C).
//   The convolutions are implicit GEMMs on mma.sync m16n8k16 bf16 with f32
//   sums: M = the band's output pixels in 16-pixel tiles, N = cout, K = the
//   taps x cin. The band's input with its halo, and y1 with its halo, sit in
//   shared memory as bf16 [pixel][channel] with the 16-byte chunks
//   swizzled as mma_tile.cuh does; ldmatrix takes one row address per lane,
//   so each lane points at its own pixel shifted by the tap (and, at stride
//   2, at pixel 2*o + off + d): no im2col copy is made. The weights are
//   loaded once per CTA into shared memory as bf16 B operands, w2 into
//   w1's space once conv1 is done (its copy overlaps the GN1 exchange).
//   GroupNorm across the cluster, deterministically: each CTA reduces its
//   band's (sum, sum of squares) per group in a fixed order into its own
//   shared memory, cluster.sync(), and every CTA reads all the cluster's
//   partials in rank order through distributed shared memory, so all of
//   them derive the same mean and rstd. conv2's halo, way (b): after GN1,
//   ReLU and the write of the band's y1, a second cluster.sync(), and each
//   CTA copies its neighbours' boundary rows of normalised y1 through
//   distributed shared memory. conv2's and the projection's accumulators
//   stay in the warps' registers until their statistics arrive; each warp
//   then applies GN2, adds the residual (x from shared memory, or the GN'd
//   projection) and the ReLU, stages the band's bf16 output in shared
//   memory and writes it with 16-byte stores (the band is contiguous in
//   NHWC). Numerics: y1 is rounded to bf16 once, as conv2's A operand (as
//   the plain version does in bf16: its GroupNorm casts back to x's type);
//   everything else stays f32 until the output is rounded once. Four
//   cluster barriers per block: GN1, y1's halo, GN2 with the projection's
//   GN, and the last, which keeps each CTA's shared memory alive until the
//   others have read it.
// * float32: conv_block_kernel, CUDA cores, one CTA per sample. The input
//   with its SAME halo, y1 with its halo and y2 live in shared memory as
//   f32 (213.5 KB at the 32x32x16 stage, inside the 227 KB opt-in); the
//   1x1 projection reuses y1's space once conv2 has consumed it. Weights
//   are read through the read-only cache. Phases run in order, separated
//   by __syncthreads().
//
// Stride 2 samples exactly the positions the TPU kernel's
// compute-then-subsample gives: the 3x3 conv reads halo rows
// 2*o + off + dy with off = 1 for an even extent and 0 for an odd one (SAME
// padding of (0,1) vs (1,1)); the 1x1 projection always reads even
// positions.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the return value is
// the launch's CUDA error, or cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}

template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }

struct Geom {
  int h, w, cin, c;     // input extent / channels, output channels
  int ho, wo, stride;   // output extent
  int off_h, off_w;     // stride-2 3x3 sampling offsets (parity of h, w)
  int groups;
  int has_proj;
  float eps;
};

// 3x3 convolution on a halo'd f32 source [(hs+2) x ws_p x cin] in shared
// memory. Output element idx = pixel * c + co; thread t owns
// idx = t, t + nt, ... and, because nt is a multiple of c, always the same
// channel co = t % c, so its running (sum, sum of squares) belong to one
// GroupNorm group. Writes into dst with row pitch dst_w and halo dst_off.
template <typename T>
__device__ void conv3x3(const float* src, int src_w, int cin,
                        const T* __restrict__ wt, int c, int ho, int wo,
                        int stride, int off_h, int off_w, float* dst,
                        int dst_w, int dst_off, float& s, float& ss) {
  const int total = ho * wo * c;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int co = idx % c;
    const int pix = idx / c;
    const int ox = pix % wo;
    const int oy = pix / wo;
    const int iy0 = oy * stride + off_h;
    const int ix0 = ox * stride + off_w;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* sp = src + ((iy0 + dy) * src_w + (ix0 + dx)) * cin;
        const T* wq = wt + (dy * 3 + dx) * cin * c + co;
        for (int ci = 0; ci < cin; ++ci) acc += sp[ci] * ld(wq + ci * c);
      }
    }
    dst[((oy + dst_off) * dst_w + (ox + dst_off)) * c + co] = acc;
    s += acc;
    ss += acc * acc;
  }
}

// Per-(sample, group) mean and 1/sqrt(var + eps) from the threads' partial
// sums. Thread t's partials belong to channel t % c. Deterministic: each
// group is reduced by one warp in a fixed order.
__device__ void group_stats(float s, float ss, float* red, float* stats,
                            int c, int groups, float count, float eps) {
  const int nt = blockDim.x;
  red[threadIdx.x] = s;
  red[nt + threadIdx.x] = ss;
  __syncthreads();
  const int cpg = c / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int full_warps = nt / 32;
  if (warp < full_warps) {
    for (int g = warp; g < groups; g += full_warps) {
      float a = 0.f, b = 0.f;
      for (int i = lane; i < nt; i += 32) {
        if ((i % c) / cpg == g) {
          a += red[i];
          b += red[nt + i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        const float mean = a / count;
        const float var = fmaxf(b / count - mean * mean, 0.f);
        stats[2 * g] = mean;
        stats[2 * g + 1] = 1.f / sqrtf(var + eps);
      }
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float gn(float v, const float* stats,
                                    const T* __restrict__ scale,
                                    const T* __restrict__ bias, int co,
                                    int cpg) {
  const int g = co / cpg;
  return (v - stats[2 * g]) * stats[2 * g + 1] * ld(scale + co) +
         ld(bias + co);
}

template <typename T>
__global__ void conv_block_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ g1s, const T* __restrict__ g1b,
    const T* __restrict__ w2, const T* __restrict__ g2s,
    const T* __restrict__ g2b, const T* __restrict__ wp,
    const T* __restrict__ gps, const T* __restrict__ gpb,
    T* __restrict__ out, Geom g) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int xw = g.w + 2, yw = g.wo + 2;
  const int x_elems = (g.h + 2) * xw * g.cin;
  const int y1_elems = (g.ho + 2) * yw * g.c;
  const int y2_elems = g.ho * g.wo * g.c;
  float* xs = smem;                  // x with its 1-pixel halo
  float* y1 = xs + x_elems;          // y1 with its halo; later the proj
  float* y2 = y1 + y1_elems;         // conv2 output
  float* red = y2 + y2_elems;        // 2 * nt partial sums
  float* st1 = red + 2 * nt;         // 2 * groups (mean, rstd) each
  float* st2 = st1 + 2 * g.groups;
  float* stp = st2 + 2 * g.groups;

  const T* xn = x + (size_t)blockIdx.x * g.h * g.w * g.cin;
  T* on = out + (size_t)blockIdx.x * g.ho * g.wo * g.c;
  const int cpg = g.c / g.groups;
  const float count = (float)(g.ho * g.wo * cpg);

  // phase 0: x into shared memory with a zero halo; y1 zeroed (its halo is
  // conv2's SAME padding)
  for (int i = tid; i < x_elems; i += nt) {
    const int ci = i % g.cin;
    const int p = i / g.cin;
    const int ix = p % xw, iy = p / xw;
    float v = 0.f;
    if (iy >= 1 && iy <= g.h && ix >= 1 && ix <= g.w)
      v = ld(xn + ((iy - 1) * g.w + (ix - 1)) * g.cin + ci);
    xs[i] = v;
  }
  for (int i = tid; i < y1_elems; i += nt) y1[i] = 0.f;
  __syncthreads();

  // phase 1: y1 = conv3x3(x, stride), GN statistics
  float s = 0.f, ss = 0.f;
  conv3x3<T>(xs, xw, g.cin, w1, g.c, g.ho, g.wo, g.stride, g.off_h, g.off_w,
             y1, yw, 1, s, ss);
  group_stats(s, ss, red, st1, g.c, g.groups, count, g.eps);

  // phase 2: y1 = relu(GN(y1)) in place
  for (int idx = tid; idx < y2_elems; idx += nt) {
    const int co = idx % g.c, pix = idx / g.c;
    float* p = y1 + (((pix / g.wo) + 1) * yw + (pix % g.wo) + 1) * g.c + co;
    *p = fmaxf(gn(*p, st1, g1s, g1b, co, cpg), 0.f);
  }
  __syncthreads();

  // phase 3: y2 = conv3x3(y1), GN statistics
  s = 0.f;
  ss = 0.f;
  conv3x3<T>(y1, yw, g.c, w2, g.c, g.ho, g.wo, 1, 0, 0, y2, g.wo, 0, s, ss);
  group_stats(s, ss, red, st2, g.c, g.groups, count, g.eps);

  // phase 4: residual projection r = conv1x1(x, stride) into y1's space
  // (conv2 has finished reading y1: group_stats ended in a barrier)
  float* r = y1;
  if (g.has_proj) {
    s = 0.f;
    ss = 0.f;
    for (int idx = tid; idx < y2_elems; idx += nt) {
      const int co = idx % g.c, pix = idx / g.c;
      const int oy = pix / g.wo, ox = pix % g.wo;
      const float* sp = xs + ((oy * g.stride + 1) * xw + ox * g.stride + 1) *
                                 g.cin;
      float acc = 0.f;
      for (int ci = 0; ci < g.cin; ++ci) acc += sp[ci] * ld(wp + ci * g.c + co);
      r[idx] = acc;
      s += acc;
      ss += acc * acc;
    }
    group_stats(s, ss, red, stp, g.c, g.groups, count, g.eps);
  }

  // phase 5: out = relu(GN(y2) + residual)
  for (int idx = tid; idx < y2_elems; idx += nt) {
    const int co = idx % g.c, pix = idx / g.c;
    float res;
    if (g.has_proj) {
      res = gn(r[idx], stp, gps, gpb, co, cpg);
    } else {
      res = xs[(((pix / g.wo) + 1) * xw + (pix % g.wo) + 1) * g.cin + co];
    }
    on[idx] = st<T>(fmaxf(gn(y2[idx], st2, g2s, g2b, co, cpg) + res, 0.f));
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* g1s, const void* g1b,
           const void* w2, const void* g2s, const void* g2b, const void* wp,
           const void* gps, const void* gpb, void* out, int n, const Geom& g,
           int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_block_kernel<T><<<n, threads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)g1s, (const T*)g1b, (const T*)w2,
      (const T*)g2s, (const T*)g2b, (const T*)wp, (const T*)gps,
      (const T*)gpb, (T*)out, g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- tensor-core kernel ----
namespace cg = cooperative_groups;
namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
// Output units (16 pixels x 16 channels, 8 f32 per thread) a warp holds in
// registers per convolution; the wrapper picks a cluster large enough.
constexpr int UNITS = 4;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

struct Band {
  int h, w, ho, wo, stride, off_h, off_w, groups, has_proj, cluster, rmax;
  float eps;
};

// Byte offsets of the shared-memory regions of one CTA, each 128-aligned;
// the same on every CTA of a cluster (sized for the tallest band), so a
// region of a neighbour is at the same offset.
struct Layout {
  size_t x, y1, w, wp, col, part, stats, gn, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__host__ __device__ inline Layout band_layout(int cin, int c, int w, int wo, int stride,
                                              int rmax) {
  Layout l;
  const size_t xr = (size_t)(rmax - 1) * stride + 3;  // input rows with halo
  const int wmax = cin > c ? cin : c;
  l.x = 0;
  l.y1 = l.x + align128(xr * (w + 2) * cin * 2);             // bf16 x band
  l.w = l.y1 + align128((size_t)(rmax + 2) * (wo + 2) * c * 2);  // bf16 y1 band
  l.wp = l.w + align128((size_t)9 * wmax * c * 2);           // w1, then w2
  l.col = l.wp + align128((size_t)cin * c * 2);              // wp
  l.part = l.col + align128((size_t)2 * MMA_WARPS * c * 2 * 4);  // per-warp column sums
  l.stats = l.part + align128((size_t)3 * c * 2 * 4);        // cluster partials
  l.gn = l.stats + align128((size_t)3 * c * 2 * 4);          // mean, rstd
  l.total = l.gn + align128((size_t)6 * c * 4);              // GN scales, biases
  return l;
}

// acc[j] = the convolution of unit j of this warp (unit u = warp + 8j: its
// 16-pixel tile u / NP, its 16 channels u % NP): A rows are pixels of a
// [pixel][CIN] bf16 tile at shared address `src` (lane's own pixel pix[j],
// shifted by dy * pitch + dx at each tap), B is the weights [TAPS * CIN][C]
// at `wt`, read through ldmatrix.trans.
template <int CIN, int C, int TAPS>
__device__ __forceinline__ void conv_mma(float (&acc)[UNITS][2][4], uint32_t src,
                                         const int (&pix)[UNITS], int pitch, uint32_t wt,
                                         int n_units, int warp, int lane) {
  constexpr int KC = CIN / 16, NP = C / 16;
#pragma unroll
  for (int j = 0; j < UNITS; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i / 4][i % 4] = 0.f;
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    const int shift = TAPS == 9 ? (tap / 3) * pitch + tap % 3 : 0;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int u = warp + MMA_WARPS * j;
        if (u < n_units) {
          uint32_t a[4], bw[4];
          mt::ldmatrix_x4(a, src + 2 * mt::tile_off<CIN>(pix[j] + shift, 2 * kc + (lane >> 4)));
          mt::ldmatrix_x4_trans(bw, mt::b_frag_addr<C>(wt, tap * CIN + 16 * kc, 2 * (u % NP), lane));
          mt::mma_bf16(acc[j][0], a, bw[0], bw[1]);
          mt::mma_bf16(acc[j][1], a, bw[2], bw[3]);
        }
      }
  }
}

// Lane's A-row pixel of each unit in a source tile of row pitch `pitch`:
// output pixel p of the band (rows of 16 per unit; a pixel past the band
// reads pixel 0 and its result is dropped) at (oy * s + ry, ox * s + rx).
template <int C>
__device__ __forceinline__ void unit_pixels(int (&pix)[UNITS], int n_pix, int wo, int s,
                                            int ry, int rx, int pitch, int warp, int lane) {
  constexpr int NP = C / 16;
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    int p = 16 * ((warp + MMA_WARPS * j) / NP) + (lane & 15);
    p = p < n_pix ? p : 0;
    pix[j] = ((p / wo) * s + ry) * pitch + (p % wo) * s + rx;
  }
}

// Per-channel (sum, sum of squares) of this warp's outputs into
// colw[warp][channel][2], unit after unit: each channel's sums are kept by
// one lane, so the order is fixed. Pixels past the band count nothing.
template <int C>
__device__ __forceinline__ void col_sums(const float (&acc)[UNITS][2][4], float* colw,
                                         int n_units, int n_pix, int warp, int lane) {
  constexpr int NP = C / 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = warp + MMA_WARPS * j;
    if (u >= n_units) continue;
    const int p0 = 16 * (u / NP) + g;
    const bool v0 = p0 < n_pix, v1 = p0 + 8 < n_pix;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = v0 ? acc[j][hh][e] : 0.f, b = v1 ? acc[j][hh][2 + e] : 0.f;
        float s = a + b, q = a * a + b * b;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (g == 0) {
          float* d = colw + 2 * (warp * C + 16 * (u % NP) + 8 * hh + 2 * t + e);
          d[0] += s;
          d[1] += q;
        }
      }
  }
}

// Thread `first + grp` (grp < groups): the group's (sum, sum of squares)
// over warps, then channels, in order, into part[grp]; colw is zeroed for
// its next use.
template <int C>
__device__ __forceinline__ void group_sums(float* colw, float* part, int groups, int first) {
  const int grp = static_cast<int>(threadIdx.x) - first;
  if (grp < 0 || grp >= groups) return;
  const int cpg = C / groups;
  float s = 0.f, q = 0.f;
  for (int w = 0; w < MMA_WARPS; ++w)
    for (int ch = grp * cpg; ch < (grp + 1) * cpg; ++ch) {
      float* d = colw + 2 * (w * C + ch);
      s += d[0];
      q += d[1];
      d[0] = d[1] = 0.f;
    }
  part[2 * grp] = s;
  part[2 * grp + 1] = q;
}

// After a cluster barrier: thread `first + grp` reads group grp's partials
// of every CTA of the cluster in rank order (distributed shared memory) and
// writes (mean, rstd): the same numbers on every CTA.
__device__ __forceinline__ void cluster_stats(cg::cluster_group& cl, float* part, float* stats,
                                              int groups, int first, float count, float eps) {
  const int grp = static_cast<int>(threadIdx.x) - first;
  if (grp < 0 || grp >= groups) return;
  float s = 0.f, q = 0.f;
  for (unsigned r = 0; r < cl.num_blocks(); ++r) {
    const float* p = cl.map_shared_rank(part, r);
    s += p[2 * grp];
    q += p[2 * grp + 1];
  }
  const float mean = s / count;
  const float var = fmaxf(q / count - mean * mean, 0.f);
  stats[2 * grp] = mean;
  stats[2 * grp + 1] = 1.f / sqrtf(var + eps);
}

__device__ __forceinline__ float gn_apply(float v, const float* stats, const float* scale,
                                          const float* bias, int ch, int cpg) {
  const int grp = ch / cpg;
  return (v - stats[2 * grp]) * stats[2 * grp + 1] * scale[ch] + bias[ch];
}

// rows x CPR chunks of a row-major bf16 matrix (row stride `ld`) into a
// swizzled [rows][8 * CPR] tile, with cp.async.
template <int DP>
__device__ __forceinline__ void load_weights(bf16* dst, const bf16* __restrict__ src, int rows) {
  constexpr int CPR = DP / 8;
  for (int i = threadIdx.x; i < rows * CPR; i += MMA_THREADS)
    mt::cp_async16(dst + mt::tile_off<DP>(i / CPR, i % CPR), src + static_cast<size_t>(i) * 8,
                   true);
}

template <int CIN, int C>
__global__ void __launch_bounds__(MMA_THREADS)
conv_block_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ g1s, const bf16* __restrict__ g1b,
                      const bf16* __restrict__ w2, const bf16* __restrict__ g2s,
                      const bf16* __restrict__ g2b, const bf16* __restrict__ wp,
                      const bf16* __restrict__ gps, const bf16* __restrict__ gpb,
                      bf16* __restrict__ out, Band g) {
  constexpr int CPRI = CIN / 8, CPR = C / 8, NP = C / 16;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char band_smem[];
  const Layout L = band_layout(CIN, C, g.w, g.wo, g.stride, g.rmax);
  bf16* xs = reinterpret_cast<bf16*>(band_smem + L.x);
  bf16* y1s = reinterpret_cast<bf16*>(band_smem + L.y1);
  bf16* ws = reinterpret_cast<bf16*>(band_smem + L.w);
  bf16* wps = reinterpret_cast<bf16*>(band_smem + L.wp);
  float* colw = reinterpret_cast<float*>(band_smem + L.col);  // [2][warps][C][2]
  float* part = reinterpret_cast<float*>(band_smem + L.part);   // [3][C][2]: GN1, GN2, proj
  float* stats = reinterpret_cast<float*>(band_smem + L.stats); // [3][C][2]
  float* gnp = reinterpret_cast<float*>(band_smem + L.gn);      // [6][C]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t = lane & 3;
  const int rank = static_cast<int>(cl.block_rank()), nc = g.cluster;
  const int sample = blockIdx.x / nc;
  const int oy0 = rank * g.ho / nc, R = (rank + 1) * g.ho / nc - oy0;
  const int n_pix = R * g.wo, n_units = (n_pix + 15) / 16 * NP;
  const int xw = g.w + 2, yw = g.wo + 2, s = g.stride;
  const int cpg = C / g.groups;
  const float count = static_cast<float>(g.ho * g.wo * cpg);

  // phase 0: the band's input rows with their zero halo (padded row
  // oy0 * s + off_h + j is input row oy0 * s + off_h + j - 1), w1 and wp
  // by cp.async; GN params as f32; y1's band zeroed (its halo columns, and
  // the halo rows at the sample's edges, are conv2's SAME padding).
  {
    const int xr = (R - 1) * s + 3, y0 = oy0 * s + g.off_h - 1;
    const bf16* xn = x + static_cast<size_t>(sample) * g.h * g.w * CIN;
    for (int i = tid; i < xr * xw * CPRI; i += MMA_THREADS) {
      const int pix = i / CPRI, c = i % CPRI;
      const int iy = y0 + pix / xw, ix = pix % xw - 1;
      const bool in = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      mt::cp_async16(xs + mt::tile_off<CIN>(pix, c),
                     in ? xn + (static_cast<size_t>(iy) * g.w + ix) * CIN + c * 8 : xn, in);
    }
    load_weights<C>(ws, w1, 9 * CIN);
    if (g.has_proj) load_weights<C>(wps, wp, CIN);
    mt::cp_async_commit();
    const bf16* src[6] = {g1s, g1b, g2s, g2b, gps, gpb};
    for (int i = tid; i < (g.has_proj ? 6 : 4) * C; i += MMA_THREADS)
      gnp[i] = __bfloat162float(src[i / C][i % C]);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (R + 2) * yw * CPR; i += MMA_THREADS)
      *reinterpret_cast<uint4*>(y1s + 8 * i) = zero;
    for (int i = tid; i < 2 * MMA_WARPS * C * 2; i += MMA_THREADS) colw[i] = 0.f;
    mt::cp_async_wait<0>();
    __syncthreads();
  }

  // phase 1: conv1, GN1's partials; w2 into w1's space once every warp is
  // done with w1, in flight during the exchange
  float acc[UNITS][2][4];
  int pix[UNITS];
  unit_pixels<C>(pix, n_pix, g.wo, s, 0, g.off_w, xw, warp, lane);
  conv_mma<CIN, C, 9>(acc, mt::smem_u32(xs), pix, xw, mt::smem_u32(ws), n_units, warp, lane);
  col_sums<C>(acc, colw, n_units, n_pix, warp, lane);
  __syncthreads();
  load_weights<C>(ws, w2, 9 * C);
  mt::cp_async_commit();
  group_sums<C>(colw, part, g.groups, 0);
  cl.sync();  // 1: GN1 partials of the cluster
  cluster_stats(cl, part, stats, g.groups, 0, count, g.eps);
  __syncthreads();

  // phase 2: y1 = relu(GN1(conv1)) as bf16 into the band's rows 1..R
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = warp + MMA_WARPS * j;
    if (u >= n_units) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (u / NP) + g4 + 8 * r;
      if (p >= n_pix) continue;
      const int yp = (p / g.wo + 1) * yw + p % g.wo + 1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ch = 16 * (u % NP) + 8 * hh + 2 * t;
        const float a = fmaxf(gn_apply(acc[j][hh][2 * r], stats, gnp, gnp + C, ch, cpg), 0.f);
        const float b =
            fmaxf(gn_apply(acc[j][hh][2 * r + 1], stats, gnp, gnp + C, ch + 1, cpg), 0.f);
        *reinterpret_cast<uint32_t*>(y1s + mt::tile_off<C>(yp, ch / 8) + ch % 8) =
            mt::pack_bf16(a, b);
      }
    }
  }
  cl.sync();  // 2: every band's y1 is written

  // y1's halo rows from the neighbours' boundary rows (distributed shared
  // memory; a neighbour's band has its own height, the same layout)
  for (int i = tid; i < 2 * yw * CPR; i += MMA_THREADS) {
    const int below = i >= yw * CPR, k = i % (yw * CPR), px = k / CPR, c = k % CPR;
    const int nb = rank + (below ? 1 : -1);
    if (nb < 0 || nb >= nc) continue;
    const int nb_r = (nb + 1) * g.ho / nc - nb * g.ho / nc;
    const int src_row = below ? 1 : nb_r, dst_row = below ? R + 1 : 0;
    const bf16* nby1 = cl.map_shared_rank(y1s, nb);
    *reinterpret_cast<uint4*>(y1s + mt::tile_off<C>(dst_row * yw + px, c)) =
        *reinterpret_cast<const uint4*>(nby1 + mt::tile_off<C>(src_row * yw + px, c));
  }
  mt::cp_async_wait<0>();  // w2
  __syncthreads();

  // phase 3: conv2 and the projection, their partials
  unit_pixels<C>(pix, n_pix, g.wo, 1, 0, 0, yw, warp, lane);
  conv_mma<C, C, 9>(acc, mt::smem_u32(y1s), pix, yw, mt::smem_u32(ws), n_units, warp, lane);
  col_sums<C>(acc, colw, n_units, n_pix, warp, lane);
  float accp[UNITS][2][4];
  if (g.has_proj) {
    // input pixel (oy * s, ox * s): padded row oy * s + 1, band row
    // (oy - oy0) * s + 1 - off_h
    unit_pixels<C>(pix, n_pix, g.wo, s, 1 - g.off_h, 1, xw, warp, lane);
    conv_mma<CIN, C, 1>(accp, mt::smem_u32(xs), pix, xw, mt::smem_u32(wps), n_units, warp,
                        lane);
    col_sums<C>(accp, colw + MMA_WARPS * C * 2, n_units, n_pix, warp, lane);
  }
  __syncthreads();
  group_sums<C>(colw, part + 2 * C, g.groups, 0);
  if (g.has_proj) group_sums<C>(colw + MMA_WARPS * C * 2, part + 4 * C, g.groups, 128);
  cl.sync();  // 3: GN2 and projection partials; every halo copy is done
  cluster_stats(cl, part + 2 * C, stats + 2 * C, g.groups, 0, count, g.eps);
  if (g.has_proj) cluster_stats(cl, part + 4 * C, stats + 4 * C, g.groups, 128, count, g.eps);
  __syncthreads();

  // phase 4: out = relu(GN2(conv2) + residual), staged as bf16 in y1's
  // space (no CTA reads it any more), then 16-byte stores of the band
  bf16* os = y1s;
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = warp + MMA_WARPS * j;
    if (u >= n_units) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (u / NP) + g4 + 8 * r;
      if (p >= n_pix) continue;
      const int xp = (p / g.wo + 1) * xw + p % g.wo + 1;  // identity residual
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ch = 16 * (u % NP) + 8 * hh + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = gn_apply(acc[j][hh][2 * r + e], stats + 2 * C, gnp + 2 * C,
                                   gnp + 3 * C, ch + e, cpg);
          const float res =
              g.has_proj
                  ? gn_apply(accp[j][hh][2 * r + e], stats + 4 * C, gnp + 4 * C, gnp + 5 * C,
                             ch + e, cpg)
                  : __bfloat162float(xs[mt::tile_off<CIN>(xp, (ch + e) / 8) + (ch + e) % 8]);
          o[e] = fmaxf(y + res, 0.f);
        }
        *reinterpret_cast<uint32_t*>(os + mt::tile_off<C>(p, ch / 8) + ch % 8) =
            mt::pack_bf16(o[0], o[1]);
      }
    }
  }
  __syncthreads();
  bf16* ob = out + (static_cast<size_t>(sample) * g.ho + oy0) * g.wo * C;
  for (int i = tid; i < n_pix * CPR; i += MMA_THREADS)
    *reinterpret_cast<uint4*>(ob + 8 * static_cast<size_t>(i)) =
        *reinterpret_cast<const uint4*>(os + mt::tile_off<C>(i / CPR, i % CPR));
  cl.sync();  // 4: no CTA leaves while another may read its partials
}

template <int CIN, int C>
int launch_mma(const void* x, const void* w1, const void* g1s, const void* g1b, const void* w2,
               const void* g2s, const void* g2b, const void* wp, const void* gps,
               const void* gpb, void* out, int n, const Band& g, cudaStream_t stream) {
  auto kernel = conv_block_mma_kernel<CIN, C>;
  const size_t smem = band_layout(CIN, C, g.w, g.wo, g.stride, g.rmax).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * g.cluster);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident is refused here, not at run time
  int fits = 0;
  err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w1), static_cast<const bf16*>(g1s),
                           static_cast<const bf16*>(g1b), static_cast<const bf16*>(w2),
                           static_cast<const bf16*>(g2s), static_cast<const bf16*>(g2b),
                           static_cast<const bf16*>(wp), static_cast<const bf16*>(gps),
                           static_cast<const bf16*>(gpb), static_cast<bf16*>(out), g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN>
int dispatch_cout(int c, const void* x, const void* w1, const void* g1s, const void* g1b,
                  const void* w2, const void* g2s, const void* g2b, const void* wp,
                  const void* gps, const void* gpb, void* out, int n, const Band& g,
                  cudaStream_t st) {
  if (c == 16) return launch_mma<CIN, 16>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, g, st);
  if (c == 32) return launch_mma<CIN, 32>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, g, st);
  if (c == 64) return launch_mma<CIN, 64>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the float32 kernel needs.
size_t conv_block_smem_bytes(int h, int w, int cin, int c, int stride,
                             int groups, int threads) {
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const size_t floats = (size_t)(h + 2) * (w + 2) * cin +
                        (size_t)(ho + 2) * (wo + 2) * c + (size_t)ho * wo * c +
                        2 * (size_t)threads + 6 * (size_t)groups;
  return floats * sizeof(float);
}

// Bytes of dynamic shared memory one CTA of the bfloat16 kernel needs, with
// `cluster` CTAs per sample.
size_t conv_block_mma_smem_bytes(int h, int w, int cin, int c, int stride,
                                 int cluster) {
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  return band_layout(cin, c, w, wo, stride, (ho + cluster - 1) / cluster).total;
}

// dtype: 0 = float32 (threads per CTA: a positive multiple of c, at most
// 1024), 1 = bfloat16 (cluster: CTAs per sample, 1..8 and at most the output
// height; cin and c in {16, 32, 64}). wp/gps/gpb are null without a
// projection.
int conv_block_forward(const void* x, const void* w1, const void* g1s,
                       const void* g1b, const void* w2, const void* g2s,
                       const void* g2b, const void* wp, const void* gps,
                       const void* gpb, void* out, int n, int h, int w,
                       int cin, int c, int stride, int groups, float eps,
                       int dtype, int threads, int cluster, void* stream) {
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const int off_h = (stride == 2 && h % 2 == 0) ? 1 : 0;
  const int off_w = (stride == 2 && w % 2 == 0) ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    Geom g;
    g.h = h;
    g.w = w;
    g.cin = cin;
    g.c = c;
    g.stride = stride;
    g.ho = ho;
    g.wo = wo;
    g.off_h = off_h;
    g.off_w = off_w;
    g.groups = groups;
    g.has_proj = wp != nullptr;
    g.eps = eps;
    const size_t smem =
        conv_block_smem_bytes(h, w, cin, c, stride, groups, threads);
    return launch<float>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n,
                         g, threads, smem, s);
  }
  if (dtype != 1 || cluster < 1 || cluster > MAX_CLUSTER || cluster > ho ||
      groups < 1 || c % groups)
    return (int)cudaErrorInvalidValue;
  Band b;
  b.h = h;
  b.w = w;
  b.ho = ho;
  b.wo = wo;
  b.stride = stride;
  b.off_h = off_h;
  b.off_w = off_w;
  b.groups = groups;
  b.has_proj = wp != nullptr;
  b.cluster = cluster;
  b.rmax = (ho + cluster - 1) / cluster;
  b.eps = eps;
  if ((b.rmax * wo + 15) / 16 * (c / 16) > MMA_WARPS * UNITS)
    return (int)cudaErrorInvalidValue;  // more output units than registers
  if (cin == 16)
    return dispatch_cout<16>(c, x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, b, s);
  if (cin == 32)
    return dispatch_cout<32>(c, x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, b, s);
  if (cin == 64)
    return dispatch_cout<64>(c, x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
