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
// several times. The design keeps every intermediate on chip: one CTA owns
// one sample, so GroupNorm's reduction over a (sample, group) and conv2's
// need for every channel of y1 both stay inside the CTA. The input with its
// SAME halo, y1 with its halo and y2 live in shared memory as f32 (213.5 KB
// at the 32x32x16 stage, inside the 227 KB opt-in); the 1x1 projection
// reuses y1's space once conv2 has consumed it. Weights are read through
// the read-only cache. Phases run in order, separated by __syncthreads().
//
// This first version is simple and right, not fast: the convolutions run on
// CUDA cores in f32, and there is one CTA per sample (32 CTAs at batch 32 on
// 132 SMs). wgmma, TMA and several CTAs per sample are later work.
//
// Stride 2 samples exactly the positions the TPU kernel's
// compute-then-subsample gives: the 3x3 conv reads halo rows
// 2*o + off + dy with off = 1 for an even extent and 0 for an odd one (SAME
// padding of (0,1) vs (1,1)); the 1x1 projection always reads even
// positions.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for this geometry.
size_t conv_block_smem_bytes(int h, int w, int cin, int c, int stride,
                             int groups, int threads) {
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const size_t floats = (size_t)(h + 2) * (w + 2) * cin +
                        (size_t)(ho + 2) * (wo + 2) * c + (size_t)ho * wo * c +
                        2 * (size_t)threads + 6 * (size_t)groups;
  return floats * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. wp/gps/gpb are null without a
// projection. threads must be a positive multiple of c (at most 1024).
int conv_block_forward(const void* x, const void* w1, const void* g1s,
                       const void* g1b, const void* w2, const void* g2s,
                       const void* g2b, const void* wp, const void* gps,
                       const void* gpb, void* out, int n, int h, int w,
                       int cin, int c, int stride, int groups, float eps,
                       int dtype, int threads, void* stream) {
  Geom g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.c = c;
  g.stride = stride;
  g.ho = (h + stride - 1) / stride;
  g.wo = (w + stride - 1) / stride;
  g.off_h = (stride == 2 && h % 2 == 0) ? 1 : 0;
  g.off_w = (stride == 2 && w % 2 == 0) ? 1 : 0;
  g.groups = groups;
  g.has_proj = wp != nullptr;
  g.eps = eps;
  const size_t smem =
      conv_block_smem_bytes(h, w, cin, c, stride, groups, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb, out, n,
                         g, threads, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, g1s, g1b, w2, g2s, g2b, wp, gps, gpb,
                                 out, n, g, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
