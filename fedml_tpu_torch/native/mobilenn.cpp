// Native on-device training core — the MobileNN analogue.
//
// Parity target: the reference's C++ device SDK
// (android/fedmlsdk/MobileNN: FedMLBaseTrainer + MNN/torch engine
// implementations, ~2.6k LoC C++) and its native secure-aggregation masking
// (MobileNN/src/security/LightSecAgg.cpp). Devices in that stack train a
// small model locally in native code and exchange *masked* updates.
//
// This is a fresh implementation sized to what a TPU-federated deployment
// actually needs on-device: a softmax-regression SGD trainer (the
// cross-device reference workload is LR/LeNet-class models) and
// finite-field masking over GF(p), p = 2^31 - 1 — the same field the
// Python SecAgg math uses (core/mpc/field_ops.py), so natively-masked
// updates unmask server-side with the existing Python pipeline.
//
// Deterministic by construction: shuffling and mask generation use
// explicit splitmix64 streams seeded by the caller, so device results are
// reproducible across runs and platforms.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// splitmix64: tiny, high-quality, seedable PRG (public-domain algorithm)
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

constexpr uint64_t kPrime = 2147483647ULL;  // 2^31 - 1 (Mersenne)

}  // namespace

extern "C" {

// Softmax-regression SGD: logits = x·W + b, cross-entropy loss, plain SGD.
// x: [n, d] row-major, y: [n] labels in [0, k). W: [d, k], b: [k] updated
// in place. Runs `epochs` passes over batches of `batch` with per-epoch
// Fisher-Yates shuffling from `seed`. Returns mean loss of the LAST epoch.
float train_linear_sgd(float* W, float* b, const float* x, const int32_t* y,
                       int32_t n, int32_t d, int32_t k, int32_t epochs,
                       int32_t batch, float lr, uint64_t seed) {
  if (n <= 0 || d <= 0 || k <= 0 || batch <= 0) return -1.0f;
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::vector<float> logits(k), probs(k);
  std::vector<float> gW(static_cast<size_t>(d) * k), gb(k);
  float last_epoch_loss = 0.0f;

  for (int32_t e = 0; e < epochs; ++e) {
    uint64_t rng = seed + static_cast<uint64_t>(e) * 0x51ED2701ULL;
    for (int32_t i = n - 1; i > 0; --i) {  // Fisher-Yates
      int32_t j = static_cast<int32_t>(splitmix64(rng) % (i + 1));
      int32_t t = order[i]; order[i] = order[j]; order[j] = t;
    }
    float epoch_loss = 0.0f;
    int32_t seen = 0;
    for (int32_t start = 0; start < n; start += batch) {
      int32_t bs = (start + batch <= n) ? batch : (n - start);
      std::memset(gW.data(), 0, gW.size() * sizeof(float));
      std::memset(gb.data(), 0, gb.size() * sizeof(float));
      for (int32_t bi = 0; bi < bs; ++bi) {
        const float* xi = x + static_cast<size_t>(order[start + bi]) * d;
        int32_t yi = y[order[start + bi]];
        // forward
        float maxl = -1e30f;
        for (int32_t c = 0; c < k; ++c) {
          float acc = b[c];
          for (int32_t f = 0; f < d; ++f) acc += xi[f] * W[f * k + c];
          logits[c] = acc;
          if (acc > maxl) maxl = acc;
        }
        float denom = 0.0f;
        for (int32_t c = 0; c < k; ++c) {
          probs[c] = std::exp(logits[c] - maxl);
          denom += probs[c];
        }
        for (int32_t c = 0; c < k; ++c) probs[c] /= denom;
        epoch_loss += -std::log(probs[yi] > 1e-12f ? probs[yi] : 1e-12f);
        ++seen;
        // backward: dlogit = probs - onehot(y)
        for (int32_t c = 0; c < k; ++c) {
          float dl = probs[c] - (c == yi ? 1.0f : 0.0f);
          gb[c] += dl;
          for (int32_t f = 0; f < d; ++f) gW[f * k + c] += xi[f] * dl;
        }
      }
      const float scale = lr / static_cast<float>(bs);
      for (size_t idx = 0; idx < gW.size(); ++idx) W[idx] -= scale * gW[idx];
      for (int32_t c = 0; c < k; ++c) b[c] -= scale * gb[c];
    }
    last_epoch_loss = seen ? epoch_loss / seen : 0.0f;
  }
  return last_epoch_loss;
}

// Accuracy of the current W, b on (x, y) — the device-side eval hook.
float eval_linear(const float* W, const float* b, const float* x,
                  const int32_t* y, int32_t n, int32_t d, int32_t k) {
  if (n <= 0) return 0.0f;
  int32_t correct = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float* xi = x + static_cast<size_t>(i) * d;
    int32_t best = 0;
    float bestv = -1e30f;
    for (int32_t c = 0; c < k; ++c) {
      float acc = b[c];
      for (int32_t f = 0; f < d; ++f) acc += xi[f] * W[f * k + c];
      if (acc > bestv) { bestv = acc; best = c; }
    }
    if (best == y[i]) ++correct;
  }
  return static_cast<float>(correct) / static_cast<float>(n);
}

// Generate a PRG mask stream over GF(2^31-1) from `seed` (LightSecAgg
// device-side primitive; server unmasks with the Python field ops).
void gen_mask(uint32_t* out, int64_t n, uint64_t seed) {
  uint64_t rng = seed;
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<uint32_t>(splitmix64(rng) % kPrime);
}

// Quantize float vector v into the field (fixed-point, `scale` ticks per
// unit, offset so negatives map into the field) and add the PRG mask from
// `seed`: out[i] = (q(v[i]) + mask[i]) mod p.
void mask_vector(uint32_t* out, const float* v, int64_t n, float scale,
                 uint64_t seed) {
  uint64_t rng = seed;
  const int64_t half = static_cast<int64_t>(kPrime / 2);
  for (int64_t i = 0; i < n; ++i) {
    double q = std::llround(static_cast<double>(v[i]) * scale);
    int64_t qi = static_cast<int64_t>(q);
    // clamp into (-p/2, p/2) then shift into [0, p)
    if (qi > half - 1) qi = half - 1;
    if (qi < -half) qi = -half;
    uint64_t f = static_cast<uint64_t>(qi + half);
    uint64_t m = splitmix64(rng) % kPrime;
    out[i] = static_cast<uint32_t>((f + m) % kPrime);
  }
}

// Remove the PRG mask and de-quantize: the server-side inverse of
// mask_vector for a SINGLE device (aggregate unmasking sums masked vectors
// and subtracts the sum of masks — done by the Python pipeline; this
// single-vector form is used in tests and point-to-point checks).
void unmask_vector(float* out, const uint32_t* masked, int64_t n,
                   float scale, uint64_t seed) {
  uint64_t rng = seed;
  const int64_t half = static_cast<int64_t>(kPrime / 2);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t m = splitmix64(rng) % kPrime;
    uint64_t f = (static_cast<uint64_t>(masked[i]) + kPrime - m) % kPrime;
    out[i] = static_cast<float>(static_cast<int64_t>(f) - half) / scale;
  }
}

int32_t mobilenn_abi_version() { return 3; }

}  // extern "C"

// ===================== CNN trainer (LeNet-class) ============================
//
// Mirror of the flax DeviceCNN (model/cv/cnn.py): conv3x3 SAME (C1) + relu +
// maxpool2 + conv3x3 SAME (C2) + relu + maxpool2 + dense + softmax CE.
// Layouts match flax exactly: x NHWC, conv kernels [3,3,Cin,Cout], dense
// kernel [features, k], flatten order (h*W + w)*C + c — so native and JAX
// devices train the SAME param tree and the server aggregates them
// interchangeably (reference: MobileNN's MNN LeNet engine,
// FedMLMNNTrainer.cpp).

namespace {

struct ConvShape {
  int32_t H, W, Cin, Cout;
};

// y[b] = relu(conv3x3_same(x)) ; x: [H,W,Cin], k: [3,3,Cin,Cout]
void conv3x3_fwd(const float* x, const float* k, const float* bias, float* y,
                 const ConvShape& s) {
  for (int32_t h = 0; h < s.H; ++h)
    for (int32_t w = 0; w < s.W; ++w)
      for (int32_t co = 0; co < s.Cout; ++co) {
        float acc = bias[co];
        for (int32_t dh = -1; dh <= 1; ++dh)
          for (int32_t dw = -1; dw <= 1; ++dw) {
            int32_t ih = h + dh, iw = w + dw;
            if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) continue;
            const float* xp = x + (ih * s.W + iw) * s.Cin;
            const float* kp = k + (((dh + 1) * 3 + (dw + 1)) * s.Cin) * s.Cout
                              + co;
            for (int32_t ci = 0; ci < s.Cin; ++ci)
              acc += xp[ci] * kp[ci * s.Cout];
          }
        y[(h * s.W + w) * s.Cout + co] = acc;
      }
}

// backward of conv3x3_same: accumulates gk/gb, writes gx (may be null)
void conv3x3_bwd(const float* x, const float* k, const float* gy, float* gx,
                 float* gk, float* gb, const ConvShape& s) {
  if (gx) std::memset(gx, 0, sizeof(float) * s.H * s.W * s.Cin);
  for (int32_t h = 0; h < s.H; ++h)
    for (int32_t w = 0; w < s.W; ++w)
      for (int32_t co = 0; co < s.Cout; ++co) {
        float g = gy[(h * s.W + w) * s.Cout + co];
        if (g == 0.0f) continue;
        gb[co] += g;
        for (int32_t dh = -1; dh <= 1; ++dh)
          for (int32_t dw = -1; dw <= 1; ++dw) {
            int32_t ih = h + dh, iw = w + dw;
            if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) continue;
            const float* xp = x + (ih * s.W + iw) * s.Cin;
            size_t kbase = (((dh + 1) * 3 + (dw + 1)) * s.Cin) * s.Cout + co;
            for (int32_t ci = 0; ci < s.Cin; ++ci) {
              gk[kbase + static_cast<size_t>(ci) * s.Cout] += xp[ci] * g;
              if (gx)
                gx[(ih * s.W + iw) * s.Cin + ci] +=
                    k[kbase + static_cast<size_t>(ci) * s.Cout] * g;
            }
          }
      }
}

// 2x2 maxpool stride 2 (floor); argmax saved for backward
void pool2_fwd(const float* x, float* y, int32_t* arg, int32_t H, int32_t W,
               int32_t C) {
  int32_t Ho = H / 2, Wo = W / 2;
  for (int32_t h = 0; h < Ho; ++h)
    for (int32_t w = 0; w < Wo; ++w)
      for (int32_t c = 0; c < C; ++c) {
        float best = -1e30f;
        int32_t bi = 0;
        for (int32_t dh = 0; dh < 2; ++dh)
          for (int32_t dw = 0; dw < 2; ++dw) {
            int32_t idx = ((h * 2 + dh) * W + (w * 2 + dw)) * C + c;
            if (x[idx] > best) { best = x[idx]; bi = idx; }
          }
        y[(h * Wo + w) * C + c] = best;
        arg[(h * Wo + w) * C + c] = bi;
      }
}

}  // namespace

extern "C" {

// Train the DeviceCNN with SGD. Params updated in place:
//   k1 [3,3,Cin,C1] b1 [C1]  k2 [3,3,C1,C2] b2 [C2]
//   Wd [feat, k]    bd [k]   with feat = (H/4)*(W/4)*C2
// x: [n, H, W, Cin] NHWC, y: [n]. Returns mean loss of the last epoch.
float train_cnn_sgd(float* k1, float* b1, float* k2, float* b2, float* Wd,
                    float* bd, const float* x, const int32_t* y, int32_t n,
                    int32_t H, int32_t W, int32_t Cin, int32_t C1, int32_t C2,
                    int32_t nclass, int32_t epochs, int32_t batch, float lr,
                    uint64_t seed) {
  if (n <= 0 || H < 4 || W < 4 || batch <= 0) return -1.0f;
  const int32_t H2 = H / 2, W2 = W / 2, H4 = H2 / 2, W4 = W2 / 2;
  const int32_t feat = H4 * W4 * C2;
  ConvShape s1{H, W, Cin, C1}, s2{H2, W2, C1, C2};
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;

  // activations (per sample)
  std::vector<float> a1(H * W * C1), p1(H2 * W2 * C1);
  std::vector<int32_t> arg1(H2 * W2 * C1);
  std::vector<float> a2(H2 * W2 * C2), p2(feat);
  std::vector<int32_t> arg2(feat);
  std::vector<float> logits(nclass), probs(nclass);
  // grads (per batch)
  std::vector<float> gk1(9 * static_cast<size_t>(Cin) * C1), gb1(C1);
  std::vector<float> gk2(9 * static_cast<size_t>(C1) * C2), gb2(C2);
  std::vector<float> gWd(static_cast<size_t>(feat) * nclass), gbd(nclass);
  // per-sample backward scratch
  std::vector<float> gp2(feat), ga2(H2 * W2 * C2), gp1(H2 * W2 * C1),
      ga1(H * W * C1);

  float last_epoch_loss = 0.0f;
  for (int32_t e = 0; e < epochs; ++e) {
    uint64_t rng = seed + static_cast<uint64_t>(e) * 0x51ED2701ULL;
    for (int32_t i = n - 1; i > 0; --i) {
      int32_t j = static_cast<int32_t>(splitmix64(rng) % (i + 1));
      int32_t t = order[i]; order[i] = order[j]; order[j] = t;
    }
    float epoch_loss = 0.0f;
    int32_t seen = 0;
    for (int32_t start = 0; start < n; start += batch) {
      int32_t bs = (start + batch <= n) ? batch : (n - start);
      std::memset(gk1.data(), 0, gk1.size() * sizeof(float));
      std::memset(gb1.data(), 0, gb1.size() * sizeof(float));
      std::memset(gk2.data(), 0, gk2.size() * sizeof(float));
      std::memset(gb2.data(), 0, gb2.size() * sizeof(float));
      std::memset(gWd.data(), 0, gWd.size() * sizeof(float));
      std::memset(gbd.data(), 0, gbd.size() * sizeof(float));
      for (int32_t bi = 0; bi < bs; ++bi) {
        const float* xi = x + static_cast<size_t>(order[start + bi]) * H * W
                          * Cin;
        int32_t yi = y[order[start + bi]];
        // ---- forward
        conv3x3_fwd(xi, k1, b1, a1.data(), s1);
        for (auto& v : a1) v = v > 0 ? v : 0;
        pool2_fwd(a1.data(), p1.data(), arg1.data(), H, W, C1);
        conv3x3_fwd(p1.data(), k2, b2, a2.data(), s2);
        for (auto& v : a2) v = v > 0 ? v : 0;
        pool2_fwd(a2.data(), p2.data(), arg2.data(), H2, W2, C2);
        float maxl = -1e30f;
        for (int32_t c = 0; c < nclass; ++c) {
          float acc = bd[c];
          for (int32_t f = 0; f < feat; ++f)
            acc += p2[f] * Wd[static_cast<size_t>(f) * nclass + c];
          logits[c] = acc;
          if (acc > maxl) maxl = acc;
        }
        float denom = 0.0f;
        for (int32_t c = 0; c < nclass; ++c) {
          probs[c] = std::exp(logits[c] - maxl);
          denom += probs[c];
        }
        for (int32_t c = 0; c < nclass; ++c) probs[c] /= denom;
        epoch_loss += -std::log(probs[yi] > 1e-12f ? probs[yi] : 1e-12f);
        ++seen;
        // ---- backward
        std::memset(gp2.data(), 0, gp2.size() * sizeof(float));
        for (int32_t c = 0; c < nclass; ++c) {
          float dl = probs[c] - (c == yi ? 1.0f : 0.0f);
          gbd[c] += dl;
          for (int32_t f = 0; f < feat; ++f) {
            gWd[static_cast<size_t>(f) * nclass + c] += p2[f] * dl;
            gp2[f] += Wd[static_cast<size_t>(f) * nclass + c] * dl;
          }
        }
        std::memset(ga2.data(), 0, ga2.size() * sizeof(float));
        for (int32_t i2 = 0; i2 < feat; ++i2) ga2[arg2[i2]] = gp2[i2];
        for (size_t i2 = 0; i2 < ga2.size(); ++i2)
          if (a2[i2] <= 0) ga2[i2] = 0;  // relu'
        conv3x3_bwd(p1.data(), k2, ga2.data(), gp1.data(), gk2.data(),
                    gb2.data(), s2);
        std::memset(ga1.data(), 0, ga1.size() * sizeof(float));
        for (int32_t i1 = 0; i1 < H2 * W2 * C1; ++i1)
          ga1[arg1[i1]] = gp1[i1];
        for (size_t i1 = 0; i1 < ga1.size(); ++i1)
          if (a1[i1] <= 0) ga1[i1] = 0;
        conv3x3_bwd(xi, k1, ga1.data(), nullptr, gk1.data(), gb1.data(), s1);
      }
      const float scale = lr / static_cast<float>(bs);
      for (size_t i2 = 0; i2 < gk1.size(); ++i2) k1[i2] -= scale * gk1[i2];
      for (int32_t c = 0; c < C1; ++c) b1[c] -= scale * gb1[c];
      for (size_t i2 = 0; i2 < gk2.size(); ++i2) k2[i2] -= scale * gk2[i2];
      for (int32_t c = 0; c < C2; ++c) b2[c] -= scale * gb2[c];
      for (size_t i2 = 0; i2 < gWd.size(); ++i2) Wd[i2] -= scale * gWd[i2];
      for (int32_t c = 0; c < nclass; ++c) bd[c] -= scale * gbd[c];
    }
    last_epoch_loss = seen ? epoch_loss / seen : 0.0f;
  }
  return last_epoch_loss;
}

// Forward-only accuracy for the DeviceCNN.
float eval_cnn(const float* k1, const float* b1, const float* k2,
               const float* b2, const float* Wd, const float* bd,
               const float* x, const int32_t* y, int32_t n, int32_t H,
               int32_t W, int32_t Cin, int32_t C1, int32_t C2,
               int32_t nclass) {
  if (n <= 0) return 0.0f;
  const int32_t H2 = H / 2, W2 = W / 2, H4 = H2 / 2, W4 = W2 / 2;
  const int32_t feat = H4 * W4 * C2;
  ConvShape s1{H, W, Cin, C1}, s2{H2, W2, C1, C2};
  std::vector<float> a1(H * W * C1), p1(H2 * W2 * C1), a2(H2 * W2 * C2),
      p2(feat);
  std::vector<int32_t> arg1(H2 * W2 * C1), arg2(feat);
  int32_t correct = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float* xi = x + static_cast<size_t>(i) * H * W * Cin;
    conv3x3_fwd(xi, k1, b1, a1.data(), s1);
    for (auto& v : a1) v = v > 0 ? v : 0;
    pool2_fwd(a1.data(), p1.data(), arg1.data(), H, W, C1);
    conv3x3_fwd(p1.data(), k2, b2, a2.data(), s2);
    for (auto& v : a2) v = v > 0 ? v : 0;
    pool2_fwd(a2.data(), p2.data(), arg2.data(), H2, W2, C2);
    int32_t best = 0;
    float bestv = -1e30f;
    for (int32_t c = 0; c < nclass; ++c) {
      float acc = bd[c];
      for (int32_t f = 0; f < feat; ++f)
        acc += p2[f] * Wd[static_cast<size_t>(f) * nclass + c];
      if (acc > bestv) { bestv = acc; best = c; }
    }
    if (best == y[i]) ++correct;
  }
  return static_cast<float>(correct) / static_cast<float>(n);
}

// ================= LightSecAgg Lagrange mask encoding =======================
//
// Native counterpart of core/mpc/lightsecagg.py mask_encoding (reference
// MobileNN/src/security/LightSecAgg.cpp): identical evaluation points and
// field math, so natively-encoded sub-masks decode with the Python
// decode_aggregate_mask. The privacy padding rows come from the device's own
// splitmix64 stream (padding values are arbitrary randomness; only the
// coding must match).

namespace {

inline uint64_t gf_mul(uint64_t a, uint64_t b) { return (a * b) % kPrime; }

uint64_t gf_pow(uint64_t base, uint64_t exp) {
  uint64_t r = 1;
  base %= kPrime;
  while (exp) {
    if (exp & 1) r = gf_mul(r, base);
    base = gf_mul(base, base);
    exp >>= 1;
  }
  return r;
}

inline uint64_t gf_inv(uint64_t a) { return gf_pow(a, kPrime - 2); }

// Lagrange basis coefficients l_k(xq) on source points src[0..m)
void lagrange_at(const uint64_t* src, int32_t m, uint64_t xq, uint64_t* out) {
  for (int32_t k = 0; k < m; ++k) {
    uint64_t num = 1, den = 1;
    for (int32_t j = 0; j < m; ++j) {
      if (j == k) continue;
      num = gf_mul(num, (xq + kPrime - src[j]) % kPrime);
      den = gf_mul(den, (src[k] + kPrime - src[j]) % kPrime);
    }
    out[k] = gf_mul(num, gf_inv(den));
  }
}

}  // namespace

// z: [d] field elements (uint32 < p), d % split_t == 0.
// out: [n_clients, d / split_t]. Returns 0 on success.
int32_t lsa_mask_encode(uint32_t* out, const uint32_t* z, int32_t d,
                        int32_t n_clients, int32_t privacy_t, int32_t split_t,
                        uint64_t seed) {
  if (d <= 0 || split_t <= 0 || d % split_t != 0) return -1;
  const int32_t l = d / split_t;
  const int32_t m = split_t + privacy_t;
  // source points: betas 1..split_t, gammas split_t+1..split_t+privacy_t
  std::vector<uint64_t> src(m);
  for (int32_t i = 0; i < m; ++i) src[i] = static_cast<uint64_t>(i + 1);
  // data rows: z split into split_t rows, then privacy_t random rows
  std::vector<uint64_t> pad(static_cast<size_t>(privacy_t) * l);
  uint64_t rng = seed;
  for (auto& v : pad) v = splitmix64(rng) % kPrime;
  std::vector<uint64_t> coeff(m);
  for (int32_t c = 0; c < n_clients; ++c) {
    uint64_t alpha = static_cast<uint64_t>(m + 1 + c);
    lagrange_at(src.data(), m, alpha, coeff.data());
    uint32_t* dst = out + static_cast<size_t>(c) * l;
    for (int32_t col = 0; col < l; ++col) {
      uint64_t acc = 0;
      for (int32_t row = 0; row < split_t; ++row)
        acc = (acc + gf_mul(coeff[row],
                            z[static_cast<size_t>(row) * l + col])) % kPrime;
      for (int32_t row = 0; row < privacy_t; ++row)
        acc = (acc + gf_mul(coeff[split_t + row],
                            pad[static_cast<size_t>(row) * l + col]))
              % kPrime;
      dst[col] = static_cast<uint32_t>(acc);
    }
  }
  return 0;
}

// ========================= native dataset reader ============================
//
// CSV reader (label in the LAST column — the reference device SDK ships
// per-engine dataset readers; this is the transport-agnostic one). Two-call
// pattern: probe for shape, then fill caller-allocated buffers.

#include <cstdio>
#include <cstdlib>

int32_t csv_probe(const char* path, int32_t* rows, int32_t* cols) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  int32_t r = 0, c = 0, cur_cols = 1;
  int ch, prev = '\n';
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == ',') ++cur_cols;
    if (ch == '\n') {
      if (prev != '\n') {  // skip blank lines
        if (c == 0) c = cur_cols;
        else if (cur_cols != c) { std::fclose(f); return -2; }
        ++r;
      }
      cur_cols = 1;
    }
    prev = ch;
  }
  if (prev != '\n' && prev != EOF) { if (c == 0) c = cur_cols; ++r; }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

// x: [rows, cols-1] features; y: [rows] labels from the last column.
int32_t csv_read(const char* path, float* x, int32_t* y, int32_t rows,
                 int32_t cols) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  for (int32_t r = 0; r < rows; ++r) {
    for (int32_t c = 0; c < cols; ++c) {
      double v;
      if (std::fscanf(f, "%lf", &v) != 1) { std::fclose(f); return -2; }
      if (c < cols - 1) x[static_cast<size_t>(r) * (cols - 1) + c] =
          static_cast<float>(v);
      else y[r] = static_cast<int32_t>(v);
      int ch = std::fgetc(f);  // consume , or newline
      (void)ch;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"

// ===================== model artifact codec (msgpack) =======================
//
// Reads/writes the framework's model artifact format natively: the
// "FMTPU1\n" magic followed by a msgpack map tree whose leaves are
// ext-42 numpy arrays (head = packed (dtype_str, shape), then raw bytes)
// — the exact bytes `serving.save_model` / `load_model` produce, so a
// device can consume the server's global model and produce an update the
// server loads with zero Python on the device (reference counterpart: the
// MNN/torch serialized-model handling in FedMLMNNTrainer.cpp /
// FedMLTorchTrainer.cpp). Subset codec: maps, strings, arrays,
// non-negative ints, ext — everything a param-tree artifact contains.

#include <map>
#include <memory>
#include <string>

namespace artifact {

constexpr char kMagic[] = "FMTPU1\n";
constexpr size_t kMagicLen = 7;
constexpr int8_t kNpExt = 42;

struct Leaf {
  std::vector<int32_t> shape;
  std::vector<float> data;
};

struct Store {
  std::map<std::string, Leaf> leaves;  // "a/b/c" slash paths, sorted
};

// ---- reader ----------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  uint8_t u8() {
    if (p >= end) { fail = true; return 0; }
    return *p++;
  }
  uint64_t be(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | u8();
    return v;
  }
  const uint8_t* raw(size_t n) {
    // compare against the remaining size, not p + n (a crafted huge n
    // would overflow the pointer arithmetic — UB — before the check)
    if (n > static_cast<size_t>(end - p)) { fail = true; return nullptr; }
    const uint8_t* r = p;
    p += n;
    return r;
  }
};

bool parse_uint(Cursor& c, uint64_t* out) {
  uint8_t t = c.u8();
  if (t <= 0x7f) { *out = t; return true; }
  if (t == 0xcc) { *out = c.be(1); return true; }
  if (t == 0xcd) { *out = c.be(2); return true; }
  if (t == 0xce) { *out = c.be(4); return true; }
  if (t == 0xcf) { *out = c.be(8); return true; }
  return false;
}

bool parse_str(Cursor& c, std::string* out) {
  uint8_t t = c.u8();
  size_t n;
  if ((t & 0xe0) == 0xa0) n = t & 0x1f;
  else if (t == 0xd9) n = c.be(1);
  else if (t == 0xda) n = c.be(2);
  else if (t == 0xdb) n = c.be(4);
  else return false;
  const uint8_t* r = c.raw(n);
  if (!r) return false;
  out->assign(reinterpret_cast<const char*>(r), n);
  return true;
}

// ext leaf -> Leaf (head tuple [dtype_str, [shape...]] + raw data).
// `len` is ATTACKER-CONTROLLED (artifacts cross trust boundaries — device
// uploads, served model pulls): it must be bounded by the remaining
// buffer before any sub-cursor is built, and allocation is deferred until
// the payload length has been checked against the declared shape.
bool parse_ext_leaf(Cursor& c, size_t len, int8_t type, Leaf* leaf) {
  if (type != kNpExt) return false;
  if (len > static_cast<size_t>(c.end - c.p)) return false;  // truncated
  Cursor h{c.p, c.p + len};
  const uint8_t* payload_end = c.p + len;
  uint8_t t = h.u8();
  size_t tuple_n;
  if ((t & 0xf0) == 0x90) tuple_n = t & 0x0f;
  else if (t == 0xdc) tuple_n = h.be(2);
  else return false;
  if (tuple_n != 2) return false;
  std::string dtype;
  if (!parse_str(h, &dtype)) return false;
  uint8_t s = h.u8();
  size_t ndim;
  if ((s & 0xf0) == 0x90) ndim = s & 0x0f;
  else if (s == 0xdc) ndim = h.be(2);
  else return false;
  size_t elems = 1;
  leaf->shape.clear();
  for (size_t i = 0; i < ndim; ++i) {
    uint64_t d;
    if (!parse_uint(h, &d)) return false;
    if (d > (1ULL << 31)) return false;  // absurd dim = crafted input
    leaf->shape.push_back(static_cast<int32_t>(d));
    if (d != 0 && elems > (1ULL << 33) / d) return false;  // overflow cap
    elems *= d;
  }
  if (h.fail) return false;
  const uint8_t* data = h.p;
  size_t nbytes = static_cast<size_t>(payload_end - data);
  // validate the declared shape against the ACTUAL payload bytes BEFORE
  // allocating — crafted dims must not drive a giant resize
  size_t unit;
  if (dtype == "<f4" || dtype == "<i4") unit = 4;
  else if (dtype == "<f8") unit = 8;
  else return false;  // artifact leaves are float tensors
  if (nbytes != elems * unit) return false;
  leaf->data.resize(elems);
  if (dtype == "<f4") {
    std::memcpy(leaf->data.data(), data, nbytes);
  } else if (dtype == "<f8") {
    // per-element memcpy: the payload sits at an arbitrary offset inside
    // the msgpack blob, and a reinterpret_cast load of a misaligned
    // double is UB (SIGBUS on strict-alignment device targets)
    for (size_t i = 0; i < elems; ++i) {
      double v;
      std::memcpy(&v, data + i * 8, 8);
      leaf->data[i] = static_cast<float>(v);
    }
  } else {  // <i4
    for (size_t i = 0; i < elems; ++i) {
      int32_t v;
      std::memcpy(&v, data + i * 4, 4);
      leaf->data[i] = static_cast<float>(v);
    }
  }
  c.p = payload_end;
  return true;
}

// Nesting bound: artifacts are attacker-controlled, and each fixmap level
// costs ~2 bytes of input, so unbounded recursion here is a crafted-blob
// stack overflow. Real parameter trees are a handful of levels deep.
constexpr int kMaxTreeDepth = 64;

bool parse_value(Cursor& c, const std::string& prefix, Store* store,
                 int depth);

bool parse_map(Cursor& c, size_t n, const std::string& prefix,
               Store* store, int depth) {
  for (size_t i = 0; i < n; ++i) {
    std::string key;
    if (!parse_str(c, &key)) return false;
    std::string path = prefix.empty() ? key : prefix + "/" + key;
    if (!parse_value(c, path, store, depth)) return false;
  }
  return true;
}

bool parse_value(Cursor& c, const std::string& prefix, Store* store,
                 int depth) {
  if (depth > kMaxTreeDepth) return false;
  if (c.p >= c.end) return false;
  uint8_t t = *c.p;
  if ((t & 0xf0) == 0x80) { c.u8(); return parse_map(c, t & 0x0f, prefix, store, depth + 1); }
  if (t == 0xde) { c.u8(); return parse_map(c, c.be(2), prefix, store, depth + 1); }
  if (t == 0xdf) { c.u8(); return parse_map(c, c.be(4), prefix, store, depth + 1); }
  size_t len;
  int8_t etype;
  if (t == 0xd4 || t == 0xd5 || t == 0xd6 || t == 0xd7 || t == 0xd8) {
    c.u8();
    len = 1u << (t - 0xd4);
    etype = static_cast<int8_t>(c.u8());
  } else if (t == 0xc7) { c.u8(); len = c.be(1); etype = static_cast<int8_t>(c.u8()); }
  else if (t == 0xc8) { c.u8(); len = c.be(2); etype = static_cast<int8_t>(c.u8()); }
  else if (t == 0xc9) { c.u8(); len = c.be(4); etype = static_cast<int8_t>(c.u8()); }
  else return false;  // artifact trees hold only maps and array leaves
  Leaf leaf;
  if (!parse_ext_leaf(c, len, etype, &leaf)) return false;
  store->leaves[prefix] = std::move(leaf);
  return true;
}

// ---- writer ----------------------------------------------------------------

void put_be(std::vector<uint8_t>* out, uint64_t v, int n) {
  for (int i = n - 1; i >= 0; --i)
    out->push_back(static_cast<uint8_t>((v >> (8 * i)) & 0xff));
}

void put_str(std::vector<uint8_t>* out, const std::string& s) {
  if (s.size() < 32) out->push_back(0xa0 | static_cast<uint8_t>(s.size()));
  else if (s.size() <= 0xff) { out->push_back(0xd9); put_be(out, s.size(), 1); }
  else if (s.size() <= 0xffff) { out->push_back(0xda); put_be(out, s.size(), 2); }
  else { out->push_back(0xdb); put_be(out, s.size(), 4); }
  out->insert(out->end(), s.begin(), s.end());
}

void put_uint(std::vector<uint8_t>* out, uint64_t v) {
  if (v <= 0x7f) out->push_back(static_cast<uint8_t>(v));
  else if (v <= 0xff) { out->push_back(0xcc); put_be(out, v, 1); }
  else if (v <= 0xffff) { out->push_back(0xcd); put_be(out, v, 2); }
  else if (v <= 0xffffffffULL) { out->push_back(0xce); put_be(out, v, 4); }
  else { out->push_back(0xcf); put_be(out, v, 8); }
}

void put_leaf(std::vector<uint8_t>* out, const Leaf& leaf) {
  std::vector<uint8_t> head;
  head.push_back(0x92);  // fixarray 2
  put_str(&head, "<f4");
  head.push_back(0x90 | static_cast<uint8_t>(leaf.shape.size()));
  size_t elems = 1;
  for (int32_t d : leaf.shape) { put_uint(&head, d); elems *= d; }
  size_t total = head.size() + elems * 4;
  out->push_back(0xc9);  // ext32 (simplest single form)
  put_be(out, total, 4);
  out->push_back(static_cast<uint8_t>(kNpExt));
  out->insert(out->end(), head.begin(), head.end());
  const uint8_t* data = reinterpret_cast<const uint8_t*>(leaf.data.data());
  out->insert(out->end(), data, data + elems * 4);
}

// nested emit: the sorted flat slash paths form a tree; emit maps
// recursively over the [begin, end) range sharing `prefix`
using LeafIter = std::map<std::string, Leaf>::const_iterator;

void put_tree(std::vector<uint8_t>* out, LeafIter begin, LeafIter end,
              size_t prefix_len) {
  // collect direct children
  std::vector<std::pair<std::string, std::pair<LeafIter, LeafIter>>> kids;
  for (LeafIter it = begin; it != end;) {
    const std::string& path = it->first;
    size_t slash = path.find('/', prefix_len);
    std::string child = (slash == std::string::npos)
                            ? path.substr(prefix_len)
                            : path.substr(prefix_len, slash - prefix_len);
    LeafIter run = it;
    while (run != end && run->first.compare(prefix_len, child.size(),
                                            child) == 0 &&
           (run->first.size() == prefix_len + child.size() ||
            run->first[prefix_len + child.size()] == '/'))
      ++run;
    kids.emplace_back(child, std::make_pair(it, run));
    it = run;
  }
  if (kids.size() < 16) out->push_back(0x80 | static_cast<uint8_t>(kids.size()));
  else if (kids.size() <= 0xffff) { out->push_back(0xde); put_be(out, kids.size(), 2); }
  else { out->push_back(0xdf); put_be(out, kids.size(), 4); }
  for (auto& k : kids) {
    put_str(out, k.first);
    LeafIter b = k.second.first, e = k.second.second;
    bool is_leaf = (std::next(b) == e &&
                    b->first.size() == prefix_len + k.first.size());
    if (is_leaf) put_leaf(out, b->second);
    else put_tree(out, b, e, prefix_len + k.first.size() + 1);
  }
}

}  // namespace artifact

extern "C" {

// Opens a model artifact; returns an opaque handle or NULL on parse
// failure. Pair with artifact_close.
void* artifact_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < static_cast<long>(artifact::kMagicLen)) { std::fclose(f); return nullptr; }
  std::vector<uint8_t> blob(static_cast<size_t>(size));
  if (std::fread(blob.data(), 1, blob.size(), f) != blob.size()) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  if (std::memcmp(blob.data(), artifact::kMagic, artifact::kMagicLen) != 0)
    return nullptr;
  auto store = std::make_unique<artifact::Store>();
  artifact::Cursor c{blob.data() + artifact::kMagicLen,
                     blob.data() + blob.size()};
  if (!artifact::parse_value(c, "", store.get(), 0) || c.fail) return nullptr;
  return store.release();
}

int32_t artifact_count(void* h) {
  return static_cast<int32_t>(
      static_cast<artifact::Store*>(h)->leaves.size());
}

// i-th (sorted) slash path; returns its length or -1.
int32_t artifact_key(void* h, int32_t i, char* out, int32_t cap) {
  auto& leaves = static_cast<artifact::Store*>(h)->leaves;
  if (i < 0 || i >= static_cast<int32_t>(leaves.size())) return -1;
  auto it = leaves.begin();
  std::advance(it, i);
  int32_t n = static_cast<int32_t>(it->first.size());
  if (cap > 0) {
    int32_t c = n < cap - 1 ? n : cap - 1;
    std::memcpy(out, it->first.data(), c);
    out[c] = 0;
  }
  return n;
}

int64_t artifact_elems(void* h, const char* key) {
  auto& leaves = static_cast<artifact::Store*>(h)->leaves;
  auto it = leaves.find(key);
  if (it == leaves.end()) return -1;
  return static_cast<int64_t>(it->second.data.size());
}

int32_t artifact_shape(void* h, const char* key, int32_t* dims,
                       int32_t cap) {
  auto& leaves = static_cast<artifact::Store*>(h)->leaves;
  auto it = leaves.find(key);
  if (it == leaves.end()) return -1;
  int32_t n = static_cast<int32_t>(it->second.shape.size());
  for (int32_t i = 0; i < n && i < cap; ++i) dims[i] = it->second.shape[i];
  return n;
}

int64_t artifact_read_f32(void* h, const char* key, float* out,
                          int64_t cap) {
  auto& leaves = static_cast<artifact::Store*>(h)->leaves;
  auto it = leaves.find(key);
  if (it == leaves.end()) return -1;
  int64_t n = static_cast<int64_t>(it->second.data.size());
  if (n > cap) return -2;
  std::memcpy(out, it->second.data.data(), static_cast<size_t>(n) * 4);
  return n;
}

void artifact_close(void* h) { delete static_cast<artifact::Store*>(h); }

// Save leaves as a NESTED artifact (slash paths -> map tree), bytes
// compatible with Python `serving.load_model`. shapes is the
// concatenation of each leaf's dims (ndims[i] entries each).
int32_t artifact_save(const char* path, const char** keys,
                      const float** data, const int32_t* ndims,
                      const int32_t* shapes, int32_t n_leaves) {
  artifact::Store store;
  const int32_t* sp = shapes;
  for (int32_t i = 0; i < n_leaves; ++i) {
    artifact::Leaf leaf;
    size_t elems = 1;
    for (int32_t d = 0; d < ndims[i]; ++d) {
      leaf.shape.push_back(*sp);
      elems *= static_cast<size_t>(*sp);
      ++sp;
    }
    leaf.data.assign(data[i], data[i] + elems);
    store.leaves[keys[i]] = std::move(leaf);
  }
  std::vector<uint8_t> out;
  out.insert(out.end(), artifact::kMagic,
             artifact::kMagic + artifact::kMagicLen);
  artifact::put_tree(&out, store.leaves.begin(), store.leaves.end(), 0);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  bool ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
  std::fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"

// ===================== device client manager ================================
//
// The FedMLClientManager analogue (reference
// MobileNN/includes/FedMLClientManager.h + JniFedMLClientManager.cpp:
// create/init/train/getEpochAndLoss/stopTraining/release): one opaque
// session object a host app drives through the C ABI in
// include/fedml_client.h. init() loads the global model ARTIFACT and the
// device's CSV shard; train() runs the local epochs (linear or CNN per
// the artifact's keys) with progress/loss callbacks; the trained params
// save back as an artifact the server loads directly.

extern "C" {

typedef void (*fedml_progress_cb)(float pct);
typedef void (*fedml_loss_cb)(int32_t epoch, float loss);

struct FedMLClient {
  artifact::Store params;
  std::vector<float> x;
  std::vector<int32_t> y;
  int32_t n = 0, d = 0;
  int32_t batch = 32, epochs = 1;
  float lr = 0.1f;
  uint64_t seed = 0;
  volatile int32_t stop_flag = 0;
  int32_t last_epoch = -1;
  float last_loss = 0.0f;
  fedml_progress_cb on_progress = nullptr;
  fedml_loss_cb on_loss = nullptr;
};

void* fedml_client_create() { return new FedMLClient(); }

void fedml_client_release(void* h) {
  delete static_cast<FedMLClient*>(h);
}

// Load the global model artifact + the device's CSV data shard.
// Returns 0 on success.
int32_t fedml_client_init(void* h, const char* model_path,
                          const char* data_path, int32_t batch_size,
                          float learning_rate, int32_t epoch_num,
                          uint64_t seed) {
  auto* c = static_cast<FedMLClient*>(h);
  void* art = artifact_open(model_path);
  if (!art) return -1;
  c->params = *static_cast<artifact::Store*>(art);
  artifact_close(art);
  int32_t rows = 0, cols = 0;
  if (csv_probe(data_path, &rows, &cols) != 0 || cols < 2) return -2;
  c->x.resize(static_cast<size_t>(rows) * (cols - 1));
  c->y.resize(rows);
  if (csv_read(data_path, c->x.data(), c->y.data(), rows, cols) != 0)
    return -3;
  c->n = rows;
  c->d = cols - 1;
  c->batch = batch_size;
  c->lr = learning_rate;
  c->epochs = epoch_num;
  c->seed = seed;
  c->stop_flag = 0;
  return 0;
}

void fedml_client_set_callbacks(void* h, fedml_progress_cb progress,
                                fedml_loss_cb loss) {
  auto* c = static_cast<FedMLClient*>(h);
  c->on_progress = progress;
  c->on_loss = loss;
}

// Local training over the loaded shard; epoch-at-a-time so stopTraining
// and the progress callback have real granularity. Returns final-epoch
// mean loss (NaN on error).
// Shared precondition of train/evaluate: the artifact's linear head must
// exist, be 2-D, and match the loaded shard's feature width — a 64-wide
// kernel against an 80-column CSV would index past the weight buffer.
// Returns the class count k, or -1 when the params are unusable.
static int32_t client_linear_classes(FedMLClient* c,
                                     artifact::Leaf** W,
                                     artifact::Leaf** B) {
  auto wi = c->params.leaves.find("Dense_0/kernel");
  auto bi = c->params.leaves.find("Dense_0/bias");
  if (wi == c->params.leaves.end() || bi == c->params.leaves.end())
    return -1;  // only the linear family is artifact-driven for now
  if (wi->second.shape.size() != 2 || wi->second.shape[0] != c->d)
    return -1;
  int32_t k = wi->second.shape[1];
  if (bi->second.shape.size() != 1 || bi->second.shape[0] != k) return -1;
  *W = &wi->second;
  *B = &bi->second;
  return k;
}

float fedml_client_train(void* h) {
  auto* c = static_cast<FedMLClient*>(h);
  artifact::Leaf *W, *B;
  int32_t k = client_linear_classes(c, &W, &B);
  if (k < 0) return NAN;
  float loss = NAN;
  for (int32_t e = 0; e < c->epochs && !c->stop_flag; ++e) {
    loss = train_linear_sgd(W->data.data(), B->data.data(),
                            c->x.data(), c->y.data(), c->n, c->d, k, 1,
                            c->batch, c->lr, c->seed + e);
    c->last_epoch = e;
    c->last_loss = loss;
    if (c->on_loss) c->on_loss(e, loss);
    if (c->on_progress)
      c->on_progress(100.0f * (e + 1) / c->epochs);
  }
  return loss;
}

// "epoch,loss" of the most recent local epoch (reference getEpochAndLoss
// returns the same pair as a string; a C ABI hands back the parts).
int32_t fedml_client_get_epoch_and_loss(void* h, int32_t* epoch,
                                        float* loss) {
  auto* c = static_cast<FedMLClient*>(h);
  *epoch = c->last_epoch;
  *loss = c->last_loss;
  return c->last_epoch >= 0 ? 0 : -1;
}

int32_t fedml_client_stop_training(void* h) {
  static_cast<FedMLClient*>(h)->stop_flag = 1;
  return 0;
}

// On-device evaluation of the CURRENT params on the loaded shard.
float fedml_client_evaluate(void* h) {
  auto* c = static_cast<FedMLClient*>(h);
  artifact::Leaf *W, *B;
  int32_t k = client_linear_classes(c, &W, &B);
  if (k < 0) return -1.0f;
  return eval_linear(W->data.data(), B->data.data(),
                     c->x.data(), c->y.data(), c->n, c->d, k);
}

// Persist the trained params as an artifact the server loads directly.
int32_t fedml_client_save_model(void* h, const char* path) {
  auto* c = static_cast<FedMLClient*>(h);
  std::vector<const char*> keys;
  std::vector<const float*> data;
  std::vector<int32_t> ndims, shapes;
  for (auto& kv : c->params.leaves) {
    keys.push_back(kv.first.c_str());
    data.push_back(kv.second.data.data());
    ndims.push_back(static_cast<int32_t>(kv.second.shape.size()));
    for (int32_t dshape : kv.second.shape) shapes.push_back(dshape);
  }
  return artifact_save(path, keys.data(), data.data(), ndims.data(),
                       shapes.data(), static_cast<int32_t>(keys.size()));
}

}  // extern "C"
