// Vectorized host optimizers for offloaded optimizer states (ZeRO-Offload):
// the port's copy of deepspeed_tpu/csrc/cpu_adam.cpp, the same entries and
// the same arithmetic, so both packages' host steps give the same bits
// (reference csrc/adam/cpu_adam_impl.cpp Step_1/4/8, csrc/adagrad/,
// csrc/lion/).
//
// The inner loops are written to auto-vectorize (-O3 -march=native
// -fopenmp), and OpenMP threads split the flat shard. The loader
// (deepspeed_tpu_torch/ops/native.py) links the OpenMP runtime torch has
// loaded and sets the team size explicitly (dstpu_set_num_threads).

#include <cmath>
#include <cstdint>
#include <cstring>

// the OpenMP runtime's, declared here: a compiler installed without
// libgomp has no omp.h, and the loader links the runtime torch loaded
extern "C" int omp_get_max_threads(void);

namespace {

inline float bf16_to_f32(uint16_t v) {
  uint32_t u = static_cast<uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  // round-to-nearest-even
  uint32_t rounding = 0x7fff + ((u >> 16) & 1);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

// the team size of every loop below: set by dstpu_set_num_threads, else
// the OpenMP default. A num_threads clause, not omp_set_num_threads, so
// the setting holds on every calling thread and leaves the team size of
// an OpenMP runtime shared with torch's intra-op pool untouched
int g_threads = 0;

inline int team() {
  return g_threads > 0 ? g_threads : omp_get_max_threads();
}

}  // namespace

extern "C" {

// Fused Adam/AdamW over a flat fp32 shard (grad fp32). adamw: decoupled
// weight decay; bias_correction as in torch.optim.Adam.
void dstpu_adam_step(float* p, float* m, float* v, const float* g, int64_t n,
                     float lr, float beta1, float beta2, float eps,
                     float weight_decay, int64_t step, int adamw,
                     int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
    bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  }
  const float step_size = lr / bc1;
  const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);
  const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;

#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
    float mi = beta1 * m[i] + omb1 * grad;
    float vi = beta2 * v[i] + omb2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float denom = std::sqrt(vi) * inv_sqrt_bc2 + eps;
    // decoupled decay is NOT bias-corrected: p -= lr*wd*p + (lr/bc1)*m/denom
    float pi = p[i];
    if (adamw && weight_decay != 0.0f) pi -= lr * weight_decay * p[i];
    p[i] = pi - step_size * (mi / denom);
  }
}

// Same update with bf16 grads (device dtype) and optional bf16 param
// mirror written for the device upload (p16 may be null).
void dstpu_adam_step_bf16g(float* p, float* m, float* v, const uint16_t* g,
                           uint16_t* p16, int64_t n, float lr, float beta1,
                           float beta2, float eps, float weight_decay,
                           int64_t step, int adamw, int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
    bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  }
  const float step_size = lr / bc1;
  const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);
  const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;

#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) {
    float grad = bf16_to_f32(g[i]);
    if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
    float mi = beta1 * m[i] + omb1 * grad;
    float vi = beta2 * v[i] + omb2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float denom = std::sqrt(vi) * inv_sqrt_bc2 + eps;
    float pi = p[i];
    if (adamw && weight_decay != 0.0f) pi -= lr * weight_decay * p[i];
    pi -= step_size * (mi / denom);
    p[i] = pi;
    if (p16) p16[i] = f32_to_bf16(pi);
  }
}

// Adagrad (csrc/adagrad/cpu_adagrad.cpp role)
void dstpu_adagrad_step(float* p, float* h, const float* g, int64_t n,
                        float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (weight_decay != 0.0f) grad += weight_decay * p[i];
    float hi = h[i] + grad * grad;
    h[i] = hi;
    p[i] -= lr * grad / (std::sqrt(hi) + eps);
  }
}

// Lion (csrc/lion/ role): sign-of-interpolation update, decoupled decay
void dstpu_lion_step(float* p, float* m, const float* g, int64_t n, float lr,
                     float beta1, float beta2, float weight_decay) {
  const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;
#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    float c = beta1 * m[i] + omb1 * grad;
    float update = (c > 0.0f) - (c < 0.0f);  // sign(c)
    if (weight_decay != 0.0f) update += weight_decay * p[i];
    p[i] -= lr * update;
    m[i] = beta2 * m[i] + omb2 * grad;
  }
}

// bulk dtype conversions for the offload staging path
void dstpu_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) dst[i] = f32_to_bf16(src[i]);
}

void dstpu_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
#pragma omp parallel for simd schedule(static) num_threads(team())
  for (int64_t i = 0; i < n; ++i) dst[i] = bf16_to_f32(src[i]);
}

int dstpu_num_threads() { return team(); }

void dstpu_set_num_threads(int n) { g_threads = n > 0 ? n : 1; }

}  // extern "C"
