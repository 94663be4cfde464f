// SIMD CPU optimizers for host-offloaded ZeRO: the port's own copy of
// csrc/cpu_adam.cpp, with the same arithmetic and the same C ABI.
//
// Reference analogue: csrc/adam/cpu_adam.cpp (AVX256/AVX512 tiled Adam over
// host-pinned fp32 master params, csrc/includes/cpu_adam.h TILE loop) and
// csrc/adagrad/cpu_adagrad.cpp. Vectorization is OpenMP-parallel loops with
// compiler-vectorized (AVX2 via -march) inner bodies plus an explicit AVX2
// path for the hot fused Adam update. The library links the OpenMP runtime
// the process's torch already loaded (ops/cpu/_build.py), so both share one
// thread pool.
//
// C ABI (loaded via ctypes, see deepspeed_tpu_torch/ops/cpu/_build.py):
//   ds_adam_step      — fused Adam/AdamW over flat fp32 arrays
//   ds_adagrad_step   — fused Adagrad
//   ds_adam_step_bf16 — Adam on fp32 master with extra bf16 param mirror
//                       (the 16-bit copy the card reads back)
//   ds_f32_to_bf16    — that mirror's conversion alone
//   ds_omp_max_threads — the OpenMP runtime's thread count

#include <cmath>
#include <cstdint>
#include <cstring>

#include <omp.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// Fused Adam/AdamW step on flat fp32 buffers.
//   adamw != 0 -> decoupled weight decay (AdamW); else L2-into-grad Adam.
//   step is the 1-based optimizer step for bias correction.
void ds_adam_step(float* params, const float* grads, float* exp_avg,
                  float* exp_avg_sq, int64_t n, float lr, float beta1,
                  float beta2, float eps, float weight_decay, int adamw,
                  int64_t step) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);

#pragma omp parallel
    {
#if defined(__AVX2__) && defined(__FMA__)
        const __m256 vb1 = _mm256_set1_ps(beta1);
        const __m256 vb2 = _mm256_set1_ps(beta2);
        const __m256 v1mb1 = _mm256_set1_ps(1.0f - beta1);
        const __m256 v1mb2 = _mm256_set1_ps(1.0f - beta2);
        const __m256 veps = _mm256_set1_ps(eps);
        const __m256 vstep = _mm256_set1_ps(step_size);
        const __m256 vbc2s = _mm256_set1_ps(bc2_sqrt);
        const __m256 vwd = _mm256_set1_ps(weight_decay);
        const __m256 vlwd = _mm256_set1_ps(1.0f - lr * weight_decay);
#pragma omp for
        for (int64_t i = 0; i <= n - 8; i += 8) {
            __m256 g = _mm256_loadu_ps(grads + i);
            __m256 p = _mm256_loadu_ps(params + i);
            if (weight_decay != 0.0f) {
                if (adamw) {
                    p = _mm256_mul_ps(p, vlwd);
                } else {
                    g = _mm256_fmadd_ps(vwd, p, g);
                }
            }
            __m256 m = _mm256_loadu_ps(exp_avg + i);
            __m256 v = _mm256_loadu_ps(exp_avg_sq + i);
            m = _mm256_fmadd_ps(vb1, m, _mm256_mul_ps(v1mb1, g));
            v = _mm256_fmadd_ps(vb2, v,
                                _mm256_mul_ps(v1mb2, _mm256_mul_ps(g, g)));
            __m256 denom = _mm256_fmadd_ps(_mm256_sqrt_ps(v),
                                           _mm256_set1_ps(1.0f / bc2_sqrt),
                                           veps);
            (void)vbc2s;
            p = _mm256_sub_ps(p, _mm256_div_ps(_mm256_mul_ps(vstep, m),
                                               denom));
            _mm256_storeu_ps(params + i, p);
            _mm256_storeu_ps(exp_avg + i, m);
            _mm256_storeu_ps(exp_avg_sq + i, v);
        }
        // scalar tail (single thread is fine: < 8 elements)
#pragma omp single
        for (int64_t i = n - (n % 8); i < n; ++i) {
            float g = grads[i];
            float p = params[i];
            if (weight_decay != 0.0f) {
                if (adamw) p *= 1.0f - lr * weight_decay;
                else g += weight_decay * p;
            }
            float m = exp_avg[i] = beta1 * exp_avg[i] + (1.0f - beta1) * g;
            float v = exp_avg_sq[i] =
                beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
            params[i] = p - step_size * m / (std::sqrt(v) / bc2_sqrt + eps);
        }
#else
#pragma omp for simd
        for (int64_t i = 0; i < n; ++i) {
            float g = grads[i];
            float p = params[i];
            if (weight_decay != 0.0f) {
                if (adamw) p *= 1.0f - lr * weight_decay;
                else g += weight_decay * p;
            }
            float m = exp_avg[i] = beta1 * exp_avg[i] + (1.0f - beta1) * g;
            float v = exp_avg_sq[i] =
                beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
            params[i] = p - step_size * m / (std::sqrt(v) / bc2_sqrt + eps);
        }
#endif
    }
}

// Adam step that also maintains a bf16 mirror of the params — the analogue
// of the reference's fp16 copy-back (cpu_adam.h dual-stream param copy):
// the bf16 buffer is what gets shipped to the TPU.
void ds_adam_step_bf16(float* params, uint16_t* params_bf16,
                       const float* grads, float* exp_avg, float* exp_avg_sq,
                       int64_t n, float lr, float beta1, float beta2,
                       float eps, float weight_decay, int adamw,
                       int64_t step) {
    ds_adam_step(params, grads, exp_avg, exp_avg_sq, n, lr, beta1, beta2,
                 eps, weight_decay, adamw, step);
#pragma omp parallel for
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, params + i, 4);
        // round-to-nearest-even bf16 truncation
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        params_bf16[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

void ds_adagrad_step(float* params, const float* grads, float* exp_avg_sq,
                     int64_t n, float lr, float eps, float weight_decay) {
#pragma omp parallel for simd
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        if (weight_decay != 0.0f) g += weight_decay * params[i];
        float v = exp_avg_sq[i] = exp_avg_sq[i] + g * g;
        params[i] -= lr * g / (std::sqrt(v) + eps);
    }
}

// The same round-to-nearest-even conversion alone: the mirror of a master
// the step did not write (initial fills, loads).
void ds_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
#pragma omp parallel for
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, src + i, 4);
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

int ds_omp_max_threads() { return omp_get_max_threads(); }

}  // extern "C"
