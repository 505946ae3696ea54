// Paged GQA attention over the KV block arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel`, launched by
// `_paged_attention_pallas` in src/repro/kernels/paged_attention.py (public
// entry `paged_attention_decode`). Same function: for slot b and kv-head h, the
// Sq*G query rows (folded Sq-major: row i*G + g' is query i of head g') attend
// over the physical blocks that block_tables[b, :] names, read in place; the
// gathered K/V is never built. Softmax runs online across logical blocks with
// fp32 running max, denominator and accumulator, exactly as the TPU kernel's
// recurrence: masked scores take the float32 mask fill `neg`, the same value the
// running max starts from, and the output is acc / max(l, 1e-30).
//
// Mask rules (a score is kept only if all hold): pos >= 0; the block is not the
// trash block 0; the query index i < q_lens[b]; causal: pos <= q_pos[b] + i;
// window: pos > q_pos[b] + i - window.
//
// Layouts: q4 (B, Hkv, SG, Dh) fp32; k/v arena (n_blocks, bs, Hkv, Dh) in fp32,
// bf16 or fp16; pos (n_blocks, bs) int32; tables (B, nb) int32; q_pos, q_lens
// (B,) int32; out (B, Hkv, SG, Dh) fp32.
//
// What bounds it on an H100: the least time is the bytes of the K/V blocks the
// tables reference, over the memory rate; at decode there are a few FLOPs per
// byte. The TPU walked the logical blocks as a sequential grid axis carrying m,
// l and acc in scratch; here one thread block per (b, h) walks them in a loop
// and keeps m, l and acc in shared memory, so nothing carries between blocks.
// Each iteration reads its own table entry (the TPU's scalar prefetch), stages
// that block's K, V (converted to fp32) and pos in shared memory, scores every
// query row against it, then updates m, l and acc. This first version is bound
// by latency: B*Hkv blocks only, and each logical block costs a dependent global
// load and four barriers. It calls neither a library attention nor cuDNN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q4, const T* __restrict__ k_arena,
                       const T* __restrict__ v_arena, const int* __restrict__ pos_arena,
                       const int* __restrict__ tables, const int* __restrict__ q_pos,
                       const int* __restrict__ q_lens, float* __restrict__ out, int hkv, int sg,
                       int g, int dh, int nb, int bs, int causal, int has_window, int window,
                       float q_scale, float neg) {
  extern __shared__ float smem[];
  float* qs = smem;             // (sg, dh) scaled queries
  float* acc = qs + sg * dh;    // (sg, dh) running weighted V
  float* ks = acc + sg * dh;    // (bs, dh) this block's K
  float* vs = ks + bs * dh;     // (bs, dh) this block's V
  float* sc = vs + bs * dh;     // (sg, bs) scores, then probabilities
  float* m = sc + sg * bs;      // (sg,) running max
  float* l = m + sg;            // (sg,) running denominator
  float* alpha = l + sg;        // (sg,) this step's rescale
  int* ps = (int*)(alpha + sg);  // (bs,) this block's positions

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int qp = q_pos[b];
  const int ql = q_lens[b];
  const size_t qoff = ((size_t)b * hkv + h) * sg * dh;

  for (int i = tid; i < sg * dh; i += THREADS) {
    qs[i] = q4[qoff + i] * q_scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < sg; r += THREADS) {
    m[r] = neg;
    l[r] = 0.f;
  }

  for (int j = 0; j < nb; ++j) {
    const int phys = tables[(size_t)b * nb + j];
    __syncthreads();  // the previous step is done with ks, vs, sc
    for (int i = tid; i < bs * dh; i += THREADS) {
      const int t = i / dh;
      const int d = i - t * dh;
      const size_t off = (((size_t)phys * bs + t) * hkv + h) * dh + d;
      ks[i] = to_f32(k_arena[off]);
      vs[i] = to_f32(v_arena[off]);
    }
    for (int t = tid; t < bs; t += THREADS) ps[t] = pos_arena[(size_t)phys * bs + t];
    __syncthreads();

    for (int i = tid; i < sg * bs; i += THREADS) {
      const int r = i / bs;
      const int t = i - r * bs;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[r * dh + d], ks[t * dh + d], s);
      const int qi = r / g;
      const int p = ps[t];
      bool valid = p >= 0 && phys != 0 && qi < ql;
      if (causal) valid = valid && p <= qp + qi;
      if (has_window) valid = valid && p > qp + qi - window;
      sc[i] = valid ? s : neg;
    }
    __syncthreads();

    for (int r = tid; r < sg; r += THREADS) {
      float mx = sc[r * bs];
      for (int t = 1; t < bs; ++t) mx = fmaxf(mx, sc[r * bs + t]);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float a = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(sc[r * bs + t] - m_new);
        sc[r * bs + t] = p;
        sum += p;
      }
      m[r] = m_new;
      l[r] = l[r] * a + sum;
      alpha[r] = a;
    }
    __syncthreads();

    for (int i = tid; i < sg * dh; i += THREADS) {
      const int r = i / dh;
      const int d = i - r * dh;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv = fmaf(sc[r * bs + t], vs[t * dh + d], pv);
      acc[i] = acc[i] * alpha[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < sg * dh; i += THREADS)
    out[qoff + i] = acc[i] / fmaxf(l[i / dh], 1e-30f);
}

template <typename T>
int launch(const void* q4, const void* k, const void* v, const void* pos, const void* tables,
           const void* q_pos, const void* q_lens, void* out, int B, int hkv, int sg, int g,
           int dh, int nb, int bs, int causal, int has_window, int window, float q_scale,
           float neg, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<T><<<dim3(B, hkv), THREADS, smem, st>>>(
      (const float*)q4, (const T*)k, (const T*)v, (const int*)pos, (const int*)tables,
      (const int*)q_pos, (const int*)q_lens, (float*)out, hkv, sg, g, dh, nb, bs, causal,
      has_window, window, q_scale, neg);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" int paged_attention_smem_bytes(int sg, int dh, int bs) {
  return (int)(sizeof(float) * (2 * sg * dh + 2 * bs * dh + sg * bs + 3 * sg) +
               sizeof(int) * bs);
}

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp16. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int paged_attention_launch(int kv_dtype, const void* q4, const void* k, const void* v,
                                      const void* pos, const void* tables, const void* q_pos,
                                      const void* q_lens, void* out, int B, int hkv, int sg,
                                      int g, int dh, int nb, int bs, int causal, int has_window,
                                      int window, float q_scale, float neg, void* stream) {
  if (B < 1 || hkv < 1 || sg < 1 || g < 1 || sg % g != 0 || dh < 1 || dh > 256 || nb < 1 ||
      bs < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)paged_attention_smem_bytes(sg, dh, bs);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_dtype) {
    case 0:
      return launch<float>(q4, k, v, pos, tables, q_pos, q_lens, out, B, hkv, sg, g, dh, nb, bs,
                           causal, has_window, window, q_scale, neg, smem, st);
    case 1:
      return launch<__nv_bfloat16>(q4, k, v, pos, tables, q_pos, q_lens, out, B, hkv, sg, g, dh,
                                   nb, bs, causal, has_window, window, q_scale, neg, smem, st);
    case 2:
      return launch<__half>(q4, k, v, pos, tables, q_pos, q_lens, out, B, hkv, sg, g, dh, nb,
                            bs, causal, has_window, window, q_scale, neg, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
