// SWIS bit-plane matmul for Hopper (sm_90a): out (M, N) fp32 = x (M, K) @ dequant(planes).
//
// Replaces the TPU kernel `_swis_matmul_kernel`, launched by
// `swis_matmul_packed` in src/repro/kernels/swis_matmul.py. Same function:
// the integer weight  w[k, n] = sign[k, n] * sum_j mask_j[k, n] << shift_j[k / group, n]
// is rebuilt on chip from the packed planes, multiplied against x in fp32, and
// the per-column scale is applied once, after the last K step. `first` drops the
// low bit-planes (keep_slices = n_shifts - first); `consecutive` is SWIS-C, where
// the group stores one offset byte and shift_j = offset + j.
//
// Layout (all row-major, as the port stores them):
//   x       (M, K)           fp32 or bf16 (converted to fp32 when staged)
//   sign    (K/32, N)        uint32, bit b of word w = weight 32*w + b, 1 = negative
//   masks   (n_shifts, K/32, N) uint32, same bit order
//   shifts  (K/group, N, shift_bytes) uint8, nibble-packed (low nibble = even j),
//           or one offset byte per group for SWIS-C
//   scale   (N,) fp32
//
// What bounds it on an H100: at decode (M <= 8) the least time is the packed
// weight bytes over the memory rate (about 1.1 bytes per weight at 4 planes,
// group 4). This first version is instead bound by the integer instructions
// each thread issues to rebuild its weights (a shift, a mask and an add per
// plane per weight), and by the few thread blocks a layer of N <= 1536 columns
// yields. The design keeps those costs down as simply as it can:
//   * one thread per output column: neighbouring threads read neighbouring
//     words of every plane, so each plane load is one coalesced transaction;
//   * sixteen K slices per block (one warp each, 512 threads) split every
//     column's K loop sixteen ways, so each thread rebuilds few weights and
//     the SM has warps to hide latency with; the slices' partial sums are
//     added in a fixed order, so the result does not depend on scheduling;
//   * x is staged once per block in shared memory as fp32, and every read of
//     it is a broadcast (all threads of a warp read the same address);
//   * each rebuilt weight is an exact integer (|w| <= 255), used for all BM
//     rows of the tile; ragged M and N are masked, so no shape is refused.
// It calls no library GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;        // output columns per block: one warp per K slice
constexpr int KSPLIT = 16;    // K slices (warps) per block
constexpr int BM = 8;         // rows of x per block
constexpr int KC_WORDS = 16;  // 32-weight words of x staged per round (512 k)
constexpr int MAX_SHIFTS = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void __launch_bounds__(BN * KSPLIT)
swis_matmul_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ sign,
                   const uint32_t* __restrict__ masks, const uint8_t* __restrict__ shifts,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int N, int group, int n_shifts, int first,
                   int consecutive, int shift_bytes) {
  __shared__ float xs[BM][KC_WORDS * 32];
  __shared__ float part[KSPLIT][BM][BN];

  const int col = threadIdx.x % BN;
  const int slice = threadIdx.x / BN;
  const int n = blockIdx.x * BN + col;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = n < N;
  const int KW = K / 32;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int kw0 = 0; kw0 < KW; kw0 += KC_WORDS) {
    const int nw = min(KC_WORDS, KW - kw0);
    const int kc = nw * 32;
    __syncthreads();  // the previous round is done with xs
    for (int i = threadIdx.x; i < BM * kc; i += blockDim.x) {
      const int r = i / kc;
      const int c = i - r * kc;
      const int m = m0 + r;
      xs[r][c] = (m < M) ? to_f32(x[(size_t)m * K + (size_t)kw0 * 32 + c]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;

    for (int w = slice; w < nw; w += KSPLIT) {
      const int kw = kw0 + w;
      const uint32_t s_word = sign[(size_t)kw * N + n];
      uint32_t mw[MAX_SHIFTS];
#pragma unroll
      for (int j = 0; j < MAX_SHIFTS; ++j)
        mw[j] = (j >= first && j < n_shifts) ? masks[((size_t)j * KW + kw) * N + n] : 0u;

      int sh[MAX_SHIFTS];
      int g_end = 0;  // first k past the group whose shifts sh holds
      for (int b = 0; b < 32; ++b) {
        const int k = kw * 32 + b;
        if (k >= g_end) {  // uniform across the warp: every thread has the same k
          const int g = k / group;
          g_end = (g + 1) * group;
          const uint8_t* sp = shifts + ((size_t)g * N + n) * shift_bytes;
          const int off = sp[0];
#pragma unroll
          for (int j = 0; j < MAX_SHIFTS; ++j) {
            if (j < n_shifts)
              sh[j] = consecutive ? off + j : (sp[j >> 1] >> ((j & 1) * 4)) & 0xF;
            else
              sh[j] = 0;
          }
        }
        int mag = 0;
#pragma unroll
        for (int j = 0; j < MAX_SHIFTS; ++j)
          mag += (int)((mw[j] >> b) & 1u) << sh[j];
        const float wv = (float)(((s_word >> b) & 1u) ? -mag : mag);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = fmaf(xs[r][w * 32 + b], wv, acc[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) part[slice][r][col] = acc[r];
  __syncthreads();
  if (slice == 0 && col_ok) {
    const float sc = scale[n];
    for (int r = 0; r < BM; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      float v = part[0][r][col];
#pragma unroll
      for (int s = 1; s < KSPLIT; ++s) v += part[s][r][col];
      out[(size_t)m * N + n] = v * sc;
    }
  }
}

}  // namespace

// x_dtype: 0 = fp32, 1 = bf16. Launches on `stream` and returns cudaGetLastError().
extern "C" int swis_matmul_launch(int x_dtype, const void* x, const void* sign,
                                  const void* masks, const void* shifts, const void* scale,
                                  void* out, int M, int K, int N, int group, int n_shifts,
                                  int first, int consecutive, int shift_bytes, void* stream) {
  if (n_shifts < 1 || n_shifts > MAX_SHIFTS || first < 0 || first >= n_shifts ||
      K % 32 != 0 || group < 1 || K % group != 0 || M < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block(BN * KSPLIT);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* sp = (const uint32_t*)sign;
  const uint32_t* mp = (const uint32_t*)masks;
  const uint8_t* hp = (const uint8_t*)shifts;
  const float* cp = (const float*)scale;
  float* op = (float*)out;
  if (x_dtype == 0)
    swis_matmul_kernel<float><<<grid, block, 0, st>>>((const float*)x, sp, mp, hp, cp, op, M, K,
                                                      N, group, n_shifts, first, consecutive,
                                                      shift_bytes);
  else if (x_dtype == 1)
    swis_matmul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)x, sp, mp, hp, cp, op, M, K, N, group, n_shifts, first,
        consecutive, shift_bytes);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
