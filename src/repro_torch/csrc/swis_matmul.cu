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
// The expert-axis launch (swis_matmul_experts_launch) runs E such products in
// one grid, out[e] (M, N) = x[e] @ dequant(planes[e]) for the stacked expert
// weights of a MoE layer: every operand above gains a leading E axis, and x[e]
// lies x_estride elements after x[e-1]; a stride of 0 gives every expert the
// same rows (decode's wi and wg read the same tokens for all experts). Its
// JAX counterpart is no Pallas kernel but a dequantized copy and an einsum
// (src/repro/models/moe.py, _quant and moe_apply); here the expert GEMMs read
// only the packed bytes. The expert index is folded into blockIdx.z beside
// the row tiles, so a layer's expert stack is one launch.
//
// What bounds it on an H100: at decode (M <= 8) the least time is the packed
// weight bytes over the memory rate, about 1.1 bytes a weight at 4 planes and
// group 4, so a 576 x 576 GEMM could take well under a microsecond. What a
// kernel of this size really waits on is latency: the launch, and each chain
// of dependent global loads. The design keeps every chain short:
//   * one thread per output column and 32-weight word: a warp's plane loads are
//     coalesced, and every thread issues all of a word's plane loads at once,
//     before the block stages anything, so they overlap the staging;
//   * x (as fp32) and the shift bytes of a round's K range and 32 columns are
//     staged in shared memory together, between one pair of barriers; the bit
//     loop does no global load;
//   * K is split across the blocks of a thread block cluster (up to 8), chosen
//     so the grid has about two blocks for each SM; each block pushes its
//     partial sums into the cluster's first block through distributed shared
//     memory, where they are added in rank order, so the result does not
//     depend on scheduling and no float atomic is used, all in one launch;
//   * the plane loop is a template on n_shifts (1..8), so unused slots cost
//     nothing; each rebuilt weight is an exact integer (|w| <= 255), used for
//     all the rows of the tile: 4 rows at M <= 4, 8 at M <= 8, 32 above
//     (prefill);
//   * ragged M and N are masked, so no shape is refused.
// It calls no library GEMM and uses no tensor core: the products are fp32 FMAs.
//
// What the chip run showed (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W):
// one decode layer's 7 GEMMs at M = 4 take 0.0410 ms against 0.0520 ms for
// torch.matmul on the dense fp32 weight (the first version: 0.169 ms), 5.2 to
// 7.2 us a GEMM, near the floor of a launch and two dependent loads; at the
// prefill shape (M = 256) 0.230 ms against 0.095 ms (first version 0.572 ms),
// where the rebuild and the shared-memory reads of x, not bytes, bound it.
// Three things mattered, in order: the shift bytes had been fetched in a chain
// of serial loads; the fully unrolled 32-weight rebuild ran out of registers,
// spilled, and left room for one block per SM (so a second wave at N = 1536);
// and clusters of 6 blocks fit the GPCs badly. Hence the staging in one round
// trip, the rebuild four weights at a time and power-of-two clusters.
// The expert-axis launch at qwen2-moe-a2.7b's decode shapes (E 64, M 4,
// 2048 x 1408 and 1408 x 2048; same card) takes 0.47-0.49 ms a stack against
// a 0.0625 ms byte bound and 0.24 ms for torch.bmm over the dequantized fp32
// stack: with K = 2048 and 2816 blocks there is no K split, and each block
// keeps one round of plane loads in flight between barriers, too few bytes
// to fill the card (a device copy of the same 208 MB runs at ~3 TB/s).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 32;          // output columns per block, one per lane
constexpr int WARPS = 8;        // warps per block; each takes one word of a round
constexpr int THREADS = BN * WARPS;
constexpr int KC = WARPS * 32;  // k per round
constexpr int MAX_SHIFTS = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int SB = 8;  // shift-staging loads a thread issues before storing

struct Args {
  const void* x;
  const uint32_t* sign;
  const uint32_t* masks;
  const uint8_t* shifts;
  const float* scale;
  float* out;
  int M, K, N, group, first, consecutive, shift_bytes;
  int m_tiles;           // row tiles of one expert: blockIdx.z = expert * m_tiles + tile
  long long x_estride;   // elements from x[e] to x[e + 1]; 0: the experts share x
  int words_per_block;   // 32-weight words of K per cluster rank
  int groups_per_round;  // most groups one round of KC can touch
  int shifts_u32;        // 1: every group row of 32 columns starts 4-byte aligned
};

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The shifts of one (group, column) from its staged bytes.
template <int NS>
__device__ __forceinline__ void decode_shifts(const uint8_t* p, int consecutive, int (&sh)[NS]) {
  uint32_t u = p[0];
  if (!consecutive) {
#pragma unroll
    for (int q = 1; q < (NS + 1) / 2; ++q) u |= (uint32_t)p[q] << (8 * q);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    sh[j] = consecutive ? (int)(u & 0xFFu) + j : (int)((u >> (4 * j)) & 0xFu);
}

template <typename XT, int NS, int BM>
__global__ void __launch_bounds__(THREADS, 2) swis_matmul_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // [BM][KC] a round's x, then [WARPS][BM][BN] partials
  float* red = xs + BM * KC;  // [cluster size][BM][BN] every block's sums (rank 0's)
  uint8_t* shs = (uint8_t*)(red + MAX_CLUSTER * BM * BN);  // [groups][BN][shift_bytes]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int lane = threadIdx.x % BN;
  const int warp = threadIdx.x / BN;
  const int n0 = blockIdx.y * BN;
  const int n = n0 + lane;
  const int expert = blockIdx.z / a.m_tiles;
  const int m0 = (blockIdx.z - expert * a.m_tiles) * BM;
  const int N = a.N, K = a.K, KW = K / 32;
  const bool col_ok = n < N;
  // this expert's operands (expert 0 alone in the 2-D launch)
  const size_t plane = (size_t)KW * N;  // words of one bit-plane
  const XT* x = (const XT*)a.x + (size_t)expert * a.x_estride;
  const uint32_t* sign = a.sign + expert * plane;
  const uint32_t* masks = a.masks + expert * NS * plane;
  const uint8_t* shifts = a.shifts + (size_t)expert * (K / a.group) * N * a.shift_bytes;
  const float* scale = a.scale + (size_t)expert * N;
  float* out = a.out + (size_t)expert * a.M * N;
  const int kw_begin = rank * a.words_per_block;
  const int kw_end = min(KW, kw_begin + a.words_per_block);

  // a block may write another's shared memory only once that block runs: the
  // arrival here is waited on before the partial sums are pushed
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int kw0 = kw_begin; kw0 < kw_end; kw0 += WARPS) {
    const int nw = min(WARPS, kw_end - kw0);
    const int kw = kw0 + warp;
    const bool has_word = warp < nw && col_ok;

    // 1. this thread's plane words, issued before the staging so they overlap it
    uint32_t s_word = 0u;
    uint32_t mw[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) mw[j] = 0u;
    if (has_word) {
      s_word = __ldg(sign + (size_t)kw * N + n);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (j >= a.first) mw[j] = __ldg(masks + ((size_t)j * KW + kw) * N + n);
    }

    if (kw0 != kw_begin) __syncthreads();  // the previous round is done with xs and shs
    // 2. stage x rows [m0, m0 + BM) of this round's K range as fp32, 4 values
    //    a load, and the shift bytes of every group the round touches, copied
    //    as they lie (a group's row of 32 columns is 32 * shift_bytes
    //    contiguous bytes). Each thread issues all its loads of a batch, x and
    //    shifts, before its first store, so they make one round trip.
    const int k0 = kw0 * 32;
    const int per_row = nw * 8;  // float4s per row of x
    const int n_x = BM * per_row;
    const int g_lo = k0 / a.group;
    const int ng = (k0 + nw * 32 - 1) / a.group - g_lo + 1;
    const int row_bytes = BN * a.shift_bytes;
    const int valid_bytes = min(BN, N - n0) * a.shift_bytes;
    const uint8_t* src = shifts + ((size_t)g_lo * N + n0) * a.shift_bytes;
    const size_t src_stride = (size_t)N * a.shift_bytes;
    const int per = row_bytes / 4;  // shift words per group row
    const int n_sh = a.shifts_u32 ? ng * per : 0;
    constexpr int XB = BM / 4;  // float4s a thread stages when the round is full
    for (int t = 0; t * THREADS * XB < n_x || t * THREADS * SB < n_sh; ++t) {
      float4 xv[XB];
      uint32_t sv[SB];
#pragma unroll
      for (int u = 0; u < XB; ++u) {
        const int i = (t * XB + u) * THREADS + threadIdx.x;
        const int r = i / per_row;
        xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n_x && m0 + r < a.M)
          xv[u] = load4(x + (size_t)(m0 + r) * K + k0 + 4 * (i - r * per_row));
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = (t * SB + u) * THREADS + threadIdx.x;
        const int gi = i / per;
        const int c = i - gi * per;
        sv[u] = 0u;
        if (i < n_sh && c * 4 < valid_bytes)
          sv[u] = __ldg((const uint32_t*)(src + gi * src_stride) + c);
      }
#pragma unroll
      for (int u = 0; u < XB; ++u) {
        const int i = (t * XB + u) * THREADS + threadIdx.x;
        const int r = i / per_row;
        if (i < n_x) *(float4*)(xs + r * KC + 4 * (i - r * per_row)) = xv[u];
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = (t * SB + u) * THREADS + threadIdx.x;
        if (i < n_sh) ((uint32_t*)shs)[i] = sv[u];
      }
    }
    if (!a.shifts_u32) {  // rows not 4-byte aligned: a byte a load
      for (int i = threadIdx.x; i < ng * row_bytes; i += THREADS) {
        const int gi = i / row_bytes;
        const int c = i - gi * row_bytes;
        shs[i] = c < valid_bytes ? __ldg(src + gi * src_stride + c) : (uint8_t)0;
      }
    }
    __syncthreads();

    if (has_word) {
      // 3. rebuild the word's weights as exact integers, four at a time, and
      // 4. take their fp32 FMAs against every row of the tile (x reads are
      //    broadcasts); four weights live at once, which keeps registers low
      const int kb = kw * 32;
      int gi = kb / a.group - g_lo;
      int g_end = (kb / a.group + 1) * a.group;  // first k past the current group
      int sh[NS];
      decode_shifts<NS>(shs + (gi * BN + lane) * a.shift_bytes, a.consecutive, sh);
      const float* xw = xs + warp * 32;
#pragma unroll 2
      for (int b0 = 0; b0 < 32; b0 += 4) {
        float w4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b = b0 + u;
          if (kb + b >= g_end) {  // uniform across the warp
            ++gi;
            g_end += a.group;
            decode_shifts<NS>(shs + (gi * BN + lane) * a.shift_bytes, a.consecutive, sh);
          }
          int mag = 0;
#pragma unroll
          for (int j = 0; j < NS; ++j) mag += (int)((mw[j] >> b) & 1u) << sh[j];
          w4[u] = (float)(((s_word >> b) & 1u) ? -mag : mag);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float4 xv = *(const float4*)(xw + r * KC + b0);
          acc[r] = fmaf(xv.x, w4[0], acc[r]);
          acc[r] = fmaf(xv.y, w4[1], acc[r]);
          acc[r] = fmaf(xv.z, w4[2], acc[r]);
          acc[r] = fmaf(xv.w, w4[3], acc[r]);
        }
      }
    }
  }

  // 5. the block's sum over its warps, in warp order, pushed into slot `rank`
  //    of the cluster's first block; that block adds the slots in rank order
  __syncthreads();  // done with xs
  float* part = xs;
#pragma unroll
  for (int r = 0; r < BM; ++r) part[(warp * BM + r) * BN + lane] = acc[r];
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* slot = cluster.map_shared_rank(red, 0) + rank * BM * BN;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    float v = part[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += part[w * BM * BN + e];
    slot[e] = v;
  }
  cluster.sync();  // every slot is written (release / acquire across the cluster)
  if (rank == 0) {
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      float v = red[e];
      for (int q = 1; q < cs; ++q) v += red[q * BM * BN + e];
      const int m = m0 + e / BN;
      const int nn = n0 + e % BN;
      if (m < a.M && nn < N) out[(size_t)m * N + nn] = v * scale[nn];
    }
  }
}

template <typename XT, int NS, int BM>
int launch(const Args& a, int n_experts, int cs, cudaStream_t st) {
  const dim3 grid(cs, (a.N + BN - 1) / BN, a.m_tiles * n_experts);
  const size_t smem = sizeof(float) * (BM * KC + MAX_CLUSTER * BM * BN) +
                      (size_t)a.groups_per_round * BN * a.shift_bytes;
  auto kern = swis_matmul_kernel<XT, NS, BM>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename XT, int BM>
int launch_ns(const Args& a, int n_shifts, int n_experts, int cs, cudaStream_t st) {
  switch (n_shifts) {
    case 1: return launch<XT, 1, BM>(a, n_experts, cs, st);
    case 2: return launch<XT, 2, BM>(a, n_experts, cs, st);
    case 3: return launch<XT, 3, BM>(a, n_experts, cs, st);
    case 4: return launch<XT, 4, BM>(a, n_experts, cs, st);
    case 5: return launch<XT, 5, BM>(a, n_experts, cs, st);
    case 6: return launch<XT, 6, BM>(a, n_experts, cs, st);
    case 7: return launch<XT, 7, BM>(a, n_experts, cs, st);
    case 8: return launch<XT, 8, BM>(a, n_experts, cs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT>
int launch_bm(const Args& a, int n_shifts, int bm, int n_experts, int cs, cudaStream_t st) {
  if (bm == 4) return launch_ns<XT, 4>(a, n_shifts, n_experts, cs, st);
  if (bm == 8) return launch_ns<XT, 8>(a, n_shifts, n_experts, cs, st);
  return launch_ns<XT, 32>(a, n_shifts, n_experts, cs, st);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// Both entry points: n_experts products of one shape, x[e] x_estride elements
// apart (16-byte aligned), every other operand stacked back to back.
int launch_experts(int x_dtype, const void* x, long long x_estride, const void* sign,
                   const void* masks, const void* shifts, const void* scale, void* out,
                   int n_experts, int M, int K, int N, int group, int n_shifts, int first,
                   int consecutive, int shift_bytes, void* stream) {
  if (n_shifts < 1 || n_shifts > MAX_SHIFTS || first < 0 || first >= n_shifts ||
      K % 32 != 0 || group < 1 || K % group != 0 || M < 1 || N < 1 || shift_bytes < 1 ||
      shift_bytes > 4 || n_experts < 1 || x_estride < 0 || ((uintptr_t)x & 15u) != 0 ||
      (x_estride * (x_dtype == 0 ? 4 : 2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int bm = M <= 4 ? 4 : M <= 8 ? 8 : 32;
  const int KW = K / 32;
  const int m_tiles = (M + bm - 1) / bm;
  if ((long long)m_tiles * n_experts > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((N + BN - 1) / BN) * m_tiles * n_experts;
  // the cluster splits K: a power of two, at most one round of words per
  // block, and no more blocks than about two per SM
  int cs = 1;
  while (cs < MAX_CLUSTER && cs * WARPS < KW && 2 * cs * tiles <= 2 * sm_count()) cs *= 2;
  Args a;
  a.x = x;
  a.sign = (const uint32_t*)sign;
  a.masks = (const uint32_t*)masks;
  a.shifts = (const uint8_t*)shifts;
  a.scale = (const float*)scale;
  a.out = (float*)out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.group = group;
  a.first = first;
  a.consecutive = consecutive;
  a.shift_bytes = shift_bytes;
  a.m_tiles = m_tiles;
  a.x_estride = x_estride;
  a.words_per_block = (KW + cs - 1) / cs;
  a.groups_per_round = (KC - 1) / group + 2;
  a.shifts_u32 = ((size_t)N * shift_bytes) % 4 == 0 && ((uintptr_t)shifts & 3u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0) return launch_bm<float>(a, n_shifts, bm, n_experts, cs, st);
  if (x_dtype == 1) return launch_bm<__nv_bfloat16>(a, n_shifts, bm, n_experts, cs, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype: 0 = fp32, 1 = bf16; x must be 16-byte aligned. Launches once on
// `stream` and returns cudaGetLastError().
extern "C" int swis_matmul_launch(int x_dtype, const void* x, const void* sign,
                                  const void* masks, const void* shifts, const void* scale,
                                  void* out, int M, int K, int N, int group, int n_shifts,
                                  int first, int consecutive, int shift_bytes, void* stream) {
  return launch_experts(x_dtype, x, 0, sign, masks, shifts, scale, out, 1, M, K, N, group,
                        n_shifts, first, consecutive, shift_bytes, stream);
}

// The expert-axis launch: out (E, M, N) fp32, out[e] = x[e] @ dequant(planes[e]),
// with sign (E, K/32, N), masks (E, n_shifts, K/32, N), shifts
// (E, K/group, N, shift_bytes), scale (E, N); x[e] starts x_estride elements
// after x[e-1] (0: one x for every expert) and must be 16-byte aligned.
extern "C" int swis_matmul_experts_launch(int x_dtype, const void* x, long long x_estride,
                                          const void* sign, const void* masks,
                                          const void* shifts, const void* scale, void* out,
                                          int n_experts, int M, int K, int N, int group,
                                          int n_shifts, int first, int consecutive,
                                          int shift_bytes, void* stream) {
  return launch_experts(x_dtype, x, x_estride, sign, masks, shifts, scale, out, n_experts, M,
                        K, N, group, n_shifts, first, consecutive, shift_bytes, stream);
}
