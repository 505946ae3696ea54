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
// only the packed bytes, and a layer's expert stack is one launch. It has a
// kernel of its own, swis_experts_kernel (namespace xk, below); the 2-D launch
// keeps swis_matmul_kernel, whose expert fields that entry leaves unused.
//
// swis_matmul_kernel. What bounds it on an H100: at decode (M <= 8) the least time is the packed
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
//
// swis_experts_kernel. A MoE decode layer's expert stacks are large (E 64 x
// 2048 x 1408, 208 MB a stack at 4 planes) and read at M <= 8, so their
// least time is the packed bytes over the memory rate (0.062 ms a stack).
// Through swis_matmul_kernel they took 0.47-0.49 ms: that kernel spends ~26
// integer instructions rebuilding each weight bit by bit (a shift, an and, a
// variable shift and an add per plane, the sign, an int-to-float convert,
// the group test), which alone keeps the integer pipe busy longer than the
// bytes take, and a block keeps one round of loads in flight between
// barriers. This kernel attacks both:
//   * the rebuild is word-wide: for 4 weights of a column (byte b of a plane
//     word shifted so their bits sit at the bytes' tops) one prmt in
//     sign-replicate mode turns a plane's bits into byte masks, a lop3 ANDs
//     them with the group's powers 1 << shift and ORs them into the
//     magnitudes (4 per word; a set bit per shift, so OR is the sum), and two
//     prmts interleave magnitude and sign bytes into two fp16x2 words: the
//     16-bit pattern sign << 15 | magnitude is the fp16 subnormal
//     +-magnitude * 2^-24, exact, with no convert. The powers come from a
//     prmt table lookup with the shift nibbles as selectors, once per group.
//     About 6 instructions a weight in all, against ~30 before (counted in
//     the built SASS by python -m repro_torch.benchmarks.sass_count).
//     Shifts must be 3-bit (0..7) with the planes of a group at distinct
//     shifts, as SWIS packs them at 8 bits or fewer (paper §2.2); the
//     wrapper refuses a stack quantized to more;
//   * the products are tensor-core mma.sync m16n8k16 with the weights as A
//     (16 columns x 16 k) and x as B: each x row is scaled by a power of two
//     so |x| < 2^15 and split into two fp16 terms (22 bits), both multiplied
//     exactly; each warp's 4-step chain starts from zero every stage and is
//     added in fp32, so the tensor core's own accumulation never runs long.
//     A k-permutation makes a lane's 4 rebuilt bytes the lane's mma slots,
//     and x is converted into that order in shared memory once per row tile;
//   * the planes and shift bytes of 256-k stages stream through a 3- or
//     4-slot cp.async ring (16-byte copies worked out once a tile), and the
//     blocks are persistent: 2 a SM, each a contiguous share of the (expert,
//     row tile, 64-column tile) tiles, so the ring runs on across tiles and
//     x is converted again only when its rows change;
//   * the four K warps' sums meet in shared memory in a fixed order: no
//     float atomics, the same result every run.
// Templates: n_shifts 1..8 x row tiles of 4, 8 and 16 for SWIS at a group that
// is a power of two >= 4 with 16-byte aligned rows; one general instance
// (8 planes, 16 rows, runtime planes) takes SWIS-C, any other group and
// unaligned rows.
// What bounds it now: the rebuild's integer instructions and the bytes are
// of a size, and they overlap only in part (a block waits at one barrier a
// stage); one decode layer's 3 stacks reach about half the byte bound.
// PERF.md has the measurements (chip_smoke.py phase 7 (b)).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// ---------------------------------------------------------------------------
// The expert-axis kernel (swis_matmul_experts_launch). The 2-D launch above
// keeps swis_matmul_kernel; every expert stack goes through this one.
namespace xk {

constexpr int BN = 64;          // output columns per block
constexpr int KS = 256;         // k per pipeline stage
constexpr int THREADS = 256;    // 8 warps: 4 along K (one 64-k step each) x 2 along N (32 columns)
constexpr int RSW = BN + 8;     // words per staged plane row: the two words a warp reads sit 8 banks apart
constexpr int MAX_STAGES = 4;
constexpr uint32_t POW_LO = 0x08040201u;  // bytes 1 << s for s = 0..7: the table
constexpr uint32_t POW_HI = 0x80402010u;  // a shift selects from with prmt

struct Args {
  const void* x;
  const uint32_t* sign;
  const uint32_t* masks;
  const uint8_t* shifts;
  const float* scale;
  float* out;
  int M, K, N, group, first, consecutive, sb, x_bf16, n_shifts;
  long long x_estride;  // elements from x[e] to x[e + 1]; 0: the experts share x
  int lg;               // log2(group) when group is a power of two >= 4, else -1
  int shift_rows;       // most group rows of shift bytes one stage touches
  int rss;              // bytes per staged shift row
  int plane_bytes, shift_bytes_stage, stage_bytes;  // one ring slot
  int stages;           // ring slots (2..4)
  int chunk_stages;     // stages of x converted at once
  int frag_off, red_off, up_off;  // byte offsets past the ring
  int m_tiles, n_experts;  // BM-row tiles of M; experts
  int plane_chunk, shift_chunk;  // cp.async sizes: 16 or 4 (shifts: 1 = plain loads)
  int shift_per;        // shift chunks per staged row
  unsigned shift_magic;  // ceil(2^32 / shift_per): idx / shift_per as one multiply
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int chunk) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (chunk == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp16_full(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The SB shift bytes of one (group row, column) of a staged stage, as one
// word (SB 0: the count is the runtime sb).
template <int SB>
__device__ __forceinline__ uint32_t load_shift(const uint8_t* shs, int rss, int sb, int row,
                                               int col) {
  const int n = SB ? SB : sb;
  const uint8_t* p = shs + row * rss + col * n;
  if (n == 1) return p[0];
  if (n == 2) return *(const uint16_t*)p;
  if (n == 4) return *(const uint32_t*)p;
  return p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}

// P[j] byte b = 1 << (shift j of the group that byte b's weights lie in),
// from h[b], that group's shift bytes: each plane pair's nibbles of two
// groups form one prmt selector into the table of powers; two more prmts
// sort the pair's bytes by plane. SWIS-C: the offset's power, then << j.
template <int NS>
__device__ __forceinline__ void build_powers(const uint32_t (&h)[4], bool consecutive,
                                             uint32_t (&P)[NS]) {
  if (consecutive) {
    const uint32_t sel = h[0] | (h[1] << 4) | (h[2] << 8) | (h[3] << 12);
    const uint32_t p0 = prmt(POW_LO, POW_HI, sel);
#pragma unroll
    for (int j = 0; j < NS; ++j) P[j] = p0 << j;
    return;
  }
#pragma unroll
  for (int ip = 0; ip < (NS + 1) / 2; ++ip) {
    const uint32_t s = 0x40u + 0x11u * ip;  // byte ip of each of the two words
    const uint32_t pa = prmt(POW_LO, POW_HI, prmt(h[0], h[1], s));
    const uint32_t pb = prmt(POW_LO, POW_HI, prmt(h[2], h[3], s));
    P[2 * ip] = prmt(pa, pb, 0x6420u);
    if (2 * ip + 1 < NS) P[2 * ip + 1] = prmt(pa, pb, 0x7531u);
  }
}

// Four weights of one column as two fp16x2 words: for each byte b of the
// shifted plane words, the weight whose bit sits at the byte's top. The
// magnitude (an integer <= 255, the OR of each set plane's power) lands in
// a byte; the sign bit in bit 7 of the byte above it. That 16-bit pattern
// is the fp16 subnormal +-magnitude * 2^-24, exact, with no conversion.
template <int NS>
__device__ __forceinline__ void rebuild4(uint32_t s, const uint32_t (&mw)[NS],
                                         const uint32_t (&P)[NS], int i, uint32_t& lo,
                                         uint32_t& hi) {
  uint32_t mag = 0;  // a plane that is dropped or absent has a zero word
#pragma unroll
  for (int j = 0; j < NS; ++j) mag |= prmt(mw[j] << i, 0u, 0xBA98u) & P[j];
  const uint32_t sg = (s << i) & 0x80808080u;
  lo = prmt(mag, sg, 0x5140u);
  hi = prmt(mag, sg, 0x7362u);
}

// GEN false: SWIS shifts, a group that is a power of two >= 4, 16-byte rows,
// NS planes. GEN true (one instance, NS 8, BM 16): anything else, with
// a.n_shifts planes and the copies worked out every stage.
template <int NS, int BM, bool GEN>
__global__ void __launch_bounds__(THREADS, 2) swis_experts_kernel(const Args a) {
  constexpr int CS = BM <= 4 ? 1 : BM / 4;  // 8-column B tiles: BM rows x 2 fp16 terms
  constexpr int SB = GEN ? 0 : (NS + 1) / 2;  // shift bytes a group
  constexpr int SBF = SB ? SB : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint2* bfrag = (uint2*)(smem + a.frag_off);  // [64-k steps][4 mma][CS][32 lanes]
  // [4 K warps][CS][8 B columns][BN] a tile's sums: over the fragments when
  // those are converted again every tile anyway
  float* red = (float*)(smem + a.red_off);
  float* up = (float*)(smem + a.up_off);  // [BM] 2^sigma of each row
  float* pmax = up + BM;                  // [BM][2] partial row maxima, then 2^-sigma

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tid = lane & 3;
  const int ss = warp & 3, nw = warp >> 2;  // this warp's 64-k step of a stage, column half
  const int w = tid >> 1, p = tid & 1;      // this lane's word of the step, nibble of each byte
  const int sh = 4 * (1 - p);
  const int M = a.M, K = a.K, N = a.N, KW = K / 32, NS_FIRST = a.first;
  const int ns = GEN ? a.n_shifts : NS;
  const int G = K / a.group;
  const int n_ks = (K + KS - 1) / KS;
  const int n_tiles = (N + BN - 1) / BN;
  // this block's tiles, t = (expert * m_tiles + row tile) * n_tiles + column tile:
  // a contiguous share, so that consecutive tiles mostly read the same x
  const int tiles = a.n_experts * a.m_tiles * n_tiles;
  const int t_begin = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);

  // The copies of a stage. Fast instances: each thread's 16-byte chunks are
  // the same every stage of a tile but for a fixed step in the source, so
  // they are worked out once a tile: chunk j of JP plane chunks (JS shift
  // chunks) reads from pp[j] (sp[j]) plus the stage's step and lands at byte
  // pd[j] (sd[j]) of a slot; pm[j] = bytes | word << 5 | live << 8 (sm[j] =
  // bytes | group row << 5 | live << 31). Past K a chunk reads 0 bytes.
  constexpr int JP = GEN ? 1 : ((NS + 1) * 8 * (BN * 4 / 16) + THREADS - 1) / THREADS;
  constexpr int JS = GEN ? 1 : SB;  // 64 group rows (group 4) of 4 * SB chunks
  const uint8_t* pp[JP];
  const uint8_t* sp[JS];
  unsigned pd[JP], pm[JP], sd[JS], sm[JS];
  // the tile the copies are at: its operands and columns
  const uint32_t* i_sign = nullptr;
  const uint32_t* i_masks = nullptr;
  const uint8_t* i_shifts = nullptr;
  int i_n0 = 0, i_cols = 0;
  auto copy_tile = [&](int t) {
    const int e = t / (a.m_tiles * n_tiles);
    i_n0 = (t % n_tiles) * BN;
    i_cols = min(BN, N - i_n0);
    i_sign = a.sign + (size_t)e * KW * N;
    i_masks = a.masks + (size_t)e * ns * KW * N;
    i_shifts = a.shifts + (size_t)e * G * N * a.sb;
    if (GEN) return;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int r = idx >> 4, c = (idx & 15) * 16, pl = r >> 3, wl = r & 7;
      const bool live = pl <= NS && !(pl >= 1 && pl - 1 < NS_FIRST);
      const uint32_t* row = pl == 0 ? i_sign + (size_t)wl * N
                                    : i_masks + ((size_t)(pl - 1) * KW + wl) * N;
      pp[j] = (const uint8_t*)(row + i_n0) + c;
      pd[j] = r * RSW * 4 + c;
      pm[j] = (unsigned)min(max(i_cols * 4 - c, 0), 16) | ((unsigned)wl << 5) |
              ((unsigned)live << 8);
    }
    const int rows = max(KS >> a.lg, 1);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int r = idx / (4 * SBF), c = (idx % (4 * SBF)) * 16;
      sp[j] = i_shifts + ((size_t)r * N + i_n0) * SBF + c;
      sd[j] = r * a.rss + c;
      sm[j] = (unsigned)min(max(i_cols * SBF - c, 0), 16) | ((unsigned)r << 5) |
              ((unsigned)(r < rows) << 31);
    }
  };
  auto issue_fast = [&](int st, uint8_t* slot) {
    const int kw0 = st * (KS / 32);
    const size_t pstep = (size_t)kw0 * N * 4;  // the stage's words, in every plane
    const int grow = (st * KS) >> a.lg;        // the stage's first group row
    const size_t sstep = (size_t)grow * N * SBF;
    uint8_t* sdst = slot + a.plane_bytes;
    if (i_cols == BN && kw0 + KS / 32 <= KW) {  // the whole stage lies inside the operands
#pragma unroll
      for (int j = 0; j < JP; ++j)
        if (pm[j] >> 8) cp16_full(slot + pd[j], pp[j] + pstep);
#pragma unroll
      for (int j = 0; j < JS; ++j)
        if (sm[j] >> 31) cp16_full(sdst + sd[j], sp[j] + sstep);
    } else {
#pragma unroll
      for (int j = 0; j < JP; ++j)
        if (pm[j] >> 8)
          cp_async(slot + pd[j], pp[j] + pstep,
                   kw0 + (int)((pm[j] >> 5) & 7u) < KW ? (int)(pm[j] & 31u) : 0, 16);
#pragma unroll
      for (int j = 0; j < JS; ++j)
        if (sm[j] >> 31)
          cp_async(sdst + sd[j], sp[j] + sstep,
                   grow + (int)((sm[j] >> 5) & 0x3FFu) < G ? (int)(sm[j] & 31u) : 0, 16);
    }
  };
  // any other instance: the copies worked out every stage
  auto issue_any = [&](int st, uint8_t* slot) {
    const int k0 = st * KS, kw0 = k0 / 32;
    const int nwords = min(KS / 32, KW - kw0);
    // planes: row r = plane (0 sign, 1 + j mask j) * 8 + word; each 64 columns
    {
      const int chunk = a.plane_chunk;
      const int per = BN * 4 / chunk;  // 16 or 64: a power of two
      const int per_lg = chunk == 16 ? 4 : 6;
      const int total = (ns + 1) * 8 * per;
      for (int idx = threadIdx.x; idx < total; idx += THREADS) {
        const int r = idx >> per_lg, c = (idx & (per - 1)) * chunk;
        const int pl = r >> 3, wl = r & 7;
        if (pl >= 1 && pl - 1 < NS_FIRST) continue;  // planes keep_slices drops
        const uint32_t* row = pl == 0 ? i_sign + (size_t)(kw0 + wl) * N
                                      : i_masks + ((size_t)(pl - 1) * KW + kw0 + wl) * N;
        const int n = wl < nwords ? min(max(i_cols * 4 - c, 0), chunk) : 0;
        cp_async(slot + (r * RSW) * 4 + c,
                 n ? (const uint8_t*)(row + i_n0) + c : (const void*)a.sign, n, chunk);
      }
    }
    // shift rows g_lo .. g_lo + rows - 1, 64 columns of sb bytes each
    {
      uint8_t* dst = slot + a.plane_bytes;
      const int g_lo = k0 / a.group;
      const int rows = min(a.shift_rows, G - g_lo);
      const int valid = i_cols * a.sb;
      const uint8_t* src = i_shifts + ((size_t)g_lo * N + i_n0) * a.sb;
      const size_t stride = (size_t)N * a.sb;
      const int chunk = a.shift_chunk;
      const int per = a.shift_per;
      const int total = rows * per;
      for (int idx = threadIdx.x; idx < total; idx += THREADS) {
        const int r = (int)__umulhi((unsigned)idx, a.shift_magic);
        const int c = (idx - r * per) * chunk;
        const int n = min(max(valid - c, 0), chunk);
        if (chunk == 1)
          dst[r * a.rss + c] = n ? src[r * stride + c] : (uint8_t)0;
        else
          cp_async(dst + r * a.rss + c, n ? src + r * stride + c : a.shifts, n, chunk);
      }
    }
  };
  // the copy cursor: the next stage to issue (tile i_t, stage i_s) and its slot
  int i_t = t_begin, i_s = 0, i_slot = 0;
  if (i_t < t_end) copy_tile(i_t);
  auto issue = [&]() {
    if (i_t < t_end) {
      uint8_t* slot = ring + i_slot * a.stage_bytes;
      if (GEN) issue_any(i_s, slot);
      else issue_fast(i_s, slot);
      i_slot = i_slot + 1 == a.stages ? 0 : i_slot + 1;
      if (++i_s == n_ks) {
        i_s = 0;
        if (++i_t < t_end) copy_tile(i_t);
      }
    }
    cp_commit();  // an empty group past the last stage keeps the count uniform
  };
  for (int st = 0; st < a.stages - 1; ++st) issue();

  float acc[2][CS][4];
  int slot_c = 0;      // the ring slot of the stage computed next
  int x_key = -1;      // the x rows whose row scales are in up / pmax
  int e = 0, m0 = 0, n0 = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int et = t / (a.m_tiles * n_tiles), mt_ = (t / n_tiles) % a.m_tiles;
    e = et;
    m0 = mt_ * BM;
    n0 = (t % n_tiles) * BN;
    const float* xf = (const float*)a.x + (size_t)e * a.x_estride;
    const __nv_bfloat16* xh = (const __nv_bfloat16*)a.x + (size_t)e * a.x_estride;
    const int key = (a.x_estride ? e : 0) * a.m_tiles + mt_;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int cs = 0; cs < CS; ++cs)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][cs][q] = 0.f;

    if (key != x_key) {
      // 1. each row's power-of-two scale over all of K: |x| * 2^sigma < 2^15
      //    keeps both fp16 terms in range, 11 bits each (2 warps a row at BM 4)
      if (t != t_begin) __syncthreads();  // every warp is done with the last rows' scales
      constexpr int WPR = BM >= 8 ? 1 : 8 / BM;  // warps per row
      constexpr int RPW = BM >= 8 ? BM / 8 : 1;  // rows per warp
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int m = (warp / WPR) * RPW + rr, part = warp % WPR;
        float amax = 0.f;
        if (m < BM && m0 + m < M) {
          if (a.x_bf16) {
            const uint2* row = (const uint2*)(xh + (size_t)(m0 + m) * K);
            for (int f = part * 32 + lane; f < K / 4; f += 32 * WPR) {
              const uint2 u = row[f];
              const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
              const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
              amax = fmaxf(amax,
                           fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)), fmaxf(fabsf(hi.x), fabsf(hi.y))));
            }
          } else {
            const float4* row = (const float4*)(xf + (size_t)(m0 + m) * K);
            for (int f = part * 32 + lane; f < K / 4; f += 32 * WPR) {
              const float4 v = row[f];
              amax =
                  fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        if (lane == 0 && m < BM) pmax[m * 2 + (WPR > 1 ? part : 0)] = amax;
        if (lane == 0 && m < BM && WPR == 1) pmax[m * 2 + 1] = 0.f;
      }
      __syncthreads();
      if (threadIdx.x < BM) {
        const float amax = fmaxf(pmax[threadIdx.x * 2], pmax[threadIdx.x * 2 + 1]);
        const int ex = (__float_as_int(amax) >> 23) & 0xFF;
        const int sigma = amax == 0.f ? 0 : max(-126, min(126, 14 - (ex - 127)));
        up[threadIdx.x] = __int_as_float((127 + sigma) << 23);
        pmax[threadIdx.x * 2] = __int_as_float((127 - sigma) << 23);  // 2^-sigma, for the end
      }
      __syncthreads();
    }

    int sl = 0;  // stage s within its chunk of converted x
    for (int s = 0; s < n_ks; ++s) {
      // 2. x of the chunk's stages as two fp16 terms in mma B-fragment order
      //    (once per x rows when the chunk is all of K): each thread converts
      //    4 k at a time (a float4 of one row), all its loads first; a k's
      //    slot follows from its bit position in its word
      if (sl == 0 && (key != x_key || a.chunk_stages < n_ks)) {
        if (s > 0 || t != t_begin) __syncthreads();  // every warp is done with the last chunk
        const int n4 = min(a.chunk_stages, n_ks - s) * (KS / 4);  // float4s a row
        const int kc0 = s * KS;
        for (int q0 = threadIdx.x; q0 < n4; q0 += THREADS) {
          float4 v[BM];
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const int k = kc0 + 4 * q0;
            v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m0 + m < M && k < K) {
              const size_t i = (size_t)(m0 + m) * K + k;
              if (a.x_bf16) {
                const uint2 u = *(const uint2*)(xh + i);
                const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
                const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
                v[m] = make_float4(lo.x, lo.y, hi.x, hi.y);
              } else {
                v[m] = *(const float4*)(xf + i);
              }
            }
          }
          const int kl = 4 * q0, sg = kl >> 6, kk = kl & 63;
          const int bit = kk & 31, b = bit >> 3, pp_ = (bit >> 2) & 1, ln = 2 * (kk >> 5) + pp_;
          // element e has r = 4 pp + e: i = 3 - e for either nibble
          __half* base = (__half*)bfrag + (sg * 4 * CS * 32 + ln) * 4 + b;
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            int cs0, g0, cs1, g1;
            if (BM == 4) { cs0 = cs1 = 0; g0 = m; g1 = m + 4; }
            else { cs0 = (m >> 3) * 2; cs1 = cs0 + 1; g0 = g1 = m & 7; }
            const float u = up[m];
            const float xs[4] = {v[m].x * u, v[m].y * u, v[m].z * u, v[m].w * u};
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const __half2 t1 = __floats2half2_rn(xs[2 * e2], xs[2 * e2 + 1]);
              const float2 back = __half22float2(t1);
              const __half2 t2 =
                  __floats2half2_rn(xs[2 * e2] - back.x, xs[2 * e2 + 1] - back.y);
              const int i0 = 3 - 2 * e2, i1 = 2 - 2 * e2;
              base[((i0 * CS + cs0) * 32 + g0 * 4) * 4] = __low2half(t1);
              base[((i1 * CS + cs0) * 32 + g0 * 4) * 4] = __high2half(t1);
              base[((i0 * CS + cs1) * 32 + g1 * 4) * 4] = __low2half(t2);
              base[((i1 * CS + cs1) * 32 + g1 * 4) * 4] = __high2half(t2);
            }
          }
        }
      }
      if (a.stages == 4) cp_wait<2>();
      else if (a.stages == 3) cp_wait<1>();
      else cp_wait<0>();
      __syncthreads();  // the stage and the chunk's fragments are in place; the last slot is free
      issue();
      const uint8_t* slot = ring + slot_c * a.stage_bytes;
      slot_c = slot_c + 1 == a.stages ? 0 : slot_c + 1;
      const uint32_t* planes = (const uint32_t*)slot;
      const uint8_t* shs = slot + a.plane_bytes;
      const int k0 = s * KS;

      // 3. this warp's 64-k step: rebuild, 4 mma steps per 16-column tile
      if (k0 + ss * 64 < K) {
        const int wl = 2 * ss + w;
        const int g_lo = GEN ? k0 / a.group : k0 >> a.lg;
        const uint2* bf = bfrag + (sl * 4 + ss) * 4 * CS * 32 + lane;
        int rb[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rb[b] = GEN ? 0 : ((k0 + 64 * ss + 32 * w + 8 * b + 4 * p) >> a.lg) - g_lo;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t A[4][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = 32 * nw + 16 * mt + 8 * half + g;
            const uint32_t* pw = planes + wl * RSW + c;
            const uint32_t sw = pw[0] << sh;
            uint32_t mw[NS], P[NS];
#pragma unroll
            for (int j = 0; j < NS; ++j)
              mw[j] = j >= NS_FIRST && (!GEN || j < ns) ? pw[(1 + j) * 8 * RSW] << sh : 0u;
            if (!GEN) {  // one group row per byte for the lane's 4 weights of it
              uint32_t h[4];
#pragma unroll
              for (int b = 0; b < 4; ++b) h[b] = load_shift<SB>(shs, a.rss, a.sb, rb[b], c);
              build_powers<NS>(h, false, P);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (GEN) {  // any group: each weight's own group row
                uint32_t h[4];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                  const int k = k0 + 64 * ss + 32 * w + 8 * b + 7 - (sh + i);
                  h[b] = load_shift<SB>(shs, a.rss, a.sb,
                                        min(k / a.group - g_lo, a.shift_rows - 1), c);
                }
                build_powers<NS>(h, a.consecutive, P);
              }
              rebuild4<NS>(sw, mw, P, i, A[i][half], A[i][2 + half]);
            }
          }
#pragma unroll
          for (int cs = 0; cs < CS; ++cs) {
            float C[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint2 bb = bf[(i * CS + cs) * 32];
              mma16816(C, A[i], bb.x, bb.y);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][cs][q] += C[q];
          }
        }
      }
      sl = sl + 1 == a.chunk_stages ? 0 : sl + 1;
    }
    x_key = key;

    // 4. the four K warps' sums and the two fp16 terms added in a fixed
    //    order, times 2^-sigma, 2^24 (the weights' subnormal scale) and the
    //    column scale
    __syncthreads();  // every warp is done with the fragments
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int cs = 0; cs < CS; ++cs) {
        const int c = 32 * nw + 16 * mt + g;
        float* r = red + ((ss * CS + cs) * 8 + 2 * tid) * BN;
        r[c] = acc[mt][cs][0];
        r[BN + c] = acc[mt][cs][1];
        r[c + 8] = acc[mt][cs][2];
        r[BN + c + 8] = acc[mt][cs][3];
      }
    __syncthreads();
    const float* scale = a.scale + (size_t)e * N;
    float* out = a.out + (size_t)e * M * N;
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int m = idx / BN, n = idx % BN;
      if (m0 + m >= M || n0 + n >= N) continue;
      int cs0, g0, cs1, g1;
      if (BM == 4) { cs0 = cs1 = 0; g0 = m; g1 = m + 4; }
      else { cs0 = (m >> 3) * 2; cs1 = cs0 + 1; g0 = g1 = m & 7; }
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v += red[((q * CS + cs0) * 8 + g0) * BN + n] + red[((q * CS + cs1) * 8 + g1) * BN + n];
      out[(size_t)(m0 + m) * N + n0 + n] = v * pmax[m * 2] * 16777216.f * scale[n0 + n];
    }
  }
  cp_wait<0>();
}

template <int NS, int BM, bool GEN>
int launch(Args a, int n_experts, cudaStream_t st) {
  constexpr int CS = BM <= 4 ? 1 : BM / 4;
  a.m_tiles = (a.M + BM - 1) / BM;
  a.n_experts = n_experts;
  auto al = [](int v) { return (v + 15) & ~15; };
  a.plane_bytes = al((NS + 1) * 8 * RSW * 4);
  a.shift_bytes_stage = al(a.shift_rows * a.rss);
  a.stage_bytes = a.plane_bytes + a.shift_bytes_stage;
  const int n_ks = (a.K + KS - 1) / KS;
  const int frag_stage = KS * 8 * CS * 2;  // fp16 B fragments of one stage's x
  const int red = 4 * CS * 8 * BN * 4;     // a tile's partial sums
  const int pair = 113 * 1024;             // two blocks to an SM
  const int limit = 227 * 1024;
  // the sums lie over the fragments when x is converted more than once a
  // tile (then no tile finds the fragments of the last)
  auto need = [&](int stages, int chunk) {
    const int frags = chunk * frag_stage;
    return stages * a.stage_bytes + (chunk < n_ks ? std::max(frags, red) : frags + red) +
           3 * BM * 4;
  };
  // two blocks to an SM: a 3-slot ring and all of x converted once; else a
  // 4-slot (or 3-slot) ring and x converted a few stages at a time; else one
  // block to an SM
  int stages = 0, chunk = 0, per_sm = 2;
  const int tries[3][2] = {{3, n_ks}, {4, std::min(n_ks, 2)}, {3, std::min(n_ks, 2)}};
  for (const auto& t : tries) {
    int c = std::min(n_ks, 64);
    while (c >= t[1] && need(t[0], c) > pair) --c;
    if (c >= t[1]) {
      stages = t[0];
      chunk = c;
      break;
    }
  }
  if (!stages) {
    per_sm = 1;
    stages = 4;
    while (stages > 2 && need(stages, 1) > limit) --stages;
    chunk = std::min(n_ks, 64);
    while (chunk > 1 && need(stages, chunk) > limit) --chunk;
  }
  chunk = (n_ks + (n_ks + chunk - 1) / chunk - 1) / ((n_ks + chunk - 1) / chunk);  // even chunks
  a.stages = stages;
  a.chunk_stages = chunk;
  a.frag_off = stages * a.stage_bytes;
  a.red_off = chunk < n_ks ? a.frag_off : a.frag_off + chunk * frag_stage;
  a.up_off = std::max(a.frag_off + chunk * frag_stage, a.red_off + red);
  const size_t smem = (size_t)a.up_off + 3 * BM * 4;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  auto kern = swis_experts_kernel<NS, BM, GEN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks, as many as are resident at once, each a contiguous
  // share of the tiles
  const long long tiles = (long long)n_experts * a.m_tiles * ((a.N + BN - 1) / BN);
  if (tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<long long>(tiles, (long long)per_sm * sm_count());
  kern<<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_ns(const Args& a, int n_shifts, int n_experts, cudaStream_t st) {
  switch (n_shifts) {
    case 1: return launch<1, BM, false>(a, n_experts, st);
    case 2: return launch<2, BM, false>(a, n_experts, st);
    case 3: return launch<3, BM, false>(a, n_experts, st);
    case 4: return launch<4, BM, false>(a, n_experts, st);
    case 5: return launch<5, BM, false>(a, n_experts, st);
    case 6: return launch<6, BM, false>(a, n_experts, st);
    case 7: return launch<7, BM, false>(a, n_experts, st);
    case 8: return launch<8, BM, false>(a, n_experts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_experts(int x_dtype, const void* x, long long x_estride, const void* sign,
                   const void* masks, const void* shifts, const void* scale, void* out,
                   int n_experts, int M, int K, int N, int group, int n_shifts, int first,
                   int consecutive, int shift_bytes, cudaStream_t st) {
  const int esize = x_dtype == 0 ? 4 : 2;
  const int sb = consecutive ? 1 : (n_shifts + 1) / 2;
  if (n_shifts < 1 || n_shifts > 8 || first < 0 || first >= n_shifts || K % 32 != 0 ||
      group < 1 || K % group != 0 || M < 1 || N < 1 || shift_bytes != sb || n_experts < 1 ||
      x_estride < 0 || (x_dtype != 0 && x_dtype != 1) || ((uintptr_t)x & 15u) != 0 ||
      (x_estride * esize) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* q, unsigned n) { return ((uintptr_t)q & (n - 1)) == 0; };
  Args a = {};
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
  a.sb = sb;
  a.n_shifts = n_shifts;
  a.x_bf16 = x_dtype == 1;
  a.x_estride = x_estride;
  a.lg = -1;
  if (group >= 4 && (group & (group - 1)) == 0)
    for (a.lg = 0; (1 << a.lg) < group; ++a.lg) {}
  // every group row a lane of a stage can name, past K included
  a.shift_rows = a.lg >= 0 ? std::max(KS >> a.lg, 1) : (KS - 1) / group + 2;
  a.rss = BN * sb + (a.lg >= 0 ? 16 : 0);
  a.plane_chunk = N % 4 == 0 && aligned(sign, 16) && aligned(masks, 16) ? 16 : 4;
  a.shift_chunk = (N * sb) % 16 == 0 && aligned(shifts, 16) ? 16
                  : (N * sb) % 4 == 0 && aligned(shifts, 4) ? 4 : 1;
  a.shift_per = BN * sb / a.shift_chunk;
  a.shift_magic = (unsigned)((0x100000000ull + a.shift_per - 1) / a.shift_per);
  if (a.lg < 0 || consecutive || a.plane_chunk != 16 || a.shift_chunk != 16)
    return launch<8, 16, true>(a, n_experts, st);
  if (M <= 4) return launch_ns<4>(a, n_shifts, n_experts, st);
  if (M <= 8) return launch_ns<8>(a, n_shifts, n_experts, st);
  return launch_ns<16>(a, n_shifts, n_experts, st);
}

}  // namespace xk

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
  return xk::launch_experts(x_dtype, x, x_estride, sign, masks, shifts, scale, out, n_experts,
                            M, K, N, group, n_shifts, first, consecutive, shift_bytes,
                            (cudaStream_t)stream);
}
