// Paged GQA attention over the KV block arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel`, launched by
// `_paged_attention_pallas` in src/repro/kernels/paged_attention.py (public
// entry `paged_attention_decode`). Same function: for slot b and kv-head h, the
// Sq*G query rows (folded Sq-major: row i*G + g' is query i of head g') attend
// over the physical blocks that block_tables[b, :] names, read in place; the
// gathered K/V is never built. Softmax runs online with fp32 running max,
// denominator and accumulator: masked scores take the float32 mask fill `neg`,
// the same value the running max starts from, and the output is
// acc / max(l, 1e-30).
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
// byte, and a decode launch moves well under a megabyte, so what it really
// waits on is latency: the launch and each chain of dependent global loads
// (table entry, then K/V). The design keeps that chain to two loads deep:
//   * the logical blocks are split across a thread block cluster of up to 8
//     blocks for each (b, h), and within each block across its 4 warps (split-KV,
//     as in flash-decoding); the block reads its slice of the table once, up
//     front, with the scaled queries;
//   * each warp copies the K/V rows of up to `chunk` logical blocks into shared
//     memory at once (16-byte `cp.async` where rows allow it), then scores them
//     for all Sq*G rows and updates its own (m, l, acc) block by block, with the
//     recurrence of the TPU kernel;
//   * the query rows are cut into the fewest equal row tiles of at most 32
//     rows whose staging (scaled queries, scores, per-warp accumulators) fits
//     the shared memory, one cluster per (b, kv-head, tile): a verify or mixed
//     launch with many queries (Sq*G up to prefill_chunk*G) runs whatever its
//     Sq, with more blocks in flight, and a decode launch stays one tile. Rows
//     never interact, so tiles change no result. A masked score skips its dot
//     product (the padded queries of a mixed launch's decode rows);
//   * the warps' partials are merged in shared memory, and the blocks' partials
//     by the cluster's first block through distributed shared memory, both in a
//     fixed order, so the result does not depend on scheduling and one launch
//     does it all. A partial that saw only masked scores has m = neg: in a fully
//     masked row every weight exp(m_i - m) is 1, so the output stays the mean of
//     V over every position the table visits (trash block included), and in a
//     row with a valid score its weight is 0, as in the sequential recurrence.
// It calls neither a library attention nor cuDNN.
//
// What the chip run showed (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W):
// one decode launch (B 4, 9 heads over 3 KV heads, Dh 64, block size 8, 16
// logical blocks, fp32 cache) takes 0.0091 ms against 0.0205 ms for SDPA over
// the gathered K/V (the first version, one block per (b, h) walking the blocks
// in a chain of barriers: 0.048 ms); at 128 logical blocks 0.0189 ms against
// 0.122 ms (first version 0.380 ms).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_CHUNK = 8;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_TILE_ROWS = 32;  // query rows a block stages at most

struct Args {
  const float* q4;
  const void* k;
  const void* v;
  const int* pos;
  const int* tables;
  const int* q_pos;
  const int* q_lens;
  float* out;
  int hkv, sg, g, dh, nb, bs, causal, has_window, window;
  float q_scale, neg;
  int blocks_per_cta;  // logical blocks per cluster rank
  int chunk;           // logical blocks a warp stages at once
  int vec;             // 1: K/V rows are copied 16 bytes at a time
  int rows;            // query rows per row tile (the last tile may hold fewer)
  int tiles;           // row tiles per (b, kv-head)
};

// Shared-memory layout, in bytes; every region starts 16-byte aligned. All
// sizes fit an int: the wrapper refuses more than MAX_SMEM bytes.
struct Layout {
  int qstride;   // floats per staged query row
  int kvstride;  // bytes per staged K or V row
  int qs, tab, wt, mf, lf, wq, lfin, warp0, warp_bytes;
  int kst, vst, ps, sc, acc, m, l, alpha;  // offsets inside one warp's region
  long long total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int esize, int sg, int dh, int bs, int bpc,
                                              int chunk) {
  constexpr int F = sizeof(float);
  Layout L;
  L.qstride = ((dh + 3) / 4) * 4 + 4;
  L.kvstride = align16(dh * esize) + 16;
  int o = 0;
  L.qs = o;   o = align16(o + F * sg * L.qstride);
  L.tab = o;  o = align16(o + F * bpc);
  L.wt = o;   o = align16(o + F * WARPS * sg);
  L.mf = o;   o = align16(o + F * sg);
  L.lf = o;   o = align16(o + F * sg);
  L.wq = o;   o = align16(o + F * MAX_CLUSTER * sg);
  L.lfin = o; o = align16(o + F * sg);
  int w = 0;
  L.kst = w;   w = align16(w + chunk * bs * L.kvstride);
  L.vst = w;   w = align16(w + chunk * bs * L.kvstride);
  L.ps = w;    w = align16(w + F * chunk * bs);
  L.sc = w;    w = align16(w + F * sg * bs);
  L.acc = w;   w = align16(w + F * sg * dh);
  L.m = w;     w = align16(w + F * sg);
  L.l = w;     w = align16(w + F * sg);
  L.alpha = w; w = align16(w + F * sg);
  L.warp0 = o;
  L.warp_bytes = w;
  L.total = o + (long long)WARPS * w;
  return L;
}

struct Config {
  int cs, bpc, chunk, rows, tiles;
  Layout L;
};

// The query rows are cut into the fewest equal tiles of at most
// MAX_TILE_ROWS rows whose staging fits the shared memory (each tile a
// cluster of its own, K/V staged once per tile); within a tile, a warp
// stages as many logical blocks at once as still fit.
Config make_config(int esize, int sg, int dh, int bs, int nb) {
  Config c;
  c.cs = std::min(MAX_CLUSTER, (nb + WARPS - 1) / WARPS);
  c.bpc = (nb + c.cs - 1) / c.cs;
  for (c.tiles = (sg + MAX_TILE_ROWS - 1) / MAX_TILE_ROWS;; ++c.tiles) {
    c.rows = (sg + c.tiles - 1) / c.tiles;
    c.chunk = std::min(MAX_CHUNK, (c.bpc + WARPS - 1) / WARPS);
    c.L = make_layout(esize, c.rows, dh, bs, c.bpc, c.chunk);
    while (c.chunk > 1 && c.L.total > MAX_SMEM) {
      --c.chunk;
      c.L = make_layout(esize, c.rows, dh, bs, c.bpc, c.chunk);
    }
    if (c.L.total <= MAX_SMEM || c.rows == 1) break;
  }
  return c;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __half22float2(*(const __half2*)&u.x);
  const float2 b = __half22float2(*(const __half2*)&u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.tiles;
  const int row0 = (blockIdx.z % a.tiles) * a.rows;  // this tile's first query row
  const int sg = min(a.rows, a.sg - row0);            // query rows in this tile
  const int dh = a.dh, bs = a.bs, hkv = a.hkv;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const Layout L = make_layout((int)sizeof(T), a.rows, dh, bs, a.blocks_per_cta, a.chunk);

  float* qs = (float*)(smem + L.qs);
  int* tab = (int*)(smem + L.tab);
  unsigned char* wbase = smem + L.warp0 + warp * L.warp_bytes;
  T* kst = (T*)(wbase + L.kst);
  T* vst = (T*)(wbase + L.vst);
  int* ps = (int*)(wbase + L.ps);
  float* sc = (float*)(wbase + L.sc);
  float* acc = (float*)(wbase + L.acc);
  float* m = (float*)(wbase + L.m);
  float* l = (float*)(wbase + L.l);
  float* alpha = (float*)(wbase + L.alpha);
  const int kvs = L.kvstride / (int)sizeof(T);  // elements per staged row
  const int qst = L.qstride;

  const int qp = a.q_pos[b];
  const int ql = a.q_lens[b];
  const size_t qoff = (((size_t)b * hkv + h) * a.sg + row0) * dh;
  const int j_lo = rank * a.blocks_per_cta;
  const int j_hi = min(a.nb, j_lo + a.blocks_per_cta);

  // prologue: the scaled queries and this rank's slice of the table, read once
  for (int i = threadIdx.x; i < sg * dh; i += THREADS) {
    const int r = i / dh;
    qs[r * qst + (i - r * dh)] = a.q4[qoff + i] * a.q_scale;
  }
  for (int j = j_lo + (int)threadIdx.x; j < j_hi; j += THREADS)
    tab[j - j_lo] = a.tables[(size_t)b * a.nb + j];
  for (int r = lane; r < sg; r += 32) {
    m[r] = a.neg;
    l[r] = 0.f;
  }
  for (int i = lane; i < sg * dh; i += 32) acc[i] = 0.f;
  __syncthreads();

  const T* karena = (const T*)a.k;
  const T* varena = (const T*)a.v;
  const int row_chunks = dh * (int)sizeof(T) / 16;  // 16-byte pieces per row (vec path)

  // warp w takes logical blocks j_lo + w, j_lo + w + WARPS, ...; `chunk` at a time
  for (int j0 = j_lo + warp; j0 < j_hi; j0 += WARPS * a.chunk) {
    const int nc = min(a.chunk, (j_hi - j0 + WARPS - 1) / WARPS);
    // stage K, V and positions of nc logical blocks
    if (a.vec) {
      const int per_block = bs * row_chunks;
      for (int i = lane; i < nc * per_block; i += 32) {
        const int c = i / per_block;
        const int rem = i - c * per_block;
        const int t = rem / row_chunks;
        const int q = rem - t * row_chunks;
        const int phys = tab[j0 + c * WARPS - j_lo];
        const size_t off = (((size_t)phys * bs + t) * hkv + h) * dh;
        const int so = (c * bs + t) * L.kvstride + q * 16;
        cp_async16((unsigned char*)kst + so, (const unsigned char*)(karena + off) + q * 16);
        cp_async16((unsigned char*)vst + so, (const unsigned char*)(varena + off) + q * 16);
      }
    } else {
      for (int i = lane; i < nc * bs * dh; i += 32) {
        const int c = i / (bs * dh);
        const int rem = i - c * bs * dh;
        const int t = rem / dh;
        const int d = rem - t * dh;
        const int phys = tab[j0 + c * WARPS - j_lo];
        const size_t off = (((size_t)phys * bs + t) * hkv + h) * dh + d;
        kst[(c * bs + t) * kvs + d] = karena[off];
        vst[(c * bs + t) * kvs + d] = varena[off];
      }
    }
    for (int i = lane; i < nc * bs; i += 32) {
      const int c = i / bs;
      const int phys = tab[j0 + c * WARPS - j_lo];
      ps[i] = phys == 0 ? -1 : a.pos[(size_t)phys * bs + (i - c * bs)];  // trash: masked
    }
    cp_async_wait_all();
    __syncwarp();

    for (int c = 0; c < nc; ++c) {
      const T* kb = kst + c * bs * kvs;
      const T* vb = vst + c * bs * kvs;
      // scores of every (row, position) of the block; a masked score is
      // `neg` whatever the dot product, so it is not computed
      for (int i = lane; i < sg * bs; i += 32) {
        const int r = i / bs;
        const int t = i - r * bs;
        const int qi = (row0 + r) / a.g;
        const int p = ps[c * bs + t];
        bool valid = p >= 0 && qi < ql;
        if (a.causal) valid = valid && p <= qp + qi;
        if (a.has_window) valid = valid && p > qp + qi - a.window;
        float s = a.neg;
        if (valid) {
          const float* qr = qs + r * qst;
          const T* kr = kb + t * kvs;
          float s0 = 0.f, s1 = 0.f;
          int d = 0;
          for (; d + 4 <= dh; d += 4) {
            const float4 qv = *(const float4*)(qr + d);
            const float4 kv = load4(kr + d);
            s0 = fmaf(qv.x, kv.x, s0);
            s1 = fmaf(qv.y, kv.y, s1);
            s0 = fmaf(qv.z, kv.z, s0);
            s1 = fmaf(qv.w, kv.w, s1);
          }
          for (; d < dh; ++d) s0 = fmaf(qr[d], to_f32(kr[d]), s0);
          s = s0 + s1;
        }
        sc[i] = s;
      }
      __syncwarp();
      // the online-softmax step of each row
      for (int r = lane; r < sg; r += 32) {
        float mx = sc[r * bs];
        for (int t = 1; t < bs; ++t) mx = fmaxf(mx, sc[r * bs + t]);
        const float m_prev = m[r];
        const float m_new = fmaxf(m_prev, mx);
        const float al = expf(m_prev - m_new);
        float sum = 0.f;
        for (int t = 0; t < bs; ++t) {
          const float pr = expf(sc[r * bs + t] - m_new);
          sc[r * bs + t] = pr;
          sum += pr;
        }
        m[r] = m_new;
        l[r] = l[r] * al + sum;
        alpha[r] = al;
      }
      __syncwarp();
      // acc = acc * alpha + p @ V
      for (int i = lane; i < sg * dh; i += 32) {
        const int r = i / dh;
        const int d = i - r * dh;
        float pv = 0.f;
        for (int t = 0; t < bs; ++t) pv = fmaf(sc[r * bs + t], to_f32(vb[t * kvs + d]), pv);
        acc[i] = acc[i] * alpha[r] + pv;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' partials, in warp order, into warp 0's acc and (mf, lf)
  float* wt = (float*)(smem + L.wt);
  float* mf = (float*)(smem + L.mf);
  float* lf = (float*)(smem + L.lf);
  auto warp_f = [&](int w, int off) {
    return (float*)(smem + L.warp0 + w * L.warp_bytes + off);
  };
  for (int r = threadIdx.x; r < sg; r += THREADS) {
    float mx = warp_f(0, L.m)[r];
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, warp_f(w, L.m)[r]);
    float lsum = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(warp_f(w, L.m)[r] - mx);
      wt[w * sg + r] = e;
      lsum += warp_f(w, L.l)[r] * e;
    }
    mf[r] = mx;
    lf[r] = lsum;
  }
  __syncthreads();
  float* acc0 = warp_f(0, L.acc);
  for (int i = threadIdx.x; i < sg * dh; i += THREADS) {
    const int r = i / dh;
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += warp_f(w, L.acc)[i] * wt[w * sg + r];
    acc0[i] = v;
  }
  cluster.sync();  // every block's (mf, lf, acc0) is written

  // the cluster's first block merges the blocks' partials, in rank order
  if (rank == 0) {
    float* wq = (float*)(smem + L.wq);
    float* lfin = (float*)(smem + L.lfin);
    for (int r = threadIdx.x; r < sg; r += THREADS) {
      float mx = mf[r];
      for (int q = 1; q < cs; ++q) mx = fmaxf(mx, cluster.map_shared_rank(mf, q)[r]);
      float lsum = 0.f;
      for (int q = 0; q < cs; ++q) {
        const float e = expf(cluster.map_shared_rank(mf, q)[r] - mx);
        wq[q * sg + r] = e;
        lsum += cluster.map_shared_rank(lf, q)[r] * e;
      }
      lfin[r] = lsum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < sg * dh; i += THREADS) {
      const int r = i / dh;
      float v = 0.f;
      for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(acc0, q)[i] * wq[q * sg + r];
      a.out[qoff + i] = v / fmaxf(lfin[r], 1e-30f);
    }
  }
  cluster.sync();  // the other blocks keep their shared memory until rank 0 has read it
}

template <typename T>
int launch(const Args& a, const Config& c, int B, cudaStream_t st) {
  auto kern = paged_attention_kernel<T>;
  const size_t smem = c.L.total;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cs, a.hkv, B * c.tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int esize_of(int kv_dtype) { return kv_dtype == 0 ? 4 : 2; }

}  // namespace

// Dynamic shared memory one block needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" int paged_attention_smem_bytes(int kv_dtype, int sg, int dh, int bs, int nb) {
  return (int)make_config(esize_of(kv_dtype), sg, dh, bs, nb).L.total;
}

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp16. Launches once on `stream` and
// returns cudaGetLastError().
extern "C" int paged_attention_launch(int kv_dtype, const void* q4, const void* k, const void* v,
                                      const void* pos, const void* tables, const void* q_pos,
                                      const void* q_lens, void* out, int B, int hkv, int sg,
                                      int g, int dh, int nb, int bs, int causal, int has_window,
                                      int window, float q_scale, float neg, void* stream) {
  if (B < 1 || hkv < 1 || sg < 1 || g < 1 || sg % g != 0 || dh < 1 || dh > 256 || nb < 1 ||
      bs < 1 || kv_dtype < 0 || kv_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int esize = esize_of(kv_dtype);
  const Config c = make_config(esize, sg, dh, bs, nb);
  if (c.L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a;
  a.q4 = (const float*)q4;
  a.k = k;
  a.v = v;
  a.pos = (const int*)pos;
  a.tables = (const int*)tables;
  a.q_pos = (const int*)q_pos;
  a.q_lens = (const int*)q_lens;
  a.out = (float*)out;
  a.hkv = hkv;
  a.sg = sg;
  a.g = g;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.q_scale = q_scale;
  a.neg = neg;
  a.blocks_per_cta = c.bpc;
  a.chunk = c.chunk;
  a.rows = c.rows;
  a.tiles = c.tiles;
  a.vec = ((size_t)dh * esize) % 16 == 0 && ((uintptr_t)k & 15u) == 0 &&
          ((uintptr_t)v & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_dtype) {
    case 0: return launch<float>(a, c, B, st);
    case 1: return launch<__nv_bfloat16>(a, c, B, st);
    default: return launch<__half>(a, c, B, st);
  }
}
