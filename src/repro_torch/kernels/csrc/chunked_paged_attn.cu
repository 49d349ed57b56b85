// Chunked paged attention for Hopper (sm_90a): flash partials of c chunk
// queries per request against that request's paged KV prefix.
//
// Replaces the Pallas TPU kernel `_kernel` / `paged_chunk_attention_kernel`
// in src/repro/kernels/chunked_paged_attn.py and computes exactly what it
// computes:
//   q [B,c,H,D]; k/v pages [P,ps,KVH,D] (float or bf16); block_tables
//   [B,n_slots] int32; ctx_lens [B] int32.  Keys at positions >= ctx_lens[b]
//   are masked.  Outputs, written straight into the ungrouped layout:
//   acc [B,c,H,D] fp32 (unnormalised), m and l [B,c,H] fp32, head h =
//   kvh*G + g.  A row with ctx 0 emits acc 0, m = -1e30, l 0 (the finite
//   sentinel keeps the downstream merge free of exp(-inf - -inf) = NaN).
//
// Design (simple first):
//   grid (B, KVH, ceil(G*c / BR)).  GQA folds the G query heads of one KV
//   head with the c chunk rows into R = G*c rows; each block owns BR of them
//   (row r -> chunk row r / G, head g = r % G), so a prefill chunk of
//   thousands of rows tiles over many blocks instead of one giant tile.
//   Each block loads its own ctx_lens[b] and walks only the live keys in
//   tiles of 32 (one key per lane), reading each key's page from
//   block_tables; padded table entries past ctx are never read.  K and V
//   tiles are staged in shared memory as fp32; every warp owns RPW rows and
//   keeps their online-softmax state (m, l) and accumulator in fp32
//   registers.  QK^T and PV are fp32 FMAs in this body: no library call, no
//   tensor cores.
//
// Bound: at decode shapes the work is ~4*ctx*c*H*D FLOPs against ctx*KVH*D*2
//   KV bytes per request; on the H100 the KV bytes read from HBM (3.35 TB/s)
//   bound it, since the tensor cores would finish the FLOPs sooner.  This
//   design does not reach that bound: fp32 FMAs on the CUDA cores (67
//   TFLOP/s) make it compute-bound well above it, and each of the
//   ceil(G*c/BR) row blocks of one (b, kvh) re-reads the same pages (from L2
//   when they run together).  Tensor-core tiles (wgmma), TMA page loads and
//   splitting long contexts across blocks are later work.
//
// Numerics: as the Pallas body, the probabilities are rounded to v's type
// before PV (e.astype(v.dtype)) while l sums the unrounded values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;  // keys per tile: one per lane

// One 16-byte global load (4 floats or 8 bf16) widened to fp32 and stored
// to 16-byte-aligned shared memory.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst);

template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* src,
                                                      float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int RPW>
constexpr size_t smem_bytes() {
  // q rows, K tile (rows padded by 4 floats), V tile, probabilities
  return sizeof(float) * (size_t(kWarps * RPW) * D + size_t(kKeys) * (D + 4) +
                          size_t(kKeys) * D + size_t(kWarps * RPW) * kKeys);
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_chunk_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int c, int H, int KVH, int ps,
                        int n_slots, float scale) {
  constexpr int BR = kWarps * RPW;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KS = D + 4;
  constexpr int DPL = (D + 31) / 32;  // PV columns per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BR][D]
  float* k_s = q_s + BR * D;                     // [kKeys][KS]
  float* v_s = k_s + kKeys * KS;                 // [kKeys][D]
  float* p_s = v_s + kKeys * D;                  // [BR][kKeys]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const int R = G * c;
  const int row0 = blockIdx.z * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ctx = min(ctx_lens[b], n_slots * ps);
  const int* table = block_tables + size_t(b) * n_slots;

  // stage this block's q rows (zeros past R)
  for (int e = tid; e < BR * (D / VEC); e += kThreads) {
    const int r = e / (D / VEC);
    const int d = (e % (D / VEC)) * VEC;
    float* dst = q_s + r * D + d;
    const int gr = row0 + r;
    if (gr < R) {
      const int ci = gr / G, g = gr % G;
      load16<T>(q + ((size_t(b) * c + ci) * H + kvh * G + g) * D + d, dst);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = 0.f;
    }
  }

  float m_r[RPW], l_r[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[rr][t] = 0.f;
  }
  const float* q_w = q_s + warp * RPW * D;
  float* p_w = p_s + warp * RPW * kKeys;

  for (int t0 = 0; t0 < ctx; t0 += kKeys) {
    __syncthreads();  // q staged / previous tile's K, V consumed
    for (int e = tid; e < kKeys * (D / VEC); e += kThreads) {
      const int j = e / (D / VEC);
      const int d = (e % (D / VEC)) * VEC;
      const int pos = t0 + j;
      float* kd = k_s + j * KS + d;
      float* vd = v_s + j * D + d;
      if (pos < ctx) {
        const size_t page = size_t(table[pos / ps]);
        const size_t off = ((page * ps + pos % ps) * KVH + kvh) * D + d;
        load16<T>(k_pages + off, kd);
        load16<T>(v_pages + off, vd);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    // scores: lane <-> key t0 + lane, for each of this warp's rows
    float s[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr] = 0.f;
    const float* kr = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + rr * D + d);
        s[rr] = fmaf(qv.x, kv.x, s[rr]);
        s[rr] = fmaf(qv.y, kv.y, s[rr]);
        s[rr] = fmaf(qv.z, kv.z, s[rr]);
        s[rr] = fmaf(qv.w, kv.w, s[rr]);
      }
    }

    // online softmax (fp32), probabilities to shared memory
    const bool valid = t0 + lane < ctx;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float x = valid ? s[rr] * scale : kNegInf;
      const float m_new = fmaxf(m_r[rr], warp_max(x));
      const float corr = expf(m_r[rr] - m_new);
      const float e = valid ? expf(x - m_new) : 0.f;
      l_r[rr] = l_r[rr] * corr + warp_sum(e);
      m_r[rr] = m_new;
      p_w[rr * kKeys + lane] = round_to<T>(e);
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[rr][t] *= corr;
    }
    __syncwarp();

    // acc += P V: lane owns columns lane + 32*t
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        vv[t] = (D % 32 == 0 || lane + 32 * t < D) ? v_s[j * D + lane + 32 * t]
                                                    : 0.f;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float p = p_w[rr * kKeys + j];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[rr][t] = fmaf(p, vv[t], acc[rr][t]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int gr = row0 + warp * RPW + rr;
    if (gr >= R) continue;
    const int ci = gr / G, g = gr % G;
    const size_t o = (size_t(b) * c + ci) * H + kvh * G + g;
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      if (D % 32 == 0 || lane + 32 * t < D)
        acc_out[o * D + lane + 32 * t] = acc[rr][t];
    if (lane == 0) {
      m_out[o] = m_r[rr];
      l_out[o] = l_r[rr];
    }
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* ctx, void* acc, void* m,
                   void* l, int B, int c, int H, int KVH, int ps, int n_slots,
                   float scale, cudaStream_t stream) {
  constexpr int BR = kWarps * RPW;
  constexpr size_t smem = smem_bytes<D, RPW>();
  auto kern = paged_chunk_attn_kernel<T, D, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int R = (H / KVH) * c;
  const dim3 grid(B, KVH, (R + BR - 1) / BR);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), c, H, KVH, ps, n_slots,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(int rpw, int rows, const void* q, const void* k,
                        const void* v, const void* tables, const void* ctx,
                        void* acc, void* m, void* l, int B, int c, int H,
                        int KVH, int ps, int n_slots, float scale,
                        cudaStream_t stream) {
  // rpw 0 picks by rows: few rows (AR: G rows per KV head) take one row a
  // warp, so no warp spends FMAs on padded rows; more rows take 8 a warp,
  // so each staged K/V tile serves 64 rows.  1 or 8 forces a tiling.
  if (rpw == 0) rpw = rows <= kWarps ? 1 : 8;
  if (rpw == 1)
    return launch<T, D, 1>(q, k, v, tables, ctx, acc, m, l, B, c, H, KVH, ps,
                           n_slots, scale, stream);
  if (rpw == 8)
    return launch<T, D, 8>(q, k, v, tables, ctx, acc, m, l, B, c, H, KVH, ps,
                           n_slots, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dim(int D, int rpw, int rows, const void* q, const void* k,
                       const void* v, const void* tables, const void* ctx,
                       void* acc, void* m, void* l, int B, int c, int H,
                       int KVH, int ps, int n_slots, float scale,
                       cudaStream_t stream) {
#define REPRO_HEAD_DIM(d)                                                    \
  if (D == d)                                                                \
    return launch_rows<T, d>(rpw, rows, q, k, v, tables, ctx, acc, m, l, B, \
                             c, H, KVH, ps, n_slots, scale, stream);
  REPRO_HEAD_DIM(8)
  REPRO_HEAD_DIM(16)
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  head_dim: 8, 16, 32, 64 or 128.  rpw:
// rows per warp, 0 (by row count), 1 or 8.  Returns the CUDA error of the
// launch (0 on success), or -1 for a dtype this library was not built for.
extern "C" int paged_chunk_attn(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* ctx_lens, void* acc, void* m,
                                void* l, int B, int c, int H, int KVH, int D,
                                int ps, int n_slots, float scale, int dtype,
                                int rpw, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (H / KVH) * c;
  if (dtype == 0)
    return launch_dim<float>(D, rpw, rows, q, k_pages, v_pages, block_tables,
                             ctx_lens, acc, m, l, B, c, H, KVH, ps, n_slots,
                             scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, rpw, rows, q, k_pages, v_pages,
                                     block_tables, ctx_lens, acc, m, l, B, c,
                                     H, KVH, ps, n_slots, scale, st);
  return -1;
}
