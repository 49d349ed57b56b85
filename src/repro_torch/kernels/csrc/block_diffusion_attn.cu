// Block-diffusion (block-causal) attention for Hopper (sm_90a): normalised
// attention over a whole position-aligned sequence, bidirectional inside a
// diffusion block and causal across blocks.
//
// Replaces the Pallas TPU kernel `_kernel` / `block_diffusion_attention_
// kernel` in src/repro/kernels/block_diffusion_attn.py and computes what it
// computes:
//   q [B,T,H,D]; k, v [B,T,KVH,D] (float or bf16); lengths [B] int32.
//   Query t sees key j when j/bs <= t/bs and j < lengths[b] (bs 1: causal).
//   out [B,T,H,D] in q's dtype = acc / max(l, 1e-30), so a row with no
//   visible key (a batch-padding entry with lengths 0) is exactly 0.
//
// Bound: at the SDAR-8B wave shape (T 512, bs 32) the live work is
//   4*D*H*sum(visible keys) FLOPs (~13 GFLOP a layer) against ~25 MB of q,
//   k, v and out; at T 2048 the FLOPs bound it (989 TFLOP/s bf16 on the
//   tensor cores).  Either way the work belongs on the tensor cores.
//
// Both bodies share the grid (B, KVH, ceil(T*G / 64)).  GQA without copies:
// the G query heads of one KV head fold into a block's rows, position-major
// (row r -> position r / G, head g = r % G), so a 64-row tile covers 64/G
// positions of every head that shares the K/V it stages.  Block-causal
// tile skip: a tile whose last position is t_hi reads keys only below
// min(lengths[b], (t_hi/bs + 1)*bs), the `pl.when` skip of the Pallas body;
// each row masks at its own limit min(lengths[b], (t/bs + 1)*bs).  Any T
// and any block size: ragged edges are masked, not asserted away.
//
// bf16, body "tensor_core" (the default): 4 warps x 16 rows on the shared
// tile of attn_tile.cuh: S = QK^T and O += PV by mma.sync.m16n8k16 (bf16
// in, fp32 accumulate), Q in registers, K/V tiles of 64 keys by cp.async
// into a two-stage ring (one barrier a tile), P kept in registers and
// rounded to bf16 as the Pallas body does.  A warp skips the products of a
// tile that lies past its last row's limit.  Three blocks an SM: at the
// wave shape a row tile walks only a few K/V tiles, so much of a block's
// life is its first load, which the other blocks' compute covers.  The
// grid's z axis is walked from the last row tile to the first, so the
// tiles with the most keys start first and the short ones fill in behind
// them.  Left for later: wgmma with TMA loads and a persistent grid.
//
// float32, and bf16 under body "cuda_core": the first design, unchanged.
// K and V tiles of 32 keys (one per lane) are staged in shared memory as
// fp32; each warp owns 8 rows and keeps their online-softmax state and
// accumulator in fp32 registers; QK^T and PV are fp32 FMAs.  TF32 tensor
// cores would miss the fp32 tolerance (2e-5), so fp32 stays here.
//
// Numerics as the Pallas body: fp32 scores, fp32 online softmax with the
// finite sentinel -1e30, masked probabilities set to 0 (so a masked tile
// never adds exp(0)), probabilities rounded to v's type before PV
// (e.astype(v.dtype)) while l sums the unrounded values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn_tile::kNegInf;

// ---------------------------------------------------------------------------
// body "cuda_core": fp32 FMAs (float32, and bf16 when forced)
// ---------------------------------------------------------------------------


constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRPW = 8;              // rows per warp
constexpr int kRows = kWarps * kRPW;  // rows per block
constexpr int kKeys = 32;            // keys per tile: one per lane

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

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Keys visible to position t: min(len, (t/bs + 1)*bs), in 64 bits so a huge
// block size cannot overflow.
__device__ __forceinline__ int key_limit(int t, int bs, int len) {
  const long long hi = (static_cast<long long>(t / bs) + 1) * bs;
  return hi < len ? static_cast<int>(hi) : len;
}

template <int D>
constexpr size_t smem_bytes() {
  // q rows, K tile (rows padded by 4 floats), V tile, probabilities
  return sizeof(float) * (size_t(kRows) * D + size_t(kKeys) * (D + 4) +
                          size_t(kKeys) * D + size_t(kRows) * kKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_diffusion_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int T_len, int H, int KVH,
                            int bs, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KS = D + 4;
  constexpr int DPL = (D + 31) / 32;  // PV columns per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* k_s = q_s + kRows * D;                  // [kKeys][KS]
  float* v_s = k_s + kKeys * KS;                 // [kKeys][D]
  float* p_s = v_s + kKeys * D;                  // [kRows][kKeys]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const int R = G * T_len;
  const int row0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = max(0, min(lengths[b], T_len));
  const int t_hi = (min(row0 + kRows, R) - 1) / G;
  const int kend = key_limit(t_hi, bs, len);

  // stage this block's q rows (zeros past R)
  for (int e = tid; e < kRows * (D / VEC); e += kThreads) {
    const int r = e / (D / VEC);
    const int d = (e % (D / VEC)) * VEC;
    float* dst = q_s + r * D + d;
    const int gr = row0 + r;
    if (gr < R) {
      const int t = gr / G, g = gr % G;
      load16<T>(q + ((size_t(b) * T_len + t) * H + kvh * G + g) * D + d, dst);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = 0.f;
    }
  }

  float m_r[kRPW], l_r[kRPW], acc[kRPW][DPL];
  int lim[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int gr = row0 + warp * kRPW + rr;
    lim[rr] = gr < R ? key_limit(gr / G, bs, len) : 0;
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[rr][t] = 0.f;
  }
  const float* q_w = q_s + warp * kRPW * D;
  float* p_w = p_s + warp * kRPW * kKeys;

  for (int t0 = 0; t0 < kend; t0 += kKeys) {
    __syncthreads();  // q staged / previous tile's K, V consumed
    for (int e = tid; e < kKeys * (D / VEC); e += kThreads) {
      const int j = e / (D / VEC);
      const int d = (e % (D / VEC)) * VEC;
      const int pos = t0 + j;
      float* kd = k_s + j * KS + d;
      float* vd = v_s + j * D + d;
      if (pos < kend) {
        const size_t off = ((size_t(b) * T_len + pos) * KVH + kvh) * D + d;
        load16<T>(k + off, kd);
        load16<T>(v + off, vd);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    // scores: lane <-> key t0 + lane, for each of this warp's rows
    float s[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) s[rr] = 0.f;
    const float* kr = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + rr * D + d);
        s[rr] = fmaf(qv.x, kv.x, s[rr]);
        s[rr] = fmaf(qv.y, kv.y, s[rr]);
        s[rr] = fmaf(qv.z, kv.z, s[rr]);
        s[rr] = fmaf(qv.w, kv.w, s[rr]);
      }
    }

    // online softmax (fp32) under each row's own key limit
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const bool ok = key < lim[rr];
      const float x = ok ? s[rr] * scale : kNegInf;
      const float m_new = fmaxf(m_r[rr], warp_max(x));
      const float corr = expf(m_r[rr] - m_new);
      const float e = ok ? expf(x - m_new) : 0.f;
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
      for (int rr = 0; rr < kRPW; ++rr) {
        const float p = p_w[rr * kKeys + j];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[rr][t] = fmaf(p, vv[t], acc[rr][t]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int gr = row0 + warp * kRPW + rr;
    if (gr >= R) continue;
    const int t = gr / G, g = gr % G;
    const size_t o = ((size_t(b) * T_len + t) * H + kvh * G + g) * D;
    const float den = fmaxf(l_r[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (D % 32 == 0 || lane + 32 * c < D)
        out[o + lane + 32 * c] = from_float<T>(acc[rr][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch_cuda_core(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int B,
                             int T_len, int H, int KVH, int bs, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = block_diffusion_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int R = (H / KVH) * T_len;
  const dim3 grid(B, KVH, (R + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), T_len, H, KVH, bs, scale);
  return cudaGetLastError();
}



// ---------------------------------------------------------------------------
// body "tensor_core": bf16 on the shared mma.sync tile
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = kMmaWarps * attn_tile::kRows;  // rows per block
// Blocks an SM holds: the short row tiles of a wave are mostly prologue
// (first K/V tile in flight), so three let two compute while one waits.
constexpr int kMmaBlocksPerSM = 3;

template <int D>
constexpr size_t mma_smem_bytes() {
  // K and V rings of two 64-key tiles each (Q lives in registers)
  return sizeof(__nv_bfloat16) * 4 * size_t(attn_tile::Geom<D>::kTileElems);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
block_diffusion_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ lengths,
                                __nv_bfloat16* __restrict__ out, int T_len,
                                int H, int KVH, int bs, float scale) {
  using Gm = attn_tile::Geom<D>;
  using attn_tile::kKeys;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + 2 * Gm::kTileElems;  // [2][kKeys][kStride] each

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int zi = gridDim.z - 1 - blockIdx.z;  // the longest row tiles first
  const int G = H / KVH;
  const int R = G * T_len;
  const int row0 = zi * kMmaRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = max(0, min(lengths[b], T_len));
  const int kend = key_limit((min(row0 + kMmaRows, R) - 1) / G, bs, len);
  const int n_tiles = (kend + kKeys - 1) / kKeys;

  const int wrow = row0 + warp * attn_tile::kRows;
  const int r0 = wrow + (lane >> 2), r1 = r0 + 8;
  attn_tile::Warp<D> w;
  w.init(r0 < R ? key_limit(r0 / G, bs, len) : 0,
         r1 < R ? key_limit(r1 / G, bs, len) : 0);
  // the warp's largest limit is its last live row's
  const int wlim =
      wrow < R ? key_limit((min(wrow + attn_tile::kRows, R) - 1) / G, bs, len)
               : 0;
  auto q_row = [&](int gr) -> const __nv_bfloat16* {
    if (gr >= R) return nullptr;
    return q + ((size_t(b) * T_len + gr / G) * H + kvh * G + gr % G) * D;
  };

  if (n_tiles > 0) {
    const size_t kv_row = size_t(KVH) * D;  // elements between positions
    const __nv_bfloat16* kb = k + size_t(b) * T_len * kv_row + size_t(kvh) * D;
    const __nv_bfloat16* vb = v + size_t(b) * T_len * kv_row + size_t(kvh) * D;
    auto load_kv = [&](int i, int st) {
      const int key0 = i * kKeys;
      attn_tile::load_rows<D, kMmaThreads>(
          k_s + st * Gm::kTileElems, kKeys, k,
          [&](int j) -> const __nv_bfloat16* {
            return key0 + j < kend ? kb + size_t(key0 + j) * kv_row : nullptr;
          },
          tid);
      attn_tile::load_rows<D, kMmaThreads>(
          v_s + st * Gm::kTileElems, kKeys, v,
          [&](int j) -> const __nv_bfloat16* {
            return key0 + j < kend ? vb + size_t(key0 + j) * kv_row : nullptr;
          },
          tid);
    };
    load_kv(0, 0);
    attn_tile::cp_async_commit();
    if (wrow < R) w.load_q(q_row(r0), q_row(r1), lane);
    const float scale2 = scale * attn_tile::kLog2e;
    for (int i = 0; i < n_tiles; ++i) {
      attn_tile::cp_async_wait<0>();  // tile i landed
      __syncthreads();  // ... for every thread; tile i-1's buffer is free
      if (i + 1 < n_tiles) {
        load_kv(i + 1, (i + 1) & 1);
        attn_tile::cp_async_commit();
      }
      if (i * kKeys < wlim)
        w.step(k_s + (i & 1) * Gm::kTileElems, v_s + (i & 1) * Gm::kTileElems,
               i * kKeys, scale2, lane);
    }
  }
  w.finish();

  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = r ? r1 : r0;
    if (gr >= R) continue;
    const size_t o =
        ((size_t(b) * T_len + gr / G) * H + kvh * G + gr % G) * D;
    const float den = fmaxf(w.l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < Gm::kNO; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(out + o + d) =
            __floats2bfloat162_rn(w.o[n][2 * r] / den,
                                  w.o[n][2 * r + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_tensor_core(const void* q, const void* k, const void* v,
                               const void* lengths, void* out, int B,
                               int T_len, int H, int KVH, int bs, float scale,
                               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kern = block_diffusion_attn_mma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const int R = (H / KVH) * T_len;
  const dim3 grid(B, KVH, (R + kMmaRows - 1) / kMmaRows);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), T_len, H, KVH, bs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, int body, const void* q,
                       const void* k, const void* v, const void* lengths,
                       void* out, int B, int T_len, int H, int KVH, int bs,
                       float scale, cudaStream_t stream) {
#define REPRO_HEAD_DIM(d)                                                   \
  if (D == d) {                                                             \
    if (body == 0)                                                          \
      return launch_cuda_core<T, d>(q, k, v, lengths, out, B, T_len, H,     \
                                    KVH, bs, scale, stream);                \
    if constexpr (sizeof(T) == 2)                                           \
      return launch_tensor_core<d>(q, k, v, lengths, out, B, T_len, H, KVH, \
                                   bs, scale, stream);                      \
    return cudaErrorInvalidValue;                                           \
  }
  REPRO_HEAD_DIM(8)
  REPRO_HEAD_DIM(16)
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(112)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  head_dim: 8, 16, 32, 64, 112 (Kimi K2) or
// 128.  block_size >= 1.  body: 0 the fp32 CUDA-core body, 1 the
// tensor-core body (bfloat16 only).  Returns the CUDA error of the launch (0 on success), or
// -1 for a dtype this library was not built for.
extern "C" int block_diffusion_attn(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int T_len, int H,
                                    int KVH, int D, int block_size,
                                    float scale, int dtype, int body,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(D, body, q, k, v, lengths, out, B, T_len, H,
                             KVH, block_size, scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, body, q, k, v, lengths, out, B,
                                     T_len, H, KVH, block_size, scale, st);
  return -1;
}
