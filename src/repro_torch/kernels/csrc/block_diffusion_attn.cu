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
// Design (simple first; the grid of the chunked paged kernel):
//   grid (B, KVH, ceil(T*G / 64)).  GQA without copies: the G query heads
//   of one KV head are folded into the block's rows, position-major (row
//   r -> position r / G, head g = r % G), so a 64-row tile covers 64/G
//   consecutive positions of every head that shares the K/V it stages; the
//   Pallas wrapper's G-fold jnp.repeat of K and V is gone.  Block-causal
//   tile skip: a tile whose last position is t_hi reads keys only below
//   min(lengths[b], (t_hi/bs + 1)*bs), the `pl.when` skip of the Pallas
//   body; inside it each row masks at its own limit min(lengths[b],
//   (t/bs + 1)*bs).  Any T and any block size: the ragged edges are masked
//   here, not asserted away.  K and V tiles of 32 keys (one per lane) are
//   staged in shared memory as fp32; each warp owns 8 rows and keeps their
//   online-softmax state and accumulator in fp32 registers.  QK^T and PV
//   are fp32 FMAs: no library call, no tensor cores.
//
// Bound: at the SDAR-8B wave shape (T 512, bs 32) the live work is
//   4*D*H*sum(visible keys) FLOPs (~18 GFLOP a layer) against ~25 MB of
//   q, k, v and out, so the tensor cores (989 TFLOP/s bf16) would bound it
//   above the bytes.  This design runs on the CUDA cores instead (67
//   TFLOP/s fp32) and re-reads K/V once per row tile (from L2 when the
//   tiles of one (b, kv head) run together).  wgmma tiles, TMA loads and
//   splitting long key ranges across blocks are later work.
//
// Numerics as the Pallas body: fp32 scores, fp32 online softmax with the
// finite sentinel -1e30, masked probabilities set to 0 (so a masked tile
// never adds exp(0)), probabilities rounded to v's type before PV
// (e.astype(v.dtype)) while l sums the unrounded values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
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
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int T_len, int H,
                   int KVH, int bs, float scale, cudaStream_t stream) {
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

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       const void* lengths, void* out, int B, int T_len, int H,
                       int KVH, int bs, float scale, cudaStream_t stream) {
#define REPRO_HEAD_DIM(d)                                                    \
  if (D == d)                                                                \
    return launch<T, d>(q, k, v, lengths, out, B, T_len, H, KVH, bs, scale, \
                        stream);
  REPRO_HEAD_DIM(8)
  REPRO_HEAD_DIM(16)
  REPRO_HEAD_DIM(32)
  REPRO_HEAD_DIM(64)
  REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  head_dim: 8, 16, 32, 64 or 128.
// block_size >= 1.  Returns the CUDA error of the launch (0 on success), or
// -1 for a dtype this library was not built for.
extern "C" int block_diffusion_attn(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int T_len, int H,
                                    int KVH, int D, int block_size,
                                    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(D, q, k, v, lengths, out, B, T_len, H, KVH,
                             block_size, scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, q, k, v, lengths, out, B, T_len, H,
                                     KVH, block_size, scale, st);
  return -1;
}
