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
// Bound: at decode shapes the work is ~4*ctx*c*H*D FLOPs against ctx*KVH*D*2
//   KV bytes per request, so the KV bytes read from HBM (3.35 TB/s) bound
//   it; the tensor cores would finish the FLOPs sooner.  What keeps a
//   kernel from that bound is too few blocks in flight (B*KVH = 64 at
//   SDAR-8B decode, for 132 SMs), one long row holding the grid while the
//   short ones idle, and loads that do not overlap compute.
//
// bf16, body "tensor_core" (the default):
//   grid (ceil(G*c / BR), KVH, B*S).  GQA folds the G query heads of one KV
//   head with the c chunk rows into R = G*c rows, position-major (row r ->
//   chunk row r / G, head g = r % G); one block holds up to BR = 128 of them
//   (8 warps x 16; 4 warps when R <= 64), so at decode every page is read
//   once per split, not once per row tile.  Split-KV decided on the device:
//   the block with split s of row b reads ctx_lens[b] itself and takes the
//   s-th of S equal, 64-key-aligned parts of that row's live keys, so every
//   split of a long row does the same work and a split past a short row's
//   context is done at once.  S comes from shapes alone (the wrapper never
//   reads a device tensor).  The block first copies its slice
//   of the block table into shared memory; each 64-key tile is then a
//   cp.async gather of 256-byte page rows into the two-stage ring of
//   attn_tile.cuh, and QK^T and PV run on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 accumulate), with Q in registers.  P enters PV
//   in three bf16 parts (kPParts), so it keeps fp32 precision where the
//   Pallas body rounds it to bf16: these partials feed every layer of every
//   decode dispatch, and through 36 layers of SDAR-8B the bf16 rounding of
//   P (even in a plain implementation) flips committed tokens whose top-1
//   and top-2 logits lie further apart than chip_smoke.py's model phase
//   allows, while fp32 P stays inside it at every split count.  The three
//   parts cost the PV product 3x its mma.sync work.  With S > 1 the live
//   splits write
//   their partials to a scratch [S,B,c,H,D+2] (an empty split writes
//   nothing) and the second kernel here merges them on the card: the exact
//   log-sum-exp merge of merge_flash_partials, one warp a row, reading only
//   the row's live splits.  At c 1 only G = 4 of a warp's 16 rows are
//   live; the kernel is byte-bound there, so the idle rows cost little.
//   Left for later: wgmma (64-row warpgroup tiles), TMA, a persistent grid
//   that would fold the merge into the last split to finish.
//
// float32, and bf16 under body "cuda_core": the first design, unchanged.
//   grid (B, KVH, ceil(G*c / BR)), BR = 8 * RPW rows; each block walks its
//   row's live keys in tiles of 32 (one key per lane), K and V staged in
//   shared memory as fp32, each warp owning RPW rows (1 or 8, picked by the
//   row count or forced) with fp32 FMAs on the CUDA cores.  TF32 tensor
//   cores would miss the fp32 tolerance (2e-5), so fp32 stays here.
//
// Numerics: as the Pallas body, the probabilities are rounded to v's type
// before PV (e.astype(v.dtype)) while l sums the unrounded values.

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
cudaError_t launch_cuda_core(const void* q, const void* k, const void* v,
                             const void* tables, const void* ctx, void* acc,
                             void* m, void* l, int B, int c, int H, int KVH,
                             int ps, int n_slots, float scale,
                             cudaStream_t stream) {
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
    return launch_cuda_core<T, D, 1>(q, k, v, tables, ctx, acc, m, l, B, c,
                                     H, KVH, ps, n_slots, scale, stream);
  if (rpw == 8)
    return launch_cuda_core<T, D, 8>(q, k, v, tables, ctx, acc, m, l, B, c,
                                     H, KVH, ps, n_slots, scale, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// body "tensor_core": bf16 on the shared mma.sync tile, split-KV
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// P enters PV in three bf16 parts (fp32 precision): see the note above.
constexpr int kPParts = 3;

template <int D>
constexpr size_t mma_smem_bytes() {
  // K and V rings of two 64-key tiles each (Q lives in registers); the
  // table slice follows
  return sizeof(__nv_bfloat16) * 4 * size_t(attn_tile::Geom<D>::kTileElems);
}

// Partials of split s go to acc + s*split_stride + row*acc_stride (D
// floats) and m/l + s*split_stride + row*ml_stride, row = (b*c + ci)*H + h:
// the final layout when S is 1, the [S,B,c,H,D+2] scratch otherwise.
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
paged_chunk_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pages,
                            const __nv_bfloat16* __restrict__ v_pages,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ ctx_lens,
                            float* __restrict__ acc, float* __restrict__ m_out,
                            float* __restrict__ l_out, long long acc_stride,
                            long long ml_stride, long long split_stride, int c,
                            int H, int KVH, int ps, int n_slots, int S,
                            float scale) {
  using Gm = attn_tile::Geom<D>;
  using attn_tile::kKeys;
  constexpr int NT = NW * 32;
  constexpr int BR = NW * attn_tile::kRows;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + 2 * Gm::kTileElems;  // [2][kKeys][kStride] each
  int* tab_s = reinterpret_cast<int*>(v_s + 2 * Gm::kTileElems);

  const int kvh = blockIdx.y;
  const int b = blockIdx.z / S;
  const int s = blockIdx.z % S;
  const int G = H / KVH;
  const int R = G * c;
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // this split's keys: the s-th of S equal 64-key-aligned parts of the row
  const int ctx = max(0, min(ctx_lens[b], n_slots * ps));
  const int row_tiles = (ctx + kKeys - 1) / kKeys;
  const int per = (row_tiles + S - 1) / S;
  const int t_lo = s * per;
  const int n_tiles = min(row_tiles, t_lo + per) - t_lo;
  const int kbeg = t_lo * kKeys;
  const int kend = min(ctx, kbeg + n_tiles * kKeys);

  // with S > 1 the merge reads only live splits, so an empty one is done
  if (n_tiles <= 0 && S > 1) return;

  const int wrow = row0 + warp * attn_tile::kRows;
  const int r0 = wrow + (lane >> 2), r1 = r0 + 8;
  attn_tile::Warp<D, kPParts> w;
  w.init(r0 < R ? kend : 0, r1 < R ? kend : 0);

  if (n_tiles > 0) {
    const int* table = block_tables + size_t(b) * n_slots;
    const int slot0 = kbeg / ps;
    const int n_tab = (kend - 1) / ps - slot0 + 1;
    for (int i = tid; i < n_tab; i += NT) tab_s[i] = table[slot0 + i];
    __syncthreads();  // the table slice is visible
    auto load_kv = [&](int i, int st) {
      const int key0 = kbeg + i * kKeys;
      auto row = [&](const __nv_bfloat16* pages, int j) {
        const int p = key0 + j;
        if (p >= kend) return static_cast<const __nv_bfloat16*>(nullptr);
        const size_t page = size_t(tab_s[p / ps - slot0]);
        return pages + ((page * ps + p % ps) * KVH + kvh) * D;
      };
      attn_tile::load_rows<D, NT>(
          k_s + st * Gm::kTileElems, kKeys, k_pages,
          [&](int j) { return row(k_pages, j); }, tid);
      attn_tile::load_rows<D, NT>(
          v_s + st * Gm::kTileElems, kKeys, v_pages,
          [&](int j) { return row(v_pages, j); }, tid);
    };
    load_kv(0, 0);
    attn_tile::cp_async_commit();
    const bool live = wrow < R;
    auto q_row = [&](int gr) -> const __nv_bfloat16* {
      if (gr >= R) return nullptr;
      return q + ((size_t(b) * c + gr / G) * H + kvh * G + gr % G) * D;
    };
    if (live) w.load_q(q_row(r0), q_row(r1), lane);
    const float scale2 = scale * attn_tile::kLog2e;
    for (int i = 0; i < n_tiles; ++i) {
      attn_tile::cp_async_wait<0>();  // tile i landed
      __syncthreads();  // ... for every thread; tile i-1's buffer is free
      if (i + 1 < n_tiles) {
        load_kv(i + 1, (i + 1) & 1);
        attn_tile::cp_async_commit();
      }
      if (live)
        w.step(k_s + (i & 1) * Gm::kTileElems, v_s + (i & 1) * Gm::kTileElems,
               kbeg + i * kKeys, scale2, lane);
    }
  }
  w.finish();

  const int tig = lane & 3;
  const long long so = s * split_stride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = r ? r1 : r0;
    if (gr >= R) continue;
    const long long row = (size_t(b) * c + gr / G) * H + kvh * G + gr % G;
    float* a = acc + so + row * acc_stride;
#pragma unroll
    for (int n = 0; n < Gm::kNO; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < D)
        *reinterpret_cast<float2*>(a + d) =
            make_float2(w.o[n][2 * r], w.o[n][2 * r + 1]);
    }
    if (tig == 0) {
      m_out[so + row * ml_stride] = w.m_natural(r);
      l_out[so + row * ml_stride] = w.l[r];
    }
  }
}

// The merge of S split partials [S, rows, D+2] (acc, m, l) into acc
// [rows, D], m and l [rows]: one warp a row, the exact log-sum-exp merge of
// merge_flash_partials in its order (m_g the max, then acc and l summed
// over s of part * exp(m_s - m_g), each product rounded before its add).
// It reads only the row's live splits, found from ctx_lens[b] as the split
// kernel cuts them: an empty split (which wrote nothing) would add exactly
// 0, and a row with none is the empty partial (acc 0, m -1e30, l 0).
template <int D>
__global__ void __launch_bounds__(256)
paged_chunk_attn_merge_kernel(const float* __restrict__ part,
                              const int* __restrict__ ctx_lens,
                              float* __restrict__ acc,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out, int rows,
                              int row_per_b, int ps, int n_slots, int S,
                              long long split_stride) {
  constexpr int PER = (D + 31) / 32;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int ctx = max(0, min(ctx_lens[row / row_per_b], n_slots * ps));
  const int row_tiles = (ctx + attn_tile::kKeys - 1) / attn_tile::kKeys;
  const int per = (row_tiles + S - 1) / S;
  const int n_live = per > 0 ? (row_tiles + per - 1) / per : 0;
  const float* p = part + size_t(row) * (D + 2);
  float mg = kNegInf;
  for (int s = 0; s < n_live; ++s) mg = fmaxf(mg, p[s * split_stride + D]);
  float a[PER], lg = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) a[i] = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float* part_s = p + s * split_stride;
    const float corr = expf(part_s[D] - mg);
    lg = __fadd_rn(lg, __fmul_rn(part_s[D + 1], corr));
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D)
        a[i] = __fadd_rn(a[i], __fmul_rn(part_s[d], corr));
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    if (D % 32 == 0 || d < D) acc[size_t(row) * D + d] = a[i];
  }
  if (lane == 0) {
    m_out[row] = mg;
    l_out[row] = lg;
  }
}

template <int D, int NW>
cudaError_t launch_tensor_core_nw(const void* q, const void* k, const void* v,
                                  const void* tables, const void* ctx,
                                  void* acc, void* m, void* l, void* scratch,
                                  int B, int c, int H, int KVH, int ps,
                                  int n_slots, int S, float scale,
                                  cudaStream_t stream) {
  constexpr int BR = NW * attn_tile::kRows;
  auto kern = paged_chunk_attn_mma_kernel<D, NW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  // the longest table slice a split can need: its tiles' slots, plus one
  // for a tile that starts inside a page
  constexpr int kKeys = attn_tile::kKeys;
  const int row_tiles = (n_slots * ps + kKeys - 1) / kKeys;
  const int per = (row_tiles + S - 1) / S;
  const int tab = (per * kKeys + ps - 1) / ps + 1;
  const size_t smem = mma_smem_bytes<D>() + sizeof(int) * size_t(tab);
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  const int R = (H / KVH) * c;
  const dim3 grid((R + BR - 1) / BR, KVH, B * S);
  const long long rows = (long long)B * c * H;
  float* a = static_cast<float*>(acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  long long acc_stride = D, ml_stride = 1, split_stride = 0;
  if (S > 1) {  // partials to the scratch, then the merge
    a = static_cast<float*>(scratch);
    mo = a + D;
    lo = a + D + 1;
    acc_stride = ml_stride = D + 2;
    split_stride = rows * (D + 2);
  }
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), a, mo, lo, acc_stride, ml_stride,
      split_stride, c, H, KVH, ps, n_slots, S, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  paged_chunk_attn_merge_kernel<D>
      <<<unsigned((rows + 7) / 8), 256, 0, stream>>>(
          a, static_cast<const int*>(ctx), static_cast<float*>(acc),
          static_cast<float*>(m), static_cast<float*>(l), int(rows), c * H,
          ps, n_slots, S, split_stride);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tensor_core(const void* q, const void* k, const void* v,
                               const void* tables, const void* ctx, void* acc,
                               void* m, void* l, void* scratch, int B, int c,
                               int H, int KVH, int ps, int n_slots, int S,
                               float scale, cudaStream_t stream) {
  // 4 warps hold up to 64 rows (a decode chunk of up to 16 positions, and
  // AR), 8 warps up to 128; more rows tile over the grid's x axis.
  // pick_splits (chunked_paged_attn.py) counts resident blocks by this.
  if ((H / KVH) * c <= 4 * attn_tile::kRows)
    return launch_tensor_core_nw<D, 4>(q, k, v, tables, ctx, acc, m, l,
                                       scratch, B, c, H, KVH, ps, n_slots, S,
                                       scale, stream);
  return launch_tensor_core_nw<D, 8>(q, k, v, tables, ctx, acc, m, l, scratch,
                                     B, c, H, KVH, ps, n_slots, S, scale,
                                     stream);
}

template <typename T>
cudaError_t launch_dim(int D, int body, int rpw, int S, const void* q,
                       const void* k, const void* v, const void* tables,
                       const void* ctx, void* acc, void* m, void* l,
                       void* scratch, int B, int c, int H, int KVH, int ps,
                       int n_slots, float scale, cudaStream_t stream) {
  const int rows = (H / KVH) * c;
#define REPRO_HEAD_DIM(d)                                                    \
  if (D == d) {                                                              \
    if (body == 0)                                                           \
      return launch_rows<T, d>(rpw, rows, q, k, v, tables, ctx, acc, m, l,   \
                               B, c, H, KVH, ps, n_slots, scale, stream);    \
    if constexpr (sizeof(T) == 2)                                            \
      return launch_tensor_core<d>(q, k, v, tables, ctx, acc, m, l, scratch, \
                                   B, c, H, KVH, ps, n_slots, S, scale,      \
                                   stream);                                  \
    return cudaErrorInvalidValue;                                            \
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
// 128.  body: 0 the fp32 CUDA-core body (rpw: rows per warp, 0 by row
// count, 1 or 8), 1 the tensor-core body (bfloat16 only) with S >= 1
// splits; S > 1 needs a float32 scratch of S*B*c*H*(D+2) and launches the
// merge kernel after the split kernel.  Returns the CUDA error of the launches (0 on success), or
// -1 for a dtype this library was not built for.
extern "C" int paged_chunk_attn(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* ctx_lens, void* acc, void* m,
                                void* l, void* scratch, int B, int c, int H,
                                int KVH, int D, int ps, int n_slots,
                                float scale, int dtype, int body, int rpw,
                                int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && scratch == nullptr)) return -1;
  if (dtype == 0)
    return launch_dim<float>(D, body, rpw, splits, q, k_pages, v_pages,
                             block_tables, ctx_lens, acc, m, l, scratch, B, c,
                             H, KVH, ps, n_slots, scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, body, rpw, splits, q, k_pages,
                                     v_pages, block_tables, ctx_lens, acc, m,
                                     l, scratch, B, c, H, KVH, ps, n_slots,
                                     scale, st);
  return -1;
}
