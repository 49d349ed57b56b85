// The tensor-core attention tile shared by the bf16 bodies of
// block_diffusion_attn.cu and chunked_paged_attn.cu (included by both; not
// a library of its own).
//
// One warp owns 16 query rows.  Its Q fragment is loaded once, straight
// from global memory, and stays in registers for the whole key loop.  Per
// 64-key tile:
//   S = Q K^T   mma.sync.m16n8k16 (bf16 x bf16 -> fp32), K by ldmatrix;
//   softmax     online, in fp32 on the accumulator fragments: the -1e30
//               sentinel, keys at or past the row's limit masked to
//               probability 0, l summing the unrounded probabilities;
//   O += P V    P rounded to bf16 in registers and fed straight back as the
//               A operand (the FlashAttention-2 register reuse: P never
//               goes to shared memory), V by ldmatrix.trans.  With
//               kParts > 1, P enters PV as that many bf16 parts (bf16(p),
//               then bf16 of what is left, ...), one product each: three
//               parts keep P to fp32 precision (2^-24), so the partials
//               carry no more rounding than an fp32 product would.
// Scores are kept in log2 units (scale * log2(e) folded into one multiply,
// exp2 on the SFU); m leaves the tile in natural units (m_natural()).
// K and V tiles (64 keys x D bf16) arrive by cp.async, 16 bytes a thread,
// into a two-stage ring the kernel drives (load_rows + commit/wait), so
// tile i+1 is in flight while tile i is computed.  Shared rows are padded
// by 16 bytes, so the eight row addresses of every ldmatrix phase fall in
// eight different bank groups: no bank conflicts.  A head dim under 16
// (the SMOKE config's 8) is padded to 16 with zeros as it is loaded, so
// the products see zeros there and the epilogue writes only d < D.
//
// Built with mma.sync + cp.async, not wgmma + TMA: the paged kernel's K/V
// tiles are gathers of 256-byte rows through a block table, not TMA boxes,
// and mma.sync lets one tile serve both kernels at 16-row granularity.
// wgmma (64-row warpgroup tiles, operands from shared memory) with TMA and
// mbarriers is the route to the card's full bf16 rate, for a later change.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr float kNegInf = -1e30f;
constexpr int kKeys = 64;  // keys per K/V tile
constexpr int kRows = 16;  // query rows per warp

// Shared-memory geometry of one head dim: rows of DP bf16 (D padded to 16)
// plus 8 bf16 (16 bytes) of padding.
template <int D>
struct Geom {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int kStride = DP + 8;  // bf16 elements per shared row
  static constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  static constexpr int kKC = DP / 16;     // k-steps of QK^T
  static constexpr int kNO = DP / 8;      // n-tiles (8 columns) of O
  static constexpr int kTileElems = kKeys * kStride;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; when !pred the 16 bytes are
// zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x - float(bf16(x)): what bf16 rounding leaves of x
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// cp.async rows [0, n) of a [kKeys or more][kStride] shared tile: row j
// comes from src(j) (a pointer to D contiguous bf16, or nullptr for a row
// of zeros); the padding columns D..DP are zeros.  All NT threads call it.
template <int D, int NT, typename Src>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int n,
                                          const __nv_bfloat16* valid_ptr,
                                          Src src, int tid) {
  using Gm = Geom<D>;
  for (int e = tid; e < n * Gm::kChunks; e += NT) {
    const int j = e / Gm::kChunks;
    const int cc = (e % Gm::kChunks) * 8;
    const __nv_bfloat16* p = src(j);
    const bool ok = p != nullptr && cc < D;
    cp_async16(dst + j * Gm::kStride + cc, ok ? p + cc : valid_ptr, ok);
  }
}

// The state of one warp's 16 rows.  Thread lane holds rows lane/4 and
// lane/4 + 8 of the warp; its O fragment covers columns 8n + 2(lane%4) +
// {0, 1} of every n-tile.  m is the running max in log2 units.  kParts:
// the bf16 parts P enters PV in (1 rounds P to bf16, as the Pallas bodies
// do).
template <int D, int kParts = 1>
struct Warp {
  using Gm = Geom<D>;
  uint32_t q[Gm::kKC][4];
  float o[Gm::kNO][4];
  float m[2], l[2];
  int lim[2];  // keys at or past lim[i] are masked for row i

  __device__ __forceinline__ void init(int lim0, int lim1) {
#pragma unroll
    for (int n = 0; n < Gm::kNO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    lim[0] = lim0;
    lim[1] = lim1;
  }

  // Q fragment straight from global memory: row0 and row1 point at the D
  // bf16 of the thread's rows lane/4 and lane/4 + 8 (nullptr for a padding
  // row, which reads as zeros), so Q takes no shared memory.
  __device__ __forceinline__ void load_q(const __nv_bfloat16* row0,
                                         const __nv_bfloat16* row1,
                                         int lane) {
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int kc = 0; kc < Gm::kKC; ++kc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = kc * 16 + h * 8 + c0;
        const bool in = col < D;
        q[kc][2 * h] = row0 && in ? __ldg(reinterpret_cast<const unsigned*>(
                                        row0 + col))
                                  : 0u;
        q[kc][2 * h + 1] = row1 && in ? __ldg(reinterpret_cast<const unsigned*>(
                                            row1 + col))
                                      : 0u;
      }
  }

  // One 64-key tile at key positions key0 .. key0+63 from shared K and V
  // tiles [kKeys][kStride]; scale2 is the softmax scale times log2(e).
  __device__ __forceinline__ void step(const __nv_bfloat16* k_s,
                                       const __nv_bfloat16* v_s, int key0,
                                       float scale2, int lane) {
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // S = Q K^T.  ldmatrix x4 of K rows: matrices (keys 0-7, d 0-7),
    // (keys 0-7, d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15) of each
    // 16x16 block = the B fragments of two 8-key n-tiles.
#pragma unroll
    for (int kc = 0; kc < Gm::kKC; ++kc) {
#pragma unroll
      for (int jj = 0; jj < kKeys / 16; ++jj) {
        uint32_t b[4];
        const int key = jj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int d = kc * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, smem_u32(k_s + key * Gm::kStride + d));
        mma_bf16(s[2 * jj], q[kc], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], q[kc], b[2], b[3]);
      }
    }

    // online softmax in fp32; element e of n-tile j is row e/2, key
    // key0 + 8j + 2(lane%4) + e%2.  A tile wholly inside both rows'
    // limits skips the per-key mask.
    const int kl = key0 + 2 * (lane & 3);
    const bool whole = key0 + kKeys <= min(lim[0], lim[1]);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = whole || kl + 8 * j + (e & 1) < lim[r]
                            ? s[j][e] * scale2
                            : kNegInf;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = whole || kl + 8 * j + (e & 1) < lim[r]
                            ? fast_exp2(s[j][e] - m[r])
                            : 0.f;
        s[j][e] = p;
        rs[r] += p;
      }
    // l is this thread's share of the row sum; the quad adds at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int n = 0; n < Gm::kNO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V.  P's A fragment for keys 16kk..16kk+15 is the S
    // accumulators of n-tiles 2kk and 2kk+1, rounded to bf16 (each further
    // part: what the earlier parts' rounding left).  ldmatrix x4
    // .trans of V rows: matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7),
    // (keys 0-7, d 8-15), (keys 8-15, d 8-15) = the B fragments of two
    // 8-column n-tiles.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[kParts][4];
#pragma unroll
      for (int t = 0; t < kParts; ++t) {
        float* p0 = s[2 * kk];
        float* p1 = s[2 * kk + 1];
        a[t][0] = pack_bf16(p0[0], p0[1]);
        a[t][1] = pack_bf16(p0[2], p0[3]);
        a[t][2] = pack_bf16(p1[0], p1[1]);
        a[t][3] = pack_bf16(p1[2], p1[3]);
        if (t + 1 < kParts) {  // keep what this part's rounding left
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p0[e] = bf16_rest(p0[e]);
            p1[e] = bf16_rest(p1[e]);
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < Gm::DP / 16; ++nd) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 15);
        const int d = nd * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, smem_u32(v_s + key * Gm::kStride + d));
#pragma unroll
        for (int t = 0; t < kParts; ++t) {
          mma_bf16(o[2 * nd], a[t], b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a[t], b[2], b[3]);
        }
      }
    }
  }

  // Row r's max logit in natural units (the -1e30 sentinel when it saw no
  // key).
  __device__ __forceinline__ float m_natural(int r) const {
    return m[r] == kNegInf ? kNegInf : m[r] * kLn2;
  }

  // Sum l over the quad that shares each row (after the last step).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

}  // namespace attn_tile
