// Dense-bias attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_attention / _attn_kernel in
// multimodal_context_reasoning_tpu/ops/pallas_attention.py: for one
// (batch, head) it computes
//
//     out = softmax(Q K^T / sqrt(Dh) + bias) V
//
// with a head-shared additive bias [B|1, 1, Lq|1, Lk] in fp32, read through
// its own element strides (stride 0 on a broadcast dimension), so the
// [B, Lq, Lk] plane the TPU version materialised and padded with -1e9 never
// exists.  The TPU kernel's order of casts: S = (Q K^T in fp32) * scale, then
// + bias; m = row max, e = exp(S - m), P = e / sum(e), all fp32; P rounded
// to V's type after the normalisation; PV accumulated in fp32.
//
// What bounds it on the H100: at the RoBERTa training shape (B = 128 rows,
// Lq = 128, Lk = 138, H = 16, Dh = 64, bf16) the work is 9.3 GFLOP against
// 139.5 MB of q, k, v and out, about 67 FLOP/byte: below the card's ~295
// FLOP/byte ridge, so the floor is the bytes (q, k, v read once, out
// written once; the bias is [B, Lk], 70 KB).
//
// Two kernels, chosen by the operand type (a dispatch, not a fallback):
//
// * bf16: dense_attention_mma_kernel, on the tensor cores (mma.sync
//   m16n8k16, bf16 operands, fp32 accumulators, operands through ldmatrix;
//   the helpers are in common.cuh, shared with flash_bwd.cu).  One block of
//   4 warps owns one (batch, head, 64 query rows): a (ceil(Lq / 64), H, B)
//   grid.  It copies the block's Q tile and the head's K (one cp.async
//   group) and V (a second group, awaited only before PV, so V's copy
//   overlaps the scores) from their strided [B, L, H, Dh] layout into shared
//   memory, 16 bytes a thread, keys padded to Lk_pad (a multiple of 16) and
//   query rows past Lq zero-filled; each row is padded by 16 bytes, so the
//   eight 16-byte rows an ldmatrix reads fall in distinct banks.  Each warp
//   then owns 16 query rows against all keys, with the whole [16, Lk_pad]
//   score tile in registers (the key count Lk_pad / 16 is a template
//   parameter, 1 to 12, so the tile is exactly sized): S = Q K^T by mma,
//   scaled (a rounded multiply, never fused with the bias add), the mask
//   added, the row max and sum by quad shuffles, P = e / sum with expf and
//   an IEEE division (the plain version's arithmetic; no exp2 prescale, no
//   reciprocal), then P rounded and packed straight into A fragments (the
//   accumulator layout of two 8-key tiles is the A layout of one 16-key
//   step) for O += P V, with V's B operands from ldmatrix.trans.  Keys at or
//   past Lk score -inf, so P is exactly 0 there; a real key the caller masks
//   with -10000 or -1e9 stays as it is, so a fully masked row comes out as
//   in the plain version.  O goes through the warp's own Q rows in shared
//   memory to 16-byte stores; rows past Lq are not written.  No atomics: two
//   launches give the same bits.
//   The mask is a template functor, the one place the score tile meets the
//   caller's mask: RowBias stages a [B|1, 1, 1, Lk] row (or zeros for no
//   bias) in shared memory once per block, since every query row adds the
//   same one (RoBERTa's padding bias, the training path); PlaneBias reads a
//   [B|1, 1, Lq, Lk] plane through its strides per score.
//   Budget: shared memory (2 Lk_pad + 64) * 72 * 2 + 4 Lk_pad bytes: 51,264
//   B at Lk = 138, 65,280 B at Lk = 190.  That is 4 resident blocks (16
//   warps) per SM up to Lk_pad = 160 and 3 above, so one block's copies
//   overlap another's products; __launch_bounds__ asks for that residency
//   (at most 128 registers a thread for 4 blocks, 168 for 3).  ptxas -v
//   (chip_smoke.py phase 2 prints it per instance): 0 spill bytes in every
//   instance; 128 registers at Lk_pad = 144 (the training path) and 160,
//   168 at 176 and 192, 45 to 128 below.
//   It takes Dh = 64 and Lk <= 192 (the wrapper raises before launch
//   otherwise) and 16-byte aligned rows.  Why not one 8-warp block per
//   (batch, head), staging K and V once: twice the shared memory per block
//   and half the blocks, while the second 64-row block's K/V read mostly
//   hits L2.
//
// * fp32: dense_attention_kernel, on the FP32 pipes.  Each block stages one
//   head's whole K and V in shared memory and serves a tile of 64 query rows
//   from it; the bias row of a query is read from memory.  One warp owns one
//   query row at a time: each lane scores its share of the keys, the warp
//   reduces max and sum with shuffles, and each lane then accumulates its
//   share of the output dimensions.
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/fused_attention.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

// ------------------------------------------------------------------ fp32

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;  // query rows served by one K/V staging

template <typename T>
size_t smem_bytes(int lk, int dh) {
  const size_t kv = 2ull * lk * (dh + row_pad<T>()) * sizeof(T);
  return kv + sizeof(float) * (size_t(kWarps) * lk + size_t(kWarps) * dh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ out, int lq, int lk, int n_heads, int dh,
                       int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
                       int64_t ski, int64_t skh, int64_t svb, int64_t svi,
                       int64_t svh, int64_t sbb, int64_t sbq, int64_t sbk,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = dh + row_pad<T>();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + size_t(lk) * ks_stride;
  float* p_s = reinterpret_cast<float*>(v_s + size_t(lk) * ks_stride);
  float* q_s = p_s + kWarps * lk;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage this head's K and V.
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int idx = threadIdx.x; idx < lk * dh; idx += kThreads) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    k_s[j * ks_stride + d] = kb[j * ski + d];
    v_s[j * ks_stride + d] = vb[j * svi + d];
  }
  __syncthreads();

  float* p = p_s + warp * lk;
  float* q_row = q_s + warp * dh;
  const int row_end = min(lq, int(blockIdx.x + 1) * kRowsPerBlock);
  for (int i = blockIdx.x * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const T* qi = q + b * sqb + i * sqi + h * sqh;
    for (int d = lane; d < dh; d += 32) q_row[d] = to_f(qi[d]);
    __syncwarp();
    const float* bias_row = bias == nullptr ? nullptr : bias + b * sbb + i * sbq;

    // Scores for this lane's keys: (q . k) * scale + bias, in fp32.
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const T* kj = k_s + j * ks_stride;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) acc = fmaf(q_row[d], to_f(kj[d]), acc);
      float s = acc * scale;
      if (bias_row != nullptr) s += __ldg(bias_row + j * sbk);
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // normalise, then round P to V's type before PV, as the TPU kernel does
    for (int j = lane; j < lk; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();

    T* oi = out + ((int64_t(b) * lq + i) * n_heads + h) * dh;
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < lk; ++j) acc = fmaf(p[j], to_f(v_s[j * ks_stride + d]), acc);
      oi[d] = from_f<T>(acc);
    }
    __syncwarp();  // q_row and p are rewritten by this warp's next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int b, int lq, int lk, int h, int dh, int64_t sqb, int64_t sqi,
           int64_t sqh, int64_t skb, int64_t ski, int64_t skh, int64_t svb,
           int64_t svi, int64_t svh, int64_t sbb, int64_t sbq, int64_t sbk,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(lk, dh);
  const cudaError_t err = reserve_smem<dense_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kRowsPerBlock - 1) / kRowsPerBlock, h, b);
  dense_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb, ski, skh, svb,
      svi, svh, sbb, sbq, sbk, scale);
  return int(cudaGetLastError());
}


// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileRows = 16 * kMmaWarps;  // query rows per block, 16 per warp
constexpr int kMmaDh = 64;                 // the one head dim instantiated
constexpr int kMaxPairs = 12;              // 16-key steps: Lk <= 192
constexpr int kRowPad = 8;                 // elements (16 bytes) after each smem row
constexpr int kS = kMmaDh + kRowPad;       // row stride of K, V and Q in shared memory

size_t mma_smem_bytes(int lk) {
  const size_t lkp = pad16(lk);
  return sizeof(bf16) * (2 * lkp + kTileRows) * kS + sizeof(float) * lkp;
}

struct MmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* out;
  int lq, lk, n_heads;
  int64_t sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, sbb, sbq, sbk;
  float scale;
};

// Mask sources: mask(hi, j) is what is added to the scaled score of the
// lane's row hi (of its two) and key j < Lk.

// A [B|1, 1, 1, Lk] bias, or none: one row staged in shared memory per block.
struct RowBias {
  static constexpr bool kStagesRow = true;
  const float* row_s;
  __device__ static RowBias make(const MmaArgs&, const float* bias_s, int, const int (&)[2]) {
    return {bias_s};
  }
  __device__ float operator()(int, int j) const { return row_s[j]; }
};

// A [B|1, 1, Lq, Lk] plane read through its strides; rows past Lq read nothing.
struct PlaneBias {
  static constexpr bool kStagesRow = false;
  const float* rows[2];
  int64_t sbk;
  __device__ static PlaneBias make(const MmaArgs& a, const float*, int b,
                                   const int (&row)[2]) {
    PlaneBias m;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      m.rows[hi] = row[hi] < a.lq ? a.bias + b * a.sbb + row[hi] * a.sbq : nullptr;
    m.sbk = a.sbk;
    return m;
  }
  __device__ float operator()(int hi, int j) const {
    return rows[hi] != nullptr ? __ldg(rows[hi] + j * sbk) : 0.f;
  }
};

// Accumulator layout of an m16n8 tile: c[e] sits at row lane / 4 + 8 (e / 2),
// column 2 (lane % 4) + e % 2.  A fragment (16x16): a[0] rows 0-7, a[1] rows
// 8-15, a[2] and a[3] the same rows at columns 8-15.
template <int NP, class Mask>
__global__ void __launch_bounds__(kMmaThreads, NP <= 10 ? 4 : 3)
dense_attention_mma_kernel(const MmaArgs a) {
  constexpr int kChunks = kMmaDh / 8;  // 16-byte chunks per row
  constexpr int kSteps = kMmaDh / 16;  // k-steps over Dh
  constexpr int kDt = kMmaDh / 8;      // 8-wide n-tiles over Dh
  constexpr int kLkp = 16 * NP;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                       // [kLkp][kS]
  bf16* v_s = k_s + kLkp * kS;                                     // [kLkp][kS]
  bf16* q_s = v_s + kLkp * kS;                                     // [kTileRows][kS], then O
  float* bias_s = reinterpret_cast<float*>(q_s + kTileRows * kS);  // [kLkp]

  const int i0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;  // this warp's first row in the tile

  // group 0: Q and K; group 1: V
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* kb = a.k + b * a.skb + h * a.skh;
  const bf16* vb = a.v + b * a.svb + h * a.svh;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 8;
    const bool ok = i0 + r < a.lq;
    cp_async16(q_s + r * kS + d, qb + (ok ? i0 + r : 0) * a.sqi + d, ok);
  }
  for (int c = threadIdx.x; c < kLkp * kChunks; c += kMmaThreads) {
    const int j = c / kChunks;
    const int d = (c % kChunks) * 8;
    const bool ok = j < a.lk;
    cp_async16(k_s + j * kS + d, kb + (ok ? j : 0) * a.ski + d, ok);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < kLkp * kChunks; c += kMmaThreads) {
    const int j = c / kChunks;
    const int d = (c % kChunks) * 8;
    const bool ok = j < a.lk;
    cp_async16(v_s + j * kS + d, vb + (ok ? j : 0) * a.svi + d, ok);
  }
  cp_async_commit();
  if constexpr (Mask::kStagesRow) {
    for (int j = threadIdx.x; j < kLkp; j += kMmaThreads)
      bias_s[j] = (a.bias != nullptr && j < a.lk) ? __ldg(a.bias + b * a.sbb + j * a.sbk) : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T for this warp's 16 rows and all keys
  float sc[NP][2][4];
#pragma unroll
  for (int jp = 0; jp < NP; ++jp)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jp][n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    uint32_t qa[4];
    ldsm_x4(qa, q_s + (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      uint32_t y[4];
      ldsm_x4(y, k_s + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kS + 16 * s +
                     8 * ((lane >> 3) & 1));
      mma16816(sc[jp][0], qa, y[0], y[1]);
      mma16816(sc[jp][1], qa, y[2], y[3]);
    }
  }

  // scale, mask, softmax in fp32; P rounded and packed as A fragments
  const int row[2] = {i0 + r0 + g, i0 + r0 + g + 8};
  const Mask mask = Mask::make(a, bias_s, b, row);
  uint32_t pa[NP][4];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float m = -INFINITY;
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
          const int j = 16 * jp + 8 * n + 2 * t + (e & 1);
          const float x = __fmul_rn(sc[jp][n][e], a.scale);
          sc[jp][n][e] = j < a.lk ? x + mask(hi, j) : -INFINITY;
          m = fmaxf(m, sc[jp][n][e]);
        }
    m = quad_max(m);
    float sum = 0.f;
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
          sc[jp][n][e] = expf(sc[jp][n][e] - m);
          sum += sc[jp][n][e];
        }
    sum = quad_sum(sum);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        pa[jp][2 * n + hi] = pack_bf16(sc[jp][n][2 * hi] / sum, sc[jp][n][2 * hi + 1] / sum);
  }

  // O = P V
  cp_async_wait<0>();
  __syncthreads();
  float o[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < NP; ++jp)
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t y[4];
      ldsm_x4_t(y, v_s + (16 * jp + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
      mma16816(o[2 * s], pa[jp], y[0], y[1]);
      mma16816(o[2 * s + 1], pa[jp], y[2], y[3]);
    }

  // O through this warp's own Q rows (read by no other warp) to 16-byte stores
  bf16* o_s = q_s + r0 * kS;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
#pragma unroll
    for (int n = 0; n < kDt; ++n)
      *reinterpret_cast<uint32_t*>(o_s + (g + 8 * hi) * kS + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * hi], o[n][2 * hi + 1]);
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 8;
    const int i = i0 + r0 + r;
    if (i < a.lq)
      *reinterpret_cast<uint4*>(a.out + ((int64_t(b) * a.lq + i) * a.n_heads + h) * kMmaDh + d) =
          *reinterpret_cast<const uint4*>(o_s + r * kS + d);
  }
}

template <int NP, class Mask>
int launch_mma(const MmaArgs& a, int b, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(16 * NP);
  const cudaError_t err = reserve_smem<dense_attention_mma_kernel<NP, Mask>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.lq + kTileRows - 1) / kTileRows, a.n_heads, b);
  dense_attention_mma_kernel<NP, Mask><<<grid, kMmaThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// The instance whose score tile holds Lk_pad = 16 NP keys.
template <int NP>
int launch_pairs(const MmaArgs& a, int b, cudaStream_t stream) {
  if constexpr (NP > kMaxPairs) {
    return int(cudaErrorInvalidValue);
  } else {
    if (pad16(a.lk) != 16 * NP) return launch_pairs<NP + 1>(a, b, stream);
    return a.sbq == 0 ? launch_mma<NP, RowBias>(a, b, stream)
                      : launch_mma<NP, PlaneBias>(a, b, stream);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int b, int lq, int lk, int h, int dh, int64_t sqb, int64_t sqi, int64_t sqh,
                int64_t skb, int64_t ski, int64_t skh, int64_t svb, int64_t svi, int64_t svh,
                int64_t sbb, int64_t sbq, int64_t sbk, float scale, cudaStream_t stream) {
  if (dh != kMmaDh || lk > 16 * kMaxPairs) return int(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lq, lk, h,
                  sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, sbb, sbq, sbk, scale};
  return launch_pairs<1>(a, b, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper names it when a launch
// is refused.
long long dense_attention_smem_bytes(int lk, int dh, int is_bf16) {
  return is_bf16 ? (long long)mma_smem_bytes(lk) : (long long)smem_bytes<float>(lk, dh);
}

// q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] with unit stride on Dh and the
// given element strides on B, L and H; bias fp32 addressed as
// bias[b * sbb + i * sbq + j * sbk] (null: no bias); out contiguous
// [B, Lq, H, Dh] of q's type.  bf16 goes to the tensor-core kernel (Dh 64,
// Lk <= 192, rows 16-byte aligned), fp32 to the FP32-pipe kernel.
int dense_attention_forward(const void* q, const void* k, const void* v,
                            const float* bias, void* out, int b, int lq, int lk,
                            int h, int dh, long long sqb, long long sqi,
                            long long sqh, long long skb, long long ski,
                            long long skh, long long svb, long long svi,
                            long long svh, long long sbb, long long sbq,
                            long long sbk, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, bias, out, b, lq, lk, h, dh, sqb, sqi, sqh, skb, ski, skh,
                       svb, svi, svh, sbb, sbq, sbk, scale, s);
  return launch<float>(q, k, v, bias, out, b, lq, lk, h, dh, sqb, sqi, sqh, skb, ski,
                       skh, svb, svi, svh, sbb, sbq, sbk, scale, s);
}

}  // extern "C"
