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
// * bf16: dense_attention_mma_kernel, on the tensor cores: one block of 4
//   warps per (batch, head, 64 query rows), the whole [16, Lk_pad] score
//   tile of a warp in registers, mma.sync with ldmatrix and cp.async.  Its
//   body is attention_mma_tile in attention_mma.cuh (the design, the order
//   of casts and the budget are noted there), shared with the stage-mask
//   forward; this file gives it the bias as a mask functor: RowBias stages a
//   [B|1, 1, 1, Lk] row (or zeros for no bias) in shared memory once per
//   block, since every query row adds the same one (RoBERTa's padding bias,
//   the training path); PlaneBias reads a [B|1, 1, Lq, Lk] plane through its
//   strides per score.  Shared memory: 51,264 B at Lk = 138, 65,280 B at
//   Lk = 190.  ptxas -v (chip_smoke.py phase 2 prints it per instance): 0
//   spill bytes in every instance; 128 registers at Lk_pad = 144 (the
//   training path) and 160, 168 at 176 and 192, 45 to 128 below.
//   Above 192 keys the key-looped dense_attention_mma_long_kernel runs the
//   tile's key loop (attention_mma_tile_long).  Every instance exists at
//   Dh = 64 and Dh = 128 (the wrapper zero-pads a narrower head to the
//   next), takes 16-byte aligned rows and any Lk.  A head wider than 128
//   (zero-padded to a multiple of 128) runs
//   dense_attention_mma_long_slab_kernel, the key loop in slabs
//   (attention_mma.cuh) at any key count: one block per 128 output columns,
//   the scores summed over every slab.  Why not one 8-warp block per
//   (batch, head), staging K and V once: twice the shared memory per block
//   and half the blocks, while the second 64-row block's K/V read mostly
//   hits L2.
//
// * fp32: dense_attention_kernel, on the FP32 pipes.  Each block stages one
//   head's whole K and V in shared memory and serves a tile of 64 query rows
//   from it; the bias row of a query is read from memory.  One warp owns one
//   query row at a time: each lane scores its share of the keys, the warp
//   reduces max and sum with shuffles, and each lane then accumulates its
//   share of the output dimensions.  Where K and V do not fit in one block's
//   shared memory (about 417 keys at Dh 64), dense_attention_stream_kernel
//   reads them from device memory instead, 32 keys at a time per warp.  The
//   staged kernel takes heads up to kMaxDh = 256 (common.cuh); a wider head
//   streams in slabs of 256 output columns, one block per slab.
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/fused_attention.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "attention_mma.cuh"
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

// K and V beyond one block's shared memory: the same rows, warps and order
// of casts, with each warp streaming its row's keys from device memory
// (through L1 and L2) in two passes: a running max and sum per lane, merged
// across the warp; then P for 32 keys at a time into a warp buffer and
// out += P V, lanes over the output dimensions.  Any Lk; Dh <= MaxDh, each
// lane holding MaxDh / 32 output columns (instantiated at kNarrowDh and
// kMaxDh, common.cuh).  With Slabs, any Dh: the grid's x holds the row
// tiles of each slab of MaxDh output columns in turn; each block scores its
// rows over the whole head, reading q through L1 (the same products in the
// same order), and writes only its slab of out.
template <typename T, int MaxDh, bool Slabs>
__global__ void __launch_bounds__(kThreads)
dense_attention_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ bias,
                              T* __restrict__ out, int lq, int lk, int n_heads, int dh,
                              int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
                              int64_t ski, int64_t skh, int64_t svb, int64_t svi,
                              int64_t svh, int64_t sbb, int64_t sbq, int64_t sbk,
                              float scale) {
  __shared__ float q_s[kWarps][Slabs ? 1 : MaxDh];
  __shared__ float p_s[kWarps][32];
  const int n_tiles = Slabs ? ceil_div(lq, kRowsPerBlock) : 1;
  const int tile = Slabs ? blockIdx.x % n_tiles : blockIdx.x;
  const int d0 = Slabs ? MaxDh * (blockIdx.x / n_tiles) : 0;  // the slab's first column
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  float* q_row = q_s[warp];
  float* p = p_s[warp];

  const int row_end = min(lq, (tile + 1) * kRowsPerBlock);
  for (int i = tile * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const T* qi = q + b * sqb + i * sqi + h * sqh;
    if constexpr (!Slabs) {
      for (int d = lane; d < dh; d += 32) q_row[d] = to_f(qi[d]);
      __syncwarp();
    }
    const float* bias_row = bias == nullptr ? nullptr : bias + b * sbb + i * sbq;
    auto score = [&](int j) {
      const T* kj = kb + j * ski;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d)
        acc = fmaf(Slabs ? to_f(__ldg(qi + d)) : q_row[d], to_f(kj[d]), acc);
      float s = acc * scale;
      if (bias_row != nullptr) s += __ldg(bias_row + j * sbk);
      return s;
    };

    float m = -INFINITY, l = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float s = score(j);
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
    const float mw = warp_max(m);
    const float sum = warp_sum(m == -INFINITY ? 0.f : l * expf(m - mw));

    float acc[MaxDh / 32] = {};
    for (int j0 = 0; j0 < lk; j0 += 32) {
      const int j = j0 + lane;
      // normalise, then round P to V's type before PV, as the TPU kernel does
      p[lane] = j < lk ? to_f(from_f<T>(expf(score(j) - mw) / sum)) : 0.f;
      __syncwarp();
      const int n = min(32, lk - j0);
#pragma unroll
      for (int r = 0; r < MaxDh / 32; ++r) {
        const int d = d0 + lane + 32 * r;
        if (d < dh)
          for (int jj = 0; jj < n; ++jj)
            acc[r] = fmaf(p[jj], to_f(vb[(j0 + jj) * svi + d]), acc[r]);
      }
      __syncwarp();
    }
    T* oi = out + ((int64_t(b) * lq + i) * n_heads + h) * dh + d0;
#pragma unroll
    for (int r = 0; r < MaxDh / 32; ++r)
      if (d0 + lane + 32 * r < dh) oi[lane + 32 * r] = from_f<T>(acc[r]);
    __syncwarp();  // q_row is rewritten by this warp's next row
  }
}

// The staged kernel when K and V fit in one block's shared memory (heads up
// to kMaxDh), else the streaming one at the narrower of its two widths that
// holds Dh; a wider head streams in slabs of kMaxDh columns.
template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int b, int lq, int lk, int h, int dh, int64_t sqb, int64_t sqi,
           int64_t sqh, int64_t skb, int64_t ski, int64_t skh, int64_t svb,
           int64_t svi, int64_t svh, int64_t sbb, int64_t sbq, int64_t sbk,
           float scale, cudaStream_t stream) {
  if (dh < 1) return int(cudaErrorInvalidValue);
  const int tiles = ceil_div(lq, kRowsPerBlock);
  const size_t smem = smem_bytes<T>(lk, dh);
  if (dh > kMaxDh || !fits_smem(smem)) {
    auto kernel = dh <= kNarrowDh ? dense_attention_stream_kernel<T, kNarrowDh, false>
                  : dh <= kMaxDh  ? dense_attention_stream_kernel<T, kMaxDh, false>
                                  : dense_attention_stream_kernel<T, kMaxDh, true>;
    const dim3 grid(tiles * ceil_div(dh, kMaxDh), h, b);
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        bias, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb, ski, skh, svb,
        svi, svh, sbb, sbq, sbk, scale);
    return int(cudaGetLastError());
  }
  const cudaError_t err = reserve_smem<dense_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return int(err);
  dense_attention_kernel<T><<<dim3(tiles, h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb, ski, skh, svb,
      svi, svh, sbb, sbq, sbk, scale);
  return int(cudaGetLastError());
}


// ------------------------------------------------------------------ bf16
// The tile body, the launch and the key-count dispatch are in
// attention_mma.cuh, shared with spec_attention.cu; here are the bias masks.

// q, k, v, out and the bias: its data pointer (null: none) and element
// strides; the head's 128-column slabs (1 below the slab instance).
struct MmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* out;
  int lq, lk, n_heads;
  int64_t sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, sbb, sbq, sbk;
  float scale;
  int slabs;
};

// A [B|1, 1, 1, Lk] bias, or none: one row staged in shared memory per block.
struct RowBias {
  using Args = MmaArgs;
  static constexpr int kKeyWords = 1;
  const float* row_s;
  int key0;
  __device__ static void stage(const MmaArgs& a, float* bias_s, int b, int key0, int nkeys) {
    for (int j = threadIdx.x; j < nkeys; j += kMmaThreads)
      bias_s[j] = (a.bias != nullptr && key0 + j < a.lk)
                      ? __ldg(a.bias + b * a.sbb + (key0 + j) * a.sbk)
                      : 0.f;
  }
  __device__ static RowBias make(const MmaArgs&, const float* bias_s, int, const int (&)[2]) {
    return {bias_s, 0};
  }
  __device__ void rebase(const float* bias_s, int k0) {
    row_s = bias_s;
    key0 = k0;
  }
  __device__ float operator()(int, int j) const { return row_s[j - key0]; }
};

// A [B|1, 1, Lq, Lk] plane read through its strides; rows past Lq read nothing.
struct PlaneBias {
  using Args = MmaArgs;
  static constexpr int kKeyWords = 1;  // the row's space, unused
  const float* rows[2];
  int64_t sbk;
  __device__ static void stage(const MmaArgs&, float*, int, int, int) {}
  __device__ static PlaneBias make(const MmaArgs& a, const float*, int b,
                                   const int (&row)[2]) {
    PlaneBias m;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      m.rows[hi] = row[hi] < a.lq ? a.bias + b * a.sbb + row[hi] * a.sbq : nullptr;
    m.sbk = a.sbk;
    return m;
  }
  __device__ void rebase(const float*, int) {}
  __device__ float operator()(int hi, int j) const {
    return rows[hi] != nullptr ? __ldg(rows[hi] + j * sbk) : 0.f;
  }
};

template <int Dh, int NP, class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks(Dh, NP))
dense_attention_mma_kernel(const MmaArgs a) {
  attention_mma_tile<Dh, NP, Mask>(a);
}

// Lk > 192: the key-looped instance (attention_mma.cuh).
template <int Dh, class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_long_min_blocks(Dh))
dense_attention_mma_long_kernel(const MmaArgs a) {
  attention_mma_tile_long<Dh, Mask>(a);
}

// Heads wider than 128: the key-looped instance in slabs (attention_mma.cuh).
template <class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_long_min_blocks(kSlabDh))
dense_attention_mma_long_slab_kernel(const MmaArgs a) {
  attention_mma_tile_long<kSlabDh, Mask, true>(a);
}

// The row or plane instance at Lk_pad = 16 NP, or the key-looped one, at
// head dim Dh.
template <int Dh>
struct DenseLaunch {
  const MmaArgs& a;
  int b;
  cudaStream_t stream;
  template <int NP>
  int run() const {
    const size_t smem = mma_smem_bytes(16 * NP, RowBias::kKeyWords, Dh);  // both masks
    return a.sbq == 0
               ? launch_mma<dense_attention_mma_kernel<Dh, NP, RowBias>>(a, b, smem, stream)
               : launch_mma<dense_attention_mma_kernel<Dh, NP, PlaneBias>>(a, b, smem, stream);
  }
  int run_long() const {
    const size_t smem = mma_long_smem_bytes(RowBias::kKeyWords, Dh);
    return a.sbq == 0
               ? launch_mma<dense_attention_mma_long_kernel<Dh, RowBias>>(a, b, smem, stream)
               : launch_mma<dense_attention_mma_long_kernel<Dh, PlaneBias>>(a, b, smem, stream);
  }
};

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int b, int lq, int lk, int h, int dh, int64_t sqb, int64_t sqi, int64_t sqh,
                int64_t skb, int64_t ski, int64_t skh, int64_t svb, int64_t svi, int64_t svh,
                int64_t sbb, int64_t sbq, int64_t sbk, float scale, cudaStream_t stream) {
  const int slabs = mma_slabs(dh);
  if (!mma_head_dim(dh) && slabs == 0) return int(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lq, lk, h,
                  sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, sbb, sbq, sbk, scale,
                  slabs > 0 ? slabs : 1};
  if (slabs > 0) {
    const size_t smem = mma_long_smem_bytes(RowBias::kKeyWords, kSlabDh, 2);  // both masks
    return sbq == 0
               ? launch_mma<dense_attention_mma_long_slab_kernel<RowBias>>(a, b, smem, stream)
               : launch_mma<dense_attention_mma_long_slab_kernel<PlaneBias>>(a, b, smem, stream);
  }
  return dh == 64 ? launch_pairs<1>(lk, DenseLaunch<64>{a, b, stream})
                  : launch_pairs<1>(lk, DenseLaunch<128>{a, b, stream});
}

}  // namespace

extern "C" {

// q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] with unit stride on Dh and the
// given element strides on B, L and H; bias fp32 addressed as
// bias[b * sbb + i * sbq + j * sbk] (null: no bias); out contiguous
// [B, Lq, H, Dh] of q's type; `scale` multiplies Q K^T (1 / sqrt of the
// true head dim when the caller has zero-padded it).  bf16 goes to the
// tensor-core kernels (Dh 64 or 128, rows 16-byte aligned; resident K/V up
// to 192 keys, key-looped above; a multiple of 128 above 128 key-looped in
// slabs), fp32 to the FP32-pipe kernels (any Dh; staged K/V while they fit
// and Dh <= 256, streamed otherwise, in slabs above 256).
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
