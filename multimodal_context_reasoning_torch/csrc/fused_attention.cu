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
// exists.  Scores and softmax are fp32, P is rounded to V's type before PV,
// PV accumulates in fp32: the TPU kernel's order of casts.
//
// What bounds it on the H100: at the RoBERTa training shape (B = 128 rows,
// Lq = 128, Lk = 138, H = 16, Dh = 64, bf16) the work is 9.3 GFLOP against
// 139.5 MB of q, k, v and out, about 67 FLOP/byte: below the card's ~295
// FLOP/byte ridge, so the floor is the bytes (q, k, v read once, out
// written once; the bias is [B, Lk], 70 KB).
//
// What the design does about it: the block layout is the stage-mask
// kernel's (csrc/spec_attention.cu).  q, k and v are read in their native
// [B, L, H, Dh] layout through strides (no transposed or padded copies),
// each block stages one head's whole K and V in shared memory once and
// serves a tile of query rows from it, and the bias row of a query is read
// from memory (one [Lk] row per query, shared by all heads through the
// cache).  One warp owns one query row at a time: each lane scores its share
// of the keys, the warp reduces max and sum with shuffles, and each lane then
// accumulates its share of the output dimensions.  The products run on the
// FP32 pipes, not the tensor cores: this first version is simple and exact,
// and a tensor-core version is later work (PERF.md carries its times against
// the byte bound).
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/fused_attention.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper names it when a launch
// is refused.
long long dense_attention_smem_bytes(int lk, int dh, int is_bf16) {
  return is_bf16 ? (long long)smem_bytes<__nv_bfloat16>(lk, dh)
                 : (long long)smem_bytes<float>(lk, dh);
}

// q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] with unit stride on Dh and the
// given element strides on B, L and H; bias fp32 addressed as
// bias[b * sbb + i * sbq + j * sbk] (null: no bias); out contiguous
// [B, Lq, H, Dh] of q's type.
int dense_attention_forward(const void* q, const void* k, const void* v,
                            const float* bias, void* out, int b, int lq, int lk,
                            int h, int dh, long long sqb, long long sqi,
                            long long sqh, long long skb, long long ski,
                            long long skh, long long svb, long long svi,
                            long long svh, long long sbb, long long sbq,
                            long long sbk, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, b, lq, lk, h, dh, sqb, sqi, sqh,
                                 skb, ski, skh, svb, svi, svh, sbb, sbq, sbk, scale, s);
  return launch<float>(q, k, v, bias, out, b, lq, lk, h, dh, sqb, sqi, sqh, skb, ski,
                       skh, svb, svi, svh, sbb, sbq, sbk, scale, s);
}

}  // extern "C"
