// Stage-mask attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_attention_spec / _spec_kernel in
// multimodal_context_reasoning_tpu/ops/pallas_attention.py: for one
// (batch, head) it computes
//
//     out = softmax(Q K^T / sqrt(Dh) - 1e9 * (1 - vis)) V
//
// where the visibility mask vis is rebuilt inside the kernel from three
// O(Lk) vectors (valid, gi, rowfull) for a stage that is "full", "chunk" or
// "cross" and a text length; no [Lq, Lk] mask or score plane ever reaches
// device memory.  Scores and softmax are fp32, P is rounded to V's type
// before PV, PV accumulates in fp32.  The mask algebra is the TPU kernel's,
// term for term, in fp32.
//
// What bounds it on the H100: at the ModCR shapes (L = 190 or 51, Dh = 64,
// H = 12; RoBERTa Lq = 128, Lk = 138, H = 16) the work is ~2*2*Lq*Lk*Dh
// FLOPs per (batch, head) against ~4*L*Dh elements moved, ~95 FLOP/byte in
// bf16: below the card's ~295 FLOP/byte ridge, so the floor is the bytes
// (q, k, v read once, out written once).
//
// What the design does about it: q, k and v are read in their native
// [B, L, H, Dh] layout through strides (no transposed or padded copies, as
// the TPU version needed), each block stages one head's whole K and V in
// shared memory once and serves a tile of query rows from it, and the mask
// costs two O(Lk) vector loads per block.  One warp owns one query row at a
// time: each lane scores its share of the keys, the warp reduces max and
// sum with shuffles, and each lane then accumulates its share of the output
// dimensions.  The products run on the FP32 pipes, not the tensor cores:
// this first version is simple and exact, and a wgmma version is later
// work (PERF.md carries its times against the byte bound).
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/spec_attention.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;  // query rows served by one K/V staging

enum Stage { kFull = 0, kChunk = 1, kCross = 2 };

template <typename T>
size_t smem_bytes(int lk, int dh) {
  const size_t kv = 2ull * lk * (dh + row_pad<T>()) * sizeof(T);
  return kv + sizeof(float) * (size_t(kWarps) * lk + size_t(kWarps) * dh + lk) +
         sizeof(int) * size_t(lk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spec_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ valid,
                      const int* __restrict__ gi, const float* __restrict__ rowfull,
                      T* __restrict__ out, int lq, int lk, int n_heads, int dh,
                      int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
                      int64_t ski, int64_t skh, int64_t svb, int64_t svi,
                      int64_t svh, int stage, int text_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = dh + row_pad<T>();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + size_t(lk) * ks_stride;
  float* p_s = reinterpret_cast<float*>(v_s + size_t(lk) * ks_stride);
  float* q_s = p_s + kWarps * lk;
  float* valid_s = q_s + kWarps * dh;
  int* gi_s = reinterpret_cast<int*>(valid_s + lk);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage this head's K and V, and the batch row's mask vectors.
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int idx = threadIdx.x; idx < lk * dh; idx += kThreads) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    k_s[j * ks_stride + d] = kb[j * ski + d];
    v_s[j * ks_stride + d] = vb[j * svi + d];
  }
  for (int j = threadIdx.x; j < lk; j += kThreads) {
    valid_s[j] = valid[int64_t(b) * lk + j];
    gi_s[j] = gi[int64_t(b) * lk + j];
  }
  __syncthreads();

  float* p = p_s + warp * lk;
  float* q_row = q_s + warp * dh;
  const int row_end = min(lq, int(blockIdx.x + 1) * kRowsPerBlock);
  for (int i = blockIdx.x * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const T* qi = q + b * sqb + i * sqi + h * sqh;
    for (int d = lane; d < dh; d += 32) q_row[d] = to_f(qi[d]);
    __syncwarp();

    // q-side terms of the mask (chunk and cross stages only; Lq == Lk there)
    int gi_q = -1;
    float row_q = 0.f;
    if (stage != kFull) {
      gi_q = gi_s[i];
      row_q = rowfull[int64_t(b) * lk + i];
    }
    const float img_q = i >= text_len ? 1.f : 0.f;

    // Scores for this lane's keys, with the mask applied additively.
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const T* kj = k_s + j * ks_stride;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) acc = fmaf(q_row[d], to_f(kj[d]), acc);
      const float valid_k = valid_s[j];
      float vis;
      if (stage == kFull) {
        vis = valid_k;
      } else {
        const float img_k = j >= text_len ? 1.f : 0.f;
        const float same = (gi_q == gi_s[j] && gi_q >= 0) ? 1.f : 0.f;
        const float eye = (i == j) ? 1.f : 0.f;
        const float text_in = fminf(same + eye + row_q, 1.f);
        const float text_rows = ((1.f - img_k) * text_in + img_k) * valid_k;
        const float img_rows = stage == kChunk ? img_k * valid_k : eye;
        vis = img_q * img_rows + (1.f - img_q) * text_rows;
      }
      const float s = acc * scale - (1.f - vis) * 1e9f;
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
int launch(const void* q, const void* k, const void* v, const float* valid,
           const int* gi, const float* rowfull, void* out, int b, int lq, int lk,
           int h, int dh, int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
           int64_t ski, int64_t skh, int64_t svb, int64_t svi, int64_t svh,
           int stage, int text_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(lk, dh);
  const cudaError_t err = reserve_smem<spec_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kRowsPerBlock - 1) / kRowsPerBlock, h, b);
  spec_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid, gi, rowfull, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb,
      ski, skh, svb, svi, svh, stage, text_len, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper names it when a launch
// is refused.
long long spec_attention_smem_bytes(int lk, int dh, int is_bf16) {
  return is_bf16 ? (long long)smem_bytes<__nv_bfloat16>(lk, dh)
                 : (long long)smem_bytes<float>(lk, dh);
}

// q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] with unit stride on Dh and the
// given element strides on B, L and H; valid, rowfull fp32 and gi int32,
// contiguous [B, Lk]; out contiguous [B, Lq, H, Dh] of q's type.
int spec_attention_forward(const void* q, const void* k, const void* v,
                           const float* valid, const int* gi,
                           const float* rowfull, void* out, int b, int lq, int lk,
                           int h, int dh, long long sqb, long long sqi,
                           long long sqh, long long skb, long long ski,
                           long long skh, long long svb, long long svi,
                           long long svh, int stage, int text_len, float scale,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, valid, gi, rowfull, out, b, lq, lk, h, dh,
                                 sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, stage,
                                 text_len, scale, s);
  return launch<float>(q, k, v, valid, gi, rowfull, out, b, lq, lk, h, dh, sqb, sqi,
                       sqh, skb, ski, skh, svb, svi, svh, stage, text_len, scale, s);
}

}  // extern "C"
