// Attention backward for Hopper (sm_90a), recomputing the scores.
//
// Replaces the TPU kernel flash_attention_bwd_pallas / _bwd_kernel in
// multimodal_context_reasoning_tpu/ops/flash.py.  For one (batch, head), with
// no dropout and a head-shared additive fp32 bias [B|1, 1, Lq|1, Lk] read
// through its strides, it recomputes S = Q K^T / sqrt(Dh) + bias and
// P = softmax(S) in fp32 and then computes
//
//     dV = P^T dO                      (P rounded to the operand type)
//     dP = dO V^T
//     dS = P o (dP - rowsum(dP o P))   (fp32)
//     dbias[b, i, j] += dS             (summed over heads, before the scale)
//     dQ = (dS / sqrt(Dh)) K           (dS rounded to the operand type)
//     dK = (dS / sqrt(Dh))^T Q
//
// with every product accumulated in fp32: the TPU kernel's order of casts.
// No [Lq, Lk] tile reaches device memory, except the optional dbias plane.
//
// What differs from the TPU: one TPU program owned a batch element and
// looped over its heads in order, so dbias summed over heads in a register
// tile.  Here one block owns one (batch, head), blocks run in parallel, and
// the head sum is an fp32 atomicAdd into a plane the wrapper zeroes; the
// order of those additions changes from run to run.  dK and dV sum over all
// query rows, so the block keeps them as fp32 accumulators in shared memory.
//
// What bounds it on the H100: at the RoBERTa training shape (B = 128 rows,
// Lq = 128, Lk = 138, H = 16, Dh = 64, bf16) five products make 23.2 GFLOP
// against 245 MB of q, k, v, dO read and dq, dk, dv written: below the
// card's ~295 FLOP/byte ridge, so the floor is the bytes.
//
// What the design does about it: each input is read once, in its native
// [B, L, H, Dh] layout through strides.  A block stages its head's K and V
// in shared memory and walks the query rows in rounds of eight: in a round
// each warp owns one row (scores, softmax, dS, the dbias atomics and that
// row's dQ, with lanes over keys and then over dimensions), and then all
// 256 threads fold the round's eight rounded P and dS rows into the dK and dV
// accumulators, each thread owning fixed (key, dimension) cells, so no
// atomics touch shared memory.  Shared memory per block is
// K, V + fp32 dK, dV + eight rows' buffers: 120 KB in bf16 and 155 KB in
// fp32 at Lk = 138, 212 KB in fp32 at Lk = 190.  The products run on the
// FP32 pipes: a tensor-core version is later work (PERF.md).
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/flash.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // query rows per round, one per warp
constexpr int kThreads = kWarps * 32;

// One warp's row buffers: P[lk], dS[lk], q[dh], dO[dh], all fp32.
__host__ __device__ inline int row_floats(int lk, int dh) { return 2 * lk + 2 * dh; }

template <typename T>
size_t smem_bytes(int lk, int dh) {
  const size_t acc = 2ull * lk * dh * sizeof(float);
  const size_t rows = sizeof(float) * size_t(kWarps) * row_floats(lk, dh);
  const size_t kv = 2ull * lk * (dh + row_pad<T>()) * sizeof(T);
  return acc + rows + kv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ bias, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias,
                 int lq, int lk, int n_heads, int dh, int64_t sqb, int64_t sqi,
                 int64_t sqh, int64_t skb, int64_t ski, int64_t skh, int64_t svb,
                 int64_t svi, int64_t svh, int64_t sob, int64_t soi, int64_t soh,
                 int64_t sbb, int64_t sbq, int64_t sbk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = dh + row_pad<T>();
  const int n_row = row_floats(lk, dh);
  float* dk_acc = reinterpret_cast<float*>(smem);     // [lk][dh]
  float* dv_acc = dk_acc + size_t(lk) * dh;           // [lk][dh]
  float* rows = dv_acc + size_t(lk) * dh;             // kWarps x row buffers
  T* k_s = reinterpret_cast<T*>(rows + size_t(kWarps) * n_row);
  T* v_s = k_s + size_t(lk) * ks_stride;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage this head's K and V; zero the dK and dV accumulators.
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int idx = threadIdx.x; idx < lk * dh; idx += kThreads) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    k_s[j * ks_stride + d] = kb[j * ski + d];
    v_s[j * ks_stride + d] = vb[j * svi + d];
    dk_acc[idx] = 0.f;
    dv_acc[idx] = 0.f;
  }
  __syncthreads();

  float* p = rows + warp * n_row;  // P, then P rounded to T
  float* ds = p + lk;              // dP, then dS / sqrt(Dh) rounded to T
  float* q_row = ds + lk;
  float* do_row = q_row + dh;

  for (int i0 = 0; i0 < lq; i0 += kWarps) {
    const int i = i0 + warp;
    if (i < lq) {
      const T* qi = q + b * sqb + i * sqi + h * sqh;
      const T* doi = dout + b * sob + i * soi + h * soh;
      for (int d = lane; d < dh; d += 32) {
        q_row[d] = to_f(qi[d]);
        do_row[d] = to_f(doi[d]);
      }
      __syncwarp();
      const float* bias_row = bias == nullptr ? nullptr : bias + b * sbb + i * sbq;

      // S = (q . k) * scale + bias and dP = dO . v for this lane's keys.
      float m = -INFINITY;
      for (int j = lane; j < lk; j += 32) {
        const T* kj = k_s + j * ks_stride;
        const T* vj = v_s + j * ks_stride;
        float s = 0.f;
        float dpj = 0.f;
#pragma unroll 8
        for (int d = 0; d < dh; ++d) {
          s = fmaf(q_row[d], to_f(kj[d]), s);
          dpj = fmaf(do_row[d], to_f(vj[d]), dpj);
        }
        s *= scale;
        if (bias_row != nullptr) s += __ldg(bias_row + j * sbk);
        p[j] = s;
        ds[j] = dpj;
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
      float row_dot = 0.f;  // sum_j dP_ij P_ij
      for (int j = lane; j < lk; j += 32) {
        const float pj = p[j] / sum;
        p[j] = pj;
        row_dot = fmaf(ds[j], pj, row_dot);
      }
      row_dot = warp_sum(row_dot);

      float* dbias_row = dbias == nullptr ? nullptr : dbias + (int64_t(b) * lq + i) * lk;
      for (int j = lane; j < lk; j += 32) {
        const float pj = p[j];
        const float dsj = pj * (ds[j] - row_dot);
        if (dbias_row != nullptr) atomicAdd(dbias_row + j, dsj);
        ds[j] = to_f(from_f<T>(dsj * scale));
        p[j] = to_f(from_f<T>(pj));
      }
      __syncwarp();

      // dQ_i = sum_j dS_ij K_j, lanes over dimensions.
      T* dqi = dq + ((int64_t(b) * lq + i) * n_heads + h) * dh;
      for (int d = lane; d < dh; d += 32) {
        float acc = 0.f;
#pragma unroll 4
        for (int j = 0; j < lk; ++j) acc = fmaf(ds[j], to_f(k_s[j * ks_stride + d]), acc);
        dqi[d] = from_f<T>(acc);
      }
    }
    __syncthreads();

    // Fold this round's rows into dV += P^T dO and dK += dS^T Q; each thread
    // owns fixed (key, dimension) cells.
    const int n_rows = min(kWarps, lq - i0);
    for (int idx = threadIdx.x; idx < lk * dh; idx += kThreads) {
      const int j = idx / dh;
      const int d = idx - j * dh;
      float ak = dk_acc[idx];
      float av = dv_acc[idx];
      for (int r = 0; r < n_rows; ++r) {
        const float* rr = rows + r * n_row;
        av = fmaf(rr[j], rr[2 * lk + dh + d], av);
        ak = fmaf(rr[lk + j], rr[2 * lk + d], ak);
      }
      dk_acc[idx] = ak;
      dv_acc[idx] = av;
    }
    __syncthreads();  // the row buffers are rewritten by the next round
  }

  for (int idx = threadIdx.x; idx < lk * dh; idx += kThreads) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    const int64_t o = ((int64_t(b) * lk + j) * n_heads + h) * dh + d;
    dk[o] = from_f<T>(dk_acc[idx]);
    dv[o] = from_f<T>(dv_acc[idx]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* bias, void* dq, void* dk, void* dv, float* dbias, int b,
           int lq, int lk, int h, int dh, const long long* st, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(lk, dh);
  const cudaError_t err = reserve_smem<flash_bwd_kernel<T>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(h, b);
  flash_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), bias, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dbias, lq, lk, h, dh, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper names it when a launch
// is refused.
long long flash_bwd_smem_bytes(int lk, int dh, int is_bf16) {
  return is_bf16 ? (long long)smem_bytes<__nv_bfloat16>(lk, dh)
                 : (long long)smem_bytes<float>(lk, dh);
}

// q and dout [B, Lq, H, Dh], k and v [B, Lk, H, Dh], all with unit stride on
// Dh.  `strides` holds 15 element strides: (B, L, H) of q, k, v and dout,
// then (b, i, j) of the bias, addressed as bias[b*sbb + i*sbq + j*sbk]
// (null: no bias).  dq, dk, dv are contiguous in q's layout and type; dbias,
// when not null, is a zeroed contiguous fp32 [B, Lq, Lk] plane the kernel
// adds the head-summed dS into.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* dout, const float* bias, void* dq, void* dk,
                             void* dv, float* dbias, int b, int lq, int lk, int h,
                             int dh, const long long* strides, float scale,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, dout, bias, dq, dk, dv, dbias, b, lq, lk, h,
                                 dh, strides, scale, s);
  return launch<float>(q, k, v, dout, bias, dq, dk, dv, dbias, b, lq, lk, h, dh,
                       strides, scale, s);
}

}  // extern "C"
