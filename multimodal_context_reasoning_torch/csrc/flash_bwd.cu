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
//     dS = P o (dP - rowsum(dP o P))   (fp32, with P unrounded)
//     dbias[b, i, j] += dS             (summed over heads, before the scale)
//     dQ = (dS / sqrt(Dh)) K           (dS / sqrt(Dh) rounded to the operand type)
//     dK = (dS / sqrt(Dh))^T Q
//
// with every product accumulated in fp32: the TPU kernel's order of casts.
// No [Lq, Lk] tile reaches device memory, except the optional dbias plane.
//
// What differs from the TPU: one TPU program owned a batch element and
// looped over its heads in order, so dbias summed over heads in a register
// tile.  Here one block owns one (batch, head), blocks run in parallel, and
// the head sum is an fp32 atomicAdd into a plane the wrapper zeroes; the
// order of those additions changes from run to run.  dq, dk and dv take no
// atomics and are the same from run to run.
//
// What bounds it on the H100: at the RoBERTa training shape (B = 128 rows,
// Lq = 128, Lk = 138, H = 16, Dh = 64, bf16) five products make 23.2 GFLOP
// against 245 MB of q, k, v, dO read and dq, dk, dv written, 95 FLOP/byte:
// below the card's ~295 FLOP/byte ridge, so the floor is the bytes.
//
// Two kernels, chosen by the operand type (a dispatch, not a fallback):
//
// * bf16: flash_bwd_mma_kernel, on the tensor cores (mma.sync m16n8k16,
//   bf16 operands, fp32 accumulators, operands through ldmatrix).  One block
//   of 8 warps owns one (batch, head).  It copies the head's K and V (keys
//   padded to Lk_pad, a multiple of 16, with zeros) and a tile of 128 query
//   rows of Q and dO from their strided [B, L, H, Dh] layout into shared
//   memory with cp.async, 16 bytes a thread; each row is padded by 16 bytes,
//   so the eight 16-byte rows an ldmatrix reads fall in distinct banks.
//   Each warp then owns 16 query rows against all keys, 16 keys at a time,
//   and keeps no [16, Lk] tile in registers: pass 1 recomputes S and takes
//   the row max and sum (online, quad shuffles); pass 2 recomputes S and
//   dP = dO V^T, forms the fp32 P, sums D = rowsum(dP o P) and writes the
//   rounded P to shared memory; pass 3 recomputes both, forms dS, adds the
//   dbias atomics, writes the rounded dS / sqrt(Dh) to shared memory and
//   feeds the same registers as the A operand of dQ += dS K (the
//   accumulator layout of two 8-key tiles is the A layout of one 16-key
//   step).  Padded keys score -inf, so P and dS are exactly 0 there; a key
//   the caller masks with -1e9 or -10000 stays as it is, so a fully masked
//   row comes out as in the plain version.  After a barrier the warps split
//   the [Lk_pad, Dh] outputs dK and dV into 16-key units (3 at most per warp
//   at Lk <= 192) and run dV += P^T dO and dK += dS^T Q over the tile's
//   rows with ldmatrix.trans operands, the fp32 sums in registers, so no
//   atomics touch them; they are written once at the end.  Recomputing S
//   three times and dP twice adds three products to the five, which the
//   tensor cores absorb at this intensity, and keeps every live register
//   tile O(16 keys).  No second Q/dO buffer: at Lq = 128 a block has one
//   tile, and at Lk = 190 a second buffer (36 KB) would not fit.
//   Budget: shared memory 156,160 B at Lk = 138 and 194,560 B at Lk = 190,
//   one block (8 warps) per SM; registers and spills as ptxas -v reports
//   them (chip_smoke.py phase 2, PERF.md).  That holds K and V for up to
//   resident_keys(64) = 192 keys; above, flash_bwd_mma_long_kernel sweeps
//   the keys in blocks of 64 (its note below; 92,160 B of shared memory at
//   any Lk).  Both exist at Dh = 64 and Dh = 128 (the wrapper zero-pads a
//   narrower head to the next, with the true width's scale) and take
//   16-byte aligned rows.  A head wider than 128 (zero-padded to a multiple
//   of 128) runs the key-looped kernel in slabs of 128 output columns
//   (flash_bwd_mma_long_kernel<128, true>, its note below).  At Dh 128 the
//   resident kernel holds up to 128 keys (208,896 B of shared memory): its
//   dK and dV sums are 2 Lk_pad Dh fp32 over 256 threads, 128 registers a
//   thread at 128 keys and 192 at 144, the most shared memory would hold;
//   and it reads the Q and dO fragments from shared memory at each product
//   instead of holding them (64 registers).  Above 128 keys the key-looped
//   kernel runs, 141,312 B at Dh 128.
//
// * fp32: flash_bwd_kernel, on the FP32 pipes.  A block stages its head's
//   K and V in shared memory and walks the query rows in rounds of eight:
//   in a round each warp owns one row (scores, softmax, dS, the dbias
//   atomics and that row's dQ, with lanes over keys and then over
//   dimensions), and then all 256 threads fold the round's eight rounded P
//   and dS rows into fp32 dK and dV accumulators in shared memory, each
//   thread owning fixed (key, dimension) cells.  155 KB of shared memory
//   at Lk = 138, 212 KB at Lk = 190.  Beyond one block's shared memory
//   (about 208 keys at Dh 64) flash_bwd_stream_kernel reads K and V from
//   device memory and keeps the dK and dV sums in the outputs.  The staged
//   kernel takes heads up to kMaxDh = 256 (common.cuh); a wider head streams
//   in slabs of 256 columns, one block per slab (only the first adds into
//   the dbias plane).
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/flash.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

// ------------------------------------------------------------------ fp32

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

// Lk beyond one block's shared memory (about 208 keys at Dh 64): the same
// rounds of eight rows and the same order of sums, with K and V read from
// device memory and the dK and dV sums kept in the fp32 outputs themselves.
// Per row, a warp first takes the running max and sum over its lanes' keys
// (merged across the warp) and D = rowsum(dP o P); then the block walks the
// keys 32 at a time: each warp writes its row's P and dS for the chunk to
// shared memory (the dbias atomics as above) and adds the chunk to its dQ,
// and after a barrier each thread folds the round's rows, in order, into
// fixed (key, dimension) cells of dK and dV.  Any Lk; Dh <= MaxDh, each lane
// holding MaxDh / 32 dQ columns (instantiated at kNarrowDh and kMaxDh,
// common.cuh).  With Slabs, any Dh: the grid's x holds each head's slabs of
// MaxDh columns in turn; a block recomputes S and dP over the whole head,
// reading q and dO through L1 (the same products in the same order), stages
// only its slab's columns of them for dK and dV, writes its slab of dq, dk
// and dv, and only the first slab's blocks add into the dbias plane.
template <int MaxDh, bool Slabs>
__global__ void __launch_bounds__(kThreads)
flash_bwd_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ bias, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dbias, int lq, int lk, int n_heads, int dh,
                        int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb, int64_t ski,
                        int64_t skh, int64_t svb, int64_t svi, int64_t svh, int64_t sob,
                        int64_t soi, int64_t soh, int64_t sbb, int64_t sbq, int64_t sbk,
                        float scale) {
  __shared__ float q_s[kWarps][MaxDh];  // the row's q, or its slab's columns
  __shared__ float do_s[kWarps][MaxDh];
  __shared__ float p_s[kWarps][32];   // P of the chunk, one row per warp
  __shared__ float ds_s[kWarps][32];  // dS / sqrt(Dh) of the chunk
  const int n_slabs = Slabs ? ceil_div(dh, MaxDh) : 1;
  const int h = Slabs ? blockIdx.x / n_slabs : blockIdx.x;
  const int d0 = Slabs ? MaxDh * (blockIdx.x % n_slabs) : 0;  // the slab's first column
  const int w = Slabs ? min(MaxDh, dh - d0) : dh;              // and its width
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  float* q_row = q_s[warp];
  float* do_row = do_s[warp];

  for (int i0 = 0; i0 < lq; i0 += kWarps) {
    const int i = i0 + warp;  // warp-uniform
    const bool active = i < lq;
    const int n_rows = min(kWarps, lq - i0);
    if (active) {
      const float* qi = q + b * sqb + i * sqi + h * sqh;
      const float* doi = dout + b * sob + i * soi + h * soh;
      for (int d = lane; d < w; d += 32) {
        q_row[d] = qi[d0 + d];
        do_row[d] = doi[d0 + d];
      }
    }
    __syncwarp();
    // the whole rows, read through L1 by a slab's scores (read only when active)
    const float* q_all = Slabs ? q + b * sqb + i * sqi + h * sqh : nullptr;
    const float* do_all = Slabs ? dout + b * sob + i * soi + h * soh : nullptr;
    const float* bias_row = (bias != nullptr && active) ? bias + b * sbb + i * sbq : nullptr;
    // S = (q . k) * scale + bias and dP = dO . v for key j
    auto score = [&](int j, float& dpj) {
      const float* kj = kb + j * ski;
      const float* vj = vb + j * svi;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) {
        s = fmaf(Slabs ? __ldg(q_all + d) : q_row[d], kj[d], s);
        dp = fmaf(Slabs ? __ldg(do_all + d) : do_row[d], vj[d], dp);
      }
      s *= scale;
      if (bias_row != nullptr) s += __ldg(bias_row + j * sbk);
      dpj = dp;
      return s;
    };

    float m = -INFINITY, l = 0.f, row_dot = 0.f;
    if (active) {
      float dpj;
      for (int j = lane; j < lk; j += 32) {
        const float s = score(j, dpj);
        const float mn = fmaxf(m, s);
        l = l * expf(m - mn) + expf(s - mn);
        m = mn;
      }
      const float mw = warp_max(m);
      l = warp_sum(m == -INFINITY ? 0.f : l * expf(m - mw));
      m = mw;
      for (int j = lane; j < lk; j += 32) {
        const float s = score(j, dpj);
        row_dot = fmaf(dpj, expf(s - m) / l, row_dot);
      }
      row_dot = warp_sum(row_dot);
    }

    float dq_r[MaxDh / 32] = {};
    for (int j0 = 0; j0 < lk; j0 += 32) {
      const int j = j0 + lane;
      float pj = 0.f, dsj = 0.f;
      if (active && j < lk) {
        float dpj;
        const float s = score(j, dpj);
        pj = expf(s - m) / l;
        dsj = pj * (dpj - row_dot);
        if (dbias != nullptr && d0 == 0)
          atomicAdd(dbias + (int64_t(b) * lq + i) * lk + j, dsj);
        dsj *= scale;
      }
      p_s[warp][lane] = pj;
      ds_s[warp][lane] = dsj;
      __syncthreads();
      const int n = min(32, lk - j0);
      if (active) {
#pragma unroll
        for (int r = 0; r < MaxDh / 32; ++r) {
          const int d = lane + 32 * r;
          if (d < w)
            for (int jj = 0; jj < n; ++jj)
              dq_r[r] = fmaf(ds_s[warp][jj], kb[(j0 + jj) * ski + d0 + d], dq_r[r]);
        }
      }
      // dV += P^T dO and dK += dS^T Q over the round's rows, in order
      for (int c = threadIdx.x; c < n * w; c += kThreads) {
        const int jj = c / w;
        const int d = c - jj * w;
        const int64_t o = ((int64_t(b) * lk + j0 + jj) * n_heads + h) * dh + d0 + d;
        float ak = i0 == 0 ? 0.f : dk[o];
        float av = i0 == 0 ? 0.f : dv[o];
        for (int r = 0; r < n_rows; ++r) {
          av = fmaf(p_s[r][jj], do_s[r][d], av);
          ak = fmaf(ds_s[r][jj], q_s[r][d], ak);
        }
        dk[o] = ak;
        dv[o] = av;
      }
      __syncthreads();  // the chunk buffers are rewritten by the next chunk
    }
    if (active) {
      float* dqi = dq + ((int64_t(b) * lq + i) * n_heads + h) * dh + d0;
#pragma unroll
      for (int r = 0; r < MaxDh / 32; ++r)
        if (lane + 32 * r < w) dqi[lane + 32 * r] = dq_r[r];
    }
  }
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileRows = 16 * kMmaWarps;  // query rows per tile, 16 per warp
constexpr int kRowPad = 8;                 // elements (16 bytes) after each smem row

// Keys held resident in flash_bwd_mma_kernel<Dh>: 192 at Dh 64; 128 at
// Dh 128, where the dK and dV sums reach 128 registers a thread.
__host__ __device__ constexpr int resident_keys(int dh) { return dh == 64 ? 192 : 128; }
// dK and dV units of 16 keys x Dh per warp: 2 * 192 / 16 = 24 over 8 warps
// at Dh 64, 2 * 128 / 16 = 16 at Dh 128.
__host__ __device__ constexpr int max_units(int dh) {
  return (2 * resident_keys(dh) / 16 + kMmaWarps - 1) / kMmaWarps;
}
// flash_bwd_mma_long_kernel's key blocks: 2 * 64 / 16 = 8 units, one per warp
constexpr int kBlkKeys = 64;
constexpr int kBlkPairs = kBlkKeys / 16;

size_t mma_smem_bytes(int lk, int dh) {
  const size_t lkp = pad16(lk);
  return sizeof(bf16) * (2 * lkp * (dh + kRowPad) + 2 * size_t(kTileRows) * (dh + kRowPad)
                         + 2 * size_t(kTileRows) * (lkp + kRowPad));
}

// The key-looped kernel's: one K and one V block, the Q and dO tiles, and
// P and dS for the tile's rows against one key block; 92,160 B at Dh 64.
size_t mma_long_smem_bytes(int dh) {
  return sizeof(bf16) * (2 * size_t(kBlkKeys) * (dh + kRowPad) +
                         2 * size_t(kTileRows) * (dh + kRowPad) +
                         2 * size_t(kTileRows) * (kBlkKeys + kRowPad));
}

// Accumulator layout of an m16n8 tile: c[e] sits at row lane / 4 + 8 (e / 2),
// column 2 (lane % 4) + e % 2.  A fragment (16x16): a[0] rows 0-7, a[1] rows
// 8-15, a[2] and a[3] the same rows at columns 8-15.
template <int Dh>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ bias, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dbias, int lq, int lk, int n_heads, int64_t sqb,
                     int64_t sqi, int64_t sqh, int64_t skb, int64_t ski, int64_t skh,
                     int64_t svb, int64_t svi, int64_t svh, int64_t sob, int64_t soi,
                     int64_t soh, int64_t sbb, int64_t sbq, int64_t sbk, float scale) {
  constexpr int kS = Dh + kRowPad;  // row stride of K, V, Q, dO in shared memory
  constexpr int kChunks = Dh / 8;   // 16-byte chunks per row
  constexpr int kSteps = Dh / 16;   // k-steps over Dh
  constexpr int kDt = Dh / 8;       // 8-wide n-tiles over Dh
  constexpr int kMaxUnits = max_units(Dh);
  // Dh 64 holds the warp's Q and dO fragments in registers for a tile; Dh 128
  // reads them from shared memory at each product
  constexpr bool kHoldX = Dh == 64;
  constexpr int kHeld = kHoldX ? kSteps : 1;
  const int lkp = pad16(lk);
  const int ps = lkp + kRowPad;     // row stride of P and dS
  const int n_pairs = lkp / 16;
  const int n_units = 2 * n_pairs;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [lkp][kS]
  bf16* v_s = k_s + lkp * kS;                 // [lkp][kS]
  bf16* q_s = v_s + lkp * kS;                 // [kTileRows][kS]
  bf16* do_s = q_s + kTileRows * kS;          // [kTileRows][kS]
  bf16* p_s = do_s + kTileRows * kS;          // [kTileRows][ps], P rounded
  bf16* ds_s = p_s + kTileRows * ps;          // [kTileRows][ps], dS / sqrt(Dh) rounded

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;  // this warp's first row in the tile

  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* ob = dout + b * sob + h * soh;
  for (int c = threadIdx.x; c < lkp * kChunks; c += kMmaThreads) {
    const int j = c / kChunks;
    const int d = (c % kChunks) * 8;
    const bool ok = j < lk;
    cp_async16(k_s + j * kS + d, kb + (ok ? j : 0) * ski + d, ok);
    cp_async16(v_s + j * kS + d, vb + (ok ? j : 0) * svi + d, ok);
  }

  float acc[kMaxUnits][kDt][4];  // dV (even units) and dK (odd), 16 keys each
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u)
#pragma unroll
    for (int n = 0; n < kDt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][n][e] = 0.f;

  for (int i0 = 0; i0 < lq; i0 += kTileRows) {
    for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const bool ok = i0 + r < lq;
      const int i = ok ? i0 + r : 0;
      cp_async16(q_s + r * kS + d, qb + i * sqi + d, ok);
      cp_async16(do_s + r * kS + d, ob + i * soi + d, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- rows: S, P, dP, D, dS, dQ for this warp's 16 query rows
    int row[2];
    const float* brow[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      row[hi] = i0 + r0 + g + 8 * hi;
      brow[hi] = (bias != nullptr && row[hi] < lq) ? bias + b * sbb + row[hi] * sbq : nullptr;
    }
    uint32_t qa[kHeld][4], oa[kHeld][4];
    if constexpr (kHoldX) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int off = (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4);
        ldsm_x4(qa[s], q_s + off);
        ldsm_x4(oa[s], do_s + off);
      }
    }
    // X (16 rows: the held fragments xa, or read from x_s) times the 16 rows
    // jp*16.. of Y^T, as two 8-key tiles
    auto product = [&](const uint32_t (&xa)[kHeld][4], const bf16* x_s, const bf16* y_s,
                       int jp, float (&out)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t y[4];
        ldsm_x4(y, y_s + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kS + 16 * s +
                       8 * ((lane >> 3) & 1));
        if constexpr (kHoldX) {
          mma16816(out[0], xa[s], y[0], y[1]);
          mma16816(out[1], xa[s], y[2], y[3]);
        } else {
          uint32_t x[4];
          ldsm_x4(x, x_s + (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
          mma16816(out[0], x, y[0], y[1]);
          mma16816(out[1], x, y[2], y[3]);
        }
      }
    };
    auto scores = [&](int jp, float (&sc)[2][4]) {
      product(qa, q_s, k_s, jp, sc);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * jp + 8 * n + 2 * t + (e & 1);
          const float* br = brow[e >> 1];
          float x = __fmul_rn(sc[n][e], scale);
          if (j >= lk)
            x = -INFINITY;
          else if (br != nullptr)
            x += __ldg(br + j * sbk);
          sc[n][e] = x;
        }
    };

    // pass 1: row max and sum of exp, online over 16-key steps
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    for (int jp = 0; jp < n_pairs; ++jp) {
      float sc[2][4];
      scores(jp, sc);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float mx = quad_max(fmaxf(fmaxf(sc[0][2 * hi], sc[0][2 * hi + 1]),
                                        fmaxf(sc[1][2 * hi], sc[1][2 * hi + 1])));
        const float mn = fmaxf(m[hi], mx);
        float sum = l[hi] * expf(m[hi] - mn);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          sum += expf(sc[n][2 * hi] - mn) + expf(sc[n][2 * hi + 1] - mn);
        m[hi] = mn;
        l[hi] = sum;
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // pass 2: P (fp32), dP, D = rowsum(dP o P); P rounded to shared memory
    float dsum[2] = {0.f, 0.f};
    for (int jp = 0; jp < n_pairs; ++jp) {
      float sc[2][4], dp[2][4];
      scores(jp, sc);
      product(oa, do_s, v_s, jp, dp);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = expf(sc[n][e] - m[e >> 1]) / l[e >> 1];
          dsum[e >> 1] += dp[n][e] * sc[n][e];
        }
        const int col = 16 * jp + 8 * n + 2 * t;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<uint32_t*>(p_s + (r0 + g + 8 * hi) * ps + col) =
              pack_bf16(sc[n][2 * hi], sc[n][2 * hi + 1]);
      }
    }
    const float dd[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};

    // pass 3: dS, the dbias atomics, dS / sqrt(Dh) rounded to shared memory
    // and, from the same registers, dQ += dS K
    float dqa[kDt][4];
#pragma unroll
    for (int n = 0; n < kDt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
    for (int jp = 0; jp < n_pairs; ++jp) {
      float sc[2][4], dp[2][4];
      scores(jp, sc);
      product(oa, do_s, v_s, jp, dp);
      uint32_t a[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * jp + 8 * n + 2 * t;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sc[n][2 * hi + e] - m[hi]) / l[hi];
            ds[e] = p * (dp[n][2 * hi + e] - dd[hi]);
            if (dbias != nullptr && row[hi] < lq && col + e < lk)
              atomicAdd(dbias + (int64_t(b) * lq + row[hi]) * lk + col + e, ds[e]);
          }
          a[2 * n + hi] = pack_bf16(ds[0] * scale, ds[1] * scale);
          *reinterpret_cast<uint32_t*>(ds_s + (r0 + g + 8 * hi) * ps + col) = a[2 * n + hi];
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t y[4];
        ldsm_x4_t(y, k_s + (16 * jp + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
        mma16816(dqa[2 * s], a, y[0], y[1]);
        mma16816(dqa[2 * s + 1], a, y[2], y[3]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (row[hi] >= lq) continue;
      bf16* out = dq + ((int64_t(b) * lq + row[hi]) * n_heads + h) * Dh + 2 * t;
#pragma unroll
      for (int n = 0; n < kDt; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(dqa[n][2 * hi], dqa[n][2 * hi + 1]);
    }
    __syncthreads();

    // ---- keys: dV += P^T dO and dK += dS^T Q over the tile's rows; each
    // warp owns fixed 16-key units of dV and dK
    const int rows_here = pad16(min(kTileRows, lq - i0));
#pragma unroll
    for (int u = 0; u < kMaxUnits; ++u) {
      const int unit = warp + kMmaWarps * u;
      if (unit >= n_units) break;
      const bool is_dk = unit & 1;
      const int key0 = 16 * (unit >> 1);
      const bf16* a_s = is_dk ? ds_s : p_s;
      const bf16* b_s = is_dk ? q_s : do_s;
      for (int r = 0; r < rows_here; r += 16) {
        uint32_t a[4];
        ldsm_x4_t(a, a_s + (r + (lane & 7) + 8 * (lane >> 4)) * ps + key0 +
                         8 * ((lane >> 3) & 1));
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t y[4];
          ldsm_x4_t(y, b_s + (r + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
          mma16816(acc[u][2 * s], a, y[0], y[1]);
          mma16816(acc[u][2 * s + 1], a, y[2], y[3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites Q, dO, P and dS
  }

#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    const int unit = warp + kMmaWarps * u;
    if (unit >= n_units) break;
    bf16* base = (unit & 1) ? dk : dv;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int j = 16 * (unit >> 1) + g + 8 * hi;
      if (j >= lk) continue;
      bf16* out = base + ((int64_t(b) * lk + j) * n_heads + h) * Dh + 2 * t;
#pragma unroll
      for (int n = 0; n < kDt; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(acc[u][n][2 * hi], acc[u][n][2 * hi + 1]);
    }
  }
}

// Lk > resident_keys(Dh): the same three passes per 16 query rows, with the key
// axis in blocks of kBlkKeys that each pass sweeps in order (K and V copied
// into shared memory per block).  Per tile of 128 query rows: sweep 1 takes
// each row's running max and sum (rescaled when the max grows), sweep 2
// D = rowsum(dP o P), both kept in registers by the lanes that own the row;
// sweep 3 recomputes S and dP per block, forms dS, adds the dbias atomics,
// accumulates dQ += dS K in registers across the blocks in key order (one
// owner per element, written once per tile), writes the rounded P and dS of
// the block to shared memory, and then each warp runs one 16-key unit of the
// block's dV or dK over the tile's rows.  A unit's sum starts from zero on
// the first query tile and from its owner's fp32 partial in `part` (device
// memory, [2][B][H][Lk][Dh], dV then dK) on later ones, and goes back there,
// or to dk and dv in bf16 after the last tile: the same thread reads and
// writes the same elements in tile order, so no atomics touch dq, dk or dv
// and two launches give the same bits.  `part` is needed only when Lq > 128.
//
// With Slabs (at Dh = kSlabDh), a head of `slabs` 128-column slabs at any
// key count (the wrapper zero-pads a wider head to the next multiple of
// 128, with the true width's scale; no resident variant, as holding the
// whole head's K and V is what the slabs avoid): one block per (head,
// output slab, batch row) on an (H * slabs, B) grid.  Each sweep takes a
// key block's S (and dP) as the sum over the head's input slabs, in slab
// order: slab sl of the block's K (and V) and of the tile's Q (and dO) is
// copied into the Dh-128 buffers and multiplied into fp32 accumulators
// held for the block's 64 keys, so every block of a head computes the same
// S, P, dP and D.  Sweep 3 then copies its own slab of K, Q and dO back
// (unless the last slab, still in place, is its own) for dQ, dK and dV,
// whose columns it alone writes; `part` is [2][B][H][Lk][slabs * 128].
// Only the first slab's blocks add dS into the dbias plane, so the plane
// holds the head sum once.  S and dP are recomputed once per output slab.
template <int Dh, bool Slabs = false>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_mma_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ bias, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dbias, float* __restrict__ part, int lq,
                          int lk, int n_heads, int64_t sqb, int64_t sqi, int64_t sqh,
                          int64_t skb, int64_t ski, int64_t skh, int64_t svb, int64_t svi,
                          int64_t svh, int64_t sob, int64_t soi, int64_t soh, int64_t sbb,
                          int64_t sbq, int64_t sbk, float scale) {
  static_assert(!Slabs || Dh == kSlabDh, "slabs are kSlabDh columns wide");
  constexpr int kS = Dh + kRowPad;        // row stride of K, V, Q, dO in shared memory
  constexpr int kPs = kBlkKeys + kRowPad;  // row stride of P and dS
  constexpr int kChunks = Dh / 8;
  constexpr int kSteps = Dh / 16;
  constexpr int kDt = Dh / 8;
  // Q and dO fragments held (Dh 64) or read at each product (Dh 128), as in
  // flash_bwd_mma_kernel
  constexpr bool kHoldX = Dh == 64;
  constexpr int kHeld = kHoldX ? kSteps : 1;
  static_assert(2 * kBlkPairs == kMmaWarps, "one dV or dK unit of a key block per warp");
  const int n_blocks = (lk + kBlkKeys - 1) / kBlkKeys;
  const int slabs = Slabs ? gridDim.x / n_heads : 1;
  const int width = Dh * slabs;  // the (padded) head

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBlkKeys][kS]
  bf16* v_s = k_s + kBlkKeys * kS;            // [kBlkKeys][kS]
  bf16* q_s = v_s + kBlkKeys * kS;            // [kTileRows][kS]
  bf16* do_s = q_s + kTileRows * kS;          // [kTileRows][kS]
  bf16* p_s = do_s + kTileRows * kS;          // [kTileRows][kPs], P rounded
  bf16* ds_s = p_s + kTileRows * kPs;         // [kTileRows][kPs], dS / sqrt(Dh) rounded

  const int h = Slabs ? blockIdx.x / slabs : blockIdx.x;
  const int own = Slabs ? blockIdx.x % slabs : 0;  // this block's output slab
  const int c0 = Dh * own;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;

  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* ob = dout + b * sob + h * soh;
  // this warp's unit: dV (even warps) or dK of 16 keys from kl in each block
  const bool is_dk = warp & 1;
  const int kl = 16 * (warp >> 1);
  float* part_u = part == nullptr
                      ? nullptr
                      : part + (is_dk ? int64_t(gridDim.y) * n_heads * lk * width : 0) +
                            (int64_t(b) * n_heads + h) * lk * width + c0;
  bf16* out_u = is_dk ? dk : dv;

  // key block blk's K (and V) into shared memory, after every copy issued so
  // far (the Q and dO tile's too) has landed
  auto load_kv = [&](int blk, bool with_v) {
    const int key0 = blk * kBlkKeys;
    for (int c = threadIdx.x; c < kBlkKeys * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const int j = key0 + r;
      const bool ok = j < lk;
      cp_async16(k_s + r * kS + d, kb + (ok ? j : 0) * ski + d, ok);
      if (with_v) cp_async16(v_s + r * kS + d, vb + (ok ? j : 0) * svi + d, ok);
    }
    cp_async_wait_all();
    __syncthreads();
  };
  // Slabs: input slab sl of key block blk's K (and V) and of the tile's Q
  // (and dO) rows into shared memory, once every warp is done with what is
  // there
  auto load_slab = [&](int i0, int blk, int sl, bool with_v, bool with_do) {
    __syncthreads();
    const int key0 = blk * kBlkKeys;
    const int col = Dh * sl;
    for (int c = threadIdx.x; c < kBlkKeys * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const int j = key0 + r;
      const bool ok = j < lk;
      cp_async16(k_s + r * kS + d, kb + (ok ? j : 0) * ski + col + d, ok);
      if (with_v) cp_async16(v_s + r * kS + d, vb + (ok ? j : 0) * svi + col + d, ok);
    }
    for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const bool ok = i0 + r < lq;
      const int i = ok ? i0 + r : 0;
      cp_async16(q_s + r * kS + d, qb + i * sqi + col + d, ok);
      if (with_do) cp_async16(do_s + r * kS + d, ob + i * soi + col + d, ok);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  for (int i0 = 0; i0 < lq; i0 += kTileRows) {
    if constexpr (!Slabs) {
      for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
        const int r = c / kChunks;
        const int d = (c % kChunks) * 8;
        const bool ok = i0 + r < lq;
        const int i = ok ? i0 + r : 0;
        cp_async16(q_s + r * kS + d, qb + i * sqi + d, ok);
        cp_async16(do_s + r * kS + d, ob + i * soi + d, ok);
      }
    }

    int row[2];
    const float* brow[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      row[hi] = i0 + r0 + g + 8 * hi;
      brow[hi] = (bias != nullptr && row[hi] < lq) ? bias + b * sbb + row[hi] * sbq : nullptr;
    }
    uint32_t qa[kHeld][4], oa[kHeld][4];
    // out += this warp's 16 rows of x_s (or the held xa) times the 16 keys
    // from 16 jp of y_s, transposed
    auto accumulate = [&](const uint32_t (&xa)[kHeld][4], const bf16* x_s, const bf16* y_s,
                          int jp, float (&out)[2][4]) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t y[4];
        ldsm_x4(y, y_s + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kS + 16 * s +
                       8 * ((lane >> 3) & 1));
        if constexpr (kHoldX) {
          mma16816(out[0], xa[s], y[0], y[1]);
          mma16816(out[1], xa[s], y[2], y[3]);
        } else {
          uint32_t x[4];
          ldsm_x4(x, x_s + (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
          mma16816(out[0], x, y[0], y[1]);
          mma16816(out[1], x, y[2], y[3]);
        }
      }
    };
    auto product = [&](const uint32_t (&xa)[kHeld][4], const bf16* x_s, const bf16* y_s,
                       int jp, float (&out)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
      accumulate(xa, x_s, y_s, jp, out);
    };
    // Slabs: the key block's S (and dP, with_dp) summed over the head's
    // input slabs, for every pair of 8-key tiles
    float s_blk[kBlkPairs][2][4], dp_blk[kBlkPairs][2][4];
    auto slab_scores = [&](int blk, bool with_dp) {
#pragma unroll
      for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_blk[jp][n][e] = dp_blk[jp][n][e] = 0.f;
      for (int sl = 0; sl < slabs; ++sl) {
        load_slab(i0, blk, sl, with_dp, with_dp);
#pragma unroll
        for (int jp = 0; jp < kBlkPairs; ++jp) {
          accumulate(qa, q_s, k_s, jp, s_blk[jp]);
          if (with_dp) accumulate(oa, do_s, v_s, jp, dp_blk[jp]);
        }
      }
    };
    auto scores = [&](int key0, int jp, float (&sc)[2][4]) {
      if constexpr (Slabs) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = s_blk[jp][n][e];
      } else {
        product(qa, q_s, k_s, jp, sc);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = key0 + 16 * jp + 8 * n + 2 * t + (e & 1);
          const float* br = brow[e >> 1];
          float x = __fmul_rn(sc[n][e], scale);
          if (j >= lk)
            x = -INFINITY;
          else if (br != nullptr)
            x += __ldg(br + j * sbk);
          sc[n][e] = x;
        }
    };
    // dP = dO V^T of the block's keys 16 jp..
    auto dprod = [&](int jp, float (&dp)[2][4]) {
      if constexpr (Slabs) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = dp_blk[jp][n][e];
      } else {
        product(oa, do_s, v_s, jp, dp);
      }
    };

    // sweep 1: row max and sum of exp, online over the key blocks
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    for (int blk = 0; blk < n_blocks; ++blk) {
      if constexpr (Slabs) {
        slab_scores(blk, false);
      } else {
        load_kv(blk, false);
        if constexpr (kHoldX) {
          if (blk == 0) {
#pragma unroll
            for (int s = 0; s < kSteps; ++s) {
              const int off = (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4);
              ldsm_x4(qa[s], q_s + off);
              ldsm_x4(oa[s], do_s + off);
            }
          }
        }
      }
      for (int jp = 0; jp < kBlkPairs; ++jp) {
        float sc[2][4];
        scores(blk * kBlkKeys, jp, sc);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float mx = quad_max(fmaxf(fmaxf(sc[0][2 * hi], sc[0][2 * hi + 1]),
                                          fmaxf(sc[1][2 * hi], sc[1][2 * hi + 1])));
          const float mn = fmaxf(m[hi], mx);
          float sum = l[hi] * expf(m[hi] - mn);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            sum += expf(sc[n][2 * hi] - mn) + expf(sc[n][2 * hi + 1] - mn);
          m[hi] = mn;
          l[hi] = sum;
        }
      }
      __syncthreads();  // the next block overwrites K
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // sweep 2: D = rowsum(dP o P) with the fp32 P
    float dsum[2] = {0.f, 0.f};
    for (int blk = 0; blk < n_blocks; ++blk) {
      if constexpr (Slabs) {
        slab_scores(blk, true);
      } else {
        load_kv(blk, true);
      }
      for (int jp = 0; jp < kBlkPairs; ++jp) {
        float sc[2][4], dp[2][4];
        scores(blk * kBlkKeys, jp, sc);
        dprod(jp, dp);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dsum[e >> 1] += dp[n][e] * (expf(sc[n][e] - m[e >> 1]) / l[e >> 1]);
      }
      __syncthreads();
    }
    const float dd[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};

    // sweep 3: dS, dbias, dQ; then the block's dV and dK units
    float dqa[kDt][4];
#pragma unroll
    for (int n = 0; n < kDt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
    const bool first_tile = i0 == 0;
    const bool last_tile = i0 + kTileRows >= lq;
    const int rows_here = pad16(min(kTileRows, lq - i0));
    for (int blk = 0; blk < n_blocks; ++blk) {
      const int key0 = blk * kBlkKeys;
      if constexpr (Slabs) {
        slab_scores(blk, true);
        if (own != slabs - 1) load_slab(i0, blk, own, false, true);  // K, Q, dO of this slab
      } else {
        load_kv(blk, true);
      }
      for (int jp = 0; jp < kBlkPairs; ++jp) {
        float sc[2][4], dp[2][4];
        scores(key0, jp, sc);
        dprod(jp, dp);
        uint32_t a[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * jp + 8 * n + 2 * t;  // in the block
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              p[e] = expf(sc[n][2 * hi + e] - m[hi]) / l[hi];
              ds[e] = p[e] * (dp[n][2 * hi + e] - dd[hi]);
              if (own == 0 && dbias != nullptr && row[hi] < lq && key0 + col + e < lk)
                atomicAdd(dbias + (int64_t(b) * lq + row[hi]) * lk + key0 + col + e, ds[e]);
            }
            a[2 * n + hi] = pack_bf16(ds[0] * scale, ds[1] * scale);
            *reinterpret_cast<uint32_t*>(ds_s + (r0 + g + 8 * hi) * kPs + col) = a[2 * n + hi];
            *reinterpret_cast<uint32_t*>(p_s + (r0 + g + 8 * hi) * kPs + col) =
                pack_bf16(p[0], p[1]);
          }
        }
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t y[4];
          ldsm_x4_t(y, k_s + (16 * jp + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
          mma16816(dqa[2 * s], a, y[0], y[1]);
          mma16816(dqa[2 * s + 1], a, y[2], y[3]);
        }
      }
      __syncthreads();

      // this warp's unit: dV += P^T dO or dK += dS^T Q over the tile's rows
      float acc[kDt][4];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = key0 + kl + g + 8 * hi;
#pragma unroll
        for (int n = 0; n < kDt; ++n) {
          float2 prev = make_float2(0.f, 0.f);
          if (!first_tile && j < lk)
            prev = *reinterpret_cast<const float2*>(part_u + int64_t(j) * width + 8 * n + 2 * t);
          acc[n][2 * hi] = prev.x;
          acc[n][2 * hi + 1] = prev.y;
        }
      }
      const bf16* a_s = is_dk ? ds_s : p_s;
      const bf16* b_s = is_dk ? q_s : do_s;
      for (int r = 0; r < rows_here; r += 16) {
        uint32_t a[4];
        ldsm_x4_t(a, a_s + (r + (lane & 7) + 8 * (lane >> 4)) * kPs + kl +
                         8 * ((lane >> 3) & 1));
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t y[4];
          ldsm_x4_t(y, b_s + (r + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
          mma16816(acc[2 * s], a, y[0], y[1]);
          mma16816(acc[2 * s + 1], a, y[2], y[3]);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = key0 + kl + g + 8 * hi;
        if (j >= lk) continue;
#pragma unroll
        for (int n = 0; n < kDt; ++n) {
          if (last_tile)
            *reinterpret_cast<uint32_t*>(out_u + ((int64_t(b) * lk + j) * n_heads + h) * width +
                                         c0 + 8 * n + 2 * t) =
                pack_bf16(acc[n][2 * hi], acc[n][2 * hi + 1]);
          else
            *reinterpret_cast<float2*>(part_u + int64_t(j) * width + 8 * n + 2 * t) =
                make_float2(acc[n][2 * hi], acc[n][2 * hi + 1]);
        }
      }
      __syncthreads();  // the next block overwrites K, V, P and dS
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (row[hi] >= lq) continue;
      bf16* out = dq + ((int64_t(b) * lq + row[hi]) * n_heads + h) * width + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kDt; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(dqa[n][2 * hi], dqa[n][2 * hi + 1]);
    }
  }
}

int launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                const float* bias, void* dq, void* dk, void* dv, float* dbias, int b,
                int lq, int lk, int h, int dh, const long long* st, float scale,
                cudaStream_t stream) {
  if (dh < 1) return int(cudaErrorInvalidValue);
  const dim3 grid(h, b);
  const size_t smem = smem_bytes<float>(lk, dh);
  if (dh > kMaxDh || !fits_smem(smem)) {
    // the narrower of the streaming kernel's two widths that holds Dh, or
    // the wider one in slabs
    auto kernel = dh <= kNarrowDh ? flash_bwd_stream_kernel<kNarrowDh, false>
                  : dh <= kMaxDh  ? flash_bwd_stream_kernel<kMaxDh, false>
                                  : flash_bwd_stream_kernel<kMaxDh, true>;
    kernel<<<dim3(h * ceil_div(dh, kMaxDh), b), kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), bias,
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), dbias,
        lq, lk, h, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], st[12], st[13], st[14], scale);
    return int(cudaGetLastError());
  }
  const cudaError_t err = reserve_smem<flash_bwd_kernel<float>>(smem);
  if (err != cudaSuccess) return int(err);
  flash_bwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), bias,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), dbias, lq,
      lk, h, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], scale);
  return int(cudaGetLastError());
}

// The fp32 floats flash_bwd_mma_long_kernel keeps between query tiles: none
// when there is one tile, or when K and V are resident; in slabs they hold
// every slab of the head.
size_t long_part_floats(int b, int lq, int lk, int h, int dh) {
  const bool looped = mma_slabs(dh) > 0 || lk > resident_keys(dh);
  return looped && lq > kTileRows ? 2 * size_t(b) * h * lk * dh : 0;
}

// The key-looped kernel at head dim Dh on an (H * slabs, B) grid (with
// Slabs, a head of `slabs` 128-column slabs; else slabs is 1).
template <int Dh, bool Slabs>
int launch_long(const void* q, const void* k, const void* v, const void* dout,
                const float* bias, void* dq, void* dk, void* dv, float* dbias, float* part,
                int b, int lq, int lk, int h, int slabs, const long long* st, float scale,
                cudaStream_t stream) {
  if (part == nullptr && long_part_floats(b, lq, lk, h, Dh * slabs) > 0)
    return int(cudaErrorInvalidValue);
  const size_t smem = mma_long_smem_bytes(Dh);
  const cudaError_t err = reserve_smem<flash_bwd_mma_long_kernel<Dh, Slabs>>(smem);
  if (err != cudaSuccess) return int(err);
  flash_bwd_mma_long_kernel<Dh, Slabs><<<dim3(h * slabs, b), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), bias, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias, part, lq, lk, h, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale);
  return int(cudaGetLastError());
}

// The resident kernel at head dim Dh up to resident_keys(Dh) keys, the
// key-looped one above.
template <int Dh>
int launch_bf16_at(const void* q, const void* k, const void* v, const void* dout,
                   const float* bias, void* dq, void* dk, void* dv, float* dbias, float* part,
                   int b, int lq, int lk, int h, const long long* st, float scale,
                   cudaStream_t stream) {
  if (lk > resident_keys(Dh))
    return launch_long<Dh, false>(q, k, v, dout, bias, dq, dk, dv, dbias, part, b, lq, lk, h,
                                  1, st, scale, stream);
  const size_t smem = mma_smem_bytes(lk, Dh);
  const cudaError_t err = reserve_smem<flash_bwd_mma_kernel<Dh>>(smem);
  if (err != cudaSuccess) return int(err);
  flash_bwd_mma_kernel<Dh><<<dim3(h, b), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), bias, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias, lq, lk, h, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale);
  return int(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* bias, void* dq, void* dk, void* dv, float* dbias, float* part,
                int b, int lq, int lk, int h, int dh, const long long* st, float scale,
                cudaStream_t stream) {
  if (const int slabs = mma_slabs(dh))
    return launch_long<kSlabDh, true>(q, k, v, dout, bias, dq, dk, dv, dbias, part, b, lq, lk,
                                      h, slabs, st, scale, stream);
  if (!mma_head_dim(dh)) return int(cudaErrorInvalidValue);
  return dh == 64 ? launch_bf16_at<64>(q, k, v, dout, bias, dq, dk, dv, dbias, part, b, lq,
                                       lk, h, st, scale, stream)
                  : launch_bf16_at<128>(q, k, v, dout, bias, dq, dk, dv, dbias, part, b, lq,
                                        lk, h, st, scale, stream);
}

}  // namespace

extern "C" {

// fp32 scratch floats the wrapper allocates and passes as `part` (0: none).
long long flash_bwd_part_floats(int b, int lq, int lk, int h, int dh, int is_bf16) {
  return is_bf16 ? (long long)long_part_floats(b, lq, lk, h, dh) : 0;
}

// q and dout [B, Lq, H, Dh], k and v [B, Lk, H, Dh], all with unit stride on
// Dh.  `strides` holds 15 element strides: (B, L, H) of q, k, v and dout,
// then (b, i, j) of the bias, addressed as bias[b*sbb + i*sbq + j*sbk]
// (null: no bias).  dq, dk, dv are contiguous in q's layout and type; dbias,
// when not null, is a zeroed contiguous fp32 [B, Lq, Lk] plane the kernel
// adds the head-summed dS into; `part` holds flash_bwd_part_floats() fp32
// (null when that is 0); `scale` is 1 / sqrt of the true head dim when the
// caller has zero-padded it.  bf16 goes to the tensor-core kernels (Dh 64 or
// 128, rows 16-byte aligned; resident K/V up to 192 keys at Dh 64 and 128 at
// Dh 128, key-looped above; a multiple of 128 above 128 key-looped in
// slabs), fp32 to the FP32-pipe kernels (any Dh; staged K/V while they fit
// and Dh <= 256, streamed otherwise, in slabs above 256).
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* dout, const float* bias, void* dq, void* dk,
                             void* dv, float* dbias, float* part, int b, int lq, int lk,
                             int h, int dh, const long long* strides, float scale,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, dout, bias, dq, dk, dv, dbias, part, b, lq, lk, h, dh,
                       strides, scale, s);
  return launch_fp32(q, k, v, dout, bias, dq, dk, dv, dbias, b, lq, lk, h, dh, strides,
                     scale, s);
}

}  // extern "C"
