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
//   them (chip_smoke.py phase 2, PERF.md).  It takes Dh = 64 and Lk <= 192
//   (the wrapper raises before launch otherwise) and 16-byte aligned rows.
//
// * fp32: flash_bwd_kernel, on the FP32 pipes.  A block stages its head's
//   K and V in shared memory and walks the query rows in rounds of eight:
//   in a round each warp owns one row (scores, softmax, dS, the dbias
//   atomics and that row's dQ, with lanes over keys and then over
//   dimensions), and then all 256 threads fold the round's eight rounded P
//   and dS rows into fp32 dK and dV accumulators in shared memory, each
//   thread owning fixed (key, dimension) cells.  155 KB of shared memory
//   at Lk = 138, 212 KB at Lk = 190.
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

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileRows = 16 * kMmaWarps;  // query rows per tile, 16 per warp
constexpr int kMmaDh = 64;                 // the one head dim instantiated
constexpr int kMaxLk = 192;
constexpr int kRowPad = 8;                 // elements (16 bytes) after each smem row
// dK and dV units of 16 keys x Dh: 2 * kMaxLk / 16 = 24 over 8 warps
constexpr int kMaxUnits = 2 * kMaxLk / 16 / kMmaWarps;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

size_t mma_smem_bytes(int lk, int dh) {
  const size_t lkp = pad16(lk);
  return sizeof(bf16) * (2 * lkp * (dh + kRowPad) + 2 * size_t(kTileRows) * (dh + kRowPad)
                         + 2 * size_t(kTileRows) * (lkp + kRowPad));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(const void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row (l & 7) of matrix
// l >> 3.  Register r holds matrix r: row lane / 4, columns 2 (lane % 4) + {0, 1}
// (with .trans: rows 2 (lane % 4) + {0, 1}, column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Reductions over the four lanes of a quad, which share accumulator rows.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
    uint32_t qa[kSteps][4], oa[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int off = (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4);
      ldsm_x4(qa[s], q_s + off);
      ldsm_x4(oa[s], do_s + off);
    }
    // X (16 rows) times the 16 rows jp*16.. of Y^T, as two 8-key tiles
    auto product = [&](const uint32_t (&xa)[kSteps][4], const bf16* y_s, int jp,
                       float (&out)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t y[4];
        ldsm_x4(y, y_s + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kS + 16 * s +
                       8 * ((lane >> 3) & 1));
        mma16816(out[0], xa[s], y[0], y[1]);
        mma16816(out[1], xa[s], y[2], y[3]);
      }
    };
    auto scores = [&](int jp, float (&sc)[2][4]) {
      product(qa, k_s, jp, sc);
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
      product(oa, v_s, jp, dp);
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
      product(oa, v_s, jp, dp);
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

int launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                const float* bias, void* dq, void* dk, void* dv, float* dbias, int b,
                int lq, int lk, int h, int dh, const long long* st, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<float>(lk, dh);
  const cudaError_t err = reserve_smem<flash_bwd_kernel<float>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(h, b);
  flash_bwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), bias,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), dbias, lq,
      lk, h, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], scale);
  return int(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* bias, void* dq, void* dk, void* dv, float* dbias, int b,
                int lq, int lk, int h, int dh, const long long* st, float scale,
                cudaStream_t stream) {
  if (dh != kMmaDh || lk > kMaxLk) return int(cudaErrorInvalidValue);
  const size_t smem = mma_smem_bytes(lk, dh);
  const cudaError_t err = reserve_smem<flash_bwd_mma_kernel<kMmaDh>>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(h, b);
  flash_bwd_mma_kernel<kMmaDh><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), bias, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias, lq, lk, h, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper names it when a launch
// is refused.
long long flash_bwd_smem_bytes(int lk, int dh, int is_bf16) {
  return is_bf16 ? (long long)mma_smem_bytes(lk, dh) : (long long)smem_bytes<float>(lk, dh);
}

// q and dout [B, Lq, H, Dh], k and v [B, Lk, H, Dh], all with unit stride on
// Dh.  `strides` holds 15 element strides: (B, L, H) of q, k, v and dout,
// then (b, i, j) of the bias, addressed as bias[b*sbb + i*sbq + j*sbk]
// (null: no bias).  dq, dk, dv are contiguous in q's layout and type; dbias,
// when not null, is a zeroed contiguous fp32 [B, Lq, Lk] plane the kernel
// adds the head-summed dS into.  bf16 goes to the tensor-core kernel (Dh 64,
// Lk <= 192, rows 16-byte aligned), fp32 to the FP32-pipe kernel.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* dout, const float* bias, void* dq, void* dk,
                             void* dv, float* dbias, int b, int lq, int lk, int h,
                             int dh, const long long* strides, float scale,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, dout, bias, dq, dk, dv, dbias, b, lq, lk, h, dh, strides,
                       scale, s);
  return launch_fp32(q, k, v, dout, bias, dq, dk, dv, dbias, b, lq, lk, h, dh, strides,
                     scale, s);
}

}  // extern "C"
