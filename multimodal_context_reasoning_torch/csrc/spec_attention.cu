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
// the TPU version needed), and the mask costs O(Lk) vector loads per block.
// Two kernels, chosen by the operand type (a dispatch, not a fallback):
//
// * bf16 (the serving path and the training step's frozen encoders):
//   spec_attention_mma_kernel, on the tensor cores.  Its body is
//   attention_mma_tile in attention_mma.cuh, shared with the dense-bias
//   forward (one block of 4 warps per (batch, head, 64 query rows), K, V
//   and the Q tile copied once by cp.async, the whole [16, Lk_pad] score
//   tile of a warp in registers, mma.sync with ldmatrix; the design and the
//   order of casts are noted there).  This file gives it the stage mask as
//   a mask functor, whose value -((1 - vis) * 1e9) is added to the scaled
//   score: x + (-n) rounds as x - n does, so the scores are the plain
//   version's bit for bit.  FullStage (vis = valid[j]) stages that row in
//   shared memory once per block.  ChunkStage (the chunk and cross stages,
//   told apart by a block-uniform argument) stages the key-side valid and
//   gi (8 bytes a key), holds each lane's two query rows' gi, rowfull and
//   image flag in registers, and rebuilds vis per score from them in fp32
//   with rounded operations (nothing contracted into an FMA).  Padded keys
//   score -inf; a fully masked row adds -1e9 to every key and comes out
//   uniform, as in the plain version.  Shared memory 65,280 B (full) and
//   66,048 B (chunk, cross) at Lk = 190: 3 blocks per SM there, 4 up to
//   Lk_pad = 160.  ptxas -v (chip_smoke.py phase 2): 46 to 168 registers,
//   0 spill bytes in every instance.  Above 192 keys the key-looped
//   spec_attention_mma_long_kernel runs the tile's key loop
//   (attention_mma_tile_long: K and V in double-buffered blocks of 64 keys,
//   the mask staged per block).  Every instance exists at Dh = 64 and
//   Dh = 128 (the wrapper zero-pads a narrower head to the next), takes
//   16-byte aligned rows and any Lk.  A head wider than 128 (zero-padded to
//   a multiple of 128) runs spec_attention_mma_long_slab_kernel, the key
//   loop in slabs (attention_mma.cuh) at any key count: one block per 128
//   output columns, the scores summed over every slab.
//
// * fp32 (the parity checks): spec_attention_kernel, on the FP32 pipes.
//   Each block stages one head's whole K and V in shared memory and serves
//   a tile of 64 query rows from it.  One warp owns one query row at a
//   time: each lane scores its share of the keys, the warp reduces max and
//   sum with shuffles, and each lane then accumulates its share of the
//   output dimensions.  Where K and V do not fit in one block's shared
//   memory (about 411 keys at Dh 64), spec_attention_stream_kernel reads
//   them from device memory instead, 32 keys at a time per warp.  The staged
//   kernel takes heads up to kMaxDh = 256 (common.cuh); a wider head streams
//   in slabs of 256 output columns, one block per slab.
//
// Plain C interface, loaded with ctypes (multimodal_context_reasoning_torch/
// ops/spec_attention.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ fp32

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

// vis of query row i and key j in fp32 (the FP32-pipe kernels): the TPU
// kernel's algebra, from the key's valid and gi and the row's gi, rowfull and
// image flag.
__device__ __forceinline__ float visibility(int stage, int text_len, int i, int j, int gi_q,
                                            float row_q, float img_q, float valid_k,
                                            int gi_k) {
  if (stage == kFull) return valid_k;
  const float img_k = j >= text_len ? 1.f : 0.f;
  const float same = (gi_q == gi_k && gi_q >= 0) ? 1.f : 0.f;
  const float eye = (i == j) ? 1.f : 0.f;
  const float text_in = fminf(same + eye + row_q, 1.f);
  const float text_rows = ((1.f - img_k) * text_in + img_k) * valid_k;
  const float img_rows = stage == kChunk ? img_k * valid_k : eye;
  return img_q * img_rows + (1.f - img_q) * text_rows;
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
      const float vis = visibility(stage, text_len, i, j, gi_q, row_q, img_q, valid_s[j],
                                   gi_s[j]);
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

// K and V beyond one block's shared memory: the same rows, warps, mask and
// order of casts, with each warp streaming its row's keys (and their valid
// and gi) from device memory in two passes: a running max and sum per lane,
// merged across the warp; then P for 32 keys at a time into a warp buffer
// and out += P V, lanes over the output dimensions.  Any Lk; Dh <= MaxDh,
// each lane holding MaxDh / 32 output columns (instantiated at kNarrowDh and
// kMaxDh, common.cuh).  With Slabs, any Dh: the grid's x holds the row tiles
// of each slab of MaxDh output columns in turn; each block scores its rows
// over the whole head, reading q through L1 (the same products in the same
// order), and writes only its slab of out.
template <typename T, int MaxDh, bool Slabs>
__global__ void __launch_bounds__(kThreads)
spec_attention_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ valid,
                             const int* __restrict__ gi, const float* __restrict__ rowfull,
                             T* __restrict__ out, int lq, int lk, int n_heads, int dh,
                             int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
                             int64_t ski, int64_t skh, int64_t svb, int64_t svi,
                             int64_t svh, int stage, int text_len, float scale) {
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
  const float* valid_b = valid + int64_t(b) * lk;
  const int* gi_b = gi + int64_t(b) * lk;
  float* q_row = q_s[warp];
  float* p = p_s[warp];

  const int row_end = min(lq, (tile + 1) * kRowsPerBlock);
  for (int i = tile * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const T* qi = q + b * sqb + i * sqi + h * sqh;
    if constexpr (!Slabs) {
      for (int d = lane; d < dh; d += 32) q_row[d] = to_f(qi[d]);
      __syncwarp();
    }
    const int gi_q = stage != kFull ? __ldg(gi_b + i) : -1;
    const float row_q = stage != kFull ? __ldg(rowfull + int64_t(b) * lk + i) : 0.f;
    const float img_q = i >= text_len ? 1.f : 0.f;
    auto score = [&](int j) {
      const T* kj = kb + j * ski;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d)
        acc = fmaf(Slabs ? to_f(__ldg(qi + d)) : q_row[d], to_f(kj[d]), acc);
      const float vis = visibility(stage, text_len, i, j, gi_q, row_q, img_q,
                                   __ldg(valid_b + j), __ldg(gi_b + j));
      return acc * scale - (1.f - vis) * 1e9f;
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
int launch(const void* q, const void* k, const void* v, const float* valid,
           const int* gi, const float* rowfull, void* out, int b, int lq, int lk,
           int h, int dh, int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
           int64_t ski, int64_t skh, int64_t svb, int64_t svi, int64_t svh,
           int stage, int text_len, float scale, cudaStream_t stream) {
  if (dh < 1) return int(cudaErrorInvalidValue);
  const int tiles = ceil_div(lq, kRowsPerBlock);
  const size_t smem = smem_bytes<T>(lk, dh);
  if (dh > kMaxDh || !fits_smem(smem)) {
    auto kernel = dh <= kNarrowDh ? spec_attention_stream_kernel<T, kNarrowDh, false>
                  : dh <= kMaxDh  ? spec_attention_stream_kernel<T, kMaxDh, false>
                                  : spec_attention_stream_kernel<T, kMaxDh, true>;
    const dim3 grid(tiles * ceil_div(dh, kMaxDh), h, b);
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        valid, gi, rowfull, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb,
        ski, skh, svb, svi, svh, stage, text_len, scale);
    return int(cudaGetLastError());
  }
  const cudaError_t err = reserve_smem<spec_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return int(err);
  spec_attention_kernel<T><<<dim3(tiles, h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid, gi, rowfull, static_cast<T*>(out), lq, lk, h, dh, sqb, sqi, sqh, skb,
      ski, skh, svb, svi, svh, stage, text_len, scale);
  return int(cudaGetLastError());
}


// ------------------------------------------------------------------ bf16
// The tile body, the launch and the key-count dispatch are in
// attention_mma.cuh, shared with fused_attention.cu; here are the stage masks.

constexpr float kMaskPenalty = 1e9f;

// q, k, v, out, and the stage's vectors: valid, gi, rowfull contiguous
// [B, Lk], the text length, chunk 0 or cross 1; the slab count.
struct SpecArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const float* valid;
  const int* gi;
  const float* rowfull;
  int lq, lk, n_heads;
  int64_t sqb, sqi, sqh, skb, ski, skh, svb, svi, svh;
  int text_len, cross;
  float scale;
  int slabs;  // the head's 128-column slabs (1 below the slab instance)
};

// The full stage: vis = valid[j], the same for every query row, so the row
// -((1 - valid[j]) * 1e9) is staged in shared memory once per block.
struct FullStage {
  using Args = SpecArgs;
  static constexpr int kKeyWords = 1;
  const float* row_s;
  int key0;
  __device__ static void stage(const SpecArgs& a, float* row_s, int b, int key0, int nkeys) {
    const float* valid = a.valid + int64_t(b) * a.lk + key0;
    for (int j = threadIdx.x; j < nkeys; j += kMmaThreads)
      row_s[j] = key0 + j < a.lk ? -__fmul_rn(1.f - __ldg(valid + j), kMaskPenalty) : 0.f;
  }
  __device__ static FullStage make(const SpecArgs&, const float* row_s, int,
                                   const int (&)[2]) {
    return {row_s, 0};
  }
  __device__ void rebase(const float* s, int k0) {
    row_s = s;
    key0 = k0;
  }
  __device__ float operator()(int, int j) const { return row_s[j - key0]; }
};

// One key's side of the chunk and cross stages' mask.
struct __align__(8) KeySide {
  float valid;
  int gi;
};

// The chunk and cross stages (Lq == Lk): the TPU kernel's algebra per score,
// from the key's staged valid and gi and the lane's two query rows' terms.
struct ChunkStage {
  using Args = SpecArgs;
  static constexpr int kKeyWords = 2;
  const KeySide* key_s;
  int key0;
  int row[2], gi_q[2];
  float row_q[2], img_q[2];
  int text_len;
  bool cross;
  __device__ static void stage(const SpecArgs& a, float* words, int b, int key0, int nkeys) {
    KeySide* key_s = reinterpret_cast<KeySide*>(words);
    const int64_t off = int64_t(b) * a.lk + key0;
    for (int j = threadIdx.x; j < nkeys; j += kMmaThreads)
      key_s[j] = key0 + j < a.lk ? KeySide{__ldg(a.valid + off + j), __ldg(a.gi + off + j)}
                                 : KeySide{0.f, -1};
  }
  // rows at or past Lq read nothing
  __device__ static ChunkStage make(const SpecArgs& a, const float* words, int b,
                                    const int (&row)[2]) {
    ChunkStage m;
    m.key_s = reinterpret_cast<const KeySide*>(words);
    m.key0 = 0;
    const int64_t off = int64_t(b) * a.lk;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool ok = row[hi] < a.lq;
      m.row[hi] = row[hi];
      m.gi_q[hi] = ok ? __ldg(a.gi + off + row[hi]) : -1;
      m.row_q[hi] = ok ? __ldg(a.rowfull + off + row[hi]) : 0.f;
      m.img_q[hi] = row[hi] >= a.text_len ? 1.f : 0.f;
    }
    m.text_len = a.text_len;
    m.cross = a.cross != 0;
    return m;
  }
  __device__ void rebase(const float* words, int k0) {
    key_s = reinterpret_cast<const KeySide*>(words);
    key0 = k0;
  }
  __device__ float operator()(int hi, int j) const {
    const KeySide key = key_s[j - key0];
    const float img_k = j >= text_len ? 1.f : 0.f;
    const float same = (gi_q[hi] == key.gi && gi_q[hi] >= 0) ? 1.f : 0.f;
    const float eye = row[hi] == j ? 1.f : 0.f;
    const float text_in = fminf(__fadd_rn(__fadd_rn(same, eye), row_q[hi]), 1.f);
    const float text_rows =
        __fmul_rn(__fadd_rn(__fmul_rn(1.f - img_k, text_in), img_k), key.valid);
    const float img_rows = cross ? eye : __fmul_rn(img_k, key.valid);
    const float vis =
        __fadd_rn(__fmul_rn(img_q[hi], img_rows), __fmul_rn(1.f - img_q[hi], text_rows));
    return -__fmul_rn(1.f - vis, kMaskPenalty);
  }
};

template <int Dh, int NP, class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks(Dh, NP))
spec_attention_mma_kernel(const SpecArgs a) {
  attention_mma_tile<Dh, NP, Mask>(a);
}

// Lk > 192: the key-looped instance (attention_mma.cuh).
template <int Dh, class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_long_min_blocks(Dh))
spec_attention_mma_long_kernel(const SpecArgs a) {
  attention_mma_tile_long<Dh, Mask>(a);
}

// Heads wider than 128: the key-looped instance in slabs (attention_mma.cuh).
template <class Mask>
__global__ void __launch_bounds__(kMmaThreads, mma_long_min_blocks(kSlabDh))
spec_attention_mma_long_slab_kernel(const SpecArgs a) {
  attention_mma_tile_long<kSlabDh, Mask, true>(a);
}

// The full or chunk/cross instance at Lk_pad = 16 NP, or the key-looped one,
// at head dim Dh.
template <int Dh>
struct SpecLaunch {
  const SpecArgs& a;
  bool full;
  int b;
  cudaStream_t stream;
  template <int NP>
  int run() const {
    return full ? launch_mma<spec_attention_mma_kernel<Dh, NP, FullStage>>(
                      a, b, mma_smem_bytes(16 * NP, FullStage::kKeyWords, Dh), stream)
                : launch_mma<spec_attention_mma_kernel<Dh, NP, ChunkStage>>(
                      a, b, mma_smem_bytes(16 * NP, ChunkStage::kKeyWords, Dh), stream);
  }
  int run_long() const {
    return full ? launch_mma<spec_attention_mma_long_kernel<Dh, FullStage>>(
                      a, b, mma_long_smem_bytes(FullStage::kKeyWords, Dh), stream)
                : launch_mma<spec_attention_mma_long_kernel<Dh, ChunkStage>>(
                      a, b, mma_long_smem_bytes(ChunkStage::kKeyWords, Dh), stream);
  }
};

int launch_bf16(const void* q, const void* k, const void* v, const float* valid,
                const int* gi, const float* rowfull, void* out, int b, int lq, int lk,
                int h, int dh, int64_t sqb, int64_t sqi, int64_t sqh, int64_t skb,
                int64_t ski, int64_t skh, int64_t svb, int64_t svi, int64_t svh,
                int stage, int text_len, float scale, cudaStream_t stream) {
  const int slabs = mma_slabs(dh);
  if ((!mma_head_dim(dh) && slabs == 0) || (stage != kFull && lq != lk))
    return int(cudaErrorInvalidValue);
  const SpecArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<bf16*>(out), valid, gi, rowfull,
                   lq, lk, h, sqb, sqi, sqh, skb, ski, skh, svb, svi, svh, text_len,
                   stage == kCross, scale, slabs > 0 ? slabs : 1};
  if (slabs > 0)
    return stage == kFull
               ? launch_mma<spec_attention_mma_long_slab_kernel<FullStage>>(
                     a, b, mma_long_smem_bytes(FullStage::kKeyWords, kSlabDh, 2), stream)
               : launch_mma<spec_attention_mma_long_slab_kernel<ChunkStage>>(
                     a, b, mma_long_smem_bytes(ChunkStage::kKeyWords, kSlabDh, 2), stream);
  return dh == 64 ? launch_pairs<1>(lk, SpecLaunch<64>{a, stage == kFull, b, stream})
                  : launch_pairs<1>(lk, SpecLaunch<128>{a, stage == kFull, b, stream});
}

}  // namespace

extern "C" {

// q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] with unit stride on Dh and the
// given element strides on B, L and H; valid, rowfull fp32 and gi int32,
// contiguous [B, Lk]; out contiguous [B, Lq, H, Dh] of q's type; `scale`
// multiplies Q K^T (1 / sqrt of the true head dim when the caller has
// zero-padded it).  bf16 goes to the tensor-core kernels (Dh 64 or 128,
// rows 16-byte aligned; resident K/V up to 192 keys, key-looped above; a
// multiple of 128 above 128 key-looped in slabs), fp32 to the FP32-pipe
// kernels (any Dh; staged K/V while they fit and Dh <= 256, streamed
// otherwise, in slabs above 256).
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
    return launch_bf16(q, k, v, valid, gi, rowfull, out, b, lq, lk, h, dh, sqb, sqi, sqh,
                       skb, ski, skh, svb, svi, svh, stage, text_len, scale, s);
  return launch<float>(q, k, v, valid, gi, rowfull, out, b, lq, lk, h, dh, sqb, sqi,
                       sqh, skb, ski, skh, svb, svi, svh, stage, text_len, scale, s);
}

}  // extern "C"
