// The bf16 tensor-core attention forward shared by fused_attention.cu (a
// dense additive bias) and spec_attention.cu (the stage mask rebuilt from
// per-token vectors).  Each source includes this header with quotes and keeps
// its own __global__ entry, which calls attention_mma_tile<NP, Mask> and so
// carries its own name in a profile; the two differ only in the Mask functor,
// the one place the score tile meets the caller's mask.  ops/build.py hashes
// every csrc/*.cuh into each kernel's rebuild key.
//
// The head dim Dh is a template parameter of both tiles, instantiated at 64
// and at 128; the wrappers zero-pad a narrower bf16 head to the next of the
// two, and a wider one to the next multiple of 128, which the key-looped
// tile runs in slabs of 128 columns (its Slabs flag, at any key count); they
// pass the true width's scale (ops/fused_attention.py, pad_bf16_heads).
// Zero columns add exact zeros to Q K^T, and the padded columns of the
// output are sliced off.
//
// For one (batch, head, 64 query rows) a block of 4 warps computes
//
//     out = softmax(Q K^T / sqrt(Dh) + mask) V
//
// in the TPU kernels' order of casts: S = (Q K^T in fp32) * scale (a rounded
// multiply, never fused with the mask add), then + mask; m = row max,
// e = exp(S - m), P = e / sum(e), all fp32; P rounded to bf16 after the
// normalisation; PV accumulated in fp32 (mma.sync m16n8k16, bf16 operands,
// fp32 accumulators, operands through ldmatrix; the helpers are in
// common.cuh).
//
// The block copies its Q tile and the head's K (one cp.async group) and V (a
// second group, awaited only before PV, so V's copy overlaps the scores) from
// their strided [B, L, H, Dh] layout into shared memory, 16 bytes a thread,
// keys padded to Lk_pad (a multiple of 16) and query rows past Lq
// zero-filled; each row is padded by 16 bytes, so the eight 16-byte rows an
// ldmatrix reads fall in distinct banks.  Meanwhile the mask stages what it
// needs per key (Mask::kKeyWords 32-bit words a key) in shared memory.  Each
// warp then owns 16 query rows against all keys, with the whole [16, Lk_pad]
// score tile in registers (the key count Lk_pad / 16 is the template
// parameter NP, 1 to 12, so the tile is exactly sized): S by mma, scaled, the
// mask added, the row max and sum by quad shuffles, P = e / sum with expf and
// an IEEE division (the plain versions' arithmetic; no exp2 prescale, no
// reciprocal), then P rounded and packed straight into A fragments (the
// accumulator layout of two 8-key tiles is the A layout of one 16-key step)
// for O += P V, with V's B operands from ldmatrix.trans.  Keys at or past Lk
// score -inf, so P is exactly 0 there; a real key the caller masks with
// -10000 or -1e9 stays as it is, so a fully masked row comes out as in the
// plain version.  O goes through the warp's own Q rows in shared memory to
// 16-byte stores; rows past Lq are not written.  No atomics: two launches
// give the same bits.
//
// Budget at Dh 64: shared memory (2 Lk_pad + 64) * 72 * 2 + 4 kKeyWords Lk_pad
// bytes, 65,280 B at Lk = 190 with one word a key: 4 resident blocks (16
// warps) per SM up to Lk_pad = 160 and 3 above, so one block's copies overlap
// another's products; the kernels' __launch_bounds__ ask for that residency
// (at most 128 registers a thread for 4 blocks, 168 for 3).  At Dh 128 the
// rows are 136 elements (122,624 B at Lk_pad = 192) and the O accumulator
// doubles to 64 fp32 a lane: the bounds ask for 2 blocks (255 registers), and
// shared memory allows 1 to 3.  These instances take Lk_pad <= 192
// (NP <= kMaxPairs).
//
// Longer keys (the encoders at --max_img_seq_length > 52) go to the
// key-looped instance attention_mma_tile_long<Mask>; the Pallas kernels need
// none, as a TPU core holds the whole key axis in VMEM.  K and V
// are staged in blocks of kBlkKeys = 64 keys, double-buffered (cp.async, the
// next block's copy in flight while the current one is multiplied), and the
// block sweeps the key axis twice.  Sweep 1 reads K alone and keeps each
// row's running max m and fp32 sum l (rescaled by exp(m_old - m_new) when
// the max grows); sweep 2 recomputes S per block, forms P = exp(S - m) / l,
// rounds it to bf16 after the normalisation, as the short instances do, and
// accumulates O += P V.  So the order of casts is the TPU kernels' (no
// unnormalised P is ever rounded); only the sum's order differs (the
// running rescale).  Shared memory 47,104 B at Dh 64 with two mask words a
// key, whatever Lk: up to 4 blocks per SM (88,064 B and 2 at Dh 128).  No
// atomics: two launches give the same bits.  Both instances take Dh = 64 or
// 128 (and the key-looped one, in slabs, any multiple of 128 above) and
// 16-byte aligned rows; the key count is unbounded.
//
// A Mask functor provides:
//   using Args;                       the kernel's one argument, a struct
//       with the fields q, k, v, out (bf16; q [B, Lq, H, Dh], k and v
//       [B, Lk, H, Dh] with unit stride on Dh and the element strides sqb,
//       sqi, sqh, skb, ski, skh, svb, svi, svh; out contiguous
//       [B, Lq, H, Dh]), lq, lk, n_heads and scale, and the mask's own;
//   static constexpr int kKeyWords;   shared-memory words it stages per key
//   static void stage(a, mask_s, b, key0, nkeys)   all threads, before the
//       block's barrier: fill mask_s[0, nkeys) for keys key0..key0+nkeys-1
//       of batch row b (zeros past Lk);
//   static Mask make(a, mask_s, b, row)      per lane, for its two rows,
//       reading mask_s as staged from key 0;
//   void rebase(mask_s, key0)         read mask_s as staged from key0 on;
//   float operator()(hi, j)           what is added to the scaled score of
//       the lane's row row[hi] and key j < Lk (j counts from key 0).

#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileRows = 16 * kMmaWarps;  // query rows per block, 16 per warp
constexpr int kMaxPairs = 12;              // 16-key steps of the resident instances
constexpr int kBlkKeys = 64;               // keys per block of the key-looped instance
constexpr int kBlkPairs = kBlkKeys / 16;
constexpr int kRowPad = 8;                 // elements (16 bytes) after each smem row

// Blocks per SM the kernels' __launch_bounds__ ask for: at Dh 64, 4 up to
// Lk_pad = 160 (128 registers) and 3 above (168); at Dh 128, 2 (255).
__host__ __device__ constexpr int mma_min_blocks(int dh, int np) {
  return dh == 64 ? (np <= 10 ? 4 : 3) : 2;
}
// The key-looped instance's: 4 at Dh 64 (128 registers), 2 at Dh 128.
__host__ __device__ constexpr int mma_long_min_blocks(int dh) { return dh == 64 ? 4 : 2; }

// Dynamic shared memory of one block at head dim `dh`: K, V, the Q tile, and
// `key_words` 32-bit words of the mask per key.
size_t mma_smem_bytes(int lk, int key_words, int dh) {
  const size_t lkp = pad16(lk);
  return sizeof(bf16) * (2 * lkp + kTileRows) * (dh + kRowPad) +
         sizeof(float) * key_words * lkp;
}

// The key-looped instance's: two K and two V blocks, `q_bufs` Q tiles (two
// in slabs), and two blocks of mask words.
size_t mma_long_smem_bytes(int key_words, int dh, int q_bufs = 1) {
  return sizeof(bf16) * (4 * kBlkKeys + q_bufs * kTileRows) * (dh + kRowPad) +
         sizeof(float) * 2 * key_words * kBlkKeys;
}

// Accumulator layout of an m16n8 tile: c[e] sits at row lane / 4 + 8 (e / 2),
// column 2 (lane % 4) + e % 2.  A fragment (16x16): a[0] rows 0-7, a[1] rows
// 8-15, a[2] and a[3] the same rows at columns 8-15.
template <int Dh, int NP, class Mask>
__device__ __forceinline__ void attention_mma_tile(const typename Mask::Args& a) {
  constexpr int kS = Dh + kRowPad;  // row stride of K, V and Q in shared memory
  constexpr int kChunks = Dh / 8;   // 16-byte chunks per row
  constexpr int kSteps = Dh / 16;   // k-steps over Dh
  constexpr int kDt = Dh / 8;       // 8-wide n-tiles over Dh
  constexpr int kLkp = 16 * NP;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                       // [kLkp][kS]
  bf16* v_s = k_s + kLkp * kS;                                     // [kLkp][kS]
  bf16* q_s = v_s + kLkp * kS;                                     // [kTileRows][kS], then O
  float* mask_s = reinterpret_cast<float*>(q_s + kTileRows * kS);  // [kLkp][kKeyWords]

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
  Mask::stage(a, mask_s, b, 0, kLkp);
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
  const Mask mask = Mask::make(a, mask_s, b, row);
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
      *reinterpret_cast<uint4*>(a.out + ((int64_t(b) * a.lq + i) * a.n_heads + h) * Dh + d) =
          *reinterpret_cast<const uint4*>(o_s + r * kS + d);
  }
}

// The key-looped instance for any Lk (used above Lk_pad = 192): the same
// per-warp rows, fragments and order of casts as attention_mma_tile, over
// key blocks of kBlkKeys in two sweeps (the design is in the header note).
//
// With Slabs (at Dh = kSlabDh), a head of a.slabs * 128 columns, any Lk: the
// grid's x holds the query tiles of each 128-column output slab in turn,
// and a block writes only its own slab of O.  A step is then one (sweep,
// key block, input slab): it multiplies Q's and K's slab in buffer
// `step & 1` (Q double-buffered too) into the key block's fp32 scores while
// the next step's copy is in flight, so the products run in the order one
// wide tile would run them; after the block's last slab the scores are
// whole, and are masked and used as below.  A key block's mask words, and
// in sweep 2 V's own slab, ride in its first step's copy, double-buffered
// by key block.  The Q K^T work is repeated once per output slab.
template <int Dh, class Mask, bool Slabs = false>
__device__ __forceinline__ void attention_mma_tile_long(const typename Mask::Args& a) {
  static_assert(!Slabs || Dh == kSlabDh, "slabs are kSlabDh columns wide");
  constexpr int kS = Dh + kRowPad;
  constexpr int kChunks = Dh / 8;
  constexpr int kSteps = Dh / 16;
  constexpr int kDt = Dh / 8;
  constexpr int kBuf = kBlkKeys * kS;                     // one K or V block
  constexpr int kQBuf = Slabs ? kTileRows * kS : 0;       // Q's second buffer, from q_s
  constexpr int kMaskBuf = kBlkKeys * Mask::kKeyWords;    // one block of mask words

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                       // [2][kBlkKeys][kS]
  bf16* v_s = k_s + 2 * kBuf;                                      // [2][kBlkKeys][kS]
  bf16* q_s = v_s + 2 * kBuf;                                      // [1|2][kTileRows][kS], then O
  float* mask_s = reinterpret_cast<float*>(q_s + kTileRows * kS + kQBuf);  // [2][kMaskBuf]

  const int slabs = Slabs ? a.slabs : 1;
  const int n_tiles = Slabs ? (a.lq + kTileRows - 1) / kTileRows : 1;
  const int i0 = (Slabs ? blockIdx.x % n_tiles : blockIdx.x) * kTileRows;
  const int c0 = Slabs ? Dh * (blockIdx.x / n_tiles) : 0;  // this block's output columns
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * warp;
  const int n_blocks = (a.lk + kBlkKeys - 1) / kBlkKeys;
  const int n_steps = 2 * n_blocks * slabs;  // sweep 1 (K), then sweep 2 (K and V)

  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* kb = a.k + b * a.skb + h * a.skh;
  const bf16* vb = a.v + b * a.svb + h * a.svh + c0;
  // a step's copies into buffer `buf`: input slab sl of key block kblk's K
  // (with Slabs, and of the Q tile) as one cp.async group, with the block's V
  // (in sweep 2) and mask words at its first slab; kblk counts over both
  // sweeps, 0 .. 2 n_blocks - 1
  auto load = [&](int buf, int kblk, int sl) {
    const int key0 = (kblk < n_blocks ? kblk : kblk - n_blocks) * kBlkKeys;
    const int col = Dh * sl;
    // keep the braces: without them nvcc 12.8 built the non-slab instances
    // wrong (their outputs came out NaN), though the code means the same
    if constexpr (Slabs) {
      for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
        const int r = c / kChunks;
        const int d = (c % kChunks) * 8;
        const bool ok = i0 + r < a.lq;
        cp_async16(q_s + buf * kQBuf + r * kS + d, qb + (ok ? i0 + r : 0) * a.sqi + col + d, ok);
      }
    }
    for (int c = threadIdx.x; c < kBlkKeys * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const int j = key0 + r;
      const bool ok = j < a.lk;
      cp_async16(k_s + buf * kBuf + r * kS + d, kb + (ok ? j : 0) * a.ski + col + d, ok);
      if (sl == 0 && kblk >= n_blocks)
        cp_async16(v_s + (kblk & 1) * kBuf + r * kS + d, vb + (ok ? j : 0) * a.svi + d, ok);
    }
    cp_async_commit();
    if (sl == 0) Mask::stage(a, mask_s + (kblk & 1) * kMaskBuf, b, key0, kBlkKeys);
  };

  if constexpr (!Slabs) {
    for (int c = threadIdx.x; c < kTileRows * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const bool ok = i0 + r < a.lq;
      cp_async16(q_s + r * kS + d, qb + (ok ? i0 + r : 0) * a.sqi + d, ok);
    }
  }
  load(0, 0, 0);  // the Q tile rides in step 0's group
  cp_async_wait<0>();
  __syncthreads();

  const int row[2] = {i0 + r0 + g, i0 + r0 + g + 8};
  Mask mask = Mask::make(a, mask_s, b, row);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float sc[kBlkPairs][2][4];

  for (int it = 0; it < n_steps; ++it) {
    // buffer (it + 1) & 1 was last read in step it - 1, before its barrier
    // (and the next key block's mask and V buffers in the last step of key
    // block it / slabs - 1)
    if (it + 1 < n_steps) load((it + 1) & 1, (it + 1) / slabs, (it + 1) % slabs);
    const int buf = it & 1;
    const int kblk = it / slabs;
    const int sl = it % slabs;
    const int key0 = (kblk < n_blocks ? kblk : kblk - n_blocks) * kBlkKeys;
    const bf16* kk = k_s + buf * kBuf;
    const bf16* qq = q_s + buf * kQBuf;

    // S (+)= Q K^T for this warp's 16 rows and the block's keys
    if (sl == 0) {
#pragma unroll
      for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jp][n][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t qa[4];
      ldsm_x4(qa, qq + (r0 + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
#pragma unroll
      for (int jp = 0; jp < kBlkPairs; ++jp) {
        uint32_t y[4];
        ldsm_x4(y, kk + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kS + 16 * s +
                       8 * ((lane >> 3) & 1));
        mma16816(sc[jp][0], qa, y[0], y[1]);
        mma16816(sc[jp][1], qa, y[2], y[3]);
      }
    }
    if (sl == slabs - 1) {
      // the scores are whole: scaled and masked
      mask.rebase(mask_s + (kblk & 1) * kMaskBuf, key0);
#pragma unroll
      for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = key0 + 16 * jp + 8 * n + 2 * t + (e & 1);
            const float x = __fmul_rn(sc[jp][n][e], a.scale);
            sc[jp][n][e] = j < a.lk ? x + mask(e >> 1, j) : -INFINITY;
          }

      if (kblk < n_blocks) {
        // sweep 1: the running row max (quad-uniform) and this lane's sum
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float mx = -INFINITY;
#pragma unroll
          for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mx = fmaxf(mx, fmaxf(sc[jp][n][2 * hi], sc[jp][n][2 * hi + 1]));
          const float mn = fmaxf(m[hi], quad_max(mx));
          float sum = l[hi] * expf(m[hi] - mn);
#pragma unroll
          for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              sum += expf(sc[jp][n][2 * hi] - mn) + expf(sc[jp][n][2 * hi + 1] - mn);
          m[hi] = mn;
          l[hi] = sum;
        }
        if (kblk == n_blocks - 1) {
          l[0] = quad_sum(l[0]);
          l[1] = quad_sum(l[1]);
        }
      } else {
        // sweep 2: P = exp(S - m) / l rounded to bf16, then O += P V
        uint32_t pa[kBlkPairs][4];
#pragma unroll
        for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              pa[jp][2 * n + hi] =
                  pack_bf16(expf(sc[jp][n][2 * hi] - m[hi]) / l[hi],
                            expf(sc[jp][n][2 * hi + 1] - m[hi]) / l[hi]);
        const bf16* vv = v_s + (kblk & 1) * kBuf;
#pragma unroll
        for (int jp = 0; jp < kBlkPairs; ++jp)
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            uint32_t y[4];
            ldsm_x4_t(y, vv + (16 * jp + (lane & 15)) * kS + 16 * s + 8 * (lane >> 4));
            mma16816(o[2 * s], pa[jp], y[0], y[1]);
            mma16816(o[2 * s + 1], pa[jp], y[2], y[3]);
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  // O through this warp's own Q rows to 16-byte stores, as attention_mma_tile
  // (with Slabs, into this block's columns of the padded head)
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
      *reinterpret_cast<uint4*>(a.out + ((int64_t(b) * a.lq + i) * a.n_heads + h) * Dh * slabs +
                                c0 + d) = *reinterpret_cast<const uint4*>(o_s + r * kS + d);
  }
}

// Reserve `Kernel`'s shared memory and launch it on a (ceil(Lq / 64) *
// a.slabs, H, B) grid (a.slabs is 1 for the Dh-64 and Dh-128 instances);
// returns cudaGetLastError().
template <auto Kernel, class Args>
int launch_mma(const Args& a, int b, size_t smem, cudaStream_t stream) {
  const cudaError_t err = reserve_smem<Kernel>(smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(ceil_div(a.lq, kTileRows) * a.slabs, a.n_heads, b);
  Kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// `launch.template run<NP>()` for the instance whose score tile holds
// Lk_pad = pad16(lk) = 16 NP keys; `launch.run_long()`, the key-looped
// instance, above 16 kMaxPairs keys.  Each picks its head dim's instance.
template <int NP, class Launch>
int launch_pairs(int lk, const Launch& launch) {
  if constexpr (NP > kMaxPairs) {
    return launch.run_long();
  } else {
    if (pad16(lk) != 16 * NP) return launch_pairs<NP + 1>(lk, launch);
    return launch.template run<NP>();
  }
}

}  // namespace
