// Flash-attention forward (causal or full, grouped-query, optionally
// windowed) for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention.py (`flash_attention_fwd`, whose
// pallas_call runs the body `_flash_fwd_kernel`).  For batch b, query head h
// (reading kv head h / G, G = H / KV) and query row i:
//   s_ij = scale * q_i . k_j            (float32; -1e30 where j > i if causal,
//                                         and where i - j >= W under a window)
//   out_i = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// with m, l and the output accumulator carried over key tiles by the online
// softmax (in the log2 domain), key tiles wholly above the diagonal or
// wholly left of the window skipped, and the output cast to q's type.  The
// window is the reference's sliding-window mask (`layers.attention`,
// `_sdpa_chunked`), which its Pallas body does not take; W >= S gives
// exactly what no window gives.  q is (B, S, H, D), k and v (B, S, KV, D),
// all float32 or all bfloat16, read through their strides (the D axis
// contiguous); out is (B, S, H, D) contiguous.  D is 16, 32, 64, 128 or 256.
//
// What bounds it on this card.  At the serving shape (qwen2.5-3b prefill:
// B=8, S=2048, H=16, KV=2, D=128, bf16, causal) it must move 151 MB (q and
// out 67 MB each, k and v 8.4 MB each: 45 us at 3.35 TB/s) and do 137.5
// GFLOP of causal QK^T and PV products (139 us at 989 TFLOP/s bf16): the
// tensor cores bound it, and only `wgmma` reaches their rate.
//
// Two bodies, chosen at compile time by dtype x D (`pick_d`):
//
// * bf16 at D = 64, 128 or 256: the Hopper body (`hopper::`), three
//   instantiations.  A persistent grid of one block an SM (193 KB of shared
//   memory, 225 KB at D = 256, admit no second) walks the work tiles, one
//   per (128-row query tile, batch, head), in an order that evens out each
//   block's load (`Work`: heaviest causal tiles first, or by head at
//   D = 256).  A block is two warpgroups of 64 query rows.  Q, K and V arrive by TMA (`cp.async.bulk.tensor`, 4-D tensor maps
//   over (D, S, heads, B) with the tensors' own byte strides, 128-byte
//   swizzle, rows past S zero-filled) into a 2-stage ring of K and V tiles
//   that runs on across work tiles, each copy completing on its stage's
//   "full" mbarrier.  No warp waits to refill a stage: each warp counts
//   itself out of a K or V tile once its products have read it, and the
//   last of the eight issues the next copy (so the next work tile's first
//   K/V tiles load while this one finishes).  Per key tile a warpgroup
//   issues QK^T together with the previous tile's PV, runs the online
//   softmax on the accumulator layout (rows 16 warp + lane / 4 and + 8,
//   columns 2t, 2t + 1 of every 8-wide chunk) while PV is on the tensor
//   cores, masking only on the diagonal, a ragged last tile or a window's
//   edge.  Where nothing is masked the softmax is lazy: P is taken against
//   the running max as it stands, so the exponentials need not wait for the
//   tile's max, which only says whether a row grew past it by more than
//   2^8; a warp where one did recomputes its 16 rows of logits with
//   `mma.sync` and takes the exact softmax (the result does not depend on
//   the reference max).  P is rounded to bf16 in place into the A fragments
//   of the next PV (`wgmma`, V read [key][d] as an MN-major B through the
//   instruction's transpose-B).  The row sums l are taken from the
//   unrounded P.  The two warpgroups take turns to issue (named barriers),
//   so that one's softmax runs while the other's products hold the tensor
//   cores.  The output is divided by l, rounded to bf16 into a swizzled
//   staging tile and written by a TMA store that skips rows past S.
//   Products of bf16 values are exact in float32, so QK^T equals the Pallas
//   body's float32 product up to summation order; P's rounding is the one
//   the Pallas body does not make (the model's own `_sdpa` makes it).
//   There is no producer warp: with one, the block has 9 or 12 warps, three
//   of them on one SM sub-partition, and ptxas (CUDA 12.9) then allocates the
//   whole kernel within 168 registers whatever `setmaxnreg` asks; the
//   consumers need over 200, and at 168 they spill and their `wgmma`s
//   serialise.  By head dim (`Smem`):
//   - D = 64, 128: 128-key tiles.  QK^T is `wgmma m64n128k16` with Q from
//     registers (read once per work tile with `ldmatrix`; the Q tile is
//     counted out like a K/V tile, so the next work tile's Q loads while
//     this one finishes), PV `wgmma m64nDk16`.  Q 128 rows, the ring of two
//     K and V stages, and a separate output staging tile.
//   - D = 256 (gemma-7b): 80-key tiles.  With 128-key tiles Q (64 KB), two
//     stages of K and V (256 KB) and the staging tile (64 KB) would take
//     384 KB; 80-key tiles take Q and the ring to 224 KB (230,468 B with
//     the barriers and the alignment, of the 232,448 a block may take),
//     which leaves no room for a staging tile.  Registers a thread (255 at
//     most, two warpgroups of 128): the output accumulator 64 x 256 float32
//     is 128, the logits tile at 80 keys 40, P's A fragments 20; Q as A
//     fragments would add 64, over the limit.  So QK^T reads Q from shared
//     memory: `wgmma m64n80k16` in its SS form, a descriptor on the
//     warpgroup's swizzled Q panels for A; PV stays RS, two `m64n128k16`
//     over V's panel halves.  Each warpgroup loads its own 64 Q rows (its
//     own box and full barrier) and stages its output in those panels,
//     which its products no longer read after its last QK^T; once the TMA
//     store has read them, its leader loads the next work tile's Q there.
//     That Q load is not overlapped with the work tile's last PV and
//     epilogue as at D <= 128, so each work tile starts by waiting for it;
//     the K/V ring runs ahead meanwhile, and k2_ablate.py finds the wait
//     too short to measure on the H100.  The lazy softmax's exact redo reads
//     Q's A fragments per k16 slice with `ldmatrix` from those panels.  Per
//     key tile and warpgroup the products are 2.6 MFLOP over 64 x 80
//     softmax elements (D = 128: 2.1 MFLOP over 64 x 128).  The work is
//     walked by head (see Work): ordered by query tile, gemma's K and V
//     (268 MB) were read from device memory again by every work tile.  A
//     causal work tile runs key tiles up to its last row's diagonal, so
//     warpgroup 0's rows may see a key tile wholly masked (computed,
//     contributing 0).
// * float32 (any D) and bf16 at D = 16 or 32: the first body (`simt::`), no
//   TMA, no wgmma.  One block of four warps per 64-row query tile; each
//   warp owns 16 rows; K and V tiles of 64 rows are double-buffered with
//   `cp.async` (rows padded by 16 bytes, rows past S zero-filled),
//   single-buffered at float32 D = 256 (see `Layout`); bf16 runs
//   `mma.sync.m16n8k16` (K's and V's B fragments through `ldmatrix`),
//   float32 FFMA (no TF32) on the same C-fragment layout.
//
// Measured at the serving shape by chip_smoke.py (NVIDIA H100 80GB HBM3,
// 700.00 W, L2 cold): the first body took 607.8-617.2 us (22.7 % of the
// bound); the Hopper body's time, beside F.scaled_dot_product_attention's
// in the same run, is in PERF.md.

#include <cuda.h>   // CUtensorMap and the driver API types only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;     // the Pallas body's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of a (B, S, heads, D) tensor whose D axis is contiguous.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[0..3] += a * b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, S, H, KV;
  Strides sq, sk, sv;
  float scale;
  int causal;
  int W;                  // the window: keys with i - j >= W are masked
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// The first body: cp.async staging, mma.sync (bf16) or FFMA (float32).
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per staged tile (== kBQ)
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kBK / 8;          // 8-key column tiles per logits tile
constexpr int kPStride = kBK + 4;     // floats per row of P (float32 path)

// Shared memory: K and V tiles twice (the next tile's copies run while
// this tile is multiplied) and the Q tile; in bf16 (D = 16 or 32 here) Q is
// read into registers once, so its tile shares the second K buffer.
// float32 keeps Q in shared memory, plus one P tile per warp; at D = 256 it
// stages K and V once, not twice: two buffers (350 KB) would pass the
// 227 KB a block may take.
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kStride = D + kVec;  // elements per padded tile row
  static constexpr int kTile = kBK * kStride;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kQRegs = !kF32;
  static constexpr int kBufs = D > 128 ? 1 : 2;
  static constexpr int kTiles = (kQRegs ? 0 : 1) + 2 * kBufs;  // [Q] K0 V0 [K1 V1]
  static constexpr size_t kBytes =
      kTiles * kTile * sizeof(T) + (kF32 ? kWarps * 16 * kPStride * sizeof(float) : 0);
};

// 16 bytes from global to shared memory without passing through registers;
// with `full` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows [row0, row0 + 64) of one head into a padded shared
// tile; rows at or past S are zero-filled, so that masked products never
// meet NaN or Inf.
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long s_stride, int row0, int S) {
  using L = Layout<T, D>;
  constexpr int kChunks = D / L::kVec;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = row0 + r < S;
    cp_async16(dst + r * L::kStride + c * L::kVec,
               src + static_cast<long long>(in ? row0 + r : 0) * s_stride + c * L::kVec,
               in);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 address the
// rows of matrix i), as mma fragments; `_trans` delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Blocks an SM should hold: bf16 is held to 168 registers a thread for
// three; float32 (whose tiles fill most of shared memory at D = 128) is not
// held.
template <typename T, int D>
constexpr int min_blocks() {
  return std::is_same<T, float>::value ? 1 : 3;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int B, int S,
                 int H, int KV, Strides sq, Strides sk, Strides sv,
                 float scale, int causal, int W) {
  using L = Layout<T, D>;
  constexpr int kDT = D / 8;          // 8-wide output column tiles
  constexpr int kStride = L::kStride;
  // float32's loops over d (QK^T) and keys (PV): at D = 256 the accumulator
  // alone takes 128 registers, and unrolled loads of more steps spill.
  constexpr int kQkUnroll = D > 128 ? 1 : 2;
  constexpr int kPvUnroll = D > 128 ? 1 : 4;

  extern __shared__ uint4 smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  T* kbuf[2];
  kbuf[0] = base + (L::kQRegs ? 0 : 1) * L::kTile;
  kbuf[1] = L::kBufs == 2 ? kbuf[0] + 2 * L::kTile : kbuf[0];
  T* vbuf[2] = {kbuf[0] + L::kTile, kbuf[1] + L::kTile};
  T* qs = L::kQRegs ? kbuf[1] : base;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int nqb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nqb - 1 - blockIdx.x / (B * H);   // heaviest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + kvh * sk.h;
  const T* vp = v + b * sv.b + kvh * sv.h;

  // Key tiles: from the first one the window reaches (keys j with
  // i - j >= W are masked; W is INT_MAX without a window) to the last one
  // at or below the diagonal.
  const int j0 = max(0, q0 - W + 1) / kBK;
  const int nkb = causal ? qt + 1 : nqb;  // tiles wholly above skipped
  // The last row of the tile that holds a query: its window starts last.
  const int imax = min(q0 + kBQ - 1, S - 1);

  stage<T, D>(qs, qp, sq.s, q0, S);
  cp_async_commit();
  stage<T, D>(kbuf[0], kp, sk.s, j0 * kBK, S);
  stage<T, D>(vbuf[0], vp, sv.s, j0 * kBK, S);
  cp_async_commit();
  cp_async_wait<1>();                     // Q has landed
  __syncthreads();

  // Rows of this thread within the block: r[0] = 16 warp + g, r[1] = + 8.
  const int rloc0 = 16 * warp + g;
  const int row[2] = {q0 + rloc0, q0 + rloc0 + 8};

  // bf16: this warp's Q as m16n8k16 A fragments, kept for the whole block.
  uint32_t qf[L::kQRegs ? D / 16 : 1][4];
  if constexpr (L::kQRegs) {
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(qs);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      qf[kk][0] = ld32(qb + rloc0 * kStride + c);
      qf[kk][1] = ld32(qb + (rloc0 + 8) * kStride + c);
      qf[kk][2] = ld32(qb + rloc0 * kStride + c + 8);
      qf[kk][3] = ld32(qb + (rloc0 + 8) * kStride + c + 8);
    }
    __syncthreads();                      // Q's tile is the second K buffer
  }

  // Running max (log2 domain), this thread's share of the row sums, and the
  // output accumulator, in the mma C-fragment layout.
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.0f, 0.0f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  const float scale2 = scale * kLog2e;   // exp(x) = exp2(x log2 e)

  for (int j = j0; j < nkb; ++j) {
    const int k0 = j * kBK;
    const int it = j - j0;
    const T* ks = kbuf[it & 1];
    const T* vs = vbuf[it & 1];
    if (L::kBufs == 2 && j + 1 < nkb) {   // the next tile's copies overlap
      stage<T, D>(kbuf[(it + 1) & 1], kp, sk.s, k0 + kBK, S);
      stage<T, D>(vbuf[(it + 1) & 1], vp, sv.s, k0 + kBK, S);
      cp_async_commit();
      cp_async_wait<1>();                 // this tile has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Logits tile: s[n][e] for row row[e / 2], key k0 + 8 n + 2 t + e % 2.
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
    if constexpr (!L::kF32) {
      // ldmatrix rows: matrix i = (key half i / 2, d half i % 2) of 16 keys.
      const int mi = lane / 8;
      const __nv_bfloat16* krow = reinterpret_cast<const __nv_bfloat16*>(ks) +
                                  ((mi >> 1) * 8 + lane % 8) * kStride + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, krow + 16 * np * kStride + 16 * kk);
          mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
    } else {
      const float* qf0 = reinterpret_cast<const float*>(qs) + rloc0 * kStride;
      const float* qf1 = qf0 + 8 * kStride;
      const float* kf = reinterpret_cast<const float*>(ks) + 2 * t * kStride;
#pragma unroll (kQkUnroll)
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qf0 + d);
        const float4 a1 = *reinterpret_cast<const float4*>(qf1 + d);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float4 c0 = *reinterpret_cast<const float4*>(kf + 8 * n * kStride + d);
          const float4 c1 = *reinterpret_cast<const float4*>(kf + (8 * n + 1) * kStride + d);
          s[n][0] += a0.x * c0.x + a0.y * c0.y + a0.z * c0.z + a0.w * c0.w;
          s[n][1] += a0.x * c1.x + a0.y * c1.y + a0.z * c1.z + a0.w * c1.w;
          s[n][2] += a1.x * c0.x + a1.y * c0.y + a1.z * c0.z + a1.w * c0.w;
          s[n][3] += a1.x * c1.x + a1.y * c1.y + a1.z * c1.z + a1.w * c1.w;
        }
      }
    }

    // Scale (into the log2 domain), mask, and the new running max per row.
    // Only the diagonal tile, a ragged last tile and a tile that the window's
    // left edge crosses hold masked entries.
    const bool edge = (causal && j == qt) || k0 + kBK > S || imax - k0 >= W;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= S || (causal && key > row[e >> 1]) || row[e >> 1] - key >= W)
            s[n][e] = kMasked;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        lsum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }

    // acc += P V.
    if constexpr (!L::kF32) {
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vs);
      // ldmatrix rows: lanes 8i..8i+7 address matrix i = (key half, d half).
      const int mi = lane / 8;
      const __nv_bfloat16* vrow =
          vb + ((mi & 1) * 8 + lane % 8) * kStride + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vrow + 16 * kk * kStride + 16 * np);
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    } else {
      float* ps = reinterpret_cast<float*>(base + L::kTiles * L::kTile) +
                  warp * 16 * kPStride;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(ps + g * kPStride + c) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(ps + (g + 8) * kPStride + c) = make_float2(s[n][2], s[n][3]);
      }
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs) + 2 * t;
#pragma unroll (kPvUnroll)
      for (int key = 0; key < kBK; ++key) {
        const float p0 = ps[g * kPStride + key];
        const float p1 = ps[(g + 8) * kPStride + key];
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(vf + key * kStride + 8 * n);
          acc[n][0] = fmaf(p0, vv.x, acc[n][0]);
          acc[n][1] = fmaf(p0, vv.y, acc[n][1]);
          acc[n][2] = fmaf(p1, vv.x, acc[n][2]);
          acc[n][3] = fmaf(p1, vv.y, acc[n][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this tile's K, V (and P)
    if (L::kBufs == 1 && j + 1 < nkb) {   // one buffer: refill it now
      stage<T, D>(kbuf[0], kp, sk.s, k0 + kBK, S);
      stage<T, D>(vbuf[0], vp, sv.s, k0 + kBK, S);
      cp_async_commit();
    }
  }

  // The row sums are split over the four threads of a row group.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const long long os = static_cast<long long>(H) * D;   // out's row stride
  T* op = out + (static_cast<long long>(b) * S) * os + static_cast<long long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      store2<T>(op + row[r] * os + 8 * n + 2 * t, acc[n][2 * r] / l[r],
                acc[n][2 * r + 1] / l[r]);
    }
  }
}

// Lets the kernel take its dynamic shared memory (above 48 KB only when
// asked), with the SM's carveout set to shared memory.
template <typename T, int D>
cudaError_t prepare() {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = Layout<T, D>::kBytes;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) cudaGetLastError();  // so the next launch does not report it
  return err;
}

// Blocks of this body an SM holds (0 if it cannot be prepared).
template <typename T, int D>
int blocks_per_sm() {
  int n = 0;
  if (prepare<T, D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_attention_kernel<T, D>, kThreads, Layout<T, D>::kBytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <typename T, int D>
cudaError_t run(const Args& a) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = Layout<T, D>::kBytes;
  const cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return err;
  const long long nqb = (a.S + kBQ - 1) / kBQ;
  const long long blocks = nqb * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.B, a.S, a.H, a.KV,
      a.sq, a.sk, a.sv, a.scale, a.causal, a.W);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The Hopper body: TMA copies, wgmma products, two ping-ponged warpgroups.
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kBQ = 128;              // query rows per work tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kPanelBytes = 128 * 128;   // 128 rows x 64 bf16
constexpr int kHalfPanel = 64 * 128;     // 64 rows x 64 bf16: one warpgroup's
constexpr int kThreads = 256;         // two warpgroups of 64 query rows
constexpr int kWarps = kThreads / 32;  // count themselves out of a stage
constexpr unsigned long long kWaitLimitNs = 10000000000ull;   // 10 s

// Shared memory, from a 1024-byte aligned base (the 128B swizzle's period),
// in swizzled panels of 64 columns (128 bytes a row):
//   D = 64, 128: Q (128 rows a panel); per stage K and V (kBK = 128 rows a
//     panel); the output's staging tile (per warpgroup D / 64 panels of 64
//     rows).  Q is read into registers once per work tile.
//   D = 256 (kQShared): Q as each warpgroup's own 4 panels of 64 rows (its
//     own TMA box and "full" barrier); per stage K and V (kBK = 80 rows a
//     panel).  Q stays in shared memory for the SS products, and each
//     warpgroup stages its output in its own Q panels once its last QK^T
//     has read them: 64 + 2 x (40 + 40) KB, with no room for a staging
//     tile beside them.
// Then the mbarriers (Q full, per warpgroup at D = 256; per stage K full
// and V full: the TMA copies complete on them) and the release counts (per
// stage of K, per stage of V, and of Q at D <= 128: each warp adds one once
// its products have read the tile).
template <int D>
struct Smem {
  static constexpr bool kQShared = D == 256;
  static constexpr int kBK = kQShared ? 80 : 128;   // keys per staged tile
  static constexpr int kPanels = D / 64;
  static constexpr int kKVPanel = kBK * 128;
  static constexpr int kQTile = kPanels * kPanelBytes;   // 128 rows of Q
  static constexpr int kKVTile = kPanels * kKVPanel;
  static constexpr int kK0 = kQTile;                      // stage s: K at
  static constexpr int kO = kK0 + 2 * kStages * kKVTile;  // kK0 + 2 s kKVTile
  static constexpr int kOBytes = kQShared ? 0 : kPanels * kPanelBytes;
  static constexpr int kQBars = kQShared ? 2 : 1;
  static constexpr int kBar = kO + kOBytes;
  static constexpr int kCount = kBar + 8 * (kQBars + 2 * kStages);
  static constexpr size_t kBytes = kCount + 4 * (2 * kStages + 1) + 1024;
};
static_assert(Smem<256>::kBytes <= 232448, "227 KB a block");

template <int kQBars>
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full(int c) const { return base + 8 * c; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (kQBars + s); }
  __device__ uint32_t v_full(int s) const {
    return base + 8 * (kQBars + kStages + s);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed.  A wait that
// outlasts kWaitLimitNs traps (the launch then fails) rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kWaitLimitNs) __trap();
  }
}

// One TMA box (64 columns x 128 rows of one head) into shared memory,
// completing on `bar`; coordinates are (column, row, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA box (64 columns x 64 rows of one head) from shared memory to the
// output; rows past S are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's stores have read their shared memory (`read`), or are done.
template <bool read>
__device__ __forceinline__ void store_wait() {
  if constexpr (read) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// wgmma shared-memory descriptors for 128B-swizzled panels (layout type 1
// in bits 62-63): 8-row core groups 1024 bytes apart (SBO).  K-major (Q and
// K: one instruction's 16 columns lie inside a 128-byte row, LBO unused);
// MN-major (V as the transposed B of PV: the next 64 columns of D lie one
// panel further, LBO = kPanelBytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of these registers across the
// asynchronous products that read or write them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The products, d (+)= a * b for one k16 slice: the accumulator of a
// warpgroup's 64 x N tile in the mma C-fragment layout per warp, A from
// registers (the m16n8k16 A-fragment layout per warp), B from shared
// memory, K-major (QK^T: K) or, with transpose-B, MN-major (PV: V).

#define D64 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define D80 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
#define D128 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// kOff: the first of the 64 accumulator registers (a 64 x 128 slice of a
// wider accumulator: columns 2 kOff .. 2 kOff + 127).
template <int kTransB, int kOff = 0, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  static_assert(kOff + 64 <= N, "the accumulator slice lies inside d");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" D128 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]), "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]), "+f"(d[kOff + 6]), "+f"(d[kOff + 7]),
        "+f"(d[kOff + 8]), "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]), "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]), "+f"(d[kOff + 15]),
        "+f"(d[kOff + 16]), "+f"(d[kOff + 17]), "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]), "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
        "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]), "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]), "+f"(d[kOff + 30]), "+f"(d[kOff + 31]),
        "+f"(d[kOff + 32]), "+f"(d[kOff + 33]), "+f"(d[kOff + 34]), "+f"(d[kOff + 35]), "+f"(d[kOff + 36]), "+f"(d[kOff + 37]), "+f"(d[kOff + 38]), "+f"(d[kOff + 39]),
        "+f"(d[kOff + 40]), "+f"(d[kOff + 41]), "+f"(d[kOff + 42]), "+f"(d[kOff + 43]), "+f"(d[kOff + 44]), "+f"(d[kOff + 45]), "+f"(d[kOff + 46]), "+f"(d[kOff + 47]),
        "+f"(d[kOff + 48]), "+f"(d[kOff + 49]), "+f"(d[kOff + 50]), "+f"(d[kOff + 51]), "+f"(d[kOff + 52]), "+f"(d[kOff + 53]), "+f"(d[kOff + 54]), "+f"(d[kOff + 55]),
        "+f"(d[kOff + 56]), "+f"(d[kOff + 57]), "+f"(d[kOff + 58]), "+f"(d[kOff + 59]), "+f"(d[kOff + 60]), "+f"(d[kOff + 61]), "+f"(d[kOff + 62]), "+f"(d[kOff + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" D64 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= a * b with A from shared memory too (K-major, descriptor da): the
// QK^T of D = 256 over its 80-key tiles, whose Q would not fit in registers
// beside the output.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{" D80 "}, %40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// 2^x on the special function unit (inputs at or below -126 give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax over one logits tile, in place: sc[4 n + e] (row
// row[e / 2], key k0 + 8 n + 2 t + e % 2) becomes the unrounded P; m and l
// are updated, and corr is the factor that rescales the output's rows.  In
// the log2 domain, p = 2^(s scale log2 e - m).  Only the diagonal tile, a
// ragged last tile and a tile that a row's window starts in hold masked
// entries (`edge`): there the logits are scaled and then masked to -1e30
// (keys past S, above the diagonal, or W or more rows back), as in the
// Pallas body and the reference's window mask; elsewhere the scaling is
// folded into one FFMA (the max commutes with it when scale2 > 0).  Each
// row's max and sum run as four independent chains (chunks n % 4), so that
// their latency does not serialise the tile.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale2, bool edge, int k0,
                                             const int (&row)[2], int t, int S,
                                             int causal, int W) {
  constexpr float kLowest = -3.402823466e38f;   // below every logit
  const bool fold = !edge && scale2 > 0.0f;
  float pm[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pm[0][q] = pm[1][q] = kLowest;
  if (fold) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pm[e >> 1][n & 3] = fmaxf(pm[e >> 1][n & 3], sc[4 * n + e]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e] * scale2;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        if (key >= S || (causal && key > row[e >> 1]) || row[e >> 1] - key >= W)
          x = kMasked;
        sc[4 * n + e] = x;
        pm[e >> 1][n & 3] = fmaxf(pm[e >> 1][n & 3], x);
      }
    }
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], fold ? mx[r] * scale2 : mx[r]);
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float ps[2][4] = {};
  if (fold) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale2, -m[e >> 1]));
        ps[e >> 1][n & 3] += sc[4 * n + e];
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = ex2(sc[4 * n + e] - m[e >> 1]);
        ps[e >> 1][n & 3] += sc[4 * n + e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// The lazy softmax of a tile without masked entries (scale2 > 0): P is
// taken against the running max m as it stands, so the exponentials need
// not wait for the tile's max, and the max only says whether any row grew
// past m by more than kLazyLog2 (P up to 2^8, far inside float32 and
// bf16's range).  Returns that; on false sc holds no usable P and the tile
// must be redone exactly.  lsum gets this thread's share of the row sums.
// The softmax is the same whatever reference max a row uses; only P's
// rounding differs, as between any two tilings.
constexpr float kLazyLog2 = 8.0f;

template <int N>
__device__ __forceinline__ bool softmax_lazy(float (&sc)[N],
                                             const float (&m)[2],
                                             float (&lsum)[2], float scale2) {
  constexpr float kLowest = -3.402823466e38f;   // below every logit
  float pm[2][4], ps[2][4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) pm[0][q] = pm[1][q] = kLowest;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pm[e >> 1][n & 3] = fmaxf(pm[e >> 1][n & 3], sc[4 * n + e]);
      sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale2, -m[e >> 1]));
      ps[e >> 1][n & 3] += sc[4 * n + e];
    }
  }
  bool grew = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mx = fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3]));
    grew |= mx * scale2 > m[r] + kLazyLog2;
    lsum[r] = (ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]);
  }
  return grew;
}

// P (bf16) as PV's A fragments, 16 keys per k slice: chunks 2 kk and
// 2 kk + 1, rows g and g + 8.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&sc)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  }
}

// Four 8x8 bf16 matrices from shared memory as mma fragments (lanes
// 8i..8i+7 address the rows of matrix i).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The 16-byte chunk `chunk` of row r of a 128B-swizzled panel.
__device__ __forceinline__ uint32_t swizzled(uint32_t panel, int r, int chunk) {
  return panel + r * 128 + ((chunk ^ (r % 8)) * 16);
}

// This warp's 16 rows of Q as A fragments, read once per work tile from the
// 128B-swizzled Q panels (matrix i = rows 0-7 / 8-15 x columns 0-7 / 8-15
// of each k16 slice).
template <int D>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[D / 16][4],
                                                 uint32_t qaddr, int warp,
                                                 int lane) {
  const int r = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(qf[kk], swizzled(qaddr + (kk / 4) * kPanelBytes, r,
                             2 * (kk % 4) + lane / 16));
  }
}

// Q's operand of QK^T: at D <= 128 this warp's A fragments, read once per
// work tile; at D = 256 the products read Q's panels in shared memory (its
// fragments would take 64 registers beside the output's 128), and the
// array is a placeholder.
template <int D>
using QFrags = uint32_t[Smem<D>::kQShared ? 1 : D / 16][4];

// S = Q K^T for this warpgroup's 64 rows (issued, not waited on): A from
// registers (`qf`) or, at D = 256, from the warpgroup's Q panels at
// `qaddr` (64 rows each, K-major like K).
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[Smem<D>::kBK / 2],
                                           const QFrags<D>& qf, uint32_t qaddr,
                                           uint32_t kaddr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Smem<D>::kKVPanel + (kk % 4) * 32;
    if constexpr (Smem<D>::kQShared) {
      const uint32_t qoff = (kk / 4) * kHalfPanel + (kk % 4) * 32;
      wgmma_ss_n80(sc, desc_sw128(qaddr + qoff, 16),
                   desc_sw128(kaddr + off, 16), kk > 0);
    } else {
      wgmma_rs_n128<0>(sc, qf[kk], desc_sw128(kaddr + off, 16), kk > 0);
    }
  }
}

// S = Q K^T again for this warp's 16 rows alone, with `mma.sync` (the
// lazy softmax's rare exact path; no warpgroup-wide instruction).  Q's A
// fragments serve as they are, or at D = 256 come per k16 slice from Q's
// panels by `ldmatrix` (as `load_q_fragments` reads them); K's B fragments
// come by `ldmatrix` (matrix i = keys 0-7 / 8-15 of 16 x columns 0-7 /
// 8-15 of a k16 slice).
template <int D>
__device__ __forceinline__ void qk_warp(float (&sc)[Smem<D>::kBK / 2],
                                        const QFrags<D>& qf, uint32_t qaddr,
                                        uint32_t kaddr, int warp, int lane) {
  constexpr int kBK = Smem<D>::kBK;
  const int mi = lane / 8;
  const int qr = 16 * warp + lane % 8 + 8 * (mi % 2);   // Q's row (D = 256)
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    if constexpr (Smem<D>::kQShared) {
      ldsm_x4(qa, swizzled(qaddr + (kk / 4) * kHalfPanel, qr,
                           2 * (kk % 4) + lane / 16));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
    }
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
      const int key = 16 * np + (mi >> 1) * 8 + lane % 8;
      uint32_t bf[4];
      ldsm_x4(bf, swizzled(kaddr + (kk / 4) * Smem<D>::kKVPanel, key,
                           2 * (kk % 4) + (mi & 1)));
      mma_bf16(&sc[8 * np], qa, bf[0], bf[1]);
      mma_bf16(&sc[8 * np + 4], qa, bf[2], bf[3]);
    }
  }
}

// O += P V (issued, not waited on).  V's panels of 64 columns lie
// kKVPanel apart; at D = 256 the output's two 128-column halves take one
// product each.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[Smem<D>::kBK / 16][4],
                                           uint32_t vaddr) {
  constexpr int kKVPanel = Smem<D>::kKVPanel;
#pragma unroll
  for (int kk = 0; kk < Smem<D>::kBK / 16; ++kk) {
    const uint32_t v = vaddr + kk * 16 * 128;
    if constexpr (D == 256) {
      wgmma_rs_n128<1, 0>(o, pa[kk], desc_sw128(v, kKVPanel), 1);
      wgmma_rs_n128<1, 64>(o, pa[kk], desc_sw128(v + 2 * kKVPanel, kKVPanel), 1);
    } else if constexpr (D == 128) {
      wgmma_rs_n128<1>(o, pa[kk], desc_sw128(v, kKVPanel), 1);
    } else {
      wgmma_rs_n64(o, pa[kk], desc_sw128(v, kKVPanel), 1);
    }
  }
}

// Ping-pong between the two warpgroups: a warpgroup issues its products
// only on its turn (named barrier 1 + c, completed by its own 128 threads
// and the other warpgroup's arrival), and hands the turn over once they are
// issued, so that one warpgroup's softmax runs while the other's products
// hold the tensor cores.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - c) : "memory");
}

// The 128 threads of warpgroup c (named barrier 3 + c).
__device__ __forceinline__ void group_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(3 + c) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// A warp counts itself out of a stage once all its products have read the
// tile; the last of the kWarps refills the stage (`refill` issues the TMA
// copy of the tile that goes there next, if there is one).  No warp waits
// for another to release a stage.
template <class Refill>
__device__ __forceinline__ void release(uint32_t* count, int lane,
                                        Refill refill) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    if (atomicAdd(count, 1u) % kWarps == kWarps - 1) refill();
  }
  __syncwarp();
}

// The work: one tile per (128-row query tile, batch, head), in one of two
// orders.  A work tile's key tiles (of BK keys) run from j0, the first its
// window reaches (0 without one), to the last that holds a key at or below
// its last row's diagonal (every tile without a causal mask): n of them.
// * By query tile (kByHead false; D = 64, 128): heaviest causal tiles
//   first, every (batch, head) of the last query tile, then of the one
//   before.  Block k of the G persistent blocks takes, in round r, tile
//   r G + k in even rounds and r G + G - 1 - k in odd ones (a snake, so
//   that each block's heavy and light causal tiles even out).  Under a
//   window n stops growing with qt at about W / BK + 2, so the order is
//   still heaviest first, with many ties.  The blocks then read every
//   head's K and V at once: this suits K and V that fit in the 50 MB L2.
// * By head (kByHead true; D = 256): the (batch, head) pairs one after
//   another, each one's query tiles paired heaviest with lightest (qt =
//   nqb - 1, 0, nqb - 2, 1, ...); block k takes pair m G + k in rounds 2m
//   and 2m + 1, so every block's pair of causal tiles costs about the
//   same and the blocks keep in step over about G / (nqb / 2) heads at a
//   time.  gemma-7b's K and V (268 MB at 8 x 2048, 16 kv heads of 256)
//   do not fit in L2: ordered by query tile, every work tile read its keys
//   from device memory again (2.3 GB, about 0.7 ms at 3.35 TB/s); by head,
//   the about 16 heads in flight (33 MB) stay in L2 and each key is read
//   from device memory about once.
struct Tile {
  int w, qt, j0, n, b, h, kvh;   // w >= the tile count: no tile
};

template <int BK, bool kByHead>
struct Work {
  int B, S, H, KV, nqb, tiles, causal, W;
  __device__ int index(int r) const {
    const int G = gridDim.x;
    const int k = static_cast<int>(blockIdx.x);
    if constexpr (kByHead) return 2 * ((r >> 1) * G + k) + (r & 1);
    return r * G + ((r & 1) ? G - 1 - k : k);
  }
  __device__ Tile tile(int r) const {
    Tile t;
    t.w = index(r);
    int bh;
    if constexpr (kByHead) {
      const int i = t.w % nqb;
      bh = t.w / nqb;
      t.qt = (i & 1) ? i / 2 : nqb - 1 - i / 2;
    } else {
      bh = t.w % (B * H);
      t.qt = nqb - 1 - t.w / (B * H);
    }
    t.j0 = max(0, t.qt * kBQ - W + 1) / BK;
    // At BK = kBQ the same values in the form the D <= 128 body was tuned
    // with: the general form costs it about 1 % (k2_ablate.py's shapes).
    if constexpr (BK == kBQ) {
      t.n = (causal ? t.qt + 1 : nqb) - t.j0;
    } else {
      t.n = (causal ? min(t.qt * kBQ + kBQ - 1, S - 1) / BK + 1
                    : (S + BK - 1) / BK) - t.j0;
    }
    if constexpr (kByHead) {
      t.b = bh / H;
      t.h = bh % H;
    } else {
      t.b = t.w % (B * H) / H;
      t.h = t.w % H;
    }
    t.kvh = t.h / (H / KV);
    return t;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int B, int S,
                       int H, int KV, float scale, int causal, int W) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  constexpr int kDT = D / 8;            // 8-wide chunks of the output

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const Bars<L::kQBars> bars{base + L::kBar};
  uint32_t* count = reinterpret_cast<uint32_t*>(
      smem_raw + (base - smem_addr(smem_raw)) + L::kCount);
  const int nqb = (S + kBQ - 1) / kBQ;
  constexpr bool kByHead = D == 256;   // the work's order (see Work, run_hopper)
  const Work<kBK, kByHead> wk{B, S, H, KV, nqb, nqb * B * H, causal, W};

  // The block's key tiles form one sequence over its work tiles: tile g of
  // it goes to stage g % kStages and completes its full barrier's phase
  // g / kStages.  `load_kv` copies sequence tile g, counting from g0, the
  // first of work tile `cur` (round rnd), whose successor is `nxt`: with
  // two stages g - g0 is at most cur.n + 1, so g lies in `cur`, in `nxt`,
  // or (after a one-tile `nxt`) in the work tile after it; within its work
  // tile it is key tile j0 + (its place there).
  auto k_addr = [&](int s) { return base + L::kK0 + 2 * s * L::kKVTile; };
  auto load_kv = [&](bool is_v, const Tile& cur, const Tile& nxt, int rnd,
                     int g0, int g) {
    int j = g - g0, j0 = cur.j0, b = cur.b, kvh = cur.kvh;
    if (j >= cur.n) {
      j -= cur.n;
      j0 = nxt.j0;
      b = nxt.b;
      kvh = nxt.kvh;
      if (nxt.w < wk.tiles && j >= nxt.n) {
        const Tile after = wk.tile(rnd + 2);
        j -= nxt.n;
        j0 = after.j0;
        b = after.b;
        kvh = after.kvh;
        if (after.w >= wk.tiles) return;
      } else if (nxt.w >= wk.tiles) {
        return;
      }
    }
    const int s = g % kStages;
    const uint32_t bar = is_v ? bars.v_full(s) : bars.k_full(s);
    const uint32_t dst = k_addr(s) + (is_v ? L::kKVTile : 0);
    mbar_expect_tx(bar, L::kKVTile);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(dst + p * L::kKVPanel, is_v ? &tv : &tk, bar, 64 * p,
               (j0 + j) * kBK, kvh, b);
  };
  // Q of work tile t: all 128 rows at once (D <= 128), or at D = 256 the
  // 64 rows of warpgroup c, into its own panels.
  auto load_q = [&](const Tile& t, int c) {
    if constexpr (L::kQShared) {
      const uint32_t dst = base + c * L::kPanels * kHalfPanel;
      mbar_expect_tx(bars.q_full(c), L::kPanels * kHalfPanel);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(dst + p * kHalfPanel, &tq, bars.q_full(c), 64 * p,
                 t.qt * kBQ + 64 * c, t.h, t.b);
    } else {
      mbar_expect_tx(bars.q_full(0), L::kQTile);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + p * kPanelBytes, &tq, bars.q_full(0), 64 * p,
                 t.qt * kBQ, t.h, t.b);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < L::kQBars; ++c) mbar_init(bars.q_full(c), 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
    }
    for (int i = 0; i < 2 * kStages + 1; ++i) count[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const Tile first = wk.tile(0), second = wk.tile(1);
#pragma unroll
    for (int c = 0; c < L::kQBars; ++c) load_q(first, c);
    for (int g = 0; g < kStages; ++g) {
      load_kv(false, first, second, 0, 0, g);
      load_kv(true, first, second, 0, 0, g);
    }
  }
  __syncthreads();

  // Two warpgroups of 64 query rows.  Key tile g's QK^T is issued together
  // with tile g - 1's PV, and its softmax runs while PV is on the tensor
  // cores.  Each warpgroup issues products key_tiles + 1 times a work tile,
  // warpgroup 0 first: warpgroup 1 passes the first turn here, and
  // warpgroup 0 takes the last one it passes at the end.
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int warp = (threadIdx.x / 32) % 4;   // within the warpgroup
  const int rl = 16 * warp + lane / 4;       // row of 64
  const bool leader = threadIdx.x % 128 == 0;
  // This warpgroup's Q rows: in each 128-row panel (D <= 128), or its own
  // panels (D = 256), where its output is also staged.
  const uint32_t qaddr = L::kQShared ? base + c * L::kPanels * kHalfPanel
                                     : base + c * kHalfPanel;
  const uint32_t oaddr =
      L::kQShared ? qaddr : base + L::kO + c * L::kPanels * kHalfPanel;
  const float scale2 = scale * kLog2e;   // exp(x) = exp2(x log2 e)
  float o[D / 2];
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.0f;
  if (c == 1) turn_pass(c);

  int g0 = 0;   // the block's first key tile of work tile `cur`
  Tile cur = wk.tile(0);
  for (int rnd = 0; cur.w < wk.tiles; ++rnd) {
    const Tile nxt = wk.tile(rnd + 1);
    const int qt = cur.qt;
    const int q0 = qt * kBQ;
    const int j0 = cur.j0;
    const int n = cur.n;
    // Rows past S (read as zero, never stored) are masked as row S - 1, so
    // that the last row that holds a query, imax, bounds every row's window.
    const int imax = min(q0 + kBQ - 1, S - 1);
    const int row[2] = {min(q0 + 64 * c + rl, S - 1),
                        min(q0 + 64 * c + rl + 8, S - 1)};
    // Key tile j takes the exact softmax where it holds masked entries (a
    // key past the work tile's first row under the causal mask, a ragged
    // last tile, keys W or more rows behind imax), and where imax's window
    // starts at its first key: there imax has seen no key yet (its max is
    // still -1e30), which the lazy path cannot take.
    auto edge = [&](int j) {
      const int reach = imax - j * kBK;
      const bool diagonal =     // at kBK = kBQ: j == qt (see Work::tile)
          kBK == kBQ ? j == qt : (j + 1) * kBK - 1 > q0;
      return (causal && diagonal) || (j + 1) * kBK > S || reach >= W ||
             (reach == W - 1 && j > j0);
    };
    auto k_ready = [&](int g) {
      mbar_wait(bars.k_full(g % kStages), (g / kStages) & 1);
    };
    auto v_ready = [&](int g) {
      mbar_wait(bars.v_full(g % kStages), (g / kStages) & 1);
    };
    auto release_k = [&](int g) {
      release(&count[g % kStages], lane,
              [&] { load_kv(false, cur, nxt, rnd, g0, g + kStages); });
    };
    auto release_v = [&](int g) {
      release(&count[kStages + g % kStages], lane,
              [&] { load_kv(true, cur, nxt, rnd, g0, g + kStages); });
    };
    auto release_q = [&] {
      release(&count[2 * kStages], lane, [&] {
        if (nxt.w < wk.tiles) load_q(nxt, 0);
      });
    };

    float m[2] = {kMasked, kMasked};   // running max, log2 domain
    float l[2] = {0.0f, 0.0f};         // this thread's share of the row sums
    float corr[2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.0f;

    QFrags<D> qf;
    if constexpr (L::kQShared) {
      mbar_wait(bars.q_full(c), rnd & 1);
    } else {
      mbar_wait(bars.q_full(0), rnd & 1);
      load_q_fragments<D>(qf, qaddr, warp, lane);
      release_q();
    }
    k_ready(g0);
    reg_fence(sc);
    turn_wait(c);
    wgmma_fence();
    qk_product<D>(sc, qf, qaddr, k_addr(g0 % kStages));
    wgmma_commit();
    turn_pass(c);
    wgmma_wait<0>();
    reg_fence(sc);
    release_k(g0);
    softmax_tile(sc, m, l, corr, scale2, edge(j0), j0 * kBK, row, t, S, causal,
                 W);
    pack_p(pa, sc);

    for (int i = 1; i < n; ++i) {
      const int j = j0 + i;             // the key tile
      const int g = g0 + i;             // its place in the block's sequence
      k_ready(g);
      v_ready(g - 1);
      reg_fence(sc);
      reg_fence(o);
      turn_wait(c);
      wgmma_fence();
      qk_product<D>(sc, qf, qaddr, k_addr(g % kStages));
      wgmma_commit();
      pv_product<D>(o, pa, k_addr((g - 1) % kStages) + L::kKVTile);
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<1>();                  // QK^T of key tile g is done
      reg_fence(sc);
      // The lazy softmax where no entry is masked; in a warp where a row
      // grew too far the tile is redone exactly once PV is done (its QK^T
      // again, K still held).  Masked tiles take the exact softmax at once.
      const bool lazy = !edge(j) && scale2 > 0.0f;
      bool redo = false;
      float lsum[2];
      if (lazy) {
        redo = __any_sync(0xffffffffu, softmax_lazy(sc, m, lsum, scale2));
      } else {
        softmax_tile(sc, m, l, corr, scale2, true, j * kBK, row, t, S,
                     causal, W);
      }
      wgmma_wait<0>();                  // PV of key tile g - 1 is done
      reg_fence(o);
      release_v(g - 1);
      if (redo) {
        qk_warp<D>(sc, qf, qaddr, k_addr(g % kStages), warp, lane);
        softmax_tile(sc, m, l, corr, scale2, false, j * kBK, row, t, S,
                     causal, W);
      }
      release_k(g);
      if (lazy && !redo) {
        l[0] += lsum[0];
        l[1] += lsum[1];
      } else {
#pragma unroll
        for (int k = 0; k < D / 2; ++k) o[k] *= corr[(k >> 1) & 1];
      }
      pack_p(pa, sc);
    }
    const int gl = g0 + n - 1;
    v_ready(gl);
    reg_fence(o);
    turn_wait(c);
    wgmma_fence();
    pv_product<D>(o, pa, k_addr(gl % kStages) + L::kKVTile);
    wgmma_commit();
    turn_pass(c);
    wgmma_wait<0>();
    reg_fence(o);
    release_v(gl);

    // Epilogue: divide by the row sums (split over the four threads of a
    // row group; a multiply by the float32 reciprocal, one rounding far
    // below bf16's), round to bf16 into the staging tile (128B-swizzled, as
    // the store's tensor map reads it) and store it with TMA, which skips
    // rows past S.  D <= 128: the previous work tile's store must have read
    // the staging tile first.  D = 256: the staging tile is this
    // warpgroup's Q panels, which its products no longer read (each warp
    // writes the rows its own redo read); once the store has read them the
    // leader loads the next work tile's Q there.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    if constexpr (!L::kQShared) {
      if (leader) store_wait<true>();
      group_sync(c);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = rl + 8 * r;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const uint32_t addr = oaddr + (n / 8) * kHalfPanel + rr * 128 +
                              (((n % 8) ^ (rr % 8)) * 16) + 4 * t;
        st_shared(addr, pack_bf16(o[4 * n + 2 * r] * l[r],
                                  o[4 * n + 2 * r + 1] * l[r]));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(c);
    if (leader) {
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_store(&to, oaddr + p * kHalfPanel, 64 * p, q0 + 64 * c, cur.h,
                  cur.b);
      store_commit();
      if constexpr (L::kQShared) {
        store_wait<true>();
        if (nxt.w < wk.tiles) load_q(nxt, c);
      }
    }
    g0 += n;
    cur = nxt;
  }
  if (c == 0) turn_wait(c);
  if (leader) store_wait<false>();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// A return value at or above this is kEncodeFailed + the CUresult of
// cuTensorMapEncodeTiled (kEncodeFailed + 999 if the driver does not offer
// the function).
constexpr int kEncodeFailed = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found in the driver at run time, so that the
// library links no -lcuda; null if the driver does not offer it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of one bf16 (B, S, heads, D) tensor: 4-D over (D, S, heads,
// B) with the tensor's own byte strides (so head slices of a fused QKV
// tensor work); a box is 64 columns x `box_rows` rows of one head,
// 128B-swizzled, and rows past S read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
               int B, const Strides& st, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed + 999;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int run_hopper(const Args& a) {
  // q is read in boxes of 128 rows (64 at D = 256, one warpgroup's), k and
  // v in boxes of kBK rows; out is written in boxes of 64 rows (one
  // warpgroup's), contiguous (B, S, H, D).
  using L = hopper::Smem<D>;
  const Strides so{static_cast<long long>(a.S) * a.H * D,
                   static_cast<long long>(a.H) * D, D};
  CUtensorMap tq, tk, tv, to;
  int err = encode_map(&tq, a.q, D, a.S, a.H, a.B, a.sq,
                       L::kQShared ? 64 : hopper::kBQ);
  if (err == 0) err = encode_map(&tk, a.k, D, a.S, a.KV, a.B, a.sk, L::kBK);
  if (err == 0) err = encode_map(&tv, a.v, D, a.S, a.KV, a.B, a.sv, L::kBK);
  if (err == 0) err = encode_map(&to, a.out, D, a.S, a.H, a.B, so, 64);
  if (err != 0) return err;
  auto kern = hopper::flash_attention_kernel<D>;
  constexpr size_t smem = L::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return e;
  }
  // A persistent grid: one block an SM (shared memory admits no more), each
  // walking the work tiles; ordered by head (D = 256) a block takes them in
  // pairs, so no more blocks than pairs.
  const long long tiles =
      static_cast<long long>((a.S + hopper::kBQ - 1) / hopper::kBQ) * a.B * a.H;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long units = D == 256 ? (tiles + 1) / 2 : tiles;
  const unsigned blocks = static_cast<unsigned>(units < sms ? units : sms);
  kern<<<blocks, hopper::kThreads, smem, a.stream>>>(
      tq, tk, tv, to, a.B, a.S, a.H, a.KV, a.scale, a.causal, a.W);
  return cudaGetLastError();
}

// The body by dtype x D: bf16 at D = 64, 128 or 256 runs the Hopper body;
// every other case the first body.
template <typename T>
int pick_d(const Args& a, int d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (d) {
      case 16: return simt::run<T, 16>(a);
      case 32: return simt::run<T, 32>(a);
      case 64: return run_hopper<64>(a);
      case 128: return run_hopper<128>(a);
      case 256: return run_hopper<256>(a);
    }
  } else {
    switch (d) {
      case 16: return simt::run<T, 16>(a);
      case 32: return simt::run<T, 32>(a);
      case 64: return simt::run<T, 64>(a);
      case 128: return simt::run<T, 128>(a);
      case 256: return simt::run<T, 256>(a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory, in bytes, that a launch for this dtype code and D
// takes (0 for a D the kernel does not take).
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype) {
    switch (D) {
      case 16: return static_cast<int>(simt::Layout<__nv_bfloat16, 16>::kBytes);
      case 32: return static_cast<int>(simt::Layout<__nv_bfloat16, 32>::kBytes);
      case 64: return static_cast<int>(hopper::Smem<64>::kBytes);
      case 128: return static_cast<int>(hopper::Smem<128>::kBytes);
      case 256: return static_cast<int>(hopper::Smem<256>::kBytes);
    }
  } else {
    switch (D) {
      case 16: return static_cast<int>(simt::Layout<float, 16>::kBytes);
      case 32: return static_cast<int>(simt::Layout<float, 32>::kBytes);
      case 64: return static_cast<int>(simt::Layout<float, 64>::kBytes);
      case 128: return static_cast<int>(simt::Layout<float, 128>::kBytes);
      case 256: return static_cast<int>(simt::Layout<float, 256>::kBytes);
    }
  }
  return 0;
}

// Blocks of the first body an SM holds at this dtype code and D, by the
// occupancy calculator (0 for the Hopper body's cases, one block an SM by
// construction, and for a D the kernel does not take).
extern "C" int flash_attention_simt_blocks_per_sm(int dtype, int D) {
  if (dtype) {
    switch (D) {
      case 16: return simt::blocks_per_sm<__nv_bfloat16, 16>();
      case 32: return simt::blocks_per_sm<__nv_bfloat16, 32>();
    }
  } else {
    switch (D) {
      case 16: return simt::blocks_per_sm<float, 16>();
      case 32: return simt::blocks_per_sm<float, 32>();
      case 64: return simt::blocks_per_sm<float, 64>();
      case 128: return simt::blocks_per_sm<float, 128>();
      case 256: return simt::blocks_per_sm<float, 256>();
    }
  }
  return 0;
}

// dtype code of q / k / v / out: 0 = float32, 1 = bfloat16.  D must be 16,
// 32, 64, 128 or 256 and H a multiple of KV; `window` >= 1 masks keys j with
// i - j >= window, 0 means no window.  Strides are in elements, for the B,
// S and head axes of q, k and v in that order (the D axis is contiguous,
// each row 16-byte aligned; in bf16 at D = 64, 128 or 256 the byte strides
// are TMA's: multiples of 16 below 2^40).  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or kEncodeFailed + a CUresult if a
// tensor map cannot be built; it neither allocates nor synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int D,
                                      const long long* strides, float scale,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (KV < 1 || H % KV != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, S, H, KV,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               scale, causal, window > 0 ? window : INT_MAX,
               static_cast<cudaStream_t>(stream)};
  return dtype ? pick_d<__nv_bfloat16>(a, D) : pick_d<float>(a, D);
}
