// Flash-attention forward (causal or full, grouped-query) for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention.py (`flash_attention_fwd`, whose
// pallas_call runs the body `_flash_fwd_kernel`).  For batch b, query head h
// (reading kv head h / G, G = H / KV) and query row i:
//   s_ij = scale * q_i . k_j            (float32; -1e30 where j > i if causal)
//   out_i = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// with m, l and the output accumulator carried over key tiles by the online
// softmax, key tiles wholly above the diagonal skipped, and the output cast
// to q's type.  q is (B, S, H, D), k and v (B, S, KV, D), all float32 or all
// bfloat16, read through their strides (the D axis contiguous); out is
// (B, S, H, D) contiguous.  D is 16, 32, 64 or 128.
//
// What bounds it on this card.  At the serving shape (qwen2.5-3b prefill:
// B=8, S=2048, H=16, KV=2, D=128, bf16, causal) it must move 151 MB (q and
// out 67 MB each, k and v 8.4 MB each: 45 us at 3.35 TB/s) and do 137 GFLOP
// of causal QK^T and PV products (139 us at 989 TFLOP/s bf16): the tensor
// cores bound it.  So in bf16 both products run on them, as
// `mma.sync.m16n8k16` (bf16 in, float32 accumulate): the products of bf16
// values are exact in float32, so QK^T equals the Pallas body's float32
// product up to summation order.  P is rounded to bf16 for the PV product,
// the one rounding the Pallas body does not make (the model's own `_sdpa`
// makes it); the row sums l are taken from the unrounded P.  The logits tile
// lives in registers only, as it lives in VMEM only on the TPU.  float32
// inputs run the same tiling on the CUDA cores (FFMA, no TF32).
//
// Layout.  One block of four warps per (query tile of 64 rows, batch, head),
// the heaviest causal tiles first.  Each warp owns 16 query rows; in bf16
// their Q fragments stay in registers for the whole block.  K and V tiles of
// 64 rows are double-buffered in shared memory: `cp.async` copies the next
// tile (16 bytes a thread, rows padded by 16 bytes so that fragment loads
// meet no bank conflict, rows past S zero-filled) while the warps multiply
// this one.  Each warp computes its 16 x 64 logits tile (K's B fragments
// through `ldmatrix`), masks only on the diagonal or a ragged last tile,
// updates m, l and the accumulator, and multiplies P by V (V's B fragments
// through `ldmatrix.trans`).  The accumulator of a thread holds the mma
// C-fragment layout (rows g and g + 8 of its warp, columns 2t and 2t + 1 of
// every 8-wide tile, g = lane / 4, t = lane % 4) in both types, so the
// softmax code is shared.  In bf16 at D = 128 a block takes 68 KB of shared
// memory and is held to 168 registers a thread (a few bytes spill), so that
// three blocks (12 warps) share an SM.  Against the first version of this kernel (single
// buffer, K fragments by 32-bit loads, every tile masked: 979 us at the
// serving shape) this one takes 612 us (H100 SXM at 700 W; PERF.md).  No
// TMA, no wgmma, no warp specialisation: those come in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per staged tile (== kBQ)
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kBK / 8;          // 8-key column tiles per logits tile
constexpr int kPStride = kBK + 4;     // floats per row of P (float32 path)
constexpr float kMasked = -1e30f;     // the Pallas body's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of a (B, S, heads, D) tensor whose D axis is contiguous.
struct Strides {
  long long b, s, h;
};

// Shared memory: K and V tiles twice (the next tile's copies run while
// this tile is multiplied) and the Q tile; in bf16 Q is read into registers
// once, so its tile shares the second K buffer.  float32 keeps Q in shared
// memory, plus one P tile per warp.
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kStride = D + kVec;  // elements per padded tile row
  static constexpr int kTile = kBK * kStride;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kTiles = kF32 ? 5 : 4;   // [Q] K0 V0 K1 V1
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Blocks an SM should hold: bf16 is held to 168 registers a thread for three;
// float32 (whose tiles fill most of shared memory at D = 128) is not held.
template <typename T>
constexpr int min_blocks() { return std::is_same<T, float>::value ? 1 : 3; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int B, int S,
                 int H, int KV, Strides sq, Strides sk, Strides sv,
                 float scale, int causal) {
  using L = Layout<T, D>;
  constexpr int kDT = D / 8;          // 8-wide output column tiles
  constexpr int kStride = L::kStride;

  extern __shared__ uint4 smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  T* kbuf[2] = {base + (L::kF32 ? 1 : 0) * L::kTile,
                base + (L::kF32 ? 3 : 2) * L::kTile};
  T* vbuf[2] = {kbuf[0] + L::kTile, kbuf[1] + L::kTile};
  T* qs = L::kF32 ? base : kbuf[1];

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

  stage<T, D>(qs, qp, sq.s, q0, S);
  cp_async_commit();
  stage<T, D>(kbuf[0], kp, sk.s, 0, S);
  stage<T, D>(vbuf[0], vp, sv.s, 0, S);
  cp_async_commit();
  cp_async_wait<1>();                     // Q has landed
  __syncthreads();

  // Rows of this thread within the block: r[0] = 16 warp + g, r[1] = + 8.
  const int rloc0 = 16 * warp + g;
  const int row[2] = {q0 + rloc0, q0 + rloc0 + 8};

  // bf16: this warp's Q as m16n8k16 A fragments, kept for the whole block.
  uint32_t qf[L::kF32 ? 1 : D / 16][4];
  if constexpr (!L::kF32) {
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

  const int nkb = causal ? qt + 1 : nqb;  // tiles wholly above skipped
  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * kBK;
    const T* ks = kbuf[j & 1];
    const T* vs = vbuf[j & 1];
    if (j + 1 < nkb) {                    // the next tile's copies overlap
      stage<T, D>(kbuf[(j + 1) & 1], kp, sk.s, k0 + kBK, S);
      stage<T, D>(vbuf[(j + 1) & 1], vp, sv.s, k0 + kBK, S);
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
      for (int np = 0; np < kNT / 2; ++np) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
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
#pragma unroll 2
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
    // Only the diagonal tile and a ragged last tile hold masked entries.
    const bool edge = (causal && j == qt) || k0 + kBK > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= S || (causal && key > row[e >> 1])) s[n][e] = kMasked;
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
#pragma unroll 4
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, S, H, KV;
  Strides sq, sk, sv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run(const Args& a) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = Layout<T, D>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return err;
    }
  }
  const long long nqb = (a.S + kBQ - 1) / kBQ;
  const long long blocks = nqb * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.B, a.S, a.H, a.KV,
      a.sq, a.sk, a.sv, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pick_d(const Args& a, int d) {
  switch (d) {
    case 16: return run<T, 16>(a);
    case 32: return run<T, 32>(a);
    case 64: return run<T, 64>(a);
    case 128: return run<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype code of q / k / v / out: 0 = float32, 1 = bfloat16.  D must be 16,
// 32, 64 or 128 and H a multiple of KV.  Strides are in elements, for the B,
// S and head axes of q, k and v in that order (the D axis is contiguous,
// each row 16-byte aligned).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int D,
                                      const long long* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, S, H, KV,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               scale, causal, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      dtype ? pick_d<__nv_bfloat16>(a, D) : pick_d<float>(a, D);
  return static_cast<int>(err);
}
