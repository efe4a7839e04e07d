// R&A segment aggregation (paper eq. 6) and the fused substitution
// baseline, for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by repro_torch/kernels/ra_aggregate.py.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ra_aggregate.py (`_ra_call`, whose pallas_call runs the
// bodies `_ra_kernel`, `_ra_kernel_sub`, `_ra_kernel_tx`, `_ra_kernel_sub_tx`).
// For every batch entry b, receiver n and segment l:
//   ra_normalized: out[n,l] = sum_m p_m e'[m,n,l] w[m,l] / max(sum_m p_m e'[m,n,l], 1e-12)
//   substitution:  out[n,l] = sum_m p_m e'[m,n,l] w[m,l] + (sum_m p_m - sum_m p_m e'[m,n,l]) w[n,l]
// with e' = e, or with a transmit mask tx: e'[m,n,l] = 1 if m == n else e[m,n,l] * tx[m,l].
// Both are one product per segment, out[:,l] = C_l^T w[:,l] with an N x N
// coefficient matrix C_l: p_m e'[m,n,l] scaled by the receiver's
// 1 / normaliser, or with the missing mass added on the diagonal.
//
// What bounds it on this card: memory.  The product does 2 N flops per
// value read and written, far below the H100's ridge point.  At the slice
// shape (B=1, N=10, L=412, K=1024, float32) it must read w once (16.9 MB)
// and write the output once (16.9 MB): 33.8 MB, 10.1 us at 3.35 TB/s,
// against 84 MFLOP (1.3 us at 67 TFLOP/s float32).  The 12-scenario grid
// of examples/sweep_grid.py at that width moves 405 MB (121 us), more
// than the 50 MB L2.
//
// Design.  The unit of work is a tile: one (b, l) segment and 32 columns
// of 16 bytes along K (128 float32 or 256 bfloat16 values), one column a
// lane, so that every load and store of w and of the output is 16 bytes a
// thread.  The grid holds every tile (3,296 at the slice in float32, 1,648
// in bfloat16; 39,552 / 19,776 for the grid), and the block scheduler
// hands out the next one as a block ends.  A tile's coefficients
// C_l[m, n] = p_m e'[m,n,l] come from N x N single-byte gathers strided by
// L (one L1 wavefront each); they are issued first, each thread's all at
// once (the mask's element type is tested outside the loads), so that they
// are not queued behind the tile's bytes, which are issued next.  The sum
// over senders of each receiver's column (the normaliser, or the missing
// mass) is taken while w is in flight, and its scale is applied once to
// the accumulator, as the reference divides once.  Two bodies:
//   * register body, N <= 16 (the paper's 10 clients): one warp a tile, N
//     a template parameter.  A lane's N 16-byte loads stay in registers
//     (160 B for the slice; 20-28 warps an SM keep over 100 KB in flight);
//     lane m gathers sender m's masks and writes column m of C to shared
//     memory, lane n sums row n; then, receiver by receiver (a rolled
//     loop: the unrolled body did not fit the instruction cache), N FMAs a
//     value from a broadcast row of C, and a 16-byte store.
//   * shared-memory body, N > 16: one block of G <= 8 warps of R receivers
//     (R = ceil(N / 8) clamped to 3..8, a template parameter) per column-
//     tile, and two column-tiles of one segment a block where registers
//     allow (SmemShape), sharing C: that halves the gathers, the largest
//     cost at n33.  Each warp gathers and sums the columns of C of its own
//     receivers (lanes over senders, no block barrier); the tile's N x 32
//     columns come into shared memory by 16-byte cp.async meanwhile; then
//     each thread reads a sender's column once (LDS.128) for its R
//     receivers.  N > 8 R takes ceil(N / (8 R)) passes over the tile; when
//     the tile and C do not both fit (N > ~200), the senders come in slabs,
//     re-read for each pass.
// Tensor cores are not used: at n33 (N = 33, L = 64, K = 1024) the float32
// FMAs take 71 M, about 2.4 us of issue on 132 SMs, under the 5.2 us the
// bytes need, and float32 accuracy (1e-5) would take three-part splits
// and six products a value.  A coefficient pre-pass kernel (C once per
// segment, read along l) was tried and lost: its launch alone cost ~5 us
// at the slice.  PERF.md (section 6) has the times, the versions tried and
// where the time goes (k1_ablate.py).
// Vectors need w and out 16-byte aligned and K a multiple of 4 (float32)
// or 8 (bfloat16); otherwise the same bodies load and store element by
// element (a ragged K, or w at a storage offset).  Accumulation is
// float32; the output takes w's dtype (float32, or bfloat16 rounded to
// nearest even).  No TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // 16-byte columns per tile, one a lane
constexpr int kRegMaxN = 16;     // the register body takes N <= 16
constexpr int kRegWarps = 4;     // warps (tiles) per block, register body
constexpr int kSmemMaxWarps = 8; // warps (receiver groups) a column-tile, smem body
constexpr long long kMaxTiles = 0x7fffffff;

template <typename WT> struct Vec;
template <> struct Vec<float> { static constexpr int V = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int V = 8; };

struct Params {
  const void* w;      // (B, N, L, K) contiguous
  const float* p;     // (B, N), batch stride p_bs (0 = shared)
  const void* e;      // (B, N, N, L), batch stride e_bs (0 = shared)
  const void* tx;     // (B, N, L), batch stride tx_bs, or null
  void* out;          // (B, N, L, K) contiguous
  long long p_bs, e_bs, tx_bs;
  int chunks;         // tiles per segment: ceil(K / V / 32)
  int tiles;          // B * L * chunks (the host refuses more than 2^31 - 1)
  int B, N, L, K;
  int mode;           // 0 ra_normalized, 1 substitution
  int e_f32, tx_f32;  // mask element types: 0 one byte, 1 float32
  int vec_in, vec_out;  // 16-byte loads / stores allowed
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mask values base[i0 + k * stride] for k < COUNT (zero unless live and
// k < count), with the element type tested once, outside the loads.
template <int COUNT>
__device__ __forceinline__ void load_masks_strided(float (&v)[COUNT], const void* base,
                                                   long long i0, int stride, int count,
                                                   bool live, int f32) {
  if (f32) {
    const float* src = static_cast<const float*>(base) + i0;
#pragma unroll
    for (int k = 0; k < COUNT; ++k)
      v[k] = live && k < count ? __ldg(src + static_cast<long long>(k) * stride) : 0.0f;
  } else {
    const uint8_t* src = static_cast<const uint8_t*>(base) + i0;
    uint32_t raw[COUNT];
#pragma unroll
    for (int k = 0; k < COUNT; ++k)
      raw[k] = live && k < count ? __ldg(src + static_cast<long long>(k) * stride) : 0u;
#pragma unroll
    for (int k = 0; k < COUNT; ++k) v[k] = static_cast<float>(raw[k]);
  }
}

// A streamed 16-byte load of w (read once: not kept in L1).  The memory
// clobber keeps it after the mask gathers issued before it, so that those
// few loads are not queued behind the tile's bytes.
__device__ __forceinline__ uint4 ld_stream(const void* src) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(src) : "memory");
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The 16-byte column of a segment row that starts at element k0, zero
// past K: one vector load, or element by element when vectors are off.
template <typename WT>
__device__ __forceinline__ uint4 load_col(const WT* row, long long k0, int K, int vec) {
  constexpr int V = Vec<WT>::V;
  if (vec) return k0 < K ? ld_stream(row + k0) : make_uint4(0, 0, 0, 0);
  uint32_t x[4] = {0, 0, 0, 0};
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(row);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (k0 + j < K) {
      if constexpr (V == 4) {
        x[j] = __ldg(reinterpret_cast<const unsigned int*>(bytes) + k0 + j);
      } else {
        const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(bytes) + k0 + j);
        x[j / 2] |= h << (16 * (j % 2));
      }
    }
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

template <typename WT>
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[Vec<WT>::V]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
  if constexpr (Vec<WT>::V == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __uint_as_float(u[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(u[j] << 16);
      x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Store a column's values (past K nothing); bfloat16 rounds to nearest even.
template <typename WT>
__device__ __forceinline__ void store_col(WT* row, long long k0, int K, int vec,
                                          const float (&x)[Vec<WT>::V]) {
  constexpr int V = Vec<WT>::V;
  if (k0 >= K) return;
  if (vec) {
    uint4 r;
    if constexpr (V == 4) {
      r = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                     __float_as_uint(x[2]), __float_as_uint(x[3]));
    } else {
      r = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    }
    asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "l"(row + k0), "r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w) : "memory");
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (k0 + j < K) {
      if constexpr (V == 4) row[k0 + j] = x[j];
      else row[k0 + j] = __float2bfloat16(x[j]);
    }
  }
}

// Where tile t lies: its batch entry, segment and this lane's first element.
struct Tile {
  int b, l;
  long long k0;
};

__device__ __forceinline__ Tile tile_at(const Params& a, int t, int lane, int V) {
  const unsigned bl = static_cast<unsigned>(t) / a.chunks;
  Tile tt;
  tt.b = static_cast<int>(bl / a.L);
  tt.l = static_cast<int>(bl % a.L);
  tt.k0 = (static_cast<long long>(t - bl * a.chunks) * kLanes + lane) * V;
  return tt;
}

// ---------------------------------------------------------------------------
// Register body: N <= 16, one warp per tile.
// ---------------------------------------------------------------------------

// Lane m gathers its sender's masks for the tile's segment: e[b, m, n, l]
// for every receiver n, tx[b, m, l] and p_m (zeros for lanes m >= N).
template <int N>
struct SenderMasks {
  float e[N];
  float tx, p;
};

template <int N>
__device__ __forceinline__ SenderMasks<N> gather_reg(const Params& a, int b, int l, int lane) {
  SenderMasks<N> g;
  const bool live = lane < N;
  g.p = live ? __ldg(a.p + b * a.p_bs + lane) : 0.0f;
  load_masks_strided(g.e, a.e, b * a.e_bs + static_cast<long long>(lane) * N * a.L + l,
                     a.L, N, live, a.e_f32);
  float t[1] = {1.0f};
  if (a.tx != nullptr)
    load_masks_strided(t, a.tx, b * a.tx_bs + static_cast<long long>(lane) * a.L + l, 0,
                       1, live, a.tx_f32);
  g.tx = t[0];
  return g;
}

// C receiver-major (coef[n * NP + m] = p_m e'[m,n,l], lane m writing its
// column), then lane n sums its row: scale[n] = 1 / max(sum, 1e-12), or
// (substitution) scale[n] = 1 and the missing mass on the diagonal.
template <int N>
__device__ __forceinline__ void build_coef_reg(const Params& a, const SenderMasks<N>& g,
                                               int lane, float* coef, float* scale) {
  constexpr int NP = (N + 3) & ~3;
  const float ps = a.mode ? warp_sum(g.p) : 0.0f;
  if (lane < NP) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float em = a.tx == nullptr ? g.e[n] : (lane == n ? 1.0f : g.e[n] * g.tx);
      coef[n * NP + lane] = g.p * em;
    }
  }
  __syncwarp();
  if (lane < N) {
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < N; ++m) s += coef[lane * NP + m];
    if (a.mode == 0) {
      scale[lane] = 1.0f / fmaxf(s, 1e-12f);
    } else {
      scale[lane] = 1.0f;
      coef[lane * NP + lane] += ps - s;  // lost mass falls back to the own segment
    }
  }
  __syncwarp();
}

template <typename WT, int N>
__global__ void __launch_bounds__(kRegWarps * kLanes)
ra_reg_kernel(const Params a) {
  constexpr int V = Vec<WT>::V;
  constexpr int NP = (N + 3) & ~3;
  __shared__ __align__(16) float coef_all[kRegWarps][N * NP + NP];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float* coef = coef_all[warp];
  float* scale = coef + N * NP;
  const WT* w = static_cast<const WT*>(a.w);
  WT* out = static_cast<WT*>(a.out);
  const long long seg = static_cast<long long>(a.L) * a.K;  // sender stride
  const int t = blockIdx.x * kRegWarps + warp;
  if (t >= a.tiles) return;
  const Tile tt = tile_at(a, t, lane, V);
  const long long row0 = (static_cast<long long>(tt.b) * N * a.L + tt.l) * a.K;
  const SenderMasks<N> g = gather_reg<N>(a, tt.b, tt.l, lane);
  uint4 raw[N];
#pragma unroll
  for (int m = 0; m < N; ++m) raw[m] = load_col(w + row0 + m * seg, tt.k0, a.K, a.vec_in);
  build_coef_reg<N>(a, g, lane, coef, scale);
  float x[N][V];
#pragma unroll
  for (int m = 0; m < N; ++m) unpack<WT>(raw[m], x[m]);
#pragma unroll 1
  for (int n = 0; n < N; ++n) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int m4 = 0; m4 < NP; m4 += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(coef + n * NP + m4);
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m4 + i < N) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(c[i], x[m4 + i][j], acc[j]);
        }
      }
    }
    const float sc = scale[n];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] *= sc;
    store_col(out + row0 + n * seg, tt.k0, a.K, a.vec_out, acc);
  }
}

// ---------------------------------------------------------------------------
// Shared-memory body: N > 16, one block of G warps per tile.
// ---------------------------------------------------------------------------

// Layout of C: coef[(m * GP + gg) * RP + r] for receiver n = gg * R + r
// (GP = ceil(N / R) groups, RP = R rounded up to 4), so that a warp reads
// its R coefficients of sender m as RP / 4 broadcast float4 loads; then
// one scale a receiver, then the slab: C column-tiles of S senders.
struct SmemPlan {
  int R, GP, G;  // receivers a warp, groups, warps a column-tile
  int C, S;      // column-tiles a block, senders a slab holds
  size_t coef_bytes, bytes;
};

// R and the groups for N; C and S are set by `smem_fit`.
inline SmemPlan smem_plan(int N) {
  SmemPlan s;
  const int r = (N + kSmemMaxWarps - 1) / kSmemMaxWarps;
  s.R = r < 3 ? 3 : (r > 8 ? 8 : r);
  s.GP = (N + s.R - 1) / s.R;
  s.G = s.GP < kSmemMaxWarps ? s.GP : kSmemMaxWarps;
  const int rp = (s.R + 3) & ~3;
  s.coef_bytes = (static_cast<size_t>(N) * s.GP * rp + ((N + 3) & ~3)) * sizeof(float);
  s.C = 1;
  s.S = 0;
  s.bytes = s.coef_bytes;
  return s;
}

// As many column-tiles as `max_warps` holds (no more than a segment has)
// when their whole slabs fit in `max_bytes` beside C; else one, its
// senders in slabs.
inline void smem_fit(SmemPlan& s, int N, int chunks, int max_warps, size_t max_bytes) {
  const size_t row = kLanes * 16;  // one sender's 32 columns
  const size_t room = max_bytes > s.coef_bytes ? max_bytes - s.coef_bytes : 0;
  const int max_cols = max_warps / s.G;
  s.C = max_cols < chunks ? max_cols : chunks;
  while (s.C > 1 && room / (s.C * row) < static_cast<size_t>(N)) --s.C;
  const size_t fit = room / (s.C * row);
  s.S = static_cast<int>(fit < static_cast<size_t>(N) ? fit : N);
  s.bytes = s.coef_bytes + static_cast<size_t>(s.C) * s.S * row;
}

// Each warp builds the columns of C of its own receiver groups (groups g,
// g + G, ...: no block barrier), lanes over senders m: R strided mask
// gathers a lane and 32 senders, the products p_m e'[m,n,l], and a shuffle
// sum per receiver: scale[n] = 1 / max(sum, 1e-12), or (substitution)
// scale[n] = 1 and the missing mass on the diagonal.  Padding receivers
// (n >= N) get zeros.  The first two chunks of 32 senders (all of them
// for N <= 64) are gathered before any is used, and `issue_w` (the tile's
// cp.async) is called right after, so that these few loads are not queued
// behind the tile's bytes.
template <int R>
struct SenderChunk {
  float e[R];
  float tx, p;
  int m;
};

template <int R>
__device__ __forceinline__ SenderChunk<R> gather_smem(const Params& a, long long eb,
                                                      long long tb, const float* pb, int n0,
                                                      int m) {
  SenderChunk<R> c;
  c.m = m;
  const bool live = m < a.N;
  load_masks_strided(c.e, a.e, eb + (static_cast<long long>(m) * a.N + n0) * a.L, a.L,
                     a.N - n0, live, a.e_f32);
  float t[1] = {1.0f};
  if (a.tx != nullptr)
    load_masks_strided(t, a.tx, tb + static_cast<long long>(m) * a.L, 0, 1, live, a.tx_f32);
  c.tx = t[0];
  c.p = live ? __ldg(pb + m) : 0.0f;
  return c;
}

template <int R, typename IssueW>
__device__ __forceinline__ void build_coef_smem(const Params& a, int b, int l, int GP,
                                                float* coef, float* scale, IssueW issue_w) {
  constexpr int RP = (R + 3) & ~3;
  const int N = a.N;
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int G = blockDim.x / kLanes;
  const float* pb = a.p + b * a.p_bs;
  const long long eb = b * a.e_bs + l, tb = b * a.tx_bs + l;
  bool issued = false;
  for (int gg = g; gg < GP; gg += G) {
    const int n0 = gg * R;
    float s[R], ps = 0.0f;  // ps: this lane's share of sum_m p_m
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    auto take = [&](const SenderChunk<R>& c) {
      ps += c.p;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float em = a.tx == nullptr ? c.e[r] : (c.m == n0 + r ? 1.0f : c.e[r] * c.tx);
        const float v = c.p * em;
        s[r] += v;
        if (c.m < N) coef[(static_cast<long long>(c.m) * GP + gg) * RP + r] = v;
      }
    };
    const SenderChunk<R> c0 = gather_smem<R>(a, eb, tb, pb, n0, lane);
    const SenderChunk<R> c1 = gather_smem<R>(a, eb, tb, pb, n0, kLanes + lane);
    if (!issued) {
      issue_w();
      issued = true;
    }
    take(c0);
    take(c1);
    for (int m0 = 2 * kLanes; m0 < N; m0 += kLanes) take(gather_smem<R>(a, eb, tb, pb, n0, m0 + lane));
    if (a.mode) ps = warp_sum(ps);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      const float sum = warp_sum(s[r]);
      if (n >= N) continue;
      if (a.mode == 0) {
        if (lane == 0) scale[n] = 1.0f / fmaxf(sum, 1e-12f);
      } else {
        if (lane == 0) scale[n] = 1.0f;
        if (lane == n % kLanes)  // the lane that wrote sender n's coefficient
          coef[(static_cast<long long>(n) * GP + gg) * RP + r] += ps - sum;
      }
    }
  }
  if (!issued) issue_w();
}

// Copy senders [m0, m0 + count) of the block's C column-tiles into the
// slab (slab[(ct * S + i) * 32 + lane]), 16 bytes a thread and sender:
// cp.async when vectors are on, else element by element.
template <typename WT>
__device__ __forceinline__ void load_slab(const Params& a, const WT* rows, long long seg,
                                          long long chunk0, int C, int S, int m0, int count,
                                          uint4* slab) {
  constexpr int V = Vec<WT>::V;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int warps = blockDim.x / kLanes;
  for (int q = warp; q < C * count; q += warps) {
    const int ct = q / count, i = q - ct * count;
    const long long k0 = ((chunk0 + ct) * kLanes + lane) * V;
    const WT* src = rows + (m0 + i) * seg;
    uint4* dst = slab + (ct * S + i) * kLanes + lane;
    if (a.vec_in) {
      const bool in = k0 < a.K;
      cp_async16(dst, in ? src + k0 : src, in ? 16 : 0);
    } else {
      *dst = load_col(src, k0, a.K, 0);
    }
  }
}

// Launch shape of the shared-memory body per instantiation: the warps a
// block may hold (C column-tiles of G warps share one C), the blocks an SM
// its registers are cut for, and the senders a thread has in flight.
// float32 with up to five receivers a warp (n33) takes 14 warps, two
// blocks an SM (73 registers; the 256 blocks then run in one round) and
// one sender at a time (more would spill); bf16 with more than five keeps
// one column-tile (its registers); the rest take two column-tiles, one
// block an SM.  k1_ablate.py times each choice.
template <typename WT, int R>
struct SmemShape {
  static constexpr bool kSmallF32 = sizeof(WT) == 4 && R <= 5;
  static constexpr int kWarps = kSmallF32 ? 14 : (sizeof(WT) == 2 && R > 5 ? 8 : 16);
  static constexpr int kMinBlocks = kSmallF32 ? 2 : 1;
  static constexpr int kUnroll = kSmallF32 ? 1 : (sizeof(WT) == 2 && R <= 5 ? 4 : 2);
};

template <typename WT, int R>
__global__ void __launch_bounds__(SmemShape<WT, R>::kWarps * kLanes,
                                  SmemShape<WT, R>::kMinBlocks)
ra_smem_kernel(const Params a, int GP, int S, int C) {
  constexpr int V = Vec<WT>::V;
  constexpr int RP = (R + 3) & ~3;
  constexpr int kUnroll = SmemShape<WT, R>::kUnroll;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N;
  float* coef = reinterpret_cast<float*>(smem);
  float* scale = coef + static_cast<size_t>(N) * GP * RP;
  uint4* slab = reinterpret_cast<uint4*>(scale + ((N + 3) & ~3));
  const int G = blockDim.x / kLanes / C;  // warps of one column-tile
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int ct = warp / G, g = warp - ct * G;
  const WT* w = static_cast<const WT*>(a.w);
  WT* out = static_cast<WT*>(a.out);
  const long long seg = static_cast<long long>(a.L) * a.K;
  const int groups = (a.chunks + C - 1) / C;  // blocks a segment
  const unsigned bl = blockIdx.x / groups;
  const int b = static_cast<int>(bl / a.L), l = static_cast<int>(bl % a.L);
  const long long chunk0 = static_cast<long long>(blockIdx.x - bl * groups) * C;
  const long long k0 = ((chunk0 + ct) * kLanes + lane) * V;
  const long long row0 = (static_cast<long long>(b) * N * a.L + l) * a.K;
  const WT* rows = w + row0;
  const bool one_slab = S >= N;
  build_coef_smem<R>(a, b, l, GP, coef, scale, [&] {
    if (one_slab) load_slab(a, rows, seg, chunk0, C, S, 0, N, slab);
  });
  if (one_slab) cp_async_wait_all();
  __syncthreads();
  const uint4* my_slab = slab + ct * S * kLanes + lane;
  for (int pass = 0; pass * G < GP; ++pass) {
    const int gg = pass * G + g;  // this warp's receiver group
    float acc[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = 0.0f;
    // Senders [i0, i1) of the slab, which holds senders from m0.
    auto accumulate = [&](int m0, int i0, int i1) {
      const float* cm = coef + (static_cast<long long>(m0 + i0) * GP + gg) * RP;
#pragma unroll kUnroll
      for (int i = i0; i < i1; ++i, cm += GP * RP) {
        float x[V];
        unpack<WT>(my_slab[i * kLanes], x);
        float c[RP];
#pragma unroll
        for (int q = 0; q < RP; q += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(cm + q);
          c[q] = c4.x; c[q + 1] = c4.y; c[q + 2] = c4.z; c[q + 3] = c4.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(c[r], x[j], acc[r][j]);
      }
    };
    if (one_slab) {
      if (gg < GP) accumulate(0, 0, N);
    } else {
      for (int m0 = 0; m0 < N; m0 += S) {
        const int count = N - m0 < S ? N - m0 : S;
        __syncthreads();
        load_slab(a, rows, seg, chunk0, C, S, m0, count, slab);
        cp_async_wait_all();
        __syncthreads();
        if (gg < GP) accumulate(m0, 0, count);
      }
    }
    if (gg < GP) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = gg * R + r;
        if (n < N) {
          const float sc = scale[n];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] *= sc;
          store_col(out + row0 + n * seg, k0, a.K, a.vec_out, acc[r]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

size_t max_smem_bytes() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(v);
}

// What a launch would run; `info` (8 entries): body (0 register, 1 shared
// memory), threads a block, dynamic shared memory bytes, blocks, tiles,
// resident blocks an SM, receivers a warp (R; N for the register body),
// sender slabs a pass.
template <typename WT, int N>
cudaError_t reg_run(const Params& a, cudaStream_t stream, long long* info) {
  auto kern = ra_reg_kernel<WT, N>;
  const unsigned blocks = (a.tiles + kRegWarps - 1) / kRegWarps;
  if (info) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kern), kRegWarps * kLanes, 0);
    const long long v[8] = {0, kRegWarps * kLanes, 0, blocks, a.tiles, per_sm, N, 1};
    for (int i = 0; i < 8; ++i) info[i] = v[i];
    return err;
  }
  kern<<<blocks, kRegWarps * kLanes, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename WT, int N>
cudaError_t reg_pick(const Params& a, cudaStream_t stream, long long* info) {
  if constexpr (N > kRegMaxN) {
    return cudaErrorInvalidValue;
  } else {
    return a.N == N ? reg_run<WT, N>(a, stream, info)
                    : reg_pick<WT, N + 1>(a, stream, info);
  }
}

template <typename WT, int R>
cudaError_t smem_run(const Params& a, SmemPlan s, cudaStream_t stream, long long* info) {
  auto kern = ra_smem_kernel<WT, R>;
  smem_fit(s, a.N, a.chunks, SmemShape<WT, R>::kWarps, max_smem_bytes());
  if (s.S < 1) return cudaErrorInvalidValue;  // C alone overflows shared memory
  if (s.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(s.bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return err;
    }
  }
  const int threads = s.C * s.G * kLanes;
  const unsigned blocks = static_cast<unsigned>(a.B) * a.L * ((a.chunks + s.C - 1) / s.C);
  if (info) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kern), threads, s.bytes);
    const long long slabs = (a.N + s.S - 1) / s.S;
    const long long v[8] = {1, threads, static_cast<long long>(s.bytes), blocks,
                            a.tiles, per_sm, R, slabs};
    for (int i = 0; i < 8; ++i) info[i] = v[i];
    return err;
  }
  kern<<<blocks, threads, s.bytes, stream>>>(a, s.GP, s.S, s.C);
  return cudaGetLastError();
}

template <typename WT, int R>
cudaError_t smem_pick(const Params& a, const SmemPlan& s, cudaStream_t stream,
                      long long* info) {
  if constexpr (R > 8) {
    return cudaErrorInvalidValue;
  } else {
    return s.R == R ? smem_run<WT, R>(a, s, stream, info)
                    : smem_pick<WT, R + 1>(a, s, stream, info);
  }
}

template <typename WT>
cudaError_t dispatch(const Params& a, cudaStream_t stream, long long* info) {
  if (a.tiles < 0) return cudaErrorInvalidValue;  // over 2^31 - 1 tiles
  if (a.N <= kRegMaxN) return reg_pick<WT, 1>(a, stream, info);
  const SmemPlan s = smem_plan(a.N);
  return smem_pick<WT, 3>(a, s, stream, info);
}

Params make_params(const void* w, const void* p, const void* e, const void* tx,
                   void* out, int B, int N, int L, int K, long long p_bs,
                   long long e_bs, long long tx_bs, int mode, int w_dtype,
                   int e_dtype, int tx_dtype) {
  const int V = w_dtype ? Vec<__nv_bfloat16>::V : Vec<float>::V;
  const long long cols = (static_cast<long long>(K) + V - 1) / V;
  Params a;
  a.w = w;
  a.p = static_cast<const float*>(p);
  a.e = e;
  a.tx = tx;
  a.out = out;
  a.p_bs = p_bs;
  a.e_bs = e_bs;
  a.tx_bs = tx_bs;
  const long long chunks = (cols + kLanes - 1) / kLanes;
  const long long tiles = static_cast<long long>(B) * L * chunks;
  a.chunks = static_cast<int>(chunks);
  a.tiles = tiles > kMaxTiles ? -1 : static_cast<int>(tiles);
  a.B = B;
  a.N = N;
  a.L = L;
  a.K = K;
  a.mode = mode;
  a.e_f32 = e_dtype;
  a.tx_f32 = tx_dtype;
  const bool k_whole = K % V == 0;
  a.vec_in = k_whole && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.vec_out = k_whole && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return a;
}

}  // namespace

// Dtype codes: w 0 = float32, 1 = bfloat16; e / tx 0 = one byte (bool or
// uint8), 1 = float32.  mode 0 = ra_normalized, 1 = substitution.  tx may be
// null (no transmit mask).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int ra_aggregate_launch(const void* w, const void* p, const void* e,
                                   const void* tx, void* out, int B, int N,
                                   int L, int K, long long p_bs, long long e_bs,
                                   long long tx_bs, int mode, int w_dtype,
                                   int e_dtype, int tx_dtype, void* stream) {
  const Params a = make_params(w, p, e, tx, out, B, N, L, K, p_bs, e_bs, tx_bs,
                               mode, w_dtype, e_dtype, tx_dtype);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = w_dtype ? dispatch<__nv_bfloat16>(a, s, nullptr)
                                  : dispatch<float>(a, s, nullptr);
  return static_cast<int>(err);
}

// The launch `ra_aggregate_launch` would make for these sizes, with w and
// out 16-byte aligned, into info[8] (see reg_run); returns a CUDA error code.
extern "C" int ra_aggregate_plan(int B, int N, int L, int K, int w_dtype,
                                 long long* info) {
  const Params a = make_params(nullptr, nullptr, nullptr, nullptr, nullptr, B, N,
                               L, K, 0, 0, 0, 0, w_dtype, 0, 0);
  const cudaError_t err = w_dtype ? dispatch<__nv_bfloat16>(a, nullptr, info)
                                  : dispatch<float>(a, nullptr, info);
  return static_cast<int>(err);
}
