// rwkv6 "Finch" time-mix scan for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by repro_torch/kernels/rwkv6_scan.py.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/rwkv6_scan.py (`rwkv6_scan`, whose pallas_call at :100
// runs the body `_rwkv6_kernel`, :29).  Per batch b and head h, over tokens
// t, with the state S in R^{DxD} (key index d, value index e) starting at
// zero:
//   out_t[e] = sum_d r_t[d] (S_{t-1}[d,e] + exp(u[d]) k_t[d] v_t[e])
//   S_t[d,e] = exp(w_t[d]) S_{t-1}[d,e] + k_t[d] v_t[e]
// and, on request, the final state S_{S-1} in float32.  r, k, v are float32
// or bfloat16 (one type for the three), w (log decay, any value <= 0) and u
// are float32; out takes r's type.  Inputs are read through their (B, S, H,
// D) strides (D contiguous), with no transposed or cast copy; out is
// (B, S, H, D) and the state (B, H, D, D), both contiguous.
//
// Two bodies; the wrapper names one per launch (`rwkv6_scan.body`: bf16 at
// D = 64 runs the chunked body, everything else the token body):
//
// * The chunked body (`chunked::`, bf16 r/k/v at D = 64: the rwkv6-1.6b
//   serving path).  What bounds it: bytes.  At the serving shape (B=8,
//   S=2048, H=32, D=64, with the final state) it reads 335 MB and writes
//   71 MB, 121.4 us at 3.35 TB/s; its products take about 42 GFLOP on the
//   bf16 tensor cores (below), about 42 us at 989 TFLOP/s.  The design keeps
//   the copies going and the arithmetic beside them:
//   - Steps of 16 tokens.  Per step, with P_t = prod_{m<t} e^{w_m} and
//     Q_j = prod_{j<m<16} e^{w_m} (both <= 1, running products as the
//     recurrence takes them):
//       out = (r P) S + A v,      S' = diag(P_16) S + (k Q)^T v,
//     where A (16 x 16) holds sum_d r_t k_j prod_{j<m<t} e^{w_m} below its
//     diagonal and the bonus sum_d r_t e^{u} k_t on it.  Between steps the
//     state carries everything, so the only in-step block is the diagonal
//     one: the two-level chunking of Gated Linear Attention with the
//     cross-sub-chunk products folded into the state, which costs fewer
//     products per token than a 64-token chunk with sub-chunks.
//   - The products on the tensor cores (`mma.sync.m16n8k16`, bf16 in,
//     float32 accumulators).  r, k and v are exact in bf16; r P, k Q, A and
//     the float32 state are not, so each is split into three bf16 parts
//     (high, middle, low: 24 bits, float32's precision) and the cross
//     products whose weight is at least 2^-16 of the leading one are summed
//     (six for (r P) S, three each for A v and (k Q)^T v): two parts, or
//     fewer products, leave errors near 1e-5 against the 2e-5 tolerance.
//     The state lives in the accumulators: S^T (value rows, key columns) is
//     the C layout of (k Q)^T v, and the same registers are the B fragments
//     of (r P) S.
//   - The diagonal block A in float32 on the CUDA cores, cut into 4 x 4
//     blocks of 4-token groups.  Below the block diagonal each decay is a
//     product of three factors, each <= 1 (after j inside j's group, the
//     groups between, before t inside t's group); inside a diagonal block
//     it is 1, e^{w_m} or a product of two (pairwise).  No factor is ever
//     divided by, so any w <= 0 is taken as it comes and there is no
//     data-dependent branch (the two-factor form e^{cum_{t-1}} e^{-cum_j}
//     of the Pallas body holds only above the -60/64 floor `ssm._rkvwg`
//     applies).
//   - An asynchronous copy ring.  One block per (b, h) walks its steps in
//     order; 128 producer threads (warps 2-5) keep the next four steps' r,
//     k, v and w in flight with `cp.async` (16-byte pieces through the
//     inputs' own strides, rows past S zero-filled, so the tail decays by
//     e^0 and adds nothing) in a 6-stage ring of 11 KB stages, and compute
//     e^w, the running products, the three-part splits and A for step
//     i + 1 into a double buffer while the 2 consumer warps (32 value
//     columns each) run step i's products.  Two mbarriers a buffer hand it
//     over; a wait that outlasts 10 s traps rather than hang.  113 KB of
//     shared memory and 6 warps of at most 168 registers admit two blocks
//     an SM: the 256 (b, h) of the serving shape in one wave.
//   What holds it back (PERF.md): the producers' per-element work (e^w,
//   running products, three-part splits and their stores, the diagonal
//   block) and the consumers' per-step split of the state share the SM's
//   issue slots and shared-memory pipe: each side alone with the copies
//   runs near the copies' own time, the two together do not overlap.
//   Tried and not faster: 8 producer warps (the block's registers then fall
//   to 80 a thread), TMA copies of 16-token boxes, three Prep buffers.
// * The token body (`token::`, float32, and bf16 at D = 16 / 32).  The
//   recurrence token by token, as the plain version runs it: per (token, d,
//   e) three float32 instructions (y += r s;  x = k v;  s = s exp(w) + x);
//   the bonus term a_t v_t[e], with a_t = sum_d r_t[d] exp(u[d]) k_t[d], is
//   one dot product per token, reduced by a warp.  What bounds it: float32
//   instructions on the CUDA cores (1.09e10 at the serving shape, 162.3 us
//   at 67 TFLOP/s).  One block per (b, h): 4 D threads; thread (g, e) owns
//   the state column e for the key rows d in group g (D/4 of them) in
//   registers.  Per tile of `tile` tokens (at most 64) the block stages r,
//   k, v and exp(w) in shared memory as float32, runs the tokens of the tile,
//   and then adds the four partials and the bonus term and writes out.  No
//   overlap of the next tile's loads with this tile's work.  At the serving
//   shape it took 710-714 us on an H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

// Element strides of a (B, S, H, D) tensor whose D axis is contiguous.
struct Strides {
  long long b, s, h;
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;      // (H, D) contiguous
  void* out;           // (B, S, H, D) contiguous
  float* state;        // (B, H, D, D) contiguous, or null
  int B, S, H, tile;
  Strides sr, sk, sv, sw;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// The token body: the recurrence token by token on the CUDA cores.
// ---------------------------------------------------------------------------
namespace token {

constexpr int kGroups = 4;    // key-row groups per head: threads = 4 D
constexpr int kMaxTile = 64;  // tokens staged in shared memory per step

size_t smem_bytes(int d, int tile) {
  return (static_cast<size_t>(4 + kGroups) * tile * d + tile) * sizeof(float);
}

template <typename T, int D, bool WRITE_STATE>
__global__ void __launch_bounds__(kGroups * D)
rwkv6_scan_token_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ out,
                  float* __restrict__ state, int S, int H, int tile,
                  Strides sr, Strides sk, Strides sv, Strides sw) {
  constexpr int kThreads = kGroups * D;
  constexpr int kRows = D / kGroups;    // key rows per thread
  constexpr int kWarps = kThreads / 32;
  static_assert(kRows % 4 == 0, "rows are read as float4");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* rs = smem;                      // [tile][D] r
  float* ks = rs + tile * D;             // [tile][D] k
  float* vs = ks + tile * D;             // [tile][D] v
  float* ws = vs + tile * D;             // [tile][D] exp(w)
  float* ys = ws + tile * D;             // [kGroups][tile][D] partial outputs
  float* as = ys + kGroups * tile * D;   // [tile] bonus dot products

  const int tid = threadIdx.x;
  const int e = tid % D;
  const int g = tid / D;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;

  float s[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) s[j] = 0.0f;

  // exp(u) for the lanes' key rows of the bonus dot product.
  constexpr int kLaneRows = (D + 31) / 32;
  float eu[kLaneRows];
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
    const int d = lane + 32 * i;
    eu[i] = d < D ? expf(u[h * D + d]) : 0.0f;
  }

  const long long r0 = b * sr.b + h * sr.h, k0 = b * sk.b + h * sk.h;
  const long long v0 = b * sv.b + h * sv.h, w0 = b * sw.b + h * sw.h;
  const long long o0 = (static_cast<long long>(b) * S * H + h) * D;
  const long long os = static_cast<long long>(H) * D;  // out's token stride

  for (int t0 = 0; t0 < S; t0 += tile) {
    const int n = min(tile, S - t0);
    for (int i = tid; i < n * D; i += kThreads) {
      const long long t = t0 + i / D;
      const int d = i % D;
      rs[i] = to_f32(r[r0 + t * sr.s + d]);
      ks[i] = to_f32(k[k0 + t * sk.s + d]);
      vs[i] = to_f32(v[v0 + t * sv.s + d]);
      ws[i] = expf(w[w0 + t * sw.s + d]);
    }
    __syncthreads();

    // Bonus dot products a_t, one warp per token.
    for (int t = warp; t < n; t += kWarps) {
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) {
        const int d = lane + 32 * i;
        if (d < D) a = fmaf(rs[t * D + d] * eu[i], ks[t * D + d], a);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) as[t] = a;
    }

    // The recurrence over the tile's tokens: this thread's rows of column e.
    for (int t = 0; t < n; ++t) {
      const float ve = vs[t * D + e];
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * D + g * kRows);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * D + g * kRows);
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * D + g * kRows);
      float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < kRows / 4; ++j4) {
        const float4 rr = r4[j4], kk = k4[j4], ww = w4[j4];
        float* sj = s + 4 * j4;
        y0 = fmaf(rr.x, sj[0], y0);
        y1 = fmaf(rr.y, sj[1], y1);
        y0 = fmaf(rr.z, sj[2], y0);
        y1 = fmaf(rr.w, sj[3], y1);
        sj[0] = fmaf(sj[0], ww.x, kk.x * ve);
        sj[1] = fmaf(sj[1], ww.y, kk.y * ve);
        sj[2] = fmaf(sj[2], ww.z, kk.z * ve);
        sj[3] = fmaf(sj[3], ww.w, kk.w * ve);
      }
      ys[(g * tile + t) * D + e] = y0 + y1;
    }
    __syncthreads();

    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D;
      const int ee = i % D;
      float y = as[t] * vs[i];
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) y += ys[(gg * tile + t) * D + ee];
      store(out + o0 + (t0 + t) * os + ee, y);
    }
    // The next tile's staging overwrites rs..ws and as only after every
    // thread has passed the barrier above and finished its token loop; the
    // reads of ys, vs and as just above end before the next barrier.
    __syncthreads();
  }

  if constexpr (WRITE_STATE) {
    float* st = state + (static_cast<long long>(b) * H + h) * D * D;
#pragma unroll
    for (int j = 0; j < kRows; ++j) st[(g * kRows + j) * D + e] = s[j];
  }
}

template <typename T, int D, bool WRITE_STATE>
cudaError_t run(const Args& a) {
  auto kern = rwkv6_scan_token_kernel<T, D, WRITE_STATE>;
  const size_t smem = smem_bytes(D, a.tile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return err;
    }
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(a.B) * a.H);
  kern<<<blocks, kGroups * D, smem, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.w, a.u, static_cast<T*>(a.out), a.state,
      a.S, a.H, a.tile, a.sr, a.sk, a.sv, a.sw);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t pick_state(const Args& a) {
  return a.state ? run<T, D, true>(a) : run<T, D, false>(a);
}

template <typename T>
cudaError_t pick_d(const Args& a, int d) {
  switch (d) {
    case 16: return pick_state<T, 16>(a);
    case 32: return pick_state<T, 32>(a);
    case 64: return pick_state<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace token

// ---------------------------------------------------------------------------
// The chunked body: steps of 16 tokens on the tensor cores, fed by a
// cp.async ring (bf16 r/k/v, D = 64).
// ---------------------------------------------------------------------------
namespace chunked {

constexpr int kD = 64;               // head dim
constexpr int kSub = 16;             // tokens a step: one m16 tile
constexpr int kStages = 6;           // ring stages of one step each
constexpr int kAhead = kStages - 2;  // steps in flight ahead of the producers
constexpr int kConsumers = 64;       // warps 0-1: the products
constexpr int kProducers = 128;      // warps 2-5: copies, decays, splits
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRow = kD + 8;         // bf16 rows of 144 bytes: ldmatrix conflict-free
constexpr int kFRow = kD + 4;        // float rows of 272 bytes
constexpr int kARow = kSub + 8;      // bf16 rows of 48 bytes
constexpr int kProducerBar = 1;      // named barrier of the producers
constexpr unsigned long long kWaitLimitNs = 10000000000ull;  // 10 s

struct Stage {                       // one step of the inputs, as copied
  __nv_bfloat16 r[kSub][kRow], k[kSub][kRow], v[kSub][kRow];
  float w[kSub][kD];
};

struct Prep {                        // one step's operands, producers -> consumers
  __nv_bfloat16 rp[3][kSub][kRow];   // r P: high, middle and low bf16 parts
  __nv_bfloat16 kp[3][kSub][kRow];   // k Q
  __nv_bfloat16 ap[3][kSub][kARow];  // the diagonal block A
  float p16[kD];                     // P_16: the state's decay over the step
};

struct Scratch {                     // the producers' own
  float rl[kSub][kFRow];             // r L: r scaled inside its 4-token group
  float ku[kSub][kFRow];             // k U
  float ew[kSub][kFRow];             // e^w
  float mid[4][kD];                  // M: 1, group 1's decay, group 2's, both
  float eu[kD];                      // e^u
};

struct Smem {
  Stage ring[kStages];
  Prep prep[2];
  Scratch x;
  unsigned long long full[2];        // producers -> consumers, per Prep buffer
  unsigned long long empty[2];       // consumers -> producers
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
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

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kProducerBar), "n"(kProducers) : "memory");
}

// 16 bytes from global to shared memory without passing through registers;
// with `full` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 address the
// rows of matrix i), as mma fragments; `_trans` delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c[0..3] += a * b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 into one register, x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}
__device__ __forceinline__ float low_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float high_f32(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// x = h + m + l to float32's 24 bits: h = bf16(x), m = bf16(x - h),
// l = bf16(x - h - m); both differences are exact in float32.
struct Split {
  uint32_t h, m, l;   // bf16 pairs, lower index in the low half
};

__device__ __forceinline__ Split split3(float x0, float x1) {
  const uint32_t h = pack_bf16(x0, x1);
  const float y0 = x0 - low_f32(h), y1 = x1 - high_f32(h);
  const uint32_t m = pack_bf16(y0, y1);
  return {h, m, pack_bf16(y0 - low_f32(m), y1 - high_f32(m))};
}

// Four bf16 at p (8-byte aligned) and four at q, as float32.
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p,
                                      const __nv_bfloat16* q) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(q);
  const uint32_t w[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = low_f32(w[i]);
    x[2 * i + 1] = high_f32(w[i]);
  }
}

__device__ __forceinline__ void load8(float (&x)[8], const float* p, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(q);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The 128 producers.  Per step i: wait for its copy, e^w, the running
// products and splits into prep[i % 2] (once the consumers have released
// it), the diagonal block, hand the buffer over, and start the copy of step
// i + kAhead into the ring stage step i - 2 used.
//
// The diagonal block A[t][j] = sum_d r_t k_j f(j, t), f(j, t) =
// prod_{j<m<t} e^{w_m}, is cut into 4 x 4 blocks of 4-token groups.  Below
// the block diagonal f is a product of three factors, each <= 1:
//   f(j, t) = U_j M(jg, tg) L_t,  U_j = prod_{j<m<=end of j's group},
//   M = prod over the groups strictly between, L_t = prod_{start of t's
//   group <= m < t},
// so A's block is sum_d (r L)_t M (k U)_j.  Inside a diagonal block f is one
// or a product of two e^w.  No factor is ever divided by, so any w <= 0 is
// taken as it comes.  Warp 0 (of the producers) runs the 4 diagonal blocks,
// 8 keys a lane; warps 1-3 the 6 blocks below them, 4 keys a lane.
__device__ __forceinline__ void produce(
    Smem& sm, const __nv_bfloat16* __restrict__ r,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, int b, int h,
    int S, int n, Strides sr, Strides sk, Strides sv, Strides sw) {
  const int p = threadIdx.x - kConsumers;
  // Copies: producer p moves the 16-byte piece p % 8 of token p / 8's rows
  // of r, k, v, and pieces p % 8 and p % 8 + 8 of its row of w.
  const int ct = p >> 3, cc = p & 7;
  const __nv_bfloat16* rs = r + b * sr.b + h * sr.h + ct * sr.s + 8 * cc;
  const __nv_bfloat16* ks = k + b * sk.b + h * sk.h + ct * sk.s + 8 * cc;
  const __nv_bfloat16* vs = v + b * sv.b + h * sv.h + ct * sv.s + 8 * cc;
  const float* ws = w + b * sw.b + h * sw.h + ct * sw.s + 4 * cc;
  int t_next = ct;                // this thread's token in the next copy
  int s_next = 0;                 // and its ring stage
  auto issue = [&]() {            // the next step's copy; steps in order
    const bool in = t_next < S;
    Stage& st = sm.ring[s_next];
    cp_async16(&st.r[ct][8 * cc], in ? rs : r, in);
    cp_async16(&st.k[ct][8 * cc], in ? ks : k, in);
    cp_async16(&st.v[ct][8 * cc], in ? vs : v, in);
    cp_async16(&st.w[ct][4 * cc], in ? ws : w, in);
    cp_async16(&st.w[ct][kD / 2 + 4 * cc], in ? ws + kD / 2 : w, in);
    cp_async_commit();   // one group a step, empty or not
    t_next += kSub;
    s_next = s_next == kStages - 1 ? 0 : s_next + 1;
    rs += kSub * sr.s;
    ks += kSub * sk.s;
    vs += kSub * sv.s;
    ws += kSub * sw.s;
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue();
  if (p < kD) sm.x.eu[p] = expf(u[h * kD + p]);

  const int d = p & (kD - 1), role = p >> 6;   // e^w: key d, tokens 8 role..
  const int pw = p >> 5, lane = p & 31;

  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    const Stage& st = sm.ring[i % kStages];
    Prep& pp = sm.prep[buf];
    cp_async_wait<kAhead - 1>();
    producers_sync();              // step i has landed; the scratch is free
    // Every loop below reads all it needs before it stores: the compiler
    // cannot tell the shared arrays apart, and would otherwise wait out
    // each load's latency after the previous store.
    {
      float e[kSub / 2];
#pragma unroll
      for (int q = 0; q < kSub / 2; ++q) e[q] = st.w[kSub / 2 * role + q][d];
#pragma unroll
      for (int q = 0; q < kSub / 2; ++q) e[q] = expf(e[q]);
#pragma unroll
      for (int q = 0; q < kSub / 2; ++q) sm.x.ew[kSub / 2 * role + q][d] = e[q];
    }
    if (i >= 2) mbar_wait(smem_addr(&sm.empty[buf]), ((i >> 1) - 1) & 1);
    producers_sync();              // e^w is complete

    {
      // Keys dk, dk + 1 of tokens t0..t0+7: a role's 16 x 64 values over
      // 64 threads.  Each thread takes the other half's decay product for
      // the factors that reach across the halves.
      const int dk = 2 * (p & 31), side = (p >> 5) & 1, half = p >> 6;
      const int t0 = kSub / 2 * half, o0 = kSub / 2 - t0;
      const __nv_bfloat16 (*src)[kRow] = side == 0 ? st.r : st.k;
      float x[8][2], e[8][2], y[8][2], across[2] = {1.0f, 1.0f};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t pair = *reinterpret_cast<const uint32_t*>(&src[t0 + q][dk]);
        x[q][0] = low_f32(pair);
        x[q][1] = high_f32(pair);
        const float2 eq = *reinterpret_cast<const float2*>(&sm.x.ew[t0 + q][dk]);
        e[q][0] = eq.x;
        e[q][1] = eq.y;
      }
      float g1[2] = {1.0f, 1.0f};   // group 1's decay (tokens 4-7)
      if (half != side) {           // r P from token 8, or k Q before 8
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float2 oq = *reinterpret_cast<const float2*>(&sm.x.ew[o0 + q][dk]);
          across[0] *= oq.x;
          across[1] *= oq.y;
          if (q >= 4) {
            g1[0] *= oq.x;
            g1[1] *= oq.y;
          }
        }
      }
      float z[8][2];
      if (side == 0) {
        // P_t = prod_{m<t} e^{w_m}; L_t inside t's 4-token group.
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float P = across[c], L = 1.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q % 4 == 0) L = 1.0f;
            y[q][c] = x[q][c] * L;
            z[q][c] = x[q][c] * P;
            L *= e[q][c];
            P *= e[q][c];
          }
          across[c] = P;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          *reinterpret_cast<float2*>(&sm.x.rl[t0 + q][dk]) = make_float2(y[q][0], y[q][1]);
          const Split sp = split3(z[q][0], z[q][1]);
          *reinterpret_cast<uint32_t*>(&pp.rp[0][t0 + q][dk]) = sp.h;
          *reinterpret_cast<uint32_t*>(&pp.rp[1][t0 + q][dk]) = sp.m;
          *reinterpret_cast<uint32_t*>(&pp.rp[2][t0 + q][dk]) = sp.l;
        }
        if (half == 1) {            // M, and P_16 for the consumers
          float2 m1, m2;
          m1.x = g1[0];
          m1.y = g1[1];
          m2.x = e[0][0] * e[1][0] * e[2][0] * e[3][0];
          m2.y = e[0][1] * e[1][1] * e[2][1] * e[3][1];
          *reinterpret_cast<float2*>(&sm.x.mid[0][dk]) = make_float2(1.0f, 1.0f);
          *reinterpret_cast<float2*>(&sm.x.mid[1][dk]) = m1;
          *reinterpret_cast<float2*>(&sm.x.mid[2][dk]) = m2;
          *reinterpret_cast<float2*>(&sm.x.mid[3][dk]) = make_float2(m1.x * m2.x, m1.y * m2.y);
          *reinterpret_cast<float2*>(&pp.p16[dk]) = make_float2(across[0], across[1]);
        }
      } else {
        // Q_j = prod_{j<m<16} e^{w_m}; U_j inside j's 4-token group.
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float Q = across[c], U = 1.0f;
#pragma unroll
          for (int q = 7; q >= 0; --q) {
            if (q % 4 == 3) U = 1.0f;
            y[q][c] = x[q][c] * U;
            z[q][c] = x[q][c] * Q;
            U *= e[q][c];
            Q *= e[q][c];
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          *reinterpret_cast<float2*>(&sm.x.ku[t0 + q][dk]) = make_float2(y[q][0], y[q][1]);
          const Split sp = split3(z[q][0], z[q][1]);
          *reinterpret_cast<uint32_t*>(&pp.kp[0][t0 + q][dk]) = sp.h;
          *reinterpret_cast<uint32_t*>(&pp.kp[1][t0 + q][dk]) = sp.m;
          *reinterpret_cast<uint32_t*>(&pp.kp[2][t0 + q][dk]) = sp.l;
        }
      }
    }
    producers_sync();              // r L, k U, M are complete

    if (pw == 0) {
      // Diagonal block g = lane / 8, keys 4dg.. and 32 + 4dg..: rows 4g + a,
      // columns 4g + c, c <= a (the bonus on c == a).
      const int g = lane >> 3, dg = lane & 7;
      const int da = 4 * dg, db = kD / 2 + 4 * dg;
      float part[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[a][c] = 0.0f;
      float rr[4][8], kk[4][8], e1[8], e2[8], eu[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load8(rr[a], &st.r[4 * g + a][da], &st.r[4 * g + a][db]);
        load8(kk[a], &st.k[4 * g + a][da], &st.k[4 * g + a][db]);
      }
      load8(e1, &sm.x.ew[4 * g + 1][da], &sm.x.ew[4 * g + 1][db]);
      load8(e2, &sm.x.ew[4 * g + 2][da], &sm.x.ew[4 * g + 2][db]);
      load8(eu, &sm.x.eu[da], &sm.x.eu[db]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float k0 = kk[0][q] * e1[q];     // k_0 f(0, 2)
        const float k1 = kk[1][q] * e2[q];     // k_1 f(1, 3)
        part[1][0] = fmaf(rr[1][q], kk[0][q], part[1][0]);
        part[2][1] = fmaf(rr[2][q], kk[1][q], part[2][1]);
        part[3][2] = fmaf(rr[3][q], kk[2][q], part[3][2]);
        part[2][0] = fmaf(rr[2][q], k0, part[2][0]);
        part[3][1] = fmaf(rr[3][q], k1, part[3][1]);
        part[3][0] = fmaf(rr[3][q], k0 * e2[q], part[3][0]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          part[a][a] = fmaf(rr[a][q] * eu[q], kk[a][q], part[a][a]);
      }
      // Sum over the block's 8 lanes, halving what a lane keeps at each
      // step: lane dg ends with entry 2 dg and 2 dg + 1 (row-major).
      float s8[8], s4[4], s2[2];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const bool up = dg & 4;
        const float give = up ? part[m / 4][m % 4] : part[2 + m / 4][m % 4];
        s8[m] = (up ? part[2 + m / 4][m % 4] : part[m / 4][m % 4]) +
                __shfl_xor_sync(0xffffffffu, give, 4);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const bool up = dg & 2;
        const float give = up ? s8[m] : s8[m + 4];
        s4[m] = (up ? s8[m + 4] : s8[m]) + __shfl_xor_sync(0xffffffffu, give, 2);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const bool up = dg & 1;
        const float give = up ? s4[m] : s4[m + 2];
        s2[m] = (up ? s4[m + 2] : s4[m]) + __shfl_xor_sync(0xffffffffu, give, 1);
      }
      const Split a = split3(s2[0], s2[1]);
      const int row = 4 * g + (dg >> 1), col = 4 * g + 2 * (dg & 1);
      *reinterpret_cast<uint32_t*>(&pp.ap[0][row][col]) = a.h;
      *reinterpret_cast<uint32_t*>(&pp.ap[1][row][col]) = a.m;
      *reinterpret_cast<uint32_t*>(&pp.ap[2][row][col]) = a.l;
    } else {
      // Block (tg, jg) below the diagonal, keys 4dg..4dg+3: warp 1 runs
      // (1, 0) and (2, 0), warp 2 (3, 0) and (2, 1), warp 3 (3, 1) and (3, 2).
      const int blk = 2 * (pw - 1) + (lane >> 4), dg = lane & 15;
      const int tg = blk < 2 ? blk + 1 : (blk == 2 || blk >= 4 ? 3 : 2);
      const int jg = blk < 3 ? 0 : (blk == 5 ? 2 : 1);
      const int gap = tg - jg - 1;           // groups strictly between
      const int mi = gap == 0 ? 0 : (gap == 2 ? 3 : (jg == 0 ? 1 : 2));
      const float4 m = *reinterpret_cast<const float4*>(&sm.x.mid[mi][4 * dg]);
      float4 rr[4], kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rr[a] = *reinterpret_cast<const float4*>(&sm.x.rl[4 * tg + a][4 * dg]);
        kk[a] = *reinterpret_cast<const float4*>(&sm.x.ku[4 * jg + a][4 * dg]);
      }
      float part[16];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 km = make_float4(kk[c].x * m.x, kk[c].y * m.y,
                                      kk[c].z * m.z, kk[c].w * m.w);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          part[4 * a + c] = rr[a].x * km.x + rr[a].y * km.y +
                            rr[a].z * km.z + rr[a].w * km.w;
        }
      }
      // Sum over the block's 16 lanes: lane dg ends with entry dg.
      float s8[8], s4[4], s2[2];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const bool up = dg & 8;
        const float give = up ? part[q] : part[q + 8];
        s8[q] = (up ? part[q + 8] : part[q]) + __shfl_xor_sync(0xffffffffu, give, 8);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool up = dg & 4;
        const float give = up ? s8[q] : s8[q + 4];
        s4[q] = (up ? s8[q + 4] : s8[q]) + __shfl_xor_sync(0xffffffffu, give, 4);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool up = dg & 2;
        const float give = up ? s4[q] : s4[q + 2];
        s2[q] = (up ? s4[q + 2] : s4[q]) + __shfl_xor_sync(0xffffffffu, give, 2);
      }
      const bool up = dg & 1;
      const float sum = (up ? s2[1] : s2[0]) +
                        __shfl_xor_sync(0xffffffffu, up ? s2[0] : s2[1], 1);
      const Split a = split3(sum, 0.0f);   // the low halves
      const int row = 4 * tg + (dg >> 2), col = 4 * jg + (dg & 3);
      *reinterpret_cast<uint16_t*>(&pp.ap[0][row][col]) = static_cast<uint16_t>(a.h);
      *reinterpret_cast<uint16_t*>(&pp.ap[1][row][col]) = static_cast<uint16_t>(a.m);
      *reinterpret_cast<uint16_t*>(&pp.ap[2][row][col]) = static_cast<uint16_t>(a.l);
    }

    mbar_arrive(smem_addr(&sm.full[buf]));
    issue();                       // step i + kAhead, into step i - 2's stage
  }
}

// The 2 consumer warps; warp c owns value columns 32c..32c+31 and holds S^T
// for them (32 values x 64 keys) in mma C fragments: st[mt][nt] covers
// values 32c + 16mt.. and keys 8nt..8nt+7, rows lane/4 and lane/4 + 8,
// columns 2(lane%4) and + 1.
__device__ __forceinline__ void consume(Smem& sm, __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ state, int b, int h,
                                        int S, int H, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int e0 = 32 * warp;
  // This lane's ldmatrix row and column.  (lr, lc) takes the four 8 x 8
  // matrices of a 16 x 16 tile rows first: A fragments of a row-major tile,
  // B fragments of a transposed one; (ar, ac) columns first: A fragments
  // of a transposed tile.
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) * 8;
  float st[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[mt][nt][c] = 0.0f;

  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    const Stage& sg = sm.ring[i % kStages];
    const Prep& pp = sm.prep[buf];
    mbar_wait(smem_addr(&sm.full[buf]), (i >> 1) & 1);

    // (r P) S over six part products, then A v over three; n-tile ne holds
    // values e0 + 8ne...
    float hi[4][4], lo[4][4];
#pragma unroll
    for (int ne = 0; ne < 4; ++ne)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[ne][c] = lo[ne][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], am[4], al[4];
      ldmatrix_x4(ah, &pp.rp[0][lr][16 * kk + lc]);
      ldmatrix_x4(am, &pp.rp[1][lr][16 * kk + lc]);
      ldmatrix_x4(al, &pp.rp[2][lr][16 * kk + lc]);
#pragma unroll
      for (int ne = 0; ne < 4; ++ne) {
        // B[d][e] = S^T[e][d] for keys 16kk.., values 8ne..: the C
        // fragments of tiles 2kk and 2kk + 1, rows g (ne even) or g + 8.
        const float* c0 = st[ne >> 1][2 * kk];
        const float* c1 = st[ne >> 1][2 * kk + 1];
        const int o = 2 * (ne & 1);
        const Split b0 = split3(c0[o], c0[o + 1]);
        const Split b1 = split3(c1[o], c1[o + 1]);
        mma_bf16(hi[ne], ah, b0.h, b1.h);
        mma_bf16(lo[ne], ah, b0.m, b1.m);
        mma_bf16(hi[ne], am, b0.h, b1.h);
        mma_bf16(lo[ne], ah, b0.l, b1.l);
        mma_bf16(hi[ne], al, b0.h, b1.h);
        mma_bf16(lo[ne], am, b0.m, b1.m);
      }
    }
    // v rows 0-15, values e0 + 16mt..: vb[mt][2q], vb[mt][2q + 1] are the B
    // fragments of A v for values e0 + 16mt + 8q..; vt[mt], the same four
    // 8 x 8 matrices in A order, is v^T's A fragment.
    uint32_t vb[2][4], vt[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4_trans(vb[mt], &sg.v[lr][e0 + 16 * mt + lc]);
      ldmatrix_x4_trans(vt[mt], &sg.v[ar][e0 + 16 * mt + ac]);
    }
    {
      uint32_t th[4], tm[4], tl[4];
      ldmatrix_x4(th, &pp.ap[0][lr][lc]);
      ldmatrix_x4(tm, &pp.ap[1][lr][lc]);
      ldmatrix_x4(tl, &pp.ap[2][lr][lc]);
#pragma unroll
      for (int ne = 0; ne < 4; ++ne) {
        const uint32_t x0 = vb[ne >> 1][2 * (ne & 1)], x1 = vb[ne >> 1][2 * (ne & 1) + 1];
        mma_bf16(hi[ne], th, x0, x1);
        mma_bf16(lo[ne], tm, x0, x1);
        mma_bf16(lo[ne], tl, x0, x1);
      }
    }

    // S^T = S^T diag(P_16) + v^T (k Q), three part products.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 dec = *reinterpret_cast<const float2*>(&pp.p16[8 * nt + 2 * tq]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        st[mt][nt][0] *= dec.x;
        st[mt][nt][1] *= dec.y;
        st[mt][nt][2] *= dec.x;
        st[mt][nt][3] *= dec.y;
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, &pp.kp[part][lr][16 * np + lc]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(st[mt][2 * np], vt[mt], kb[0], kb[1]);
          mma_bf16(st[mt][2 * np + 1], vt[mt], kb[2], kb[3]);
        }
      }
    }

    const int t0 = i * kSub;
#pragma unroll
    for (int ne = 0; ne < 4; ++ne) {
      const int e = e0 + 8 * ne + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + g + 8 * half;
        if (t < S) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((static_cast<long long>(b) * S + t) * H + h) * kD + e) =
              __floats2bfloat162_rn(hi[ne][2 * half] + lo[ne][2 * half],
                                    hi[ne][2 * half + 1] + lo[ne][2 * half + 1]);
        }
      }
    }
    mbar_arrive(smem_addr(&sm.empty[buf]));
  }

  if (state) {
    float* sp = state + (static_cast<long long>(b) * H + h) * kD * kD;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = 8 * nt + 2 * tq, e = e0 + 16 * mt + g;
        sp[d * kD + e] = st[mt][nt][0];
        sp[(d + 1) * kD + e] = st[mt][nt][1];
        sp[d * kD + e + 8] = st[mt][nt][2];
        sp[(d + 1) * kD + e + 8] = st[mt][nt][3];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_chunked_kernel(const __nv_bfloat16* __restrict__ r,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ w, const float* __restrict__ u,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ state,
                          int S, int H, Strides sr, Strides sk, Strides sv,
                          Strides sw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int n = (S + kSub - 1) / kSub;
  // The diagonal block's entries above its 4 x 4 block diagonal stay zero.
  for (int q = threadIdx.x; q < static_cast<int>(sizeof(Prep::ap) / 4); q += kThreads) {
    reinterpret_cast<uint32_t*>(sm.prep[0].ap)[q] = 0u;
    reinterpret_cast<uint32_t*>(sm.prep[1].ap)[q] = 0u;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_addr(&sm.full[i]), kProducers);
      mbar_init(smem_addr(&sm.empty[i]), kConsumers);
    }
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(sm, r, k, v, w, u, b, h, S, n, sr, sk, sv, sw);
  } else {
    consume(sm, out, state, b, h, S, H, n);
  }
}

// Each input's rows are copied in 16-byte pieces: the base address and the
// byte strides of the B, S and H axes must be multiples of 16.
bool copyable(const void* p, const Strides& s, long long elem) {
  const long long m = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % m == 0 &&
         s.s % m == 0 && s.h % m == 0;
}

cudaError_t run(const Args& a) {
  if (!copyable(a.r, a.sr, 2) || !copyable(a.k, a.sk, 2) ||
      !copyable(a.v, a.sv, 2) || !copyable(a.w, a.sw, 4)) {
    return cudaErrorInvalidValue;
  }
  auto kern = rwkv6_scan_chunked_kernel;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(a.B) * a.H);
  kern<<<blocks, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.r), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.w, a.u,
      static_cast<__nv_bfloat16*>(a.out), a.state, a.S, a.H, a.sr, a.sk, a.sv, a.sw);
  return cudaGetLastError();
}

}  // namespace chunked

}  // namespace

// Bodies: 0 = token, 1 = chunked.  dtype code of r / k / v / out: 0 =
// float32, 1 = bfloat16.  The token body takes D = 16, 32 or 64 and
// 1 <= tile <= 64; the chunked body bf16 at D = 64 only, with every input's
// base address and B / S / H byte strides multiples of 16 (tile is not
// read).  Strides are in elements, for the B, S and H axes of each input
// (its D axis is contiguous).  state may be null (the final state is then
// not written).  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for what the body does not take; it
// neither allocates nor synchronises.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* out,
                                 void* state, int B, int S, int H, int D,
                                 int tile, const long long* strides,
                                 int dtype, int body, void* stream) {
  const Strides sr{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sw{strides[9], strides[10], strides[11]};
  const Args a{r, k, v, static_cast<const float*>(w),
               static_cast<const float*>(u), out, static_cast<float*>(state),
               B, S, H, tile, sr, sk, sv, sw, static_cast<cudaStream_t>(stream)};
  if (body == 1) {
    if (dtype != 1 || D != chunked::kD) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(chunked::run(a));
  }
  if (body != 0 || tile < 1 || tile > token::kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      dtype ? token::pick_d<__nv_bfloat16>(a, D) : token::pick_d<float>(a, D);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of a body (0 = token, at head dim d
// and `tile`; 1 = chunked).
extern "C" int rwkv6_scan_smem_bytes(int body, int d, int tile) {
  return static_cast<int>(body == 1 ? sizeof(chunked::Smem)
                                    : token::smem_bytes(d, tile));
}
