// rwkv6 "Finch" time-mix scan for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by repro_torch/kernels/rwkv6_scan.py.
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/rwkv6_scan.py (`rwkv6_scan`, whose pallas_call runs the
// body `_rwkv6_kernel`).  Per batch b and head h, over tokens t, with the
// state S in R^{DxD} (key index d, value index e) starting at zero:
//   out_t[e] = sum_d r_t[d] (S_{t-1}[d,e] + exp(u[d]) k_t[d] v_t[e])
//   S_t[d,e] = exp(w_t[d]) S_{t-1}[d,e] + k_t[d] v_t[e]
// and, on request, the final state S_{S-1} in float32.  r, k, v are float32
// or bfloat16 (one type for the three), w (log decay <= 0) and u are
// float32; out takes r's type.  All arithmetic is float32.
//
// Form.  The Pallas body runs the chunked form: per chunk of 64 tokens four
// 64x64x64 products, with the in-chunk decay split into two factors
// exp(cum_{t-1}) exp(-cum_j) that stay finite only because the caller floors
// the log decay at -60/64.  Here the recurrence runs token by token, as the
// plain version does: no factor can overflow whatever the decay, and each
// state value needs three float32 instructions per token
// (y += r s;  x = k v;  s = s exp(w) + x), where the chunked form spends
// about four multiply-adds per token and state value.  The bonus term
// a_t v_t[e], with a_t = sum_d r_t[d] exp(u[d]) k_t[d], is one dot product
// per token, reduced by a warp.
//
// What bounds it on this card: float32 instructions on the CUDA cores.  At
// the serving shape (B=8, S=2048, H=32, D=64; bf16 r/k/v, f32 w) it reads
// 335 MB and writes 71 MB (about 121 us at 3.35 TB/s), and does 1.07e10
// float32 operations, counted as 5 per (token, d, e) (about 160 us at
// 67 TFLOP/s): the scan cannot use the tensor cores in this form.
//
// Layout.  One block per (b, h): 4 D threads.  Thread (g, e) owns the state
// column e for the key rows d in group g (D/4 of them) in registers, and
// produces a partial sum of out_t[e] over its rows.  Per tile of `tile`
// tokens (at most 64; the wrapper stages 32) the block stages r, k, v and
// exp(w) in shared memory as float32 (read once from HBM through the
// (B, S, H, D) strides: no transposed copy), runs the tokens of the tile,
// and then adds the four partials and the bonus term and writes out.  The
// grid is B*H blocks; at the serving shape 256 blocks of 256 threads on 132
// SMs, with (4 + 4) * 32 * 64 floats = 66 KB of shared memory each, so all
// of them are resident at once.  No TMA, no wgmma, no overlap of the next
// tile's loads with this tile's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;    // key-row groups per head: threads = 4 D
constexpr int kMaxTile = 64;  // tokens staged in shared memory per step

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

template <typename T, int D, bool WRITE_STATE>
__global__ void __launch_bounds__(kGroups * D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
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
  auto kern = rwkv6_scan_kernel<T, D, WRITE_STATE>;
  const size_t smem =
      (static_cast<size_t>(4 + kGroups) * a.tile * D + a.tile) * sizeof(float);
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

}  // namespace

// dtype code of r / k / v / out: 0 = float32, 1 = bfloat16.  D must be 16,
// 32 or 64, and 1 <= tile <= 64.  Strides are in elements, for the B, S and
// H axes of each input (its D axis is contiguous).  state may be null (the
// final state is then not written).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* out,
                                 void* state, int B, int S, int H, int D,
                                 int tile, const long long* strides,
                                 int dtype, void* stream) {
  if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sr{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sw{strides[9], strides[10], strides[11]};
  const Args a{r, k, v, static_cast<const float*>(w),
               static_cast<const float*>(u), out, static_cast<float*>(state),
               B, S, H, tile, sr, sk, sv, sw, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype ? pick_d<__nv_bfloat16>(a, D) : pick_d<float>(a, D);
  return static_cast<int>(err);
}
