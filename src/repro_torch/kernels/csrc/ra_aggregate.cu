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
//
// What bounds it on this card: memory.  Per segment it is an (N x N)^T (N x K)
// product with 2 N flops per value moved, far below the H100's ridge point.
// At the slice shape (B=1, N=10, L=412, K=1024, float32) it must read
// w once (16.9 MB) and write the output once (16.9 MB): 33.8 MB, about 10 us
// at 3.35 TB/s, against 84 MFLOP (about 1.3 us at 67 TFLOP/s float32).
// That working set fits in the 50 MB L2, so a timing must say whether L2
// was warm (chip_smoke.py times both).
//
// Design.  The Pallas grid (B, receiver, L/BL) re-reads every sender tile
// once per receiver (N reads of the model stack) and writes a receiver-major
// copy of e.  Here one block owns one (b, l): it builds that segment's
// N x N coefficients p_m e'[m,n,l] in shared memory straight from the
// packed mask (bool/uint8 or float32, read as it comes), plus one scale per
// receiver: the reciprocal of the eq.-6 normalizer, or the substitution
// mode's missing mass.  Then threads stride over K: each thread reads
// w[m,l,k] once per sender (the sender loop unrolled by 4 so several loads
// are in flight) and accumulates a compile-time group of kRecvGroup
// receivers in registers, writing each output once.  For N <= kRecvGroup
// that is one read of w and one write of the output; larger N loops over
// receiver groups.  Substitution adds miss[n] * w[n,l,k] after the sum, as
// the reference does, re-reading the receiver's own value (an L1 hit).
// Accumulation is float32; the output takes w's dtype (float32 or bfloat16,
// round to nearest even).  No TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRecvGroup = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

struct Args {
  const void* w;      // (B, N, L, K) contiguous
  const float* p;     // (B, N), batch stride p_bs (0 = shared)
  const void* e;      // (B, N, N, L), batch stride e_bs (0 = shared)
  const void* tx;     // (B, N, L), batch stride tx_bs, or null
  void* out;          // (B, N, L, K) contiguous
  int B, N, L, K, NP;  // NP: N rounded up to a multiple of kRecvGroup
  long long p_bs, e_bs, tx_bs;
  cudaStream_t stream;
};

template <int MODE, bool HAS_TX, typename WT, typename ET, typename TT>
__global__ void __launch_bounds__(kThreads)
ra_aggregate_kernel(const WT* __restrict__ w, const float* __restrict__ p,
                    const ET* __restrict__ e, const TT* __restrict__ tx,
                    WT* __restrict__ out, int N, int L, int K, int NP,
                    long long p_bs, long long e_bs, long long tx_bs) {
  extern __shared__ float smem[];
  float* coef = smem;            // [N][NP]: coef[m * NP + n], zero for n >= N
  float* scale = smem + N * NP;  // [NP]: 1 / normalizer, or the missing mass

  const long long bl = blockIdx.x;
  const int b = static_cast<int>(bl / L);
  const int l = static_cast<int>(bl % L);
  const float* pb = p + b * p_bs;
  const ET* eb = e + b * e_bs;

  for (int i = threadIdx.x; i < N * NP; i += blockDim.x) {
    const int m = i / NP;
    const int n = i % NP;
    float c = 0.0f;
    if (n < N) {
      float ev = to_f32(eb[(static_cast<size_t>(m) * N + n) * L + l]);
      if constexpr (HAS_TX) {
        const TT* tb = tx + b * tx_bs;
        ev = (m == n) ? 1.0f : ev * to_f32(tb[static_cast<size_t>(m) * L + l]);
      }
      c = pb[m] * ev;
    }
    coef[i] = c;
  }
  __syncthreads();

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    for (int m = 0; m < N; ++m) s += coef[m * NP + n];
    if constexpr (MODE == 0) {
      scale[n] = 1.0f / fmaxf(s, 1e-12f);
    } else {
      float ps = 0.0f;
      for (int m = 0; m < N; ++m) ps += pb[m];
      scale[n] = ps - s;  // lost mass falls back to the own segment
    }
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(L) * K;  // sender stride in w
  const size_t base = static_cast<size_t>(b) * N * row + static_cast<size_t>(l) * K;
  const WT* wb = w + base;
  WT* ob = out + base;
  for (int n0 = 0; n0 < N; n0 += kRecvGroup) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float acc[kRecvGroup];
#pragma unroll
      for (int r = 0; r < kRecvGroup; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int m = 0; m < N; ++m) {
        const float wv = to_f32(wb[m * row + k]);
        const float* cm = coef + m * NP + n0;
#pragma unroll
        for (int r = 0; r < kRecvGroup; ++r) acc[r] = fmaf(cm[r], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRecvGroup; ++r) {
        const int n = n0 + r;
        if (n < N) {
          float v;
          if constexpr (MODE == 0) {
            v = acc[r] * scale[n];
          } else {
            v = fmaf(scale[n], to_f32(wb[n * row + k]), acc[r]);
          }
          store(ob + n * row + k, v);
        }
      }
    }
  }
}

template <int MODE, bool HAS_TX, typename WT, typename ET, typename TT>
cudaError_t run(const Args& a) {
  auto kern = ra_aggregate_kernel<MODE, HAS_TX, WT, ET, TT>;
  const size_t smem = static_cast<size_t>(a.N * a.NP + a.NP) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return err;          // N too large for this device's shared memory
    }
  }
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(a.B) * a.L);
  kern<<<blocks, kThreads, smem, a.stream>>>(
      static_cast<const WT*>(a.w), a.p, static_cast<const ET*>(a.e),
      static_cast<const TT*>(a.tx), static_cast<WT*>(a.out),
      a.N, a.L, a.K, a.NP, a.p_bs, a.e_bs, a.tx_bs);
  return cudaGetLastError();
}

template <int MODE, bool HAS_TX, typename WT, typename ET>
cudaError_t pick_tx(const Args& a, int tx_dtype) {
  if constexpr (!HAS_TX) {
    return run<MODE, false, WT, ET, uint8_t>(a);
  } else {
    return tx_dtype ? run<MODE, true, WT, ET, float>(a)
                    : run<MODE, true, WT, ET, uint8_t>(a);
  }
}

template <int MODE, bool HAS_TX, typename WT>
cudaError_t pick_e(const Args& a, int e_dtype, int tx_dtype) {
  return e_dtype ? pick_tx<MODE, HAS_TX, WT, float>(a, tx_dtype)
                 : pick_tx<MODE, HAS_TX, WT, uint8_t>(a, tx_dtype);
}

template <int MODE, bool HAS_TX>
cudaError_t pick_w(const Args& a, int w_dtype, int e_dtype, int tx_dtype) {
  return w_dtype ? pick_e<MODE, HAS_TX, __nv_bfloat16>(a, e_dtype, tx_dtype)
                 : pick_e<MODE, HAS_TX, float>(a, e_dtype, tx_dtype);
}

template <int MODE>
cudaError_t pick_has_tx(const Args& a, int w_dtype, int e_dtype, int tx_dtype) {
  return a.tx ? pick_w<MODE, true>(a, w_dtype, e_dtype, tx_dtype)
              : pick_w<MODE, false>(a, w_dtype, e_dtype, tx_dtype);
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
  const int np = (N + kRecvGroup - 1) / kRecvGroup * kRecvGroup;
  const Args a{w, static_cast<const float*>(p), e, tx, out, B, N, L, K, np,
               p_bs, e_bs, tx_bs, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = mode ? pick_has_tx<1>(a, w_dtype, e_dtype, tx_dtype)
                               : pick_has_tx<0>(a, w_dtype, e_dtype, tx_dtype);
  return static_cast<int>(err);
}

