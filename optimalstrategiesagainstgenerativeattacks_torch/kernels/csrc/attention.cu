// K2: SAGAN self-attention core for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/attention_pallas.py
// at commit 79a0a33: _attn_kernel, launched by _run_attn under
// self_attention_pallas.
//
// What it computes, per sample b, with f, g [N, CQ] and h [N, C]:
//   S[i, j] = f_i . g_j
//   P[:, j] = softmax over the SOURCE axis i of S[:, j]
//   out_j   = sum_i P[i, j] h_i                     (f32 accumulation)
// N <= 256 spatial tokens, so one column's whole softmax fits a block.
//
// What bounds it on the card: at the flagship sites (N = 64 or 256,
// CQ = 16 or 32, C = 128 or 256) it does about 2 N^2 (CQ + C) flops per
// sample against 2 N (2 CQ + 2 C) bytes of bf16 in and out: tens of flops per
// byte, so neither HBM nor the f32 FMA pipes are saturated by a simple
// kernel, and the real limit is latency and on-chip reuse.  The design keeps
// the N x N map out of device memory entirely: one block owns one sample and
// a tile of TJ output columns; it stages f for all N source rows and the
// tile's g columns in shared memory, computes the TJ score columns into
// shared memory, takes each column's softmax there (one warp per column,
// shuffles for max and sum), and then streams h from global memory once per
// block, each thread accumulating TJ outputs of one channel in registers.
// Each h element loaded feeds TJ FMAs, and the loads are coalesced along C.
// Shared-memory rows are padded to odd strides so threads walking rows hit
// distinct banks.  No tensor cores yet (mma / wgmma / TMA are later work).
//
// The TPU kernel held one sample's whole problem in VMEM per grid step; here
// the grid is (sample x column tile) so enough blocks run on 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTJ = 16;        // output columns per block
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int f_stride(int cq) { return cq | 1; }  // odd

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const T* __restrict__ f, const T* __restrict__ g,
                      const T* __restrict__ h, T* __restrict__ out,
                      int n_tiles, int N, int CQ, int C) {
  extern __shared__ float smem[];
  const int fs = f_stride(CQ);
  constexpr int ps = kTJ + 1;
  float* f_s = smem;               // [N][fs]
  float* g_s = f_s + N * fs;       // [CQ][kTJ]
  float* p_s = g_s + CQ * kTJ;     // [N][ps]: scores, then probabilities

  const int64_t b = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * kTJ;
  const int nj = min(kTJ, N - j0);
  const T* fb = f + b * N * CQ;
  const T* gb = g + b * N * CQ;
  const T* hb = h + b * N * C;
  T* ob = out + b * N * C;

  for (int idx = threadIdx.x; idx < N * CQ; idx += blockDim.x) {
    const int i = idx / CQ, k = idx - i * CQ;
    f_s[i * fs + k] = to_f32(fb[idx]);
  }
  for (int idx = threadIdx.x; idx < kTJ * CQ; idx += blockDim.x) {
    const int jj = idx / CQ, k = idx - jj * CQ;
    g_s[k * kTJ + jj] = jj < nj ? to_f32(gb[(int64_t)(j0 + jj) * CQ + k]) : 0.f;
  }
  __syncthreads();

  // scores: thread i computes S[i, j0 .. j0 + kTJ)
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float s[kTJ];
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj) s[jj] = 0.f;
    for (int k = 0; k < CQ; ++k) {
      const float fv = f_s[i * fs + k];
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) s[jj] = fmaf(fv, g_s[k * kTJ + jj], s[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj) p_s[i * ps + jj] = s[jj];
  }
  __syncthreads();

  // softmax over i, one warp per column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int jj = warp; jj < nj; jj += n_warps) {
    float m = -INFINITY;
    for (int i = lane; i < N; i += 32) m = fmaxf(m, p_s[i * ps + jj]);
    m = warp_max(m);
    float sum = 0.f;
    for (int i = lane; i < N; i += 32) {
      const float e = expf(p_s[i * ps + jj] - m);
      p_s[i * ps + jj] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int i = lane; i < N; i += 32) p_s[i * ps + jj] *= inv;
  }
  __syncthreads();

  // out_j[c] = sum_i P[i, j] h_i[c]; thread owns channel c for all kTJ columns
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[kTJ];
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj) acc[jj] = 0.f;
    for (int i = 0; i < N; ++i) {
      const float hv = to_f32(hb[(int64_t)i * C + c]);
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) acc[jj] = fmaf(p_s[i * ps + jj], hv, acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj)
      if (jj < nj) ob[(int64_t)(j0 + jj) * C + c] = from_f32<T>(acc[jj]);
  }
}

template <typename T>
int launch(const void* f, const void* g, const void* h, void* out, long long B, int N,
           int CQ, int C, size_t smem, cudaStream_t stream) {
  const int n_tiles = (N + kTJ - 1) / kTJ;
  cudaError_t err = cudaFuncSetAttribute(attention_core_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_core_kernel<T><<<(unsigned)(B * n_tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), static_cast<const T*>(h),
      static_cast<T*>(out), n_tiles, N, CQ, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) the kernel needs for N tokens and CQ dims.
long long osga_attention_core_smem_bytes(int N, int CQ) {
  return (long long)sizeof(float) *
         ((long long)N * f_stride(CQ) + (long long)CQ * kTJ + (long long)N * (kTJ + 1));
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success),
// read right after the launch.
int osga_attention_core_fwd(const void* f, const void* g, const void* h, void* out,
                            long long B, int N, int CQ, int C, int dtype, void* stream) {
  const size_t smem = (size_t)osga_attention_core_smem_bytes(N, CQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(f, g, h, out, B, N, CQ, C, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(f, g, h, out, B, N, CQ, C, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* osga_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
