// K2: SAGAN self-attention core for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/attention_pallas.py
// at commit 79a0a33: _attn_kernel, launched by _run_attn under
// self_attention_pallas.
//
// What it computes, per sample b, with f, g [N, CQ] and h [N, C]:
//   S[i, j] = f_i . g_j
//   P[:, j] = softmax over the SOURCE axis i of S[:, j]     (f32)
//   out_j   = sum_i P[i, j] h_i                             (f32 accumulation)
// N <= 256 spatial tokens.
//
// What bounds it on the card: memory.  Each sample reads f, g and h once and
// writes out once, 2 N (2 CQ + 2 C) bytes in bf16, against 2 N^2 (CQ + C)
// flops: at the flagship sites (N = 64 or 256, CQ = 16 or 32, C = 128 or
// 256) that is 32 to 128 flops per byte, below the H100's ~295 bf16
// flops/byte ridge.  The largest site (B = 1920, N = 64, C = 256, CQ = 32)
// moves 141.6 MB, 42.3 us at 3.35 TB/s.  The N x N map never reaches device
// memory.
//
// bf16: tensor cores, FlashAttention-2's shape at N <= 256.
//   * A persistent CTA walks over samples.  It copies one sample's f, g and h
//     into shared memory with 16-byte cp.async, double buffered: the next
//     sample's copy is in flight while this one computes.  At N = 64 a CTA
//     has 8 warps and two CTAs share an SM (registers capped at 128); at
//     N = 256 (16 warp items per sample) a CTA has 16 warps and the SM to
//     itself.  Rows are padded by 16 bytes, so ldmatrix and the fragment
//     loads hit 32 distinct banks.  Shapes whose rows are not 16-byte
//     multiples (CQ or C not a multiple of 8) take plain element loads.
//   * Roles: the query rows j are the M dimension, the source tokens i the
//     softmax axis, so the softmax runs along each row of S^T = g f^T.  A
//     warp item is 16 rows j and up to 128 output channels; S^T comes from
//     mma.sync.m16n8k16 bf16 -> f32, K = CQ zero-padded to a multiple of 16
//     (exact).  Rows j >= N and channels c >= C are zero padding in shared
//     memory; columns i >= N are masked with -inf.
//   * Softmax in two passes over i-tiles of 16: the first keeps each row's
//     running max and sum (quad shuffles on the accumulator fragments), the
//     second recomputes S^T and forms P = exp(S - max) / sum.  P is rounded
//     to bf16 AFTER the normalisation, as the JAX reference rounds
//     (nn/blocks.py SelfAttention: softmax in f32, then .astype(bf16)), not
//     FlashAttention's rounding of the unnormalised exponentials.  On an
//     H100, 99.85-100 % of the bf16 outputs equal the plain version's at the
//     flagship sites, and ex2.approx loses none of them against exp2f
//     (scripts/torch_attention_agreement.py).
//   * Output: P's accumulator fragments are reused as the A operand of
//     O += P h; h is the B operand, read through ldmatrix.trans.  O is
//     accumulated in f32, rounded to bf16, staged 64 channels at a time in
//     the warp's own shared tile and written with 16-byte coalesced stores.
//   * What still holds it back (PERF.md): at N = 256 the exponentials of
//     both passes and the rate of mma.sync instructions, not memory;
//     wgmma with TMA loads is the next step.
//
// f32: the SIMT kernel, P in f32 (the f32 path runs only in parity checks;
// TF32 tensor cores would miss their 1e-4 tolerance).  One block owns one
// sample and a tile of 16 output columns; scores and softmax live in shared
// memory, h streams from global memory once per block.
//
// The backward is torch ops (kernels/attention.py:attention_core_bwd), as
// the Pallas kernel's VJP was jnp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // per-block dynamic shared memory on sm_90

// ---------------------------------------------------------------- f32 (SIMT)

constexpr int kTJ = 16;        // output columns per block
constexpr int kThreads = 128;  // 4 warps

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

long long f32_smem_bytes(int N, int CQ) {
  return (long long)sizeof(float) *
         ((long long)N * f_stride(CQ) + (long long)CQ * kTJ + (long long)N * (kTJ + 1));
}

__global__ void __launch_bounds__(kThreads)
attention_core_f32_kernel(const float* __restrict__ f, const float* __restrict__ g,
                          const float* __restrict__ h, float* __restrict__ out,
                          int n_tiles, int N, int CQ, int C) {
  extern __shared__ float smem_f32[];
  float* smem = smem_f32;
  const int fs = f_stride(CQ);
  constexpr int ps = kTJ + 1;
  float* f_s = smem;               // [N][fs]
  float* g_s = f_s + N * fs;       // [CQ][kTJ]
  float* p_s = g_s + CQ * kTJ;     // [N][ps]: scores, then probabilities

  const int64_t b = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * kTJ;
  const int nj = min(kTJ, N - j0);
  const float* fb = f + b * N * CQ;
  const float* gb = g + b * N * CQ;
  const float* hb = h + b * N * C;
  float* ob = out + b * N * C;

  for (int idx = threadIdx.x; idx < N * CQ; idx += blockDim.x) {
    const int i = idx / CQ, k = idx - i * CQ;
    f_s[i * fs + k] = fb[idx];
  }
  for (int idx = threadIdx.x; idx < kTJ * CQ; idx += blockDim.x) {
    const int jj = idx / CQ, k = idx - jj * CQ;
    g_s[k * kTJ + jj] = jj < nj ? gb[(int64_t)(j0 + jj) * CQ + k] : 0.f;
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
      const float hv = hb[(int64_t)i * C + c];
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) acc[jj] = fmaf(p_s[i * ps + jj], hv, acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj)
      if (jj < nj) ob[(int64_t)(j0 + jj) * C + c] = acc[jj];
  }
}

int launch_f32(const void* f, const void* g, const void* h, void* out, long long B, int N,
               int CQ, int C, cudaStream_t stream) {
  const int n_tiles = (N + kTJ - 1) / kTJ;
  const size_t smem = (size_t)f32_smem_bytes(N, CQ);
  cudaError_t err = cudaFuncSetAttribute(attention_core_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_core_f32_kernel<<<(unsigned)(B * n_tiles), kThreads, smem, stream>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<float*>(out), n_tiles, N, CQ, C);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 (tensor cores)

constexpr int kCB = 128;      // output channels per warp item
constexpr int kHalf = 64;     // output channels staged at a time
constexpr int kSkew = 8;      // bf16 padding per shared row: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

// One stage of shared memory (one sample), in bf16 elements.
struct Layout {
  int np;     // N rounded up to 16
  int kq;     // CQ rounded up to 16
  int cp;     // C rounded up to 16
  int fs;     // row stride of f and g
  int hs;     // row stride of h
  int g_off;  // f starts at 0
  int h_off;
  int stage;  // elements of one stage
};

__host__ __device__ __forceinline__ Layout make_layout(int N, int CQ, int C) {
  Layout L;
  L.np = (N + 15) & ~15;
  L.kq = (CQ + 15) & ~15;
  L.cp = (C + 15) & ~15;
  L.fs = L.kq + kSkew;
  L.hs = L.cp + kSkew;
  L.g_off = L.np * L.fs;
  L.h_off = 2 * L.np * L.fs;
  L.stage = L.h_off + L.np * L.hs;
  return L;
}

constexpr int kOutTile = 16 * (kHalf + kSkew);  // one warp's output staging, elements

// Launch shape: 16 warps where a sample has 16 or more warp items (N = 256)
// and two stages still fit, else 8; two sample stages where they fit, else one.
struct Plan {
  int warps, stages;
  long long smem;
};

Plan make_plan(int N, int CQ, int C) {
  const Layout L = make_layout(N, CQ, C);
  const int items = (L.np / 16) * ((L.cp + kCB - 1) / kCB);
  const long long two = 2LL * 2 * L.stage;
  Plan p;
  p.warps = items >= 16 && two + 2LL * 16 * kOutTile <= kMaxSmemBytes ? 16 : 8;
  const long long out = 2LL * p.warps * kOutTile;
  p.stages = two + out <= kMaxSmemBytes ? 2 : 1;
  p.smem = 2LL * p.stages * L.stage + out;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 or 1) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy one sample's f, g, h into a stage.  Padding stays zero: it is cleared
// once at kernel start and never written.
template <int WARPS>
__device__ __forceinline__ void load_sample(__nv_bfloat16* st, const Layout& L,
                                            const __nv_bfloat16* f, const __nv_bfloat16* g,
                                            const __nv_bfloat16* h, long long s, int N,
                                            int CQ, int C, bool vec) {
  constexpr int kThreadsAll = WARPS * 32;
  const __nv_bfloat16* fb = f + s * N * CQ;
  const __nv_bfloat16* gb = g + s * N * CQ;
  const __nv_bfloat16* hb = h + s * N * C;
  if (vec) {  // rows are whole 16-byte chunks
    const int qc = CQ / 8, hc = C / 8;
    for (int idx = threadIdx.x; idx < N * qc; idx += kThreadsAll) {
      const int i = idx / qc, q = idx - i * qc;
      cp_async16(st + i * L.fs + 8 * q, fb + idx * 8);
      cp_async16(st + L.g_off + i * L.fs + 8 * q, gb + idx * 8);
    }
    for (int idx = threadIdx.x; idx < N * hc; idx += kThreadsAll) {
      const int i = idx / hc, q = idx - i * hc;
      cp_async16(st + L.h_off + i * L.hs + 8 * q, hb + idx * 8);
    }
  } else {
    for (int idx = threadIdx.x; idx < N * CQ; idx += kThreadsAll) {
      const int i = idx / CQ, k = idx - i * CQ;
      st[i * L.fs + k] = fb[idx];
      st[L.g_off + i * L.fs + k] = gb[idx];
    }
    for (int idx = threadIdx.x; idx < N * C; idx += kThreadsAll) {
      const int i = idx / C, c = idx - i * C;
      st[L.h_off + i * L.hs + c] = hb[idx];
    }
  }
}

// S^T for the warp's 16 rows j0.. against source tokens i0 .. i0 + 16, masked
// to -inf at i >= N.  s[t][0..1]: row gid, i = i0 + 8t + 2 tig + {0, 1};
// s[t][2..3]: row gid + 8, the same i.
__device__ __forceinline__ void scores(float s[2][4], const __nv_bfloat16* st, const Layout& L,
                                       int j0, int i0, int N, int gid, int tig) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  const __nv_bfloat16* ga = st + L.g_off + (j0 + gid) * L.fs + 2 * tig;
  const __nv_bfloat16* fb = st + (i0 + gid) * L.fs + 2 * tig;
#pragma unroll 2
  for (int k = 0; k < L.kq; k += 16) {
    const uint32_t a[4] = {lds32(ga + k), lds32(ga + 8 * L.fs + k), lds32(ga + k + 8),
                           lds32(ga + 8 * L.fs + k + 8)};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __nv_bfloat16* fr = fb + 8 * t * L.fs + k;
      mma_bf16(s[t], a, lds32(fr), lds32(fr + 8));
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = i0 + 8 * t + 2 * tig;
    if (i >= N) s[t][0] = s[t][2] = -INFINITY;
    if (i + 1 >= N) s[t][1] = s[t][3] = -INFINITY;
  }
}

// One warp item: 16 rows j0.. and channels c0 .. c0 + ncols of one sample.
__device__ __forceinline__ void attend_item(const __nv_bfloat16* cur, const Layout& L,
                                            __nv_bfloat16* ostage, __nv_bfloat16* ob, int N,
                                            int C, int j0, int c0, bool vec) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int ncols = min(kCB, L.cp - c0);  // a multiple of 16

  // pass 1: each row's max and sum of exp over all i
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll 2
  for (int i0 = 0; i0 < L.np; i0 += 16) {
    float sc[2][4];
    scores(sc, cur, L, j0, i0, N, gid, tig);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = quad_max(fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                                      fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
      const float mn = fmaxf(m[r], mx);
      const float mb = mn * kLog2e;
      l[r] = l[r] * ex2(fmaf(m[r], kLog2e, -mb)) +
             ex2(fmaf(sc[0][2 * r], kLog2e, -mb)) + ex2(fmaf(sc[0][2 * r + 1], kLog2e, -mb)) +
             ex2(fmaf(sc[1][2 * r], kLog2e, -mb)) + ex2(fmaf(sc[1][2 * r + 1], kLog2e, -mb));
      m[r] = mn;
    }
  }
  float mb[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mb[r] = m[r] * kLog2e;
    inv[r] = 1.f / quad_sum(l[r]);
  }

  // pass 2: P = exp(S - max) / sum, rounded to bf16, then O += P h
  float o[kCB / 8][4];
#pragma unroll
  for (int t = 0; t < kCB / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // ldmatrix.x4.trans row address of this lane: matrices (i 0-7, c 0-7),
  // (i 8-15, c 0-7), (i 0-7, c 8-15), (i 8-15, c 8-15)
  const int q = lane >> 3;
  const __nv_bfloat16* hl = cur + L.h_off + ((q & 1) * 8 + (lane & 7)) * L.hs + c0 + (q >> 1) * 8;
#pragma unroll 2
  for (int i0 = 0; i0 < L.np; i0 += 16) {
    float sc[2][4];
    scores(sc, cur, L, j0, i0, N, gid, tig);
    float p[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[t][e] = ex2(fmaf(sc[t][e], kLog2e, -mb[e >> 1])) * inv[e >> 1];
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const __nv_bfloat16* hrow = hl + i0 * L.hs;
#pragma unroll
    for (int t2 = 0; t2 < kCB / 16; ++t2) {
      if (16 * t2 < ncols) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, hrow + 16 * t2);
        mma_bf16(o[2 * t2], a, b[0], b[1]);
        mma_bf16(o[2 * t2 + 1], a, b[2], b[3]);
      }
    }
  }

  // epilogue, 64 channels at a time: bf16 into the warp's staging tile, then
  // 16-byte coalesced stores of whole rows
  constexpr int os = kHalf + kSkew;
#pragma unroll
  for (int half = 0; half < kCB / kHalf; ++half) {
    const int h0 = half * kHalf;
    if (h0 < ncols) {
#pragma unroll
      for (int t = 0; t < kHalf / 8; ++t) {
        if (h0 + 8 * t < ncols) {
          const int ot = half * (kHalf / 8) + t;
          *reinterpret_cast<uint32_t*>(ostage + gid * os + 8 * t + 2 * tig) =
              pack_bf16(o[ot][0], o[ot][1]);
          *reinterpret_cast<uint32_t*>(ostage + (gid + 8) * os + 8 * t + 2 * tig) =
              pack_bf16(o[ot][2], o[ot][3]);
        }
      }
      __syncwarp();
      const int chunks = min(kHalf, ncols - h0) / 8;
      for (int idx = lane; idx < 16 * chunks; idx += 32) {
        const int r = idx / chunks, cc = 8 * (idx - r * chunks);
        const int j = j0 + r, c = c0 + h0 + cc;
        if (j >= N) continue;
        const __nv_bfloat16* src = ostage + r * os + cc;
        if (vec) {
          if (c < C)
            *reinterpret_cast<uint4*>(ob + (long long)j * C + c) =
                *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && c + e < C; ++e) ob[(long long)j * C + c + e] = src[e];
        }
      }
      __syncwarp();
    }
  }
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
attention_core_bf16_kernel(const __nv_bfloat16* __restrict__ f,
                           const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ h, __nv_bfloat16* __restrict__ out,
                           long long B, int N, int CQ, int C, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const Layout L = make_layout(N, CQ, C);
  const int warp = threadIdx.x >> 5;
  __nv_bfloat16* ostage = sm + stages * L.stage + warp * kOutTile;

  {  // zero all of shared memory once: the padding is never written again
    uint4* p = reinterpret_cast<uint4*>(sm);
    const int n16 = (stages * L.stage + WARPS * kOutTile) / 8;
    for (int idx = threadIdx.x; idx < n16; idx += WARPS * 32) p[idx] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int n_cb = (L.cp + kCB - 1) / kCB;
  const int n_items = (L.np / 16) * n_cb;
  // a ring of `stages` samples: stages - 1 copies stay in flight while one computes
  for (int k = 0; k < stages - 1; ++k) {
    const long long sk = blockIdx.x + (long long)k * gridDim.x;
    if (sk < B) load_sample<WARPS>(sm + k * L.stage, L, f, g, h, sk, N, CQ, C, vec);
    cp_async_commit();
  }
  int it = 0;
  for (long long s = blockIdx.x; s < B; s += gridDim.x, ++it) {
    const long long ahead = s + (long long)(stages - 1) * gridDim.x;
    if (ahead < B)
      load_sample<WARPS>(sm + ((it + stages - 1) % stages) * L.stage, L, f, g, h, ahead, N, CQ,
                         C, vec);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();
    const __nv_bfloat16* cur = sm + (it % stages) * L.stage;
    for (int item = warp; item < n_items; item += WARPS)
      attend_item(cur, L, ostage, out + s * N * C, N, C, (item / n_cb) * 16,
                  (item % n_cb) * kCB, vec);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

constexpr int kMaxDevices = 64;

// Launch state of one kernel on one device, queried at its first launch there
// and again when the shared memory changes (the same few shapes repeat every
// train step).  Function attributes and SM counts belong to a device.
struct DeviceLaunchState {
  int smem_set, n_sm, occ_smem, per_sm;  // zero until queried
};

template <int WARPS>
int launch_bf16_warps(const void* f, const void* g, const void* h, void* out, long long B,
                      int N, int CQ, int C, const Plan& p, cudaStream_t stream) {
  static DeviceLaunchState states[kMaxDevices];
  auto kernel = attention_core_bf16_kernel<WARPS>;
  const int smem = (int)p.smem;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceLaunchState& st = states[dev];
  if (smem > st.smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    st.smem_set = smem;
  }
  if (st.n_sm == 0) {
    err = cudaDeviceGetAttribute(&st.n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem != st.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.per_sm, kernel, WARPS * 32, smem);
    if (err != cudaSuccess) return (int)err;
    st.occ_smem = smem;
  }
  if (st.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)st.n_sm * st.per_sm;
  const long long grid = B < cap ? B : cap;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  const int vec = (CQ % 8 == 0) && (C % 8 == 0) && (addr % 16 == 0);
  kernel<<<(unsigned)grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(out), B, N, CQ, C,
      p.stages, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* f, const void* g, const void* h, void* out, long long B, int N,
                int CQ, int C, cudaStream_t stream) {
  const Plan p = make_plan(N, CQ, C);
  if (p.warps == 16) return launch_bf16_warps<16>(f, g, h, out, B, N, CQ, C, p, stream);
  return launch_bf16_warps<8>(f, g, h, out, B, N, CQ, C, p, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) the kernel for this dtype takes at these sizes.
long long osga_attention_core_smem_bytes(int N, int CQ, int C, int dtype) {
  if (dtype == 0) return f32_smem_bytes(N, CQ);
  return make_plan(N, CQ, C).smem;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success),
// read right after the launch.
int osga_attention_core_fwd(const void* f, const void* g, const void* h, void* out,
                            long long B, int N, int CQ, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0) return launch_f32(f, g, h, out, B, N, CQ, C, s);
  if (dtype == 1) return launch_bf16(f, g, h, out, B, N, CQ, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* osga_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
