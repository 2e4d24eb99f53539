// One-token GQA attention over a KV cache (flash decode) for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_decode` / `_flash_decode_kernel`
// of src/repro/kernels/flash_attn/flash_attn.py (:61, body :26).  For
// every (batch b, head h), with kv head h / (H / Hkv):
//
//     out = softmax_j(mask(softcap(q . k_j * Dh^-0.5))) . v_j,
//     mask: j <= pos[b] and, when window > 0, j > pos[b] - window,
//
// q (B, H, Dh), k and v (B, S, Hkv, Dh), pos (B,) int32, out (B, H, Dh) in
// q's dtype.  Repeated KV heads are never materialised.
//
// Bound on the H100: the function reads K and V once.  At the zamba2-1.2b
// decode shape (B=8, S=2112, Hkv=H=32, Dh=64, bf16) that is ~69 MB:
// ~0.021 ms at 3.35 TB/s, against ~70 MFLOP.  Bytes bound it.
//
// Design (simple and right first):
// * One block per (b, h) of kWarps warps.  Only the keys the mask admits
//   are read: the range [max(0, pos - window + 1), min(pos, S - 1)], which
//   also covers a ragged S tail and pos = 0.  A row whose mask admits no
//   key gives the uniform mean of v, as the plain version's softmax over
//   logits that are all -1e30 does.
// * The warps take 32-key tiles in turn.  In a tile each lane owns one key
//   and computes q . k with 16-byte loads; the warp then updates its
//   online softmax (running max, denominator, and an f32 accumulator in
//   which each lane owns Dh/32 dimensions of v).
// * The warps' partial results are combined in a fixed order in shared
//   memory; no atomics, so a rerun is bit-identical.
// * The TPU kernel keeps its running accumulator in q's dtype and so
//   rounds it to bf16 between S tiles (flash_attn.py:55-58).  This kernel
//   accumulates in f32 and rounds once at the end, so it is closer to the
//   plain version than the TPU kernel is.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// q . row over 16 bytes of the key row (4 f32 or 8 bf16 values)
__device__ __forceinline__ float dot16(const uint4& u, const float* qd,
                                       float s, float) {
  s = fmaf(qd[0], __uint_as_float(u.x), s);
  s = fmaf(qd[1], __uint_as_float(u.y), s);
  s = fmaf(qd[2], __uint_as_float(u.z), s);
  return fmaf(qd[3], __uint_as_float(u.w), s);
}

__device__ __forceinline__ float dot16(const uint4& u, const float* qd,
                                       float s, __nv_bfloat16) {
  const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pr[i]);
    s = fmaf(qd[2 * i], f.x, s);
    s = fmaf(qd[2 * i + 1], f.y, s);
  }
  return s;
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int H, int S, int Hkv,
                        int window, float scale, float softcap) {
  constexpr int Dh = 32 * DPL;
  constexpr int kPer16 = 16 / sizeof(T);  // values per 16-byte load
  __shared__ __align__(16) float qs[Dh];
  __shared__ float wm[kWarps], wl[kWarps];
  __shared__ float wacc[kWarps][Dh];

  const int bh = blockIdx.x;
  const int b = bh / H, hq = bh % H;
  const int kvh = hq / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    qs[d] = repro::to_f32(q[static_cast<long long>(bh) * Dh + d]);
  __syncthreads();

  const int p = pos[b];
  long long lo = window > 0 ? static_cast<long long>(p) - window + 1 : 0;
  lo = lo > 0 ? lo : 0;
  long long hi = p < S - 1 ? p : S - 1;
  const bool uniform = lo > hi;  // the mask admits no key
  if (uniform) {
    lo = 0;
    hi = S - 1;
  }
  const long long row = static_cast<long long>(Hkv) * Dh;  // key stride
  const T* kb = k + (static_cast<long long>(b) * S * Hkv + kvh) * Dh;
  const T* vb = v + (static_cast<long long>(b) * S * Hkv + kvh) * Dh;

  float m = -INFINITY, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

  for (long long t0 = lo + 32LL * warp; t0 <= hi; t0 += 32LL * kWarps) {
    const long long j = t0 + lane;
    const bool valid = j <= hi;
    float s = -INFINITY;
    if (valid) {
      if (uniform) {
        s = 0.f;
      } else {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + j * row);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < Dh / kPer16; ++c)
          dot = dot16(__ldg(kr + c), qs + c * kPer16, dot, T());
        s = dot * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      }
    }
    const float m_new = fmaxf(m, warp_max(s));  // lane 0's key is valid
    const float pj = valid ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);  // 0 on the first tile
    l = l * corr + warp_sum(pj);
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= corr;
    const int cnt = hi - t0 + 1 < 32 ? static_cast<int>(hi - t0 + 1) : 32;
    const T* vr = vb + t0 * row + lane * DPL;
#pragma unroll 4
    for (int jj = 0; jj < cnt; ++jj) {
      const float pw = __shfl_sync(kFull, pj, jj);
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[d] = fmaf(pw, repro::to_f32(__ldg(vr + jj * row + d)), acc[d]);
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) wacc[warp][lane * DPL + d] = acc[d];
  __syncthreads();

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // fixed order
      if (wm[w] == -INFINITY) continue;  // this warp saw no key
      const float f = expf(wm[w] - M);
      L = fmaf(wl[w], f, L);
      A = fmaf(wacc[w][d], f, A);
    }
    out[static_cast<long long>(bh) * Dh + d] =
        repro::from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DPL>
int launch_dpl(const void* q, const void* k, const void* v, const void* pos,
               void* out, int B, int H, int S, int Hkv, int window,
               float scale, float softcap, cudaStream_t stream) {
  flash_decode_kernel<T, DPL><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), H, S, Hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int H, int S, int Hkv, int Dh, int window,
           float scale, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return launch_dpl<T, 1>(q, k, v, pos, out, B, H, S, Hkv, window, scale,
                              softcap, st);
    case 64:
      return launch_dpl<T, 2>(q, k, v, pos, out, B, H, S, Hkv, window, scale,
                              softcap, st);
    case 128:
      return launch_dpl<T, 4>(q, k, v, pos, out, B, H, S, Hkv, window, scale,
                              softcap, st);
    case 256:
      return launch_dpl<T, 8>(q, k, v, pos, out, B, H, S, Hkv, window, scale,
                              softcap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* pos, void* out, int B, int H,
                                int S, int Hkv, int Dh, int window,
                                float scale, float softcap, void* stream) {
  return launch<float>(q, k, v, pos, out, B, H, S, Hkv, Dh, window, scale,
                       softcap, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* out, int B, int H,
                                 int S, int Hkv, int Dh, int window,
                                 float scale, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, pos, out, B, H, S, Hkv, Dh, window,
                               scale, softcap, stream);
}
