// Mamba2 SSD intra-chunk block for Hopper (sm_90a), f32, CUDA C++ on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` / `_ssd_intra_kernel`
// of src/repro/kernels/ssd_scan/ssd_scan.py (:39, body :22) for f32
// inputs; bf16 inputs take the tensor-core kernel of ssd_intra_tc.cu
// (TF32 tensor cores would miss the f32 tolerance of 1e-4).  For every
// (batch b, chunk c, head h):
//
//     y[i] = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * x_j,
//     cs   = cumsum(a) along the chunk,
//
// with x, y (b, c, q, h, p), a (b, h, c, q) in f32, and B, C (b, c, q, n)
// shared by every head (n_groups = 1).  Everything is accumulated in f32.
//
// Bound on the H100: at the zamba2-1.2b prefill shape (b=8, c=16, q=128,
// h=64, p=64, n=64) in f32 the function moves ~553 MB: ~0.165 ms at
// 3.35 TB/s; its causal products are ~8.8 GFLOP, ~0.13 ms at the f32 rate
// of the CUDA cores.  The model that runs this kernel is the reduced f32
// hybrid; the full-width model is bf16.
//
// Design:
// * The TPU grid is (b, c, h), one score tile C.B^T per grid step.  Here a
//   block owns one (b, c) and a group of kHeadsPerBlock heads: it builds
//   the causal score tile S = C.B^T once in shared memory and reuses it
//   for each of its heads, which removes the TPU design's recomputation of
//   S for every head (B and C do not depend on the head).
// * The cumulative sums of a for the block's heads are warp scans (one
//   warp per head, fixed order) done once at the start.
// * Per head: the decayed tile W = S o exp(cs_i - cs_j) on the lower
//   triangle.  The mask j <= i is tested BEFORE exp: above the diagonal
//   cs_i - cs_j > 0 can overflow to inf, and inf * 0 would make NaN.
// * Both products run in f32 on the CUDA cores in 4 x 4 register tiles
//   fed by 16-byte shared-memory loads (C, B, S and W are stored
//   k-major / j-major for that), and stop at the diagonal.
// * Shared memory at q=128, n=64, p=64: B and C 64 KB (x reuses their
//   space), S and W 64 KB each, the sums 4 KB: ~196 KB in all, above
//   48 KB, so the launch sets cudaFuncAttributeMaxDynamicSharedMemorySize
//   first.  One block fits on an SM; its 16 warps hide the latency.
// * Sums run in a fixed order with no atomics: a rerun is bit-identical.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kHeadsPerBlock = 8;  // <= kThreads / 32: one scan warp each
constexpr int kT = 4;              // register tiles are kT x kT

size_t region0_floats(int q, int p, int n) {
  const size_t bc = 2 * static_cast<size_t>(n) * q;
  const size_t xs = static_cast<size_t>(q) * p;
  return bc > xs ? bc : xs;
}

size_t smem_bytes(int q, int p, int n) {
  return (region0_floats(q, p, n) + 2 * static_cast<size_t>(q) * q +
          static_cast<size_t>(kHeadsPerBlock) * q) * sizeof(float);
}

__device__ __forceinline__ void fma4x4(float (&acc)[kT][kT], const float4 r,
                                       const float4 c) {
  const float rv[kT] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    acc[i][0] = fmaf(rv[i], c.x, acc[i][0]);
    acc[i][1] = fmaf(rv[i], c.y, acc[i][1]);
    acc[i][2] = fmaf(rv[i], c.z, acc[i][2]);
    acc[i][3] = fmaf(rv[i], c.w, acc[i][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     T* __restrict__ y, int nc, int q, int h, int p, int n,
                     int r0) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;          // n x q: Ct[k*q + i] = C_i[k]
  float* Bt = smem + n * q;  // n x q: Bt[k*q + j] = B_j[k]
  float* xs = smem;          // q x p, once S is built (reuses C, B)
  float* St = smem + r0;     // q x q: St[j*q + i] = C_i . B_j, j <= i
  float* Wt = St + q * q;    // q x q: Wt[j*q + i] = S_ij exp(cs_i - cs_j)
  float* cs = Wt + q * q;    // kHeadsPerBlock x q: cumsums of a

  const int bc = blockIdx.x;  // b * nc + c
  const int bi = bc / nc, ci = bc % nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long row0 = static_cast<long long>(bc) * q;  // (b, c, 0) row
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int nh = min(h, h0 + kHeadsPerBlock) - h0;

  // 1. the block's cumsums of a: one warp per head, 32 steps at a time
  if (warp < nh) {
    const float* ah =
        a + ((static_cast<long long>(bi) * h + h0 + warp) * nc + ci) * q;
    float carry = 0.f;
    for (int base = 0; base < q; base += 32) {
      float v = base + lane < q ? ah[base + lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (base + lane < q) cs[warp * q + base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  // 2. C and B of the chunk -> shared f32, k-major
  for (int e = tid; e < q * n; e += blockDim.x) {
    const int i = e % q, k = e / q;
    Ct[k * q + i] = repro::to_f32(Cm[(row0 + i) * n + k]);
    Bt[k * q + i] = repro::to_f32(Bm[(row0 + i) * n + k]);
  }
  __syncthreads();
  // 3. S = C B^T on the causal lower triangle: 4 x 4 tiles (ti, tj) with
  //    tj <= ti, enumerated row by row
  const int nt = q / kT;
  for (int t = tid; t < nt * (nt + 1) / 2; t += blockDim.x) {
    int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    while (ti * (ti + 1) / 2 > t) --ti;
    const int tj = t - ti * (ti + 1) / 2;
    const int i0 = ti * kT, j0 = tj * kT;
    float acc[kT][kT] = {};  // acc[j][i]
    for (int k = 0; k < n; ++k)
      fma4x4(acc, *reinterpret_cast<const float4*>(&Bt[k * q + j0]),
             *reinterpret_cast<const float4*>(&Ct[k * q + i0]));
#pragma unroll
    for (int jj = 0; jj < kT; ++jj) {
      float4 o;
      o.x = j0 + jj <= i0 + 0 ? acc[jj][0] : 0.f;
      o.y = j0 + jj <= i0 + 1 ? acc[jj][1] : 0.f;
      o.z = j0 + jj <= i0 + 2 ? acc[jj][2] : 0.f;
      o.w = j0 + jj <= i0 + 3 ? acc[jj][3] : 0.f;
      *reinterpret_cast<float4*>(&St[(j0 + jj) * q + i0]) = o;
    }
  }
  __syncthreads();  // C and B are dead: x takes their space below

  const int col_groups = p / kT;
  const int tiles = nt * col_groups;
  for (int hl = 0; hl < nh; ++hl) {
    const int hh = h0 + hl;
    const float* csh = cs + hl * q;
    for (int e = tid; e < q * p; e += blockDim.x) {
      const int t = e / p, pp = e % p;
      xs[t * p + pp] = repro::to_f32(x[((row0 + t) * h + hh) * p + pp]);
    }
    for (int e = tid; e < q * q; e += blockDim.x) {
      const int j = e / q, i = e % q;
      // mask first: exp of cs_i - cs_j > 0 above the diagonal overflows
      Wt[e] = j <= i ? St[e] * expf(csh[i] - csh[j]) : 0.f;
    }
    __syncthreads();
    // y = W x: a thread owns rows i0..i0+3 and columns c0..c0+3
    for (int tile = tid; tile < tiles; tile += blockDim.x) {
      const int i0 = (tile / col_groups) * kT;
      const int c0 = (tile % col_groups) * kT;
      float acc[kT][kT] = {};  // acc[i][c]
      for (int j = 0; j < i0 + kT; ++j)  // W is 0 beyond the diagonal
        fma4x4(acc, *reinterpret_cast<const float4*>(&Wt[j * q + i0]),
               *reinterpret_cast<const float4*>(&xs[j * p + c0]));
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        T* yr = y + ((row0 + i0 + r) * h + hh) * p + c0;
#pragma unroll
        for (int cc = 0; cc < kT; ++cc)
          yr[cc] = repro::from_f32<T>(acc[r][cc]);
      }
    }
    __syncthreads();  // the next head overwrites x and W
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* B, const void* C,
           void* y, int b, int c, int q, int h, int p, int n, void* stream) {
  if (b <= 0 || c <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || q % kT ||
      p % kT)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(q, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * c, (h + kHeadsPerBlock - 1) / kHeadsPerBlock);
  ssd_intra_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      c, q, h, p, n, static_cast<int>(region0_floats(q, p, n)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_intra_chunk_f32(const void* x, const void* a,
                                   const void* B, const void* C, void* y,
                                   int b, int c, int q, int h, int p, int n,
                                   void* stream) {
  return launch<float>(x, a, B, C, y, b, c, q, h, p, n, stream);
}
