// Mamba2 SSD intra-chunk block for Hopper (sm_90a), bf16, on the tensor
// cores: CUDA C++ with mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` / `_ssd_intra_kernel`
// of src/repro/kernels/ssd_scan/ssd_scan.py (:39, body :22) for bf16
// inputs; f32 inputs keep the CUDA-core kernel of ssd_intra.cu (TF32
// would miss the f32 tolerance).  For every (batch b, chunk c, head h):
//
//     y[i] = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * x_j,
//     cs   = cumsum(a) along the chunk,
//
// with x, y (b, c, q, h, p) bf16, a (b, h, c, q) f32, and B, C (b, c, q, n)
// bf16 shared by every head (n_groups = 1).
//
// Bound on the H100: at the zamba2-1.2b prefill shape (b=8, c=16, q=128,
// h=64, p=64, n=64) the function moves ~277 MB (x in, y out, plus a, B,
// C): ~0.083 ms at 3.35 TB/s.  Its causal products are ~8.8 GFLOP,
// ~0.009 ms at the dense bf16 tensor-core rate, so bytes bound it; on the
// CUDA cores in f32 (the first design) the products alone took longer
// than the bytes.  The design is FlashAttention's forward pass with the
// decay in place of the softmax:
//
// * Work unit: a block of 4 warps owns one (b, c) and up to 16 heads, and
//   walks (head, 64-column chunk of p) units.  The chunk's C and B rows
//   (q x n each) are staged once in shared memory; each unit's x tile
//   (q x 64) streams through a two-stage cp.async ring, so the next
//   unit's x is in flight while this one computes.  Rows are padded by 16
//   bytes, so ldmatrix reads hit 32 distinct banks.  Shared memory at
//   q = 128, n = 64: C and B 36 KB, the ring 36 KB, the y tile 18 KB, the
//   cumsums 8 KB: 98 KB, two blocks per SM.
// * The block's a rows arrive by cp.async ahead of C, B and x; their
//   cumsums are warp scans in a fixed order, done once in place and kept
//   in log2 units, so a decay is one ex2.approx.
// * Measured on the H100 against this design (PERF.md): a third ring
//   stage, storing y straight from registers, bulk async copies of y, a
//   double-buffered y tile, S for the next key block issued ahead of
//   this one's product, 8 warps each on half of the columns, plain loads
//   of a before the first unit, and 8 heads per block all ran slower.
//   What limits it now looks like the ldmatrix traffic: every 16-row
//   block reads B_j and x_j again; wgmma would read x once per 64 rows.
// * A warp owns 16-row blocks i of the output and walks the key blocks
//   j <= i: S_ij = C_i . B_j^T (16 x 16, depth n) by mma with C_i's
//   fragments held in registers; the decay is applied with the mask
//   j <= i tested BEFORE exp (above the diagonal cs_i - cs_j > 0 can
//   overflow to inf, and inf * 0 would be NaN); the f32 accumulator is
//   packed into bf16 A fragments in registers (the m16n8k16 C layout is
//   the A layout) and multiplied by x_j (ldmatrix.trans) into y_i in f32.
//   S is recomputed per head: it costs about as many MMAs as the product
//   with x, and keeps S and the decayed tile out of shared memory.
// * The triangle is balanced: row blocks i and nb - 1 - i go to the same
//   warp, so every warp carries nb + 1 key blocks.
// * y goes through shared memory and out in 16-byte stores.
// * Numerics: only the decayed scores are rounded to bf16 before the
//   second product (FlashAttention's P.V does the same); every sum is f32
//   and runs in a fixed order with no atomics, so a rerun is bit-identical.
// * Shapes: any q, p and n.  Rows past q, columns of x past p and depth
//   past n are zero-filled in shared memory by the kernel.  The copies are
//   16-byte cp.async when n and p are multiples of 8, element loads
//   otherwise (a always goes by cp.async: q is a multiple of 4).  n <= 128 keeps C_i in registers; a larger n reads it from
//   shared memory at every step.

#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeadsPerBlock = 16;
constexpr int kCols = 64;              // columns of x and y per unit
constexpr int kXS = kCols + 8;         // row stride of the x and y tiles
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory layout, the same on host and device
struct Smem {
  int qp;  // q rounded up to 16
  int np;  // depth of C.B^T rounded up to the k-steps
  int ns;  // row stride of C and B (np + 8)
  __host__ __device__ Smem(int q, int n, int ks) {
    qp = (q + 15) / 16 * 16;
    np = ks > 0 ? 16 * ks : (n + 15) / 16 * 16;
    ns = np + 8;
  }
  __host__ __device__ int cs_floats() const { return kHeadsPerBlock * qp; }
  __host__ __device__ int bc_elems() const { return qp * ns; }
  __host__ __device__ int x_elems() const { return qp * kXS; }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(cs_floats()) * 4 +
           (2 * static_cast<size_t>(bc_elems()) +
            (kStages + 1) * static_cast<size_t>(x_elems())) *
               2;
  }
};

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- one 16-row block of one unit ------------------------------------------

// y_i (16 x 64) of row block ib into the y tile.  Fragment layouts of
// m16n8k16 (lane = 4 g + t): A holds (g | g+8, 2t..2t+1 | 2t+8..2t+9), B
// (k 2t..2t+1 | 2t+8..2t+9, n g), C (g | g+8, 2t..2t+1).
template <int KS>
__device__ __forceinline__ void row_block(int ib, const bf16* Cs,
                                          const bf16* Bs, const bf16* xt,
                                          const float* csh, bf16* ys,
                                          const Smem& L, int pw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kRegK = KS > 0 ? KS : 1;
  uint32_t cf[kRegK][4];
  const bf16* c_row = Cs + (ib * 16 + (lane & 15)) * L.ns + (lane >> 4) * 8;
  if constexpr (KS > 0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(cf[ks], c_row + ks * 16);
  }
  float acc[kCols / 8][4] = {};
  const float cs_r0 = csh[ib * 16 + g], cs_r1 = csh[ib * 16 + g + 8];
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * L.ns +
                    ((lane >> 3) & 1) * 8;
  for (int jb = 0; jb <= ib; ++jb) {
    // S_ij = C_i . B_j^T: two 16 x 8 tiles
    float s[2][4] = {};
    const bf16* b_row = Bs + jb * 16 * L.ns + b_off;
    if constexpr (KS > 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, b_row + ks * 16);
        mma(s[0], cf[ks], b[0], b[1]);
        mma(s[1], cf[ks], b[2], b[3]);
      }
    } else {
      for (int ks = 0; ks < L.np / 16; ++ks) {
        uint32_t b[4];
        ldsm_x4(cf[0], c_row + ks * 16);
        ldsm_x4(b, b_row + ks * 16);
        mma(s[0], cf[0], b[0], b[1]);
        mma(s[1], cf[0], b[2], b[3]);
      }
    }
    // decay, masked before exp on the diagonal block, then bf16 A fragments
    const float2 cj0 = *reinterpret_cast<const float2*>(csh + jb * 16 + 2 * t);
    const float2 cj1 =
        *reinterpret_cast<const float2*>(csh + jb * 16 + 8 + 2 * t);
    const float cj[2][2] = {{cj0.x, cj0.y}, {cj1.x, cj1.y}};
    float w[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = g + 8 * (e >> 1);          // row within the block
        const int cj_ = nt * 8 + 2 * t + (e & 1);  // column within it
        const float d = (e >> 1 ? cs_r1 : cs_r0) - cj[nt][e & 1];
        w[nt][e] = (jb < ib || cj_ <= ri) ? s[nt][e] * exp2_approx(d) : 0.f;
      }
    }
    const uint32_t pf[4] = {pack_bf16(w[0][0], w[0][1]),
                            pack_bf16(w[0][2], w[0][3]),
                            pack_bf16(w[1][0], w[1][1]),
                            pack_bf16(w[1][2], w[1][3])};
    // y_i += P_ij . x_j, 16 columns of x per ldmatrix
    const bf16* x_row = xt + (jb * 16 + (lane & 15)) * kXS + (lane >> 4) * 8;
#pragma unroll
    for (int c16 = 0; c16 < kCols / 16; ++c16) {
      if (c16 * 16 < pw) {
        uint32_t b[4];
        ldsm_x4_t(b, x_row + c16 * 16);
        mma(acc[2 * c16], pf, b[0], b[1]);
        mma(acc[2 * c16 + 1], pf, b[2], b[3]);
      }
    }
  }
  bf16* y0 = ys + (ib * 16 + g) * kXS + 2 * t;
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(y0 + nt * 8) = pack_bf16(acc[nt][0],
                                                          acc[nt][1]);
    *reinterpret_cast<uint32_t*>(y0 + 8 * kXS + nt * 8) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// ---- the kernel ---------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, bf16* __restrict__ y,
                        int nc, int q, int h, int p, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem L(q, n, KS);
  float* cs = reinterpret_cast<float*>(smem_raw);  // heads x qp: a, then
                                                   // cumsums in log2 units
  bf16* Cs = reinterpret_cast<bf16*>(cs + L.cs_floats());
  bf16* Bs = Cs + L.bc_elems();
  bf16* xs = Bs + L.bc_elems();  // kStages x (qp x kXS)
  bf16* ys = xs + kStages * L.x_elems();

  const int bc = blockIdx.x;  // b * nc + c
  const int bi = bc / nc, ci = bc % nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(bc) * q;  // (b, c, 0) row
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int nh = min(h, h0 + kHeadsPerBlock) - h0;
  const int n_pc = (p + kCols - 1) / kCols;  // column chunks per head
  const int units = nh * n_pc;
  const bool vec = n % 8 == 0 && p % 8 == 0;
  const bf16 zero = __float2bfloat16(0.f);

  // x tile of unit u (head u / n_pc, columns from 64 (u % n_pc)) -> stage
  auto load_unit = [&](int u, int stage) {
    if (u >= units) return;
    const int hh = h0 + u / n_pc, c0 = (u % n_pc) * kCols;
    bf16* dst = xs + stage * L.x_elems();
    if (vec) {
      for (int e = tid; e < L.qp * (kCols / 8); e += kThreads) {
        const int r = e >> 3, cc = (e & 7) * 8;
        const bool ok = r < q && c0 + cc < p;
        const long long off = ok ? ((row0 + r) * h + hh) * p + c0 + cc : 0;
        cp_async16(dst + r * kXS + cc, x + off, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < L.qp * kCols; e += kThreads) {
        const int r = e / kCols, cc = e % kCols;
        const bool ok = r < q && c0 + cc < p;
        dst[r * kXS + cc] = ok ? x[((row0 + r) * h + hh) * p + c0 + cc] : zero;
      }
    }
  };

  // 1. the a rows of the block's heads (one group), then C and B of the
  //    chunk (zero past q rows and n columns) with the first x tile; the
  //    cumsums once the a rows have landed
  for (int e = tid; e < nh * (L.qp / 4); e += kThreads) {
    const int hl = e / (L.qp / 4), k = (e % (L.qp / 4)) * 4;
    const bool ok = k < q;  // past q: 0, so cs past q repeats cs[q-1]
    const long long off =
        ok ? ((static_cast<long long>(bi) * h + h0 + hl) * nc + ci) * q + k : 0;
    cp_async16(cs + hl * L.qp + k, a + off, ok ? 16 : 0);
  }
  cp_async_commit();
  if (vec) {
    const int cpr = L.np / 8;  // 16-byte pieces per row
    for (int e = tid; e < L.qp * cpr; e += kThreads) {
      const int r = e / cpr, k = (e % cpr) * 8;
      const bool ok = r < q && k < n;
      const long long off = ok ? (row0 + r) * n + k : 0;
      cp_async16(Cs + r * L.ns + k, Cm + off, ok ? 16 : 0);
      cp_async16(Bs + r * L.ns + k, Bm + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < L.qp * L.np; e += kThreads) {
      const int r = e / L.np, k = e % L.np;
      const bool ok = r < q && k < n;
      Cs[r * L.ns + k] = ok ? Cm[(row0 + r) * n + k] : zero;
      Bs[r * L.ns + k] = ok ? Bm[(row0 + r) * n + k] : zero;
    }
  }
  for (int st = 0; st < kStages - 1; ++st) {
    load_unit(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();  // the a rows landed
  for (int hl = warp; hl < nh; hl += kWarps) {
    float carry = 0.f;
    for (int base = 0; base < L.qp; base += 32) {
      float v = base + lane < L.qp ? cs[hl * L.qp + base + lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (base + lane < L.qp) cs[hl * L.qp + base + lane] = v * kLog2e;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  // 2. the units: compute from one stage while the next fills
  const int nb = L.qp / 16;  // row blocks
  for (int u = 0; u < units; ++u) {
    const int hl = u / n_pc, c0 = (u % n_pc) * kCols;
    const int pw = min(kCols, p - c0);
    const bf16* xt = xs + (u % kStages) * L.x_elems();
    cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u landed; unit u - 1's stage and y are done
    load_unit(u + kStages - 1, (u + kStages - 1) % kStages);
    cp_async_commit();
    for (int pi = warp; pi < (nb + 1) / 2; pi += kWarps) {
      row_block<KS>(pi, Cs, Bs, xt, cs + hl * L.qp, ys, L, pw, lane);
      if (nb - 1 - pi != pi)
        row_block<KS>(nb - 1 - pi, Cs, Bs, xt, cs + hl * L.qp, ys, L, pw,
                      lane);
    }
    __syncthreads();  // the y tile is complete
    const int hh = h0 + hl;
    if (vec) {
      for (int e = tid; e < q * (kCols / 8); e += kThreads) {
        const int r = e >> 3, cc = (e & 7) * 8;
        if (cc < pw)
          *reinterpret_cast<uint4*>(y + ((row0 + r) * h + hh) * p + c0 + cc) =
              *reinterpret_cast<const uint4*>(ys + r * kXS + cc);
      }
    } else {
      for (int e = tid; e < q * pw; e += kThreads) {
        const int r = e / pw, cc = e % pw;
        y[((row0 + r) * h + hh) * p + c0 + cc] = ys[r * kXS + cc];
      }
    }
  }
}

template <int KS>
int launch_ks(const void* x, const void* a, const void* B, const void* C,
              void* y, int b, int c, int q, int h, int p, int n,
              cudaStream_t stream) {
  auto kern = ssd_intra_tc_kernel<KS>;
  const size_t smem = Smem(q, n, KS).bytes();
  static std::atomic<unsigned long long> allowed{0};
  // the limit is raised to the most a block may ask for, once per device;
  // a launch asking for more is refused and reported by cudaGetLastError
  cudaError_t err = repro::allow_dynamic_smem(kern, 232448, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * c, (h + kHeadsPerBlock - 1) / kHeadsPerBlock);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<bf16*>(y), c, q, h, p, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_intra_chunk_bf16(const void* x, const void* a,
                                    const void* B, const void* C, void* y,
                                    int b, int c, int q, int h, int p, int n,
                                    void* stream) {
  if (b <= 0 || c <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || q % 4)
    return static_cast<int>(cudaErrorInvalidValue);  // a rows go 16 bytes
                                                     // at a time
  const auto st = static_cast<cudaStream_t>(stream);
  const int steps = (n + 15) / 16;  // k-steps of C.B^T
  if (steps <= 1) return launch_ks<1>(x, a, B, C, y, b, c, q, h, p, n, st);
  if (steps <= 2) return launch_ks<2>(x, a, B, C, y, b, c, q, h, p, n, st);
  if (steps <= 4) return launch_ks<4>(x, a, B, C, y, b, c, q, h, p, n, st);
  if (steps <= 8) return launch_ks<8>(x, a, B, C, y, b, c, q, h, p, n, st);
  return launch_ks<0>(x, a, B, C, y, b, c, q, h, p, n, st);
}
