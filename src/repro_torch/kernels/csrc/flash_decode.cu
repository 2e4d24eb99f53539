// One-token GQA attention over a KV cache (flash decode) for Hopper
// (sm_90a), CUDA C++: a split-S kernel and a merge kernel.
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
// Bound on the H100: the function reads the K and V rows the mask admits
// once each.  At the zamba2-1.2b decode shape (B=8, S=2112, Hkv=H=32,
// Dh=64, bf16, pos = S - 1) that is 2 x 69.2 MB = 138.5 MB: 0.0413 ms at
// 3.35 TB/s, against ~70 MFLOP.  Bytes bound it, so the design is about
// keeping enough bytes in flight on every SM.
//
// Design:
// * Split S across blocks.  Grid (n_split, Hkv x head groups, B).  The
//   keys are cut into chunks of 64 and dealt to the splits in turn: split
//   s owns chunks s, s + n_split, s + 2 n_split, ...  So whatever `pos`
//   admits, every split gets the same number of admitted chunks to within
//   one, and the grid stays balanced from pos = 0 to pos = S - 1 (with
//   contiguous ranges of S per split, the splits past pos sit idle while
//   the others carry the row).  The host plans n_split from the shapes
//   and the SM count alone (kernels/flash_attn/flash_attn.py::split_plan):
//   no more splits than fill the card in one wave of resident blocks, and
//   a count that deals the chunks out evenly.  The launch reads nothing
//   from the device and can be captured in a CUDA graph.  Each block cuts
//   its chunks to the key range the mask admits, read from `pos` on the
//   device; a block left with no key writes an empty partial (m = -inf,
//   l = 0).  A row whose mask admits no key gives the uniform mean of v,
//   as the plain version's softmax over logits that are all -1e30 does:
//   every split then takes its keys with logit 0.
// * One block serves RB query heads of one kv head (RB = the GQA ratio
//   rounded up to 1, 2, 4 or 8), so K and V are read from device memory
//   once per kv head (once per 8 query heads above a ratio of 8).
// * K and V tiles of 4 KB each are staged into shared memory by
//   `cp.async` 16-byte copies in a ring of two stages (16 KB; registers
//   limit an SM to eight blocks).  Each stage has an `mbarrier` whose
//   phase completes when every thread's copies for that stage have landed
//   (`cp.async.mbarrier.arrive.noinc`), so the next tile is in flight
//   while the current one is scored.  (Three and four stages measured
//   slower: with 768 blocks resident, more bytes in flight only queue.)
//   Keys outside the block's range are zero-filled by the copy itself.
//   Two block barriers per tile: the logits alternate between two
//   buffers, and a stage is refilled once every thread has passed the
//   next tile's first barrier.
// * Scoring: kG lanes share one key row, each with 16-byte shared loads
//   and its slice of every query head held in registers; a shuffle tree
//   sums the slices.  Then one warp per head updates the online softmax
//   (running max, denominator, f32), and each warp accumulates p . v for
//   its share of the tile's keys with lanes owning Dh / 32 dimensions.
// * Head dims 32, 64, 96, 128 and 256.  Dh = 96 (phi-3-vision) is no power
//   of two: a key row is 12 (bf16) or 24 (f32) 16-byte chunks, so kG is
//   the largest power of two that divides the chunk count (4 or 8) and
//   each lane takes 3 chunks; the tile is 32 (bf16) or 16 (f32) keys of
//   6 KB, still a divisor of a chunk; in p . v each lane owns 3
//   dimensions, loaded one value at a time.  The cache is read as it
//   lies, unpadded.  At power-of-two Dh every count is what it was.
// * The warps' accumulators are summed in a fixed order into a partial
//   (m, l, acc[Dh]) in f32, written to a scratch buffer that the wrapper
//   allocates.  A second, small kernel merges the splits of each (b, h) in
//   split order and writes the output in q's dtype; it is launched as a
//   programmatic dependent, so it is launched while the splits drain and
//   starts as soon as they end.  The kernels use no atomics, so a rerun
//   is bit-identical.
// * The TPU kernel keeps its running accumulator in q's dtype and so
//   rounds it to bf16 between S tiles (flash_attn.py:55-58).  These
//   kernels accumulate in f32 and round once at the end, so they are
//   closer to the plain version than the TPU kernel is.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

// ---- asynchronous copies and mbarriers (PTX) ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// 16 bytes from global to shared memory; src_bytes = 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on `bar` once all of this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- loads and reductions --------------------------------------------------

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

// 32-bit words -> floats: one float per word, or two bf16 (low half first)
__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  out[0] = f.x;
  out[1] = f.y;
}

// N consecutive values of type T as floats.  Where N * sizeof(T) is a
// power of two (the address aligned to it), with the widest loads that fit;
// else (Dh = 96: 3 values a lane) one value at a time, which assumes no
// alignment beyond T's own
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  if constexpr ((kBytes & (kBytes - 1)) != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = repro::to_f32(p[i]);
  } else if constexpr (kBytes < 4) {
    out[0] = repro::to_f32(p[0]);
  } else {
    uint32_t w[kBytes / 4];
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) unpack(w[i], out + i * kPerWord, T());
  }
}

// the largest power of two that is at most n (n >= 1)
constexpr int pow2_floor(int n) {
  return n & (n - 1) ? pow2_floor(n & (n - 1)) : n;
}

// ---- the split kernel ------------------------------------------------------

template <typename T, int DH, int RB>
struct Cfg {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kCPR = kRowBytes / 16;  // 16-byte chunks per key row
  // lanes per key in scoring: the largest power of two dividing kCPR, at
  // most 32 (kCPR itself when Dh is a power of two; 4 in bf16 and 8 in f32
  // at Dh = 96, each lane then taking 3 chunks), so the shuffle tree holds
  static constexpr int kLow = kCPR & -kCPR;
  static constexpr int kG = kLow < 32 ? kLow : 32;
  static constexpr int kCPT = kCPR / kG;            // chunks per lane
  static constexpr int kVals = 16 / static_cast<int>(sizeof(T));
  static constexpr int kKPP = kThreads / kG;  // keys per scoring pass
  static constexpr int kRaw = 4096 / kRowBytes;
  // ~4 KB of keys, a power of two in [16, 64] (so it divides a 64-key
  // chunk) and a multiple of kKPP: 32 keys at Dh = 96 in bf16, 16 in f32
  static constexpr int kPow =
      pow2_floor(kRaw > 64 ? 64 : (kRaw < 16 ? 16 : kRaw));
  static constexpr int kTile = kPow > kKPP ? kPow : kKPP;
  static constexpr int kDPL = DH / 32;  // dims per lane in p . v (3 at 96)
  static constexpr int kTileElems = kTile * DH;
  static constexpr int kCopies = kTile * kCPR / kThreads;  // per tensor
  static constexpr int kKvBytes = kStages * 2 * kTileElems * sizeof(T);
  static constexpr int kSsBytes = 2 * RB * kTile * 4;  // two tiles' logits
  static constexpr int kStatBytes = (3 * RB * 4 + 7) / 8 * 8;
  static constexpr int kRedBytes = kWarps * RB * DH * 4;  // aliases K/V
  static constexpr int kSmem = kKvBytes + kSsBytes + kStatBytes + kStages * 8;
  static_assert(DH % 32 == 0 && kRowBytes % 16 == 0, "head dim");
  static_assert(64 % kTile == 0, "a tile divides a chunk");
  static_assert(kTile % kKPP == 0 && kTile % kWarps == 0, "tile");
  static_assert(kTile * kCPR % kThreads == 0, "copies");
  static_assert(kRedBytes <= kKvBytes, "reduction buffer");
};

template <typename T, int DH, int RB>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ pos,
                              float* __restrict__ part, int H, int S,
                              int Hkv, int n_groups, int chunk,
                              int n_split, int window, float scale,
                              float softcap) {
  using C = Cfg<T, DH, RB>;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int h0 = kvh * rep + grp * RB;  // first query head of this block
  const int nh = rep - grp * RB < RB ? rep - grp * RB : RB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // partial record of head h0 + r: [m, l, acc[DH]]
  float* rec = part + ((static_cast<long long>(b) * H + h0) * n_split + split) *
                          (DH + 2);
  const long long rec_stride = static_cast<long long>(n_split) * (DH + 2);

  extern __shared__ __align__(16) unsigned char smem[];
  T* kvs = reinterpret_cast<T*>(smem);
  float* ss2 = reinterpret_cast<float*>(smem + C::kKvBytes);  // [2][RB][kTile]
  float* m_run = reinterpret_cast<float*>(smem + C::kKvBytes + C::kSsBytes);
  float* l_run = m_run + RB;
  float* corr = l_run + RB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kKvBytes +
                                              C::kSsBytes + C::kStatBytes);
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][RB][DH], at the end

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], kThreads);
  }
  if (tid < RB) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  __syncthreads();  // barriers initialised

  // this block's keys: the chunks c = split, split + n_split, ... that
  // meet the range [lo, hi] the mask admits
  const int p = pos[b];
  long long lo = window > 0 ? static_cast<long long>(p) - window + 1 : 0;
  lo = lo > 0 ? lo : 0;
  long long hi = p < S - 1 ? p : S - 1;
  const bool uniform = lo > hi;  // the mask admits no key
  if (uniform) {
    lo = 0;
    hi = S - 1;
  }
  const long long c_lo = lo / chunk, c_hi = hi / chunk;
  const long long c0 = c_lo + ((split - c_lo) % n_split + n_split) % n_split;
  if (c0 > c_hi) {  // empty partial
    if (tid < nh) {
      rec[tid * rec_stride] = -INFINITY;
      rec[tid * rec_stride + 1] = 0.f;
    }
    return;
  }
  const long long row = static_cast<long long>(Hkv) * DH;  // key stride
  const T* kb = k + (static_cast<long long>(b) * S * Hkv + kvh) * DH;
  const T* vb = v + (static_cast<long long>(b) * S * Hkv + kvh) * DH;
  const int tiles_per_chunk = chunk / C::kTile;
  auto tile_key0 = [&](int t) {  // first key of the block's tile t
    return (c0 + static_cast<long long>(t / tiles_per_chunk) * n_split) *
               chunk +
           (t % tiles_per_chunk) * C::kTile;
  };
  auto issue = [&](int t) {  // keys outside [lo, hi] are zero-filled
    T* ks = kvs + (t % kStages) * 2 * C::kTileElems;
    T* vs = ks + C::kTileElems;
    const long long key0 = tile_key0(t);
#pragma unroll
    for (int u = 0; u < C::kCopies; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / C::kCPR, c = i % C::kCPR;
      const bool ok = lo <= key0 + r && key0 + r <= hi;
      const long long off = (ok ? key0 + r : 0) * row + c * C::kVals;
      cp_async16(ks + r * DH + c * C::kVals, kb + off, ok ? 16 : 0);
      cp_async16(vs + r * DH + c * C::kVals, vb + off, ok ? 16 : 0);
    }
    cp_async_arrive(&bar[t % kStages]);
  };
  // this lane's slices of the query heads (zero for heads past nh)
  const int cg = tid % C::kG;  // the lane's chunk within a key row
  float qr[RB][C::kCPT][C::kVals];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int i = 0; i < C::kCPT; ++i) {
      if (r < nh) {
        load_f32<T, C::kVals>(
            q + (static_cast<long long>(b) * H + h0 + r) * DH +
                (cg + C::kG * i) * C::kVals,
            qr[r][i]);
      } else {
#pragma unroll
        for (int e = 0; e < C::kVals; ++e) qr[r][i][e] = 0.f;
      }
    }
  }

  const int n_tiles =
      static_cast<int>((c_hi - c0) / n_split + 1) * tiles_per_chunk;
  for (int t = 0; t < kStages && t < n_tiles; ++t) issue(t);

  float acc[RB][C::kDPL];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int d = 0; d < C::kDPL; ++d) acc[r][d] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&bar[st], (t / kStages) & 1);
    const T* ks = kvs + st * 2 * C::kTileElems;
    const T* vs = ks + C::kTileElems;
    const long long key0 = tile_key0(t);
    float* ss = ss2 + (t & 1) * RB * C::kTile;  // tiles alternate buffers

    // 1. logits of the tile's keys for every head
#pragma unroll
    for (int pass = 0; pass < C::kTile / C::kKPP; ++pass) {
      const int j = pass * C::kKPP + tid / C::kG;
      float dot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) dot[r] = 0.f;
#pragma unroll
      for (int i = 0; i < C::kCPT; ++i) {
        float kv[C::kVals];
        load_f32<T, C::kVals>(ks + j * DH + (cg + C::kG * i) * C::kVals, kv);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int e = 0; e < C::kVals; ++e)
            dot[r] = fmaf(qr[r][i][e], kv[e], dot[r]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int o = C::kG / 2; o > 0; o >>= 1)
          dot[r] += __shfl_xor_sync(kFull, dot[r], o);
      if (cg == 0) {
        const bool valid = lo <= key0 + j && key0 + j <= hi;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float s = -INFINITY;
          if (valid) {
            if (uniform) {
              s = 0.f;
            } else {
              s = dot[r] * scale;
              if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            }
          }
          ss[r * C::kTile + j] = s;
        }
      }
    }
    // every thread has also finished tile t - 1: its stage takes a new tile
    __syncthreads();
    if (t > 0 && t - 1 + kStages < n_tiles) issue(t - 1 + kStages);

    // 2. online softmax: warp w updates heads w, w + kWarps, ...
    for (int r = warp; r < RB; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < C::kTile; j += 32)
        mx = fmaxf(mx, ss[r * C::kTile + j]);
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      // -inf while no admitted key has been seen (a chunk's edge tile)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < C::kTile; j += 32) {
        const float pj = expf(ss[r * C::kTile + j] - m_use);  // -inf -> 0
        ss[r * C::kTile + j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_use);  // 0 until the first key
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p . v over this warp's keys of the tile
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float c = corr[r];
#pragma unroll
      for (int d = 0; d < C::kDPL; ++d) acc[r][d] *= c;
    }
#pragma unroll
    for (int jw = 0; jw < C::kTile / kWarps; ++jw) {
      const int j = jw * kWarps + warp;
      float vv[C::kDPL];
      load_f32<T, C::kDPL>(vs + j * DH + lane * C::kDPL, vv);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pj = ss[r * C::kTile + j];
#pragma unroll
        for (int d = 0; d < C::kDPL; ++d) acc[r][d] = fmaf(pj, vv[d], acc[r][d]);
      }
    }
  }

  // the warps' accumulators, summed in warp order (red aliases the stages)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int d = 0; d < C::kDPL; ++d)
      red[(warp * RB + r) * DH + lane * C::kDPL + d] = acc[r][d];
  __syncthreads();
  for (int i = tid; i < nh * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * RB + r) * DH + d];
    rec[r * rec_stride + 2 + d] = a;
  }
  if (tid < nh) {
    rec[tid * rec_stride] = m_run[tid];
    rec[tid * rec_stride + 1] = l_run[tid];
  }
}

// ---- the merge kernel: one block of DH threads per (b, h) ------------------

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    flash_decode_merge_kernel(const float* __restrict__ part,
                              T* __restrict__ out, int n_split) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* rec = part + bh * n_split * (DH + 2);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the splits are done
  float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {  // split order
    const float m = rec[s * (DH + 2)];
    const float l = rec[s * (DH + 2) + 1];
    const float a = rec[s * (DH + 2) + 2 + d];
    if (m == -INFINITY) continue;  // an empty split
    const float m_new = fmaxf(M, m);
    const float c_old = expf(M - m_new), c_new = expf(m - m_new);
    L = L * c_old + l * c_new;
    A = A * c_old + a * c_new;
    M = m_new;
  }
  out[bh * DH + d] = repro::from_f32<T>(A / fmaxf(L, 1e-30f));
}

// ---- launches ----------------------------------------------------------------

template <typename T, int DH, int RB>
int launch_rb(const void* q, const void* k, const void* v, const void* pos,
              void* part, void* out, int B, int H, int S, int Hkv,
              int n_split, int chunk, int window, float scale,
              float softcap, cudaStream_t stream) {
  using C = Cfg<T, DH, RB>;
  auto kern = flash_decode_split_kernel<T, DH, RB>;
  static std::atomic<unsigned long long> allowed{0};
  cudaError_t err = repro::allow_dynamic_smem(kern, C::kSmem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rep = H / Hkv;
  const int n_groups = (rep + RB - 1) / RB;
  const dim3 grid(n_split, Hkv * n_groups, B);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<float*>(part), H, S, Hkv, n_groups, chunk, n_split,
      window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge is launched as a programmatic dependent of the split kernel:
  // its blocks may be placed while the splits run and wait in
  // griddepcontrol.wait until every split block has finished
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(DH);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_decode_merge_kernel<T, DH>, static_cast<const float*>(part),
      static_cast<T*>(out), n_split));
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* pos,
              void* part, void* out, int B, int H, int S, int Hkv, int rb,
              int n_split, int chunk, int window, float scale,
              float softcap, cudaStream_t st) {
  switch (rb) {
    case 1:
      return launch_rb<T, DH, 1>(q, k, v, pos, part, out, B, H, S, Hkv,
                                 n_split, chunk, window, scale, softcap,
                                 st);
    case 2:
      return launch_rb<T, DH, 2>(q, k, v, pos, part, out, B, H, S, Hkv,
                                 n_split, chunk, window, scale, softcap,
                                 st);
    case 4:
      return launch_rb<T, DH, 4>(q, k, v, pos, part, out, B, H, S, Hkv,
                                 n_split, chunk, window, scale, softcap,
                                 st);
    case 8:
      return launch_rb<T, DH, 8>(q, k, v, pos, part, out, B, H, S, Hkv,
                                 n_split, chunk, window, scale, softcap,
                                 st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* part, void* out, int B, int H, int S, int Hkv, int Dh,
           int rb, int n_split, int chunk, int window, float scale,
           float softcap, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Hkv <= 0 || H % Hkv || n_split <= 0 ||
      chunk <= 0 || chunk % 64 ||
      static_cast<long long>(n_split - 1) * chunk >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, pos, part, out, B, H, S, Hkv, rb,
                              n_split, chunk, window, scale, softcap, st);
    case 64:
      return launch_dh<T, 64>(q, k, v, pos, part, out, B, H, S, Hkv, rb,
                              n_split, chunk, window, scale, softcap, st);
    case 96:
      return launch_dh<T, 96>(q, k, v, pos, part, out, B, H, S, Hkv, rb,
                              n_split, chunk, window, scale, softcap, st);
    case 128:
      return launch_dh<T, 128>(q, k, v, pos, part, out, B, H, S, Hkv, rb,
                               n_split, chunk, window, scale, softcap,
                               st);
    case 256:
      return launch_dh<T, 256>(q, k, v, pos, part, out, B, H, S, Hkv, rb,
                               n_split, chunk, window, scale, softcap,
                               st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DH>
int smem_dh(int rb) {
  switch (rb) {
    case 1:
      return Cfg<T, DH, 1>::kSmem;
    case 2:
      return Cfg<T, DH, 2>::kSmem;
    case 4:
      return Cfg<T, DH, 4>::kSmem;
    case 8:
      return Cfg<T, DH, 8>::kSmem;
    default:
      return -1;
  }
}

template <typename T>
int smem(int dh, int rb) {
  switch (dh) {
    case 32:
      return smem_dh<T, 32>(rb);
    case 64:
      return smem_dh<T, 64>(rb);
    case 96:
      return smem_dh<T, 96>(rb);
    case 128:
      return smem_dh<T, 128>(rb);
    case 256:
      return smem_dh<T, 256>(rb);
    default:
      return -1;
  }
}

}  // namespace

// Dynamic shared memory (bytes) of the split kernel's instantiation for
// bf16 (or f32), head dim dh and rb query heads per block; -1 if there is
// none.  ptxas reports only static shared memory, which is 0.
extern "C" int flash_decode_smem_bytes(int bf16, int dh, int rb) {
  return bf16 ? smem<__nv_bfloat16>(dh, rb) : smem<float>(dh, rb);
}

// part: B * H * n_split * (Dh + 2) f32 of scratch; rb: query heads per
// block (1, 2, 4 or 8); split s takes the chunks of `chunk` keys (a
// multiple of 64) c = s, s + n_split, ..., and none may be empty.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* pos, void* part, void* out,
                                int B, int H, int S, int Hkv, int Dh, int rb,
                                int n_split, int chunk, int window,
                                float scale, float softcap, void* stream) {
  return launch<float>(q, k, v, pos, part, out, B, H, S, Hkv, Dh, rb,
                       n_split, chunk, window, scale, softcap, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* part, void* out,
                                 int B, int H, int S, int Hkv, int Dh,
                                 int rb, int n_split, int chunk,
                                 int window, float scale, float softcap,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, pos, part, out, B, H, S, Hkv, Dh,
                               rb, n_split, chunk, window, scale,
                               softcap, stream);
}
