// Flash attention for Hopper on the tensor cores: unmasked
// softmax(Q K^T / sqrt(D)) V with an online f32 max and sum, never writing
// the (N, S) score matrix. Replaces the TPU kernel
// egot2x/ops/pallas_attention.py::flash_attention (:77, body _flash_kernel
// :31).
//
// Shapes: q (BH, N, D), k and v (BH, S, D) -> o (BH, N, D), any N, S >= 1
// and D >= 1, f32 or bf16 in, f32 logits, max, sum and accumulator, o in
// q's dtype. Each of the four tensors is addressed through (batch, head,
// row) element strides with contiguous D, so the port's (B, T, H, Dh)
// attention layout is read in place: bh = b * nheads + head.
//
// What it computes is the TPU kernel's, not its blocks: the running max
// starts at -1e30, keys past S are masked (the TPU kernel's s_valid), and
// the result is acc / max(l, 1e-30). D is padded only to the k-step of the
// product's MMA (16 for bf16, 8 for f32), never to 128 as the TPU layout
// pads it. A head dim past 128 takes the wide kernel below, which works on
// D in chunks of 128.
//
// Design, FlashAttention-2 style with mma.sync. A block is 4 warps and 64
// query rows; each warp owns 16 rows for the whole key sweep. K and V
// tiles of BK keys (128 for bf16 at D <= 32, else 64, or 32 at D > 64)
// are double-buffered in shared memory with cp.async (16-byte copies that
// zero-fill keys past S and dims past D; an input whose rows are not
// 16-byte aligned is staged through registers instead). Per tile a warp
//   1. computes its 16 x BK scores S = Q K^T into accumulator registers
//      (Q's A fragments live in registers for the whole sweep);
//   2. reduces each row's max and sum over the quad of lanes that hold it
//      (two shuffles), rescales the output accumulator once, and takes
//      p = exp2(s c - m c) with c = log2(e) / sqrt(D): one FFMA and one
//      ex2.approx a score (the max is kept on the unscaled scores, so bf16
//      Q enters the MMA exactly as given);
//   3. feeds P to P V straight from the score registers.
// Fragment layouts (PTX ISA, lane = 4 g + t): the C fragment of an m16n8
// product holds rows g, g + 8 and columns 2t, 2t + 1.
//   bf16, m16n8k16: the A fragment of a 16-key chunk is the C fragments of
//     its two 8-key score tiles, packed to bf16 pairs as they lie. K's B
//     fragment is one 32-bit load of two adjacent dims; V's comes from
//     ldmatrix.trans (V is stored key-major).
//   f32, m16n8k8 on 3xTF32: x = hi + lo with hi = x rounded to TF32 (a
//     Veltkamp split: c = x * 8193, hi = c - (c - x), exact in f32) and lo
//     = x - hi truncated to TF32; a b = hi bh + hi bl + lo bh in f32, each
//     product good to ~2^-21 relative, as the f32 gate (rtol 1e-4) needs:
//     one TF32 pass (~5e-4) cannot hold it. The A fragment of m16n8k8 holds
//     columns t and t + 4, not 2t and 2t + 1, so the k index of P V is
//     permuted: A column t is key 2t and column t + 4 is key 2t + 1, and
//     V's B fragment reads rows 2t and 2t + 1 to match. The sum over keys
//     does not care, and P never moves between registers.
// Shared rows are DP + 16 bytes / element long: the 32-bit fragment loads
// of a warp (8 rows x 4 lanes) and ldmatrix's 8 rows of 16 bytes fall on
// distinct banks.
//
// What bounds it on an H100: at the main path's shape (TalkNet at T = 2048
// frames, 8 heads: BH 8, N = S = 2048, D 16 or 32) one launch does 4 N S D
// BH = 2.1 (D 16) or 4.3 (D 32) GFLOP and N S BH = 33.6 M exponentials.
// On the tensor cores (495 TFLOP/s TF32, 989 bf16) the products take 4-9
// us (f32, one pass) or 2-4 us (bf16); the exponentials at the MUFU rate
// (16 per clock per SM, reckoned from the data sheet: ~4.2e12/s) take 8
// us; the bytes 1.3 us. So its bound is the exponentials. The kernel runs
// at ~3x that bound in bf16: timing it with parts switched off showed no
// one pipe or copy to be the limit, but a cost per tile (the barriers and
// the copies' waits; longer bf16 tiles helped) and too few warps to
// overlap the MMAs with the exponentials. 128-row blocks, a split of the
// keys over two warp groups, and 32 rows a warp were all slower or no
// faster. The 3xTF32 route issues three MMAs and splits both operands of
// each product, which makes the f32 kernel issue-bound.
// Build (nvcc -Xptxas -v, sm_90a): at D 16 / 32, 137 / 135 registers (f32)
// and 147 / 128 (bf16), no spills; shared memory 20,480 / 36,864 bytes
// (f32) and 24,576 / 40,960 (bf16) a block, so registers, not shared
// memory, cap the blocks an SM holds.
//
// D > 128 (flash_attention_wide_kernel): the Q fragments and the output
// accumulator of a whole head would not fit in registers, so D is cut into
// chunks of 128 and each block writes one chunk of the output (grid z).
// Per key tile it sums the scores over every chunk, staging K's chunk and
// loading Q's fragments of it in turn, and ends on its own chunk, whose V
// stays staged for P V. Scores are recomputed once per output chunk, and
// tiles are staged and consumed without double buffering: correctness
// first; no path of the system runs it (TalkNet's heads are 16 and 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;             // query rows per block
constexpr int STAGES = 2;                    // K/V tiles in shared memory
constexpr float NEG = -1e30f;                // the TPU kernel's NEG_INF
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, n;  // elements between batches, heads and rows
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int nheads, n, s, d;
  float qscale;  // log2(e) / sqrt(d)
  int aligned;   // k and v rows start on 16 bytes: stage with cp.async
};

// Tile geometry at padded head dim DP.
template <typename T, int DP>
struct Geo {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int D_PAD = DP;
  static constexpr int KSTEP = BF16 ? 16 : 8;      // MMA k of Q K^T
  // keys per tile: 128 for bf16 at D <= 32, whose scores fit in registers
  static constexpr int BK = (BF16 && DP <= 32) ? 128 : DP <= 64 ? 64 : 32;
  static constexpr int CE = 16 / (int)sizeof(T);   // elements per 16 bytes
  static constexpr int RS = DP + CE;               // shared row stride
  static constexpr int TILE = BK * RS;             // elements of a K tile
  static constexpr int SMEM = 2 * STAGES * TILE * (int)sizeof(T);  // K, V
  static constexpr int NT = BK / 8;                // score tiles of 8 keys
  static constexpr int DT = DP / 8;                // output tiles of 8 dims
  static constexpr int QK = DP / KSTEP;            // k-steps of Q K^T
  static_assert(DP % KSTEP == 0 && DP <= 128, "head dim padding");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x on the MUFU: exp2f without its fix-up for results below 2^-126,
// which a softmax weight that small cannot feel
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// x = hi + lo, both TF32: hi rounds x to 11 significant bits (Veltkamp:
// exact in round-to-nearest f32; the _rn intrinsics keep nvcc from fusing
// it into FMAs), lo = x - hi is exact and is truncated to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b ~ hi bh + hi bl + lo bh, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; only `bytes` are read, the rest is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// at most STAGES - 1 groups pending: of the last STAGES groups committed,
// the oldest (tile it's) has landed
__device__ __forceinline__ void cp_async_wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K and V rows k0 .. k0 + BK into one stage ([K | V], BK x RS each): dims
// past d and keys past s are zeros.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(T* dst, const T* k, const T* v,
                                           const Args& a, int k0) {
  using G = Geo<T, DP>;
  if (a.aligned) {
    constexpr int CPR = DP / G::CE;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < G::BK * CPR; i += THREADS) {
      const int j = i / CPR, e0 = (i % CPR) * G::CE;
      const int key = k0 + j;
      const int n = (key < a.s && e0 < a.d) ? min(G::CE, a.d - e0) : 0;
      const int bytes = n * (int)sizeof(T);
      T* ks = dst + j * G::RS + e0;
      cp_async16(ks, n ? k + key * a.sk.n + e0 : k, bytes);
      cp_async16(ks + G::TILE, n ? v + key * a.sv.n + e0 : v, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < G::BK * DP; i += THREADS) {
      const int j = i / DP, e = i % DP;
      const int key = k0 + j;
      const bool in = key < a.s && e < a.d;
      dst[j * G::RS + e] = in ? k[key * a.sk.n + e] : from_f32<T>(0.f);
      dst[G::TILE + j * G::RS + e] =
          in ? v[key * a.sv.n + e] : from_f32<T>(0.f);
    }
  }
}

// q (row, col), 0 outside (n, d)
template <typename T>
__device__ __forceinline__ float q_at(const T* q, long long sqn, int row,
                                      int col, int n, int d) {
  return (row < n && col < d) ? to_f32(q[row * sqn + col]) : 0.f;
}

// The A fragments of the warp's 16 rows (r0, r0 + 8) for every k-step:
// bf16 pairs (m16n8k16) or f32 bits (m16n8k8, split per use).
template <typename T, int DP>
__device__ __forceinline__ void load_q(uint32_t (&qf)[Geo<T, DP>::QK][4],
                                       const T* q, const Args& a, int r0,
                                       int t) {
  using G = Geo<T, DP>;
#pragma unroll
  for (int kk = 0; kk < G::QK; ++kk) {
    const int c = kk * G::KSTEP;
    if constexpr (G::BF16) {
      const int c0 = c + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i & 1), col = c0 + 8 * (i >> 1);
        qf[kk][i] = pack_bf16(q_at(q, a.sq.n, row, col, a.n, a.d),
                              q_at(q, a.sq.n, row, col + 1, a.n, a.d));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i & 1), col = c + t + 4 * (i >> 1);
        qf[kk][i] = __float_as_uint(q_at(q, a.sq.n, row, col, a.n, a.d));
      }
    }
  }
}

// S = Q K^T for one tile: sc[nt] is the C fragment of keys 8 nt .. 8 nt + 7
template <typename T, int DP>
__device__ __forceinline__ void tile_scores(
    float (&sc)[Geo<T, DP>::NT][4], const uint32_t (&qf)[Geo<T, DP>::QK][4],
    const T* ks, int g, int t) {
  using G = Geo<T, DP>;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < G::QK; ++kk) {
    if constexpr (G::BF16) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const T* kr = ks + (nt * 8 + g) * G::RS + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    } else {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(qf[kk][i]), ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const float* kr = reinterpret_cast<const float*>(ks) +
                          (nt * 8 + g) * G::RS + kk * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(sc[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// acc += P V for one tile, P in the score registers
template <typename T, int DP>
__device__ __forceinline__ void tile_pv(float (&acc)[Geo<T, DP>::DT][4],
                                        const float (&p)[Geo<T, DP>::NT][4],
                                        const T* vs, int lane, int t) {
  using G = Geo<T, DP>;
  const int g = lane / 4;
  if constexpr (G::BF16) {
    // ldmatrix.trans: lane L addresses row L % 8 of matrix L / 8; matrices
    // (keys +0, dims +0), (keys +8, dims +0), (keys +0, dims +8), (keys +8,
    // dims +8) are the B fragments {b0b1, b2b3} of two output tiles
    const int mi = lane / 8, rr = lane % 8;
#pragma unroll
    for (int kc = 0; kc < G::BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                              pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                              pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                              pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < G::DT; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kc * 16 + rr + 8 * (mi & 1)) * G::RS +
                              (dt + (mi >> 1)) * 8);
        mma_bf16(acc[dt], pa, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pa, bv[2], bv[3]);
      }
    }
  } else {
    const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
    for (int kc = 0; kc < G::NT; ++kc) {
      // A column t is key 2t, column t + 4 is key 2t + 1
      uint32_t ah[4], al[4];
      split_tf32(p[kc][0], ah[0], al[0]);
      split_tf32(p[kc][2], ah[1], al[1]);
      split_tf32(p[kc][1], ah[2], al[2]);
      split_tf32(p[kc][3], ah[3], al[3]);
#pragma unroll
      for (int dt = 0; dt < G::DT; ++dt) {
        const float* vr = vf + (kc * 8 + 2 * t) * G::RS + dt * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[0], bh0, bl0);
        split_tf32(vr[G::RS], bh1, bl1);
        mma_3xtf32(acc[dt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// Keys past s masked, then the online softmax of one tile: the running max
// m and this lane's part of the running sum l of rows r0, r0 + 8 updated,
// acc rescaled once, and the scores turned into p in place.
template <typename T, int DP>
__device__ __forceinline__ void online_softmax(
    float (&sc)[Geo<T, DP>::NT][4], float (&acc)[Geo<T, DP>::DT][4],
    float (&m)[2], float (&l)[2], int k0, int s, float c, int t) {
  using G = Geo<T, DP>;
  constexpr int NT = G::NT, DT = G::DT;
  if (k0 + G::BK > s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = k0 + nt * 8 + 2 * t;
      if (key >= s) sc[nt][0] = sc[nt][2] = NEG;
      if (key + 1 >= s) sc[nt][1] = sc[nt][3] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
  }
  float alpha[2], off[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * c);
    off[r] = -mx[r] * c;
    m[r] = mx[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[nt][i] = ex2(fmaf(sc[nt][i], c, off[i >> 1]));
      ps[i >> 1] += sc[nt][i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], ps[r]);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
}

// o rows r0, r0 + 8 (of n), columns below d: acc / the row's sum
template <typename T, int DP>
__device__ __forceinline__ void write_rows(
    T* o, long long son, const float (&acc)[Geo<T, DP>::DT][4],
    float (&l)[2], int r0, int n, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < Geo<T, DP>::DT; ++dt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = dt * 8 + 2 * t + j;
        if (col < d)
          o[row * son + col] = from_f32<T>(acc[dt][2 * r + j] / denom);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const Args a) {
  using G = Geo<T, DP>;
  constexpr int BK = G::BK, NT = G::NT, DT = G::DT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * ROWS + (threadIdx.x / 32) * 16 + g;
  const int b = blockIdx.y / a.nheads;
  const int hd = blockIdx.y % a.nheads;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + hd * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hd * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hd * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + hd * a.so.h;

  uint32_t qf[G::QK][4];
  load_q<T, DP>(qf, q, a, r0, t);
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  // rows r0 and r0 + 8: running max (of unscaled scores) and this lane's
  // part of the running sum
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const float c = a.qscale;

  // a ring of STAGES tiles: STAGES - 1 in flight while one is computed
  const int ntiles = (a.s + BK - 1) / BK;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles)
      stage_tile<T, DP>(tiles + j * 2 * G::TILE, k, v, a, j * BK);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    // the stage being refilled was read in tile it - 1, which ended on a
    // barrier
    const int next = it + STAGES - 1;
    if (next < ntiles)
      stage_tile<T, DP>(tiles + (next % STAGES) * 2 * G::TILE, k, v, a,
                        next * BK);
    cp_async_commit();
    cp_async_wait_tile();   // this thread's copies of tile it have landed
    __syncthreads();        // and everyone's
    const T* ks = tiles + (it % STAGES) * 2 * G::TILE;

    float sc[NT][4];
    tile_scores<T, DP>(sc, qf, ks, g, t);
    const int k0 = it * BK;
    online_softmax<T, DP>(sc, acc, m, l, k0, a.s, c, t);
    tile_pv<T, DP>(acc, sc, ks + G::TILE, lane, t);
    __syncthreads();   // every warp is done with this stage
  }
  write_rows<T, DP>(o, a.so.n, acc, l, r0, a.n, a.d, t);
}

template <typename T, int DP>
int launch(const Args& a, int bh, cudaStream_t stream) {
  using G = Geo<T, DP>;
  auto kern = flash_attention_kernel<T, DP>;
  if (G::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.n + ROWS - 1) / ROWS, bh);
  kern<<<grid, THREADS, G::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// D > 128: head dims in chunks of WIDE; block (row tile, bh, chunk oc)
// writes output dims [WIDE oc, WIDE oc + WIDE). See the note at the top.
constexpr int WIDE = 128;

template <typename T>
struct Wide {
  using G = Geo<T, WIDE>;
  static constexpr int SMEM = 2 * G::TILE * (int)sizeof(T);  // one K, V
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_wide_kernel(const Args a) {
  using G = Geo<T, WIDE>;
  constexpr int BK = G::BK, NT = G::NT, DT = G::DT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tile = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * ROWS + (threadIdx.x / 32) * 16 + g;
  const int b = blockIdx.y / a.nheads;
  const int hd = blockIdx.y % a.nheads;
  const int nc = (a.d + WIDE - 1) / WIDE, oc = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + hd * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hd * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hd * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + hd * a.so.h + oc * WIDE;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  const int ntiles = (a.s + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
    for (int i = 0; i < nc; ++i) {
      const int ch = (oc + 1 + i) % nc;   // the last chunk is oc
      Args ac = a;
      ac.d = min(WIDE, a.d - ch * WIDE);
      uint32_t qf[G::QK][4];
      load_q<T, WIDE>(qf, q + ch * WIDE, ac, r0, t);
      stage_tile<T, WIDE>(tile, k + ch * WIDE, v + ch * WIDE, ac, k0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // the chunk is staged
      float part[NT][4];
      tile_scores<T, WIDE>(part, qf, tile, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] += part[nt][j];
      if (i + 1 < nc) __syncthreads();   // before the next chunk lands
    }
    online_softmax<T, WIDE>(sc, acc, m, l, k0, a.s, a.qscale, t);
    tile_pv<T, WIDE>(acc, sc, tile + G::TILE, lane, t);
    __syncthreads();   // every warp is done with the tile
  }
  write_rows<T, WIDE>(o, a.so.n, acc, l, r0, a.n,
                      min(WIDE, a.d - oc * WIDE), t);
}

template <typename T>
int launch_wide(const Args& a, int bh, cudaStream_t stream) {
  const dim3 grid((a.n + ROWS - 1) / ROWS, bh, (a.d + WIDE - 1) / WIDE);
  flash_attention_wide_kernel<T>
      <<<grid, THREADS, Wide<T>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// f(Geo<T, DP>{}) at the least DP >= d that is a multiple of the k-step;
// -1 for d > 128.
template <typename T, int DP = Geo<T, 128>::KSTEP, typename F>
int by_head_dim(int d, F&& f) {
  if constexpr (DP > 128) {
    return -1;
  } else {
    if (d <= DP) return f(Geo<T, DP>{});
    return by_head_dim<T, DP + Geo<T, 128>::KSTEP>(d, f);
  }
}

template <typename T>
int dispatch(const Args& a, int bh, cudaStream_t s) {
  if (a.d > WIDE) return launch_wide<T>(a, bh, s);
  const int err = by_head_dim<T>(a.d, [&](auto geo) {
    return launch<T, decltype(geo)::D_PAD>(a, bh, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

bool aligned16(const void* p, long long sb, long long sh, long long sn,
               int elem) {
  const long long ce = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % ce == 0 &&
         sh % ce == 0 && sn % ce == 0;
}

}  // namespace

extern "C" {

// q, k, v, o: element strides (batch, head, row) each, D contiguous;
// bh = batches * nheads blocks of rows. dtype 0: float32, 1: bfloat16 (all
// four tensors). Returns a cudaError_t.
int egot2x_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int dtype, int bh, int nheads, int n,
                           int s, int d, long long sqb, long long sqh,
                           long long sqn, long long skb, long long skh,
                           long long skn, long long svb, long long svh,
                           long long svn, long long sob, long long soh,
                           long long son, void* stream) {
  if (bh < 1 || nheads < 1 || n < 1 || s < 1 || d < 1 || bh > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const bool aligned = aligned16(k, skb, skh, skn, elem) &&
                       aligned16(v, svb, svh, svn, elem);
  Args a{q, k, v, o, {sqb, sqh, sqn}, {skb, skh, skn}, {svb, svh, svn},
         {sob, soh, son}, nheads, n, s, d,
         (float)(1.4426950408889634 / std::sqrt((double)d)), aligned};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, bh, st);
  return dispatch<__nv_bfloat16>(a, bh, st);
}

// dynamic shared memory of one block at head dim d and dtype (0: f32, 1:
// bf16), bytes
int egot2x_flash_attention_smem_bytes(int d, int dtype) {
  if (d > WIDE) return dtype == 0 ? Wide<float>::SMEM
                                  : Wide<__nv_bfloat16>::SMEM;
  auto smem = [](auto geo) { return decltype(geo)::SMEM; };
  return dtype == 0 ? by_head_dim<float>(d, smem)
                    : by_head_dim<__nv_bfloat16>(d, smem);
}

const char* egot2x_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
