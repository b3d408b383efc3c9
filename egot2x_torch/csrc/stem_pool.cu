// Fused stems for Hopper: stride-2 conv + folded eval-BN + ReLU + 3x3/2
// pad-1 max-pool, writing only the pooled map. One kernel design,
// stem_pool_tc_kernel, an implicit GEMM on the tensor cores (mma.sync), for
// both TPU stem kernels and both input types:
//
//   float output  replaces egot2x/ops/pallas_stem.py::fused_stem_pool
//                 (:232, body _stem_kernel): scale, bias, ReLU, pool; the
//                 output in the input's dtype (f32 or bf16).
//   int8 output   replaces egot2x/ops/pallas_stem.py::fused_stem_pool_q
//                 (:351, body _stem_kernel_q): q = min(rint(relu(acc *
//                 scale + bias) / s), 127) per channel, then an integer
//                 3x3/2 max-pool. NG trunks of 64 channels stack in one
//                 launch (the fused LAM+TTM stem, NG = 2): the frames are
//                 read once and each trunk's channels use their own BN and
//                 step s.
//
// Training (the float stems): the TRAIN instances are the same body with a
// training epilogue. They park the f32 conv values in the tile (whatever
// the output's type), then for each pooled output take BN + ReLU of each
// in-image position of its 3x3 window, rounded to the output's type, and
// keep the first maximum in row-major order (a strict >, as F.max_pool2d
// picks it). They write the output (the inference instance's bit for bit),
// the winner's window position (uint8, 0-8) and its conv value before BN
// (f32): 5 more bytes a pooled value, so that the backward needs neither
// the pre-pool map (4x the pooled values) nor a second conv.
// stem_pool_backward_kernel (below the launchers) is the gradient.
//
// Geometries (every variant instantiates both):
//   2D  ResNet-18 conv1: (N, H, W, 3) NHWC, 7x7/2 pad 3, 3 -> 64 channels;
//   3D  TalkNet frontend3D: (B, T, H, W) grey, 5x7x7 stride (1,2,2),
//       temporal zero-pad 2 applied per sample (frames of one clip never
//       see frames of the next).
// Output (frames, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64*NG) NHWC.
//
// What bounds it on an H100: at one request (480 frames of 224^2) the 2D
// stem is 111 GFLOP a trunk on in-image taps (zero-pad taps need no
// product): 0.11 ms at the bf16 tensor-core peak (989 TFLOP/s), 0.23 ms at
// TF32's (495), 1.67 ms on the f32 CUDA cores (67); its bytes (289 MB of
// f32 or 145 MB of bf16 input, 96 MB a trunk of f32 output) take
// 0.07-0.12 ms. The 3D stem is 44 GFLOP. So the stems are bound by their
// operations, and the design spends nothing on bytes it does not have to
// move: the pre-pool conv map (4x the bytes of the pooled output) never
// leaves shared memory, and each input pixel is read from device memory
// once per tile (plus a small halo) for all stacked trunks.
//
// The implicit GEMM, per 7x7 pooled tile (a 15x15 conv tile), with
// mma.sync m16n8k16 and f32 sums:
//   M  the tile's conv pixels: one M-tile of 16 is one conv row (the 16th
//      pixel is computed and dropped);
//   N  64 channels of one trunk: 8 n-tiles;
//   K  the taps, in runs that lie contiguous in the staged NHWC halo: 2D,
//      per kh the 7 kw x 3 ci = 21 values of one halo row, padded to 24 (K
//      168 -> 11 k-steps, 176); 3D, per (kt, kh) the 7 kw, padded to 8 (K
//      280 -> 18 k-steps, 288). The padded taps have zero weights.
// Conv pixel c of a row reads its run at halo offset 2c CIN, so the A
// fragment's two adjacent taps are one 32-bit shared load, and the words a
// warp loads span fewer than 32 banks: no bank conflicts, no im2col copy.
// The weights lie in shared memory in fragment order, (k-step, n-tile,
// lane) x [hi b0b1, hi b2b3, lo b0b1, lo b2b3]: one 16-byte load a lane
// feeds every MMA of two M-tiles (ops/stem.py::weight_fragments lays them
// out once per loaded weight).
//
// Two input kinds, one body:
//   bf16  A = the exact bf16 frames, B = the f32 weights split into bf16
//         w_hi + w_lo: two bf16 MMAs, sum x (w_hi + w_lo), good to ~2^-16
//         relative a tap.
//   f32   3xFP16: x and w scaled by powers of two and split into fp16 hi +
//         lo; three fp16 MMAs, x_hi w_hi + x_hi w_lo + x_lo w_hi (x_lo w_lo,
//         2^-22 of a product, is dropped). fp16 keeps TF32's 11 significant
//         bits at the bf16 rate (one m16n8k16 instruction does twice the
//         products of TF32's m16n8k8), and the hi + lo pair keeps 22; bf16
//         hi + lo keeps only 16, which misses the f32 gate on raw 0-255
//         frames (the CPU emulation in
//         tests/test_torch_port_split_precision.py shows both).
//         fp16's narrow exponent range is answered by powers of two, which
//         are exact: each output channel's weights are scaled by 2^-e_w so
//         that their max |w| lies in [2^14, 2^15) (the wrapper, once per
//         weight), and each tile's halo by 2^-e_x from its own max |x| (the
//         staging: a warp max, then shared memory). The epilogue multiplies
//         by 2^(e_x + e_w), folded into the BN scale. An element far below
//         its tile's max keeps only absolute precision, about 2^-38 of that
//         max (fp16's smallest subnormal, 2^-24, against 2^14).
//
// Block structure: a persistent block of 8 warps a trunk walks (frame,
// tile) work items; each warp owns two conv rows (mg and mg + 8) of one
// trunk. Per tile:
//   1. the halo (KT x 35 rows x 40 cols x CIN, zeros outside the frame, the
//      clip and the 35 real columns) is staged: bf16 bits, 8 loads in
//      flight a thread; or f32, every load of the thread in flight, its
//      max, a barrier, then the fp16 hi and lo planes;
//   2. the conv, its 11 or 18 k-steps unrolled so that the halo offsets of
//      the K runs are constants;
//   3. the epilogue: scale, bias, ReLU, and for int8 the divide by s, round
//      half to even and min 127 on the FP32 pipe (see quantize); conv
//      positions outside the image are zeroed (exact: post-ReLU values are
//      >= 0 and every pool window holds a real position), and the tile is
//      parked in shared memory in the output's type (rounding to bf16 is
//      monotonic, so the pool after it gives the same values);
//   4. the 3x3/2 max-pool from shared memory, and the 7x7 tile is written.
// Where it lets a second block onto the SM (Layout below), the halo and the
// conv tile share shared memory behind one more barrier a tile, so that one
// block's staging overlaps the other's MMAs; where even that does not fit
// (3D, f32 in, float out), the tile is parked and pooled 32 channels at a
// time.
//
// The quantizer is the JAX package's quantize_static on the BN+ReLU
// output: an IEEE f32 divide by s and a round half to even.
//
// Measured on an H100 (tools/ab_kernels.py against a build with every
// instance at its one-block layout, halo and tile apart, no register cap):
// the two-block layouts are 1.15-1.23x faster where they differ (2D f32,
// 3D f32 and bf16 float out, 3D f32 int8 out), though the cap of 128
// registers spills up to 104 bytes.
// Build (nvcc -Xptxas -v, sm_90a): 128 registers every instance, 8-104
// bytes spilled; shared memory 72,040 (bf16 in, int8 2D n = 1) to 140,416
// bytes (f32 in, int8 2D n = 2, one block an SM). chip_smoke.py's build
// phase reports each instance.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int COUT = 64;                 // channels of one trunk
constexpr int KS = 7;                    // spatial kernel edge
constexpr int PT = 7;                    // pooled tile edge
constexpr int CT = 2 * PT + 1;           // conv tile edge
constexpr int IT = 2 * (CT - 1) + KS;    // input tile edge
constexpr int NPIX = CT * CT;            // conv pixels per tile
constexpr int THREADS = 256;             // 8 warps a trunk
// shared memory a block may take for two blocks an SM: (228 KB - 1 KB
// reserved a block) / 2
constexpr int SMEM_TWO_BLOCKS = (228 * 1024 - 2 * 1024) / 2;
// f32 input: the least scaling exponent, so that 2^e_x and 2^e_w stay
// normal f32 powers of two, and so does 2^(e_x + e_w) wherever the conv's
// products are finite in f32 (ops/stem.py::E_MIN is the same)
constexpr int E_MIN = -63;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int KT, int CIN>
struct Geo {
  static constexpr int RUN = CIN == 3 ? 24 : 8;    // taps of a run, padded
  static constexpr int HPR = RUN / 8;              // 8-tap halves per run
  static constexpr int RUNS = KT * KS;             // (kt, kh) runs
  static constexpr int KSTEPS = (RUNS * RUN + 15) / 16;
  static constexpr int XCOLS = 40;                 // staged halo columns
  static constexpr int XRS = XCOLS * CIN;          // halo row, 16-bit
  static constexpr int HALO = KT * IT * XRS;       // 16-bit of one plane
  static constexpr int WFRAG = KSTEPS * 8 * 32 * 8;  // 16-bit of one trunk
  // the 16th pixel of a conv row (2 * 15 columns on) reads a whole run
  static_assert(2 * 15 * CIN + RUN <= XRS, "halo row too short");
};

// Shared memory of one instance: fragments | halo planes, conv tile | BN
// scale and bias, steps, per-warp max (and, TRAIN, the 2^e_w factors).
// PARTS channel groups are parked and pooled one after the other (float
// output only); ALIAS puts the conv tile over the halo planes. The first
// of (1, apart), (1, aliased), (2, aliased) that fits two blocks an SM is
// taken, else (1, apart) at one block (and always for NG = 2, 512
// threads). The training variant parks the f32 conv values, whatever the
// output's type.
template <int KT, int CIN, int NG, bool F32IN, typename Tout, bool TRAIN>
struct LayoutSizes {
  using G = Geo<KT, CIN>;
  using Tpark = typename std::conditional<TRAIN, float, Tout>::type;
  static constexpr bool INT8 = std::is_same<Tout, int8_t>::value;
  static_assert(!(TRAIN && INT8), "the int8 stem has no training variant");
  static constexpr int NTH = THREADS * NG;
  static constexpr int FRAG_BYTES = NG * G::WFRAG * 2;
  static constexpr int HALO_BYTES = (F32IN ? 2 : 1) * G::HALO * 2;
  static constexpr int SCALAR_BYTES =
      (2 * NG * COUT + 2 * NG + 16 + (TRAIN ? NG * COUT : 0)) * 4;
  static constexpr int tile_ch(int parts) {
    return INT8 ? NG * COUT : COUT / parts;
  }
  // pixel stride of the parked tile, elements of Tout: 16 bytes of pad
  // (int8) or 8 elements (float) keep its stores free of bank conflicts
  static constexpr int cstride(int parts) {
    return tile_ch(parts) + (INT8 ? 16 : 8);
  }
  static constexpr int tile_bytes(int parts) {
    return NPIX * cstride(parts) * (int)sizeof(Tpark);
  }
  static constexpr int region(int parts, bool alias) {
    return alias ? cmax(HALO_BYTES, tile_bytes(parts))
                 : HALO_BYTES + tile_bytes(parts);
  }
  static constexpr int bytes(int parts, bool alias) {
    return FRAG_BYTES + SCALAR_BYTES + region(parts, alias);
  }
  static constexpr bool fits(int parts, bool alias) {
    return NG == 1 && bytes(parts, alias) <= SMEM_TWO_BLOCKS;
  }
  // 0: (1, apart), 1: (1, aliased), 2: (2, aliased)
  static constexpr int choice() {
    return fits(1, false) ? 0
           : fits(1, true) ? 1
           : (!INT8 && fits(2, true)) ? 2 : 0;
  }
};

template <int KT, int CIN, int NG, bool F32IN, typename Tout,
          bool TRAIN = false>
struct Layout : LayoutSizes<KT, CIN, NG, F32IN, Tout, TRAIN> {
  using S = LayoutSizes<KT, CIN, NG, F32IN, Tout, TRAIN>;
  static constexpr int PARTS = S::choice() == 2 ? 2 : 1;
  static constexpr bool ALIAS = S::choice() != 0;
  static constexpr int TILE_CH = S::tile_ch(PARTS);
  static constexpr int CSTRIDE = S::cstride(PARTS);
  static constexpr int REGION = S::region(PARTS, ALIAS);
  static constexpr int BYTES = S::bytes(PARTS, ALIAS);
  static constexpr int BLOCKS = S::fits(PARTS, ALIAS) ? 2 : 1;
  static_assert(S::HALO_BYTES % 16 == 0 && REGION % 16 == 0, "alignment");
  static_assert((CSTRIDE * (int)sizeof(typename S::Tpark)) % 8 == 0,
                "tile rows");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Where one work item sits: frame n = b * tlen + t, pooled tile origin.
struct Tile {
  int n, b, t, po0, pc0, cr0, cc0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tlen, int tiles_h,
                                        int tiles_w) {
  Tile tc;
  const int tw = tile % tiles_w;
  const int th = (tile / tiles_w) % tiles_h;
  tc.n = tile / (tiles_w * tiles_h);
  tc.b = tc.n / tlen;
  tc.t = tc.n % tlen;
  tc.po0 = th * PT;
  tc.pc0 = tw * PT;
  tc.cr0 = 2 * tc.po0 - 1;  // first conv row/col of the tile
  tc.cc0 = 2 * tc.pc0 - 1;
  return tc;
}

// Where one tile's halo lies in x (B, T, H, W, CIN): its first input row
// and element of a row, and the clip's first frame.
struct HaloOrigin {
  int t, ir0, e0;
  int64_t clip;
};

__device__ __forceinline__ HaloOrigin halo_origin(const Tile& tc, int tlen,
                                                  int cin) {
  return {tc.t, 2 * tc.cr0 - 3, (2 * tc.cc0 - 3) * cin,
          (int64_t)tc.b * tlen};
}

// halo element i (row r of KT x 35, element e of 40 x CIN): false for a
// zero (outside the frame, the clip, the 35 real columns or the halo),
// else its index in x
template <int KT, int CIN>
__device__ __forceinline__ bool halo_source(int i, const HaloOrigin& o,
                                            int tlen, int h, int wd,
                                            int64_t& src) {
  using G = Geo<KT, CIN>;
  const int r = i / G::XRS, e = i - r * G::XRS;
  const int kt = r / IT, row = r - kt * IT;
  const int ts = o.t + kt - KT / 2, hy = o.ir0 + row, we = o.e0 + e;
  src = ((o.clip + ts) * h + hy) * wd * CIN + we;
  return i < G::HALO && e < IT * CIN && ts >= 0 && ts < tlen && hy >= 0 &&
         hy < h && we >= 0 && we < wd * CIN;
}

// halo offset (16-bit) of 8-tap half h of the K axis; halves past the last
// run have zero weights and read run 0
template <int KT, int CIN>
__device__ __forceinline__ int half_offset(int h) {
  using G = Geo<KT, CIN>;
  const int run = h / G::HPR;
  return run >= G::RUNS
             ? 0
             : ((run / KS) * IT + run % KS) * G::XRS + 8 * (h % G::HPR);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b, m16n8k16, bf16 or fp16 operands, f32 sums
template <bool FP16>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (FP16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^e as an f32, exact for -126 <= e <= 127
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

// the scaling exponent of a tile whose max |x| is m: m 2^-e in [2^14,
// 2^15) for m >= 2^-48; m = 0 gives e = -15 (frexpf(0) has exponent 0)
__device__ __forceinline__ int tile_exponent(float m) {
  int k;
  frexpf(m, &k);
  return max(k - 15, E_MIN);
}

// min(rint(relu(acc s + o) / qs), 127) on the FP32 pipe: the IEEE
// quotient y / qs from r = 1 / qs (correctly rounded, once per trunk) and
// one FMA correction, q0 + r (y - q0 qs) with q0 = y r, which is the
// correctly rounded quotient (Markstein's theorem: r within half an ulp of
// 1 / qs and q0 within an ulp of y / qs); then round half to even by the
// 1.5 * 2^23 addition, exact for 0 <= q <= 127. The same function as
// min(__float2uint_rn(y / qs), 127u), without the divide's MUFU.RCP and
// the conversion, both quarter-rate.
__device__ __forceinline__ uint32_t quantize(float acc, float s, float o,
                                             float qs, float r) {
  const float y = fmaxf(fmaf(acc, s, o), 0.f);
  const float q0 = __fmul_rn(y, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, qs, y), r, q0);
  return __float_as_uint(fminf(q, 127.f) + 12582912.f) - 0x4B400000u;
}

// v as the output type would hold it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// 1. the bf16 halo as bits, STAGE loads in flight a thread
template <int KT, int CIN, int NTH>
__device__ __forceinline__ void stage_bf16(uint16_t* x_s,
                                           const uint16_t* __restrict__ x,
                                           const Tile& tc, int tlen, int h,
                                           int wd) {
  using G = Geo<KT, CIN>;
  constexpr int STAGE = 8;
  const HaloOrigin o = halo_origin(tc, tlen, CIN);
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < G::HALO; i0 += STAGE * NTH) {
    uint16_t v[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      int64_t src;
      v[j] = 0;
      if (halo_source<KT, CIN>(i0 + j * NTH, o, tlen, h, wd, src))
        v[j] = __ldg(x + src);
    }
#pragma unroll
    for (int j = 0; j < STAGE; ++j)
      if (i0 + j * NTH < G::HALO) x_s[i0 + j * NTH] = v[j];
  }
}

// 1. the f32 halo as fp16 hi and lo planes of x 2^-e_x, every load of the
// thread in flight; returns 2^e_x. Holds one barrier (the tile's max).
template <int KT, int CIN, int NTH>
__device__ __forceinline__ float stage_f32(uint16_t* x_s, float* wmax,
                                           const float* __restrict__ x,
                                           const Tile& tc, int tlen, int h,
                                           int wd) {
  using G = Geo<KT, CIN>;
  constexpr int NLOAD = (G::HALO + NTH - 1) / NTH;
  const int tid = threadIdx.x;
  const HaloOrigin o = halo_origin(tc, tlen, CIN);
  float v[NLOAD];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < NLOAD; ++j) {
    int64_t src;
    v[j] = 0.f;
    if (halo_source<KT, CIN>(tid + j * NTH, o, tlen, h, wd, src))
      v[j] = __ldg(x + src);
    m = fmaxf(m, fabsf(v[j]));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (tid % 32 == 0) wmax[tid / 32] = m;
  __syncthreads();
  m = wmax[0];
#pragma unroll
  for (int w = 1; w < NTH / 32; ++w) m = fmaxf(m, wmax[w]);
  const int e = tile_exponent(m);
  const float down = pow2(-e);
#pragma unroll
  for (int j = 0; j < NLOAD; ++j) {
    const int i = tid + j * NTH;
    if (i < G::HALO) {
      const float xs = v[j] * down;
      const __half hi = __float2half_rn(xs);
      const __half lo = __float2half_rn(xs - __half2float(hi));
      x_s[i] = __half_as_ushort(hi);
      x_s[G::HALO + i] = __half_as_ushort(lo);
    }
  }
  return pow2(e);
}

// x: (B, T, H, W, CIN) f32 (F32IN) or bf16; wf: (NG, KSTEPS, 8, 32, 8)
// fp16 (F32IN, weights scaled by 2^-e_w) or bf16 fragments; wexp: (64*NG,)
// 2^e_w (F32IN, else unread); scale, bias: (64*NG,) f32; qscale: (NG,) f32
// (int8 output, else unread); out: (B*T, Ho, Wo, 64*NG) Tout. TRAIN also
// writes win (B*T, Ho, Wo, 64) uint8, each pooled output's winner 0-8 in
// its 3x3 window (row-major, the first maximum: a strict >, as
// F.max_pool2d), and yw (B*T, Ho, Wo, 64) f32, the winner's conv value
// before BN (unread otherwise).
template <int KT, int CIN, int NG, bool F32IN, typename Tout, bool TRAIN>
__global__ void __launch_bounds__(
    Layout<KT, CIN, NG, F32IN, Tout, TRAIN>::NTH,
    Layout<KT, CIN, NG, F32IN, Tout, TRAIN>::BLOCKS)
stem_pool_tc_kernel(const void* __restrict__ xin,
                    const uint4* __restrict__ wf,
                    const float* __restrict__ wexp,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ qscale,
                    Tout* __restrict__ out, uint8_t* __restrict__ win,
                    float* __restrict__ yw, int tlen, int h, int wd, int hc,
                    int wc, int ho, int wo, int tiles_h, int tiles_w,
                    int total_tiles) {
  using L = Layout<KT, CIN, NG, F32IN, Tout, TRAIN>;
  using G = Geo<KT, CIN>;
  using Tpark = typename L::Tpark;
  constexpr int NTH = L::NTH, CS = L::CSTRIDE;
  extern __shared__ uint4 smem_tc[];
  uint4* w_s = smem_tc;                                    // fragments
  uint8_t* region = reinterpret_cast<uint8_t*>(w_s + NG * G::WFRAG / 8);
  uint16_t* x_s = reinterpret_cast<uint16_t*>(region);     // halo planes
  Tpark* c_s =
      reinterpret_cast<Tpark*>(region + (L::ALIAS ? 0 : L::HALO_BYTES));
  // BN scale: times 2^e_w (F32IN) for inference; TRAIN keeps it apart, in
  // we_s, as the parked conv values carry it
  float* sc_s = reinterpret_cast<float*>(region + L::REGION);
  float* bi_s = sc_s + NG * COUT;
  float* qs_s = bi_s + NG * COUT;                          // s, then 1 / s
  float* wmax = qs_s + 2 * NG;                             // per-warp max |x|
  float* we_s = wmax + 16;                                 // TRAIN: 2^e_w

  const int tid = threadIdx.x;
  for (int i = tid; i < NG * G::WFRAG / 8; i += NTH) w_s[i] = __ldg(wf + i);
  for (int i = tid; i < NG * COUT; i += NTH) {
    float e = 1.f;
    if constexpr (F32IN) e = __ldg(wexp + i);
    if constexpr (TRAIN) {
      sc_s[i] = __ldg(scale + i);
      we_s[i] = e;
    } else {
      sc_s[i] = __ldg(scale + i) * e;
    }
    bi_s[i] = __ldg(bias + i);
  }
  if (L::INT8 && tid < NG) {
    qs_s[tid] = __ldg(qscale + tid);
    qs_s[NG + tid] = __frcp_rn(qs_s[tid]);
  }

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int tr = warp / 8;               // this warp's trunk
  const int mg = warp % 8;               // conv rows mg and mg + 8
  const bool two_rows = mg + 8 < CT;
  const int rows[2] = {mg, two_rows ? mg + 8 : mg};
  const uint4* wt = w_s + tr * G::KSTEPS * 8 * 32 + lane;

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const Tile tc = tile_at(tile, tlen, tiles_h, tiles_w);
    // the previous tile's pool read c_s, which the halo overlays
    if (L::ALIAS) __syncthreads();
    // 1. the halo; the previous tile's conv finished before its epilogue
    // barrier, so x_s is free
    float fx = 1.f;   // 2^e_x
    if constexpr (F32IN)
      fx = stage_f32<KT, CIN, NTH>(x_s, wmax, static_cast<const float*>(xin),
                                   tc, tlen, h, wd);
    else
      stage_bf16<KT, CIN, NTH>(x_s, static_cast<const uint16_t*>(xin), tc,
                               tlen, h, wd);
    __syncthreads();

    // 2. the conv: two M-tiles (conv rows) x 64 channels of trunk tr
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
    const uint16_t* xb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      xb[i] = x_s + 2 * rows[i] * G::XRS + 2 * CIN * g + 2 * t;
#pragma unroll   // the halves' halo offsets fold to constants
    for (int s = 0; s < G::KSTEPS; ++s) {
      constexpr int PIX8 = 16 * CIN;   // pixel g + 8, 16-bit further on
      const int o0 = half_offset<KT, CIN>(2 * s);
      const int o1 = half_offset<KT, CIN>(2 * s + 1);
      uint32_t a[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = lds32(xb[i] + o0);
        a[i][1] = lds32(xb[i] + o0 + PIX8);
        a[i][2] = lds32(xb[i] + o1);
        a[i][3] = lds32(xb[i] + o1 + PIX8);
        if constexpr (F32IN) {
          al[i][0] = lds32(xb[i] + G::HALO + o0);
          al[i][1] = lds32(xb[i] + G::HALO + o0 + PIX8);
          al[i][2] = lds32(xb[i] + G::HALO + o1);
          al[i][3] = lds32(xb[i] + G::HALO + o1 + PIX8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint4 w = wt[(s * 8 + nt) * 32];
#pragma unroll
        for (int i = 0; i < 2; ++i) {   // small parts first
          if constexpr (F32IN) mma<true>(acc[i][nt], al[i], w.x, w.y);
          mma<F32IN>(acc[i][nt], a[i], w.z, w.w);
          mma<F32IN>(acc[i][nt], a[i], w.x, w.y);
        }
      }
    }
    // every warp's A loads are done before the tile overwrites the halo
    if (L::ALIAS) __syncthreads();

    if constexpr (L::INT8) {
      // 3. BN + ReLU + quantize into the shared int8 tile
      const float qs = qs_s[tr], rqs = qs_s[NG + tr];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two_rows) break;
        const int cr = tc.cr0 + rows[i];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = g + 8 * half;
          if (c >= CT) continue;
          const int cc = tc.cc0 + c;
          const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
          uint8_t* dst = reinterpret_cast<uint8_t*>(c_s) +
                         (rows[i] * CT + c) * CS + tr * COUT + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int ch = tr * COUT + nt * 8 + 2 * t;
            const uint32_t q0 = quantize(acc[i][nt][2 * half],
                                         sc_s[ch] * fx, bi_s[ch], qs, rqs);
            const uint32_t q1 = quantize(acc[i][nt][2 * half + 1],
                                         sc_s[ch + 1] * fx, bi_s[ch + 1], qs,
                                         rqs);
            *reinterpret_cast<uint16_t*>(dst + nt * 8) =
                inside ? (uint16_t)(q0 | (q1 << 8)) : (uint16_t)0;
          }
        }
      }
      __syncthreads();

      // 4. 3x3/2 max-pool of the bytes of every trunk, 4 channels a word
      // (values are 0..127, so the unsigned byte max is the int8 max)
      const uint8_t* c_q = reinterpret_cast<const uint8_t*>(c_s);
      for (int i = tid; i < PT * PT * (NG * COUT / 4); i += NTH) {
        const int q4 = i % (NG * COUT / 4);
        const int pp = i / (NG * COUT / 4);
        const int pr = pp / PT, pc = pp % PT;
        const int po = tc.po0 + pr, pcw = tc.pc0 + pc;
        if (po >= ho || pcw >= wo) continue;
        uint32_t m = 0u;
#pragma unroll
        for (int dr = 0; dr < 3; ++dr)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int p = (2 * pr + dr) * CT + 2 * pc + dc;
            m = __vmaxu4(m, *reinterpret_cast<const uint32_t*>(
                                c_q + p * CS + 4 * q4));
          }
        *reinterpret_cast<uint32_t*>(
            reinterpret_cast<int8_t*>(out) +
            (((int64_t)tc.n * ho + po) * wo + pcw) * (NG * COUT) + 4 * q4) = m;
      }
    } else {
      constexpr int NTP = L::TILE_CH / 8;   // n-tiles a part
#pragma unroll
      for (int part = 0; part < L::PARTS; ++part) {
        if (part > 0) __syncthreads();   // the previous part's pool is done
        // 3. BN + ReLU into the shared tile, in the output's type; TRAIN
        // parks the f32 conv values instead
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !two_rows) break;
          const int cr = tc.cr0 + rows[i];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = g + 8 * half;
            if (c >= CT) continue;
            const int cc = tc.cc0 + c;
            const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
            Tpark* dst = c_s + (rows[i] * CT + c) * CS + 2 * t;
#pragma unroll
            for (int j = 0; j < NTP; ++j) {
              const int nt = part * NTP + j, ch = nt * 8 + 2 * t;
              if constexpr (TRAIN) {
                // 2^(e_x + e_w) is exact, so fmaf(y, scale, bias) below
                // is the inference epilogue's value bit for bit
                store2(dst + j * 8, acc[i][nt][2 * half] * (fx * we_s[ch]),
                       acc[i][nt][2 * half + 1] * (fx * we_s[ch + 1]));
              } else {
                const float y0 = fmaxf(
                    fmaf(acc[i][nt][2 * half], sc_s[ch] * fx, bi_s[ch]), 0.f);
                const float y1 = fmaxf(fmaf(acc[i][nt][2 * half + 1],
                                            sc_s[ch + 1] * fx, bi_s[ch + 1]),
                                       0.f);
                store2(dst + j * 8, inside ? y0 : 0.f, inside ? y1 : 0.f);
              }
            }
          }
        }
        __syncthreads();

        // 4. 3x3/2 max-pool: pooled (pr, pc) reads tile rows/cols
        // 2pr..2pr+2
        for (int i = tid; i < PT * PT * (L::TILE_CH / 4); i += NTH) {
          const int q4 = i % (L::TILE_CH / 4);
          const int pp = i / (L::TILE_CH / 4);
          const int pr = pp / PT, pc = pp % PT;
          const int po = tc.po0 + pr, pcw = tc.pc0 + pc;
          if (po >= ho || pcw >= wo) continue;
          const int64_t o = (((int64_t)tc.n * ho + po) * wo + pcw) * COUT +
                            part * L::TILE_CH + 4 * q4;
          if constexpr (TRAIN) {
            // BN + ReLU of each in-image position, rounded to the
            // output's type, compared in window order with a strict >
            const int ch = part * L::TILE_CH + 4 * q4;
            float best[4] = {-1.f, -1.f, -1.f, -1.f}, yb[4] = {};
            uint32_t k[4] = {};
#pragma unroll
            for (int dr = 0; dr < 3; ++dr)
#pragma unroll
              for (int dc = 0; dc < 3; ++dc) {
                const int r = 2 * pr + dr, c = 2 * pc + dc;
                const int cr = tc.cr0 + r, cc = tc.cc0 + c;
                if (cr < 0 || cr >= hc || cc < 0 || cc >= wc) continue;
                const float4 y4 = load4(c_s + (r * CT + c) * CS + 4 * q4);
                const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float z = round_to<Tout>(
                      fmaxf(fmaf(y[j], sc_s[ch + j], bi_s[ch + j]), 0.f));
                  if (z > best[j]) {
                    best[j] = z;
                    yb[j] = y[j];
                    k[j] = dr * 3 + dc;
                  }
                }
              }
            store4(out + o, make_float4(best[0], best[1], best[2], best[3]));
            *reinterpret_cast<uint32_t*>(win + o) =
                k[0] | (k[1] << 8) | (k[2] << 16) | (k[3] << 24);
            *reinterpret_cast<float4*>(yw + o) =
                make_float4(yb[0], yb[1], yb[2], yb[3]);
          } else {
            float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int dr = 0; dr < 3; ++dr)
#pragma unroll
              for (int dc = 0; dc < 3; ++dc) {
                const int p = (2 * pr + dr) * CT + 2 * pc + dc;
                m = max4(m, load4(c_s + p * CS + 4 * q4));
              }
            store4(out + o, m);
          }
        }
      }
    }
    // without ALIAS, the next tile's epilogue writes c_s only after its
    // halo barrier, which every thread reaches after this pool
  }
}

// Launches stem_pool_tc_kernel as persistent blocks over every (frame,
// tile) item.
template <int KT, int CIN, int NG, bool F32IN, typename Tout,
          bool TRAIN = false>
int launch(const void* x, const void* wf, const void* wexp, const void* scale,
           const void* bias, const void* qscale, void* out, void* win,
           void* yw, int frames, int tlen, int h, int wd,
           cudaStream_t stream) {
  using L = Layout<KT, CIN, NG, F32IN, Tout, TRAIN>;
  auto kernel = stem_pool_tc_kernel<KT, CIN, NG, F32IN, Tout, TRAIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, L::NTH, L::BYTES)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int tiles_h = (ho + PT - 1) / PT, tiles_w = (wo + PT - 1) / PT;
  const long long total = (long long)frames * tiles_h * tiles_w;
  if (total <= 0 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < (long long)sms * per_sm ? total
                                                         : (long long)sms * per_sm);
  kernel<<<grid, L::NTH, L::BYTES, stream>>>(
      x, static_cast<const uint4*>(wf), static_cast<const float*>(wexp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(qscale), static_cast<Tout*>(out),
      static_cast<uint8_t*>(win), static_cast<float*>(yw), tlen, h, wd, hc,
      wc, ho, wo, tiles_h, tiles_w, (int)total);
  return (int)cudaGetLastError();
}

// The float stems, inference (TRAIN false) or training, by kind and dtype
// (the C interface's codes below).
template <bool TRAIN>
int launch_float(const void* x, const void* wf, const void* wexp,
                 const void* scale, const void* bias, void* out, void* win,
                 void* yw, int kind, int dtype, int b, int tlen, int h,
                 int wd, cudaStream_t s) {
  if (kind == 2 && dtype == 0)
    return launch<1, 3, 1, true, float, TRAIN>(
        x, wf, wexp, scale, bias, nullptr, out, win, yw, b, 1, h, wd, s);
  if (kind == 2 && dtype == 1)
    return launch<1, 3, 1, false, __nv_bfloat16, TRAIN>(
        x, wf, wexp, scale, bias, nullptr, out, win, yw, b, 1, h, wd, s);
  if (kind == 3 && dtype == 0)
    return launch<5, 1, 1, true, float, TRAIN>(
        x, wf, wexp, scale, bias, nullptr, out, win, yw, b * tlen, tlen, h,
        wd, s);
  if (kind == 3 && dtype == 1)
    return launch<5, 1, 1, false, __nv_bfloat16, TRAIN>(
        x, wf, wexp, scale, bias, nullptr, out, win, yw, b * tlen, tlen, h,
        wd, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory of each instance, as egot2x_stem_pool_smem_bytes reports it
template <int KT, int CIN, int NG, bool TRAIN = false>
int smem_of(int dtype, bool int8) {
  if (int8)
    return dtype == 0 ? Layout<KT, CIN, NG, true, int8_t>::BYTES
                      : Layout<KT, CIN, NG, false, int8_t>::BYTES;
  return dtype == 0
             ? Layout<KT, CIN, NG, true, float, TRAIN>::BYTES
             : Layout<KT, CIN, NG, false, __nv_bfloat16, TRAIN>::BYTES;
}

// ---------------------------------------------------------------------------
// The float stem's backward: the gradient the JAX package takes by XLA's
// autodiff of its XLA stems (egot2x/nn/resnet2d.py _StemConv + BN + ReLU +
// max_pool, egot2x/nn/talknet.py _Stem3DConv), from what the training
// forward saved: the pooled output p, the winners and their conv values yw.
// With g = dL/dp [p > 0] (ReLU's gradient is 0 where it clipped):
//   dL/dy at a pre-pool position = scale * the sum of g over the pooled
//     outputs whose window it won (at most 4: 2 rows x 2 columns);
//   dL/dbias = sum of g, dL/dscale = sum of g yw, per channel.
// dy is gathered, not scattered: a thread owns the 2x2 pre-pool positions
// (2po + dr, 2pc + dc) of one pooled output and 4 channels, reads the
// winners of the pooled outputs (po, pc), (po, pc + 1), (po + 1, pc),
// (po + 1, pc + 1) (row 2po lies only in window po, at its middle row;
// row 2po + 1 in windows po, its last row, and po + 1, its first), so dy is
// written once, with no atomics, and is deterministic. The same thread adds
// its own pooled output's g and g yw to its channels' sums; a block sums
// its threads' in shared memory, and a second pass sums the blocks' in
// order. It is bound by its bytes (dp, p, win, yw read once, dy written
// once: dy, f32 at 4x the pooled positions, is 55% of them in f32): at 480
// frames of 224^2 about 2.9 GB, 0.87 ms at 3.35 TB/s; it does ~2 operations
// a byte.
constexpr int BWD_THREADS = 256;          // 16 pooled positions x 16 quads
constexpr int BWD_PIX = BWD_THREADS / 16;
constexpr int BWD_BLOCKS_PER_SM = 8;

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
stem_pool_backward_kernel(const T* __restrict__ dp, const T* __restrict__ p,
                          const uint8_t* __restrict__ win,
                          const float* __restrict__ yw,
                          const float* __restrict__ scale,
                          float* __restrict__ dy,
                          float* __restrict__ partial, long long pooled,
                          int hc, int wc, int ho, int wo) {
  __shared__ float red[2][BWD_PIX][COUT];
  const int q4 = threadIdx.x % 16, slot = threadIdx.x / 16;
  const int c0 = 4 * q4;
  const float4 sc = *reinterpret_cast<const float4*>(scale + c0);
  float sb[4] = {}, ss[4] = {};
  const long long plane = (long long)ho * wo;
  for (long long i = (long long)blockIdx.x * BWD_PIX + slot; i < pooled;
       i += (long long)gridDim.x * BWD_PIX) {
    const long long n = i / plane;
    const int rem = (int)(i - n * plane);
    const int po = rem / wo, pc = rem - po * wo;
    float g[2][2][4];
    uint32_t w[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qo = po + a, qc = pc + b;
        w[a][b] = 0xffffffffu;    // matches no window position
#pragma unroll
        for (int j = 0; j < 4; ++j) g[a][b][j] = 0.f;
        if (qo < ho && qc < wo) {
          const long long off = ((n * ho + qo) * wo + qc) * COUT + c0;
          const float4 d = load4(dp + off), v = load4(p + off);
          g[a][b][0] = v.x > 0.f ? d.x : 0.f;
          g[a][b][1] = v.y > 0.f ? d.y : 0.f;
          g[a][b][2] = v.z > 0.f ? d.z : 0.f;
          g[a][b][3] = v.w > 0.f ? d.w : 0.f;
          w[a][b] = *reinterpret_cast<const uint32_t*>(win + off);
        }
      }
    const float4 y = *reinterpret_cast<const float4*>(
        yw + ((n * ho + po) * wo + pc) * COUT + c0);
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sb[j] += g[0][0][j];
      ss[j] += g[0][0][j] * yv[j];
    }
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      const int r = 2 * po + dr;
      if (r >= hc) break;
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int c = 2 * pc + dc;
        if (c >= wc) break;
        float acc[4] = {};
#pragma unroll
        for (int a = 0; a <= dr; ++a)
#pragma unroll
          for (int b = 0; b <= dc; ++b) {
            // the window row / column this position is in window (po + a)
            const int kr = dr == 0 ? 1 : (a == 0 ? 2 : 0);
            const int kc = dc == 0 ? 1 : (b == 0 ? 2 : 0);
            const uint32_t k = kr * 3 + kc;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (((w[a][b] >> (8 * j)) & 0xffu) == k) acc[j] += g[a][b][j];
          }
        *reinterpret_cast<float4*>(dy + ((n * hc + r) * wc + c) * COUT + c0) =
            make_float4(acc[0] * sc.x, acc[1] * sc.y, acc[2] * sc.z,
                        acc[3] * sc.w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][slot][c0 + j] = sb[j];
    red[1][slot][c0 + j] = ss[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * COUT) {
    const int which = threadIdx.x / COUT, ch = threadIdx.x % COUT;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_PIX; ++k) s += red[which][k][ch];
    partial[((long long)blockIdx.x * 2 + which) * COUT + ch] = s;
  }
}

// the second pass: sums (2, 64) = the blocks' partials summed in order
__global__ void __launch_bounds__(2 * COUT)
stem_pool_backward_sum_kernel(const float* __restrict__ partial, int blocks,
                              float* __restrict__ sums) {
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[b * 2 * COUT + threadIdx.x];
  sums[threadIdx.x] = s;
}

int backward_blocks(long long pooled, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long want = (pooled + BWD_PIX - 1) / BWD_PIX;
  const long long cap = (long long)sms * BWD_BLOCKS_PER_SM;
  *blocks = (int)(want < cap ? want : cap);
  return 0;
}

template <typename T>
int launch_backward(const void* dp, const void* p, const void* win,
                    const void* yw, const void* scale, void* dy,
                    void* partial, void* sums, int frames, int hc, int wc,
                    cudaStream_t stream) {
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const long long pooled = (long long)frames * ho * wo;
  int blocks = 0;
  if (pooled <= 0) return (int)cudaErrorInvalidValue;
  if (int err = backward_blocks(pooled, &blocks)) return err;
  stem_pool_backward_kernel<T><<<blocks, BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(dp), static_cast<const T*>(p),
      static_cast<const uint8_t*>(win), static_cast<const float*>(yw),
      static_cast<const float*>(scale), static_cast<float*>(dy),
      static_cast<float*>(partial), pooled, hc, wc, ho, wo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_pool_backward_sum_kernel<<<1, 2 * COUT, 0, stream>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The C interface's version: 3 since the float stems have a training
// variant and a backward (2: the float stems take weight fragments; 1,
// implicit before, took f32 taps for the float stem and for f32 input).
int egot2x_stem_pool_abi() { return 3; }

// Float stems. kind 2: 2D, x (b, h, w, 3); kind 3: 3D, x (b, tlen, h, w).
// dtype 0: f32 x and out, wf the fp16 fragments of the weights scaled by
// 2^-e_w and wexp (64,) the 2^e_w; dtype 1: bf16 x and out, wf the bf16
// fragments (wexp unread). wf (1, ksteps, 8, 32, 8) from
// ops/stem.py::weight_fragments. Returns a cudaError_t.
int egot2x_stem_pool(const void* x, const void* wf, const void* wexp,
                     const void* scale, const void* bias, void* out, int kind,
                     int dtype, int b, int tlen, int h, int wd,
                     void* stream) {
  return launch_float<false>(x, wf, wexp, scale, bias, out, nullptr, nullptr,
                             kind, dtype, b, tlen, h, wd,
                             static_cast<cudaStream_t>(stream));
}

// The float stems' training forward: the same output, and win (b*tlen,
// ho, wo, 64) uint8, each output's winner 0-8 in its 3x3 window, and yw
// (b*tlen, ho, wo, 64) f32, the winner's conv value.
int egot2x_stem_pool_train(const void* x, const void* wf, const void* wexp,
                           const void* scale, const void* bias, void* out,
                           void* win, void* yw, int kind, int dtype, int b,
                           int tlen, int h, int wd, void* stream) {
  return launch_float<true>(x, wf, wexp, scale, bias, out, win, yw, kind,
                            dtype, b, tlen, h, wd,
                            static_cast<cudaStream_t>(stream));
}

// The float stems' backward. dp, p: (frames, ho, wo, 64) f32 (dtype 0) or
// bf16 (dtype 1), the output's gradient and the output; win, yw as the
// training forward wrote them; scale (64,) f32. Writes dy (frames, hc, wc,
// 64) f32 and sums (2, 64) f32 = (dL/dbias, dL/dscale); partial holds
// egot2x_stem_pool_backward_blocks(...) x 2 x 64 f32.
int egot2x_stem_pool_backward(const void* dp, const void* p, const void* win,
                              const void* yw, const void* scale, void* dy,
                              void* partial, void* sums, int dtype,
                              int frames, int hc, int wc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(dp, p, win, yw, scale, dy, partial, sums,
                                  frames, hc, wc, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(dp, p, win, yw, scale, dy, partial,
                                          sums, frames, hc, wc, s);
  return (int)cudaErrorInvalidValue;
}

// blocks of the backward's first pass (its partial sums' rows), or -1
int egot2x_stem_pool_backward_blocks(int frames, int hc, int wc) {
  const long long ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  int blocks = 0;
  if (backward_blocks((long long)frames * ho * wo, &blocks)) return -1;
  return blocks;
}

// int8 stems, ng trunks stacked (kind 2: ng 1 or 2; kind 3: ng 1); wf
// (ng, ksteps, 8, 32, 8) and wexp (64*ng,) as for the float stems by
// dtype; scale, bias (64*ng,); qscale (ng,); out int8 (b*tlen, ho, wo,
// 64*ng).
int egot2x_stem_pool_q(const void* x, const void* wf, const void* wexp,
                       const void* scale, const void* bias,
                       const void* qscale, void* out, int kind, int dtype,
                       int ng, int b, int tlen, int h, int wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (kind == 2 && ng == 1)
      return launch<1, 3, 1, true, int8_t>(x, wf, wexp, scale, bias, qscale,
                                           out, nullptr, nullptr, b, 1, h, wd,
                                           s);
    if (kind == 2 && ng == 2)
      return launch<1, 3, 2, true, int8_t>(x, wf, wexp, scale, bias, qscale,
                                           out, nullptr, nullptr, b, 1, h, wd,
                                           s);
    if (kind == 3 && ng == 1)
      return launch<5, 1, 1, true, int8_t>(x, wf, wexp, scale, bias, qscale,
                                           out, nullptr, nullptr, b * tlen,
                                           tlen, h, wd, s);
  } else if (dtype == 1) {
    if (kind == 2 && ng == 1)
      return launch<1, 3, 1, false, int8_t>(x, wf, wexp, scale, bias, qscale,
                                            out, nullptr, nullptr, b, 1, h,
                                            wd, s);
    if (kind == 2 && ng == 2)
      return launch<1, 3, 2, false, int8_t>(x, wf, wexp, scale, bias, qscale,
                                            out, nullptr, nullptr, b, 1, h,
                                            wd, s);
    if (kind == 3 && ng == 1)
      return launch<5, 1, 1, false, int8_t>(x, wf, wexp, scale, bias, qscale,
                                            out, nullptr, nullptr, b * tlen,
                                            tlen, h, wd, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block, bytes: kind as above, ng 0 for the
// float stem or the int8 stem's trunks, -1 for the float stem's training
// variant; dtype 0 (f32 input) or 1 (bf16)
int egot2x_stem_pool_smem_bytes(int kind, int ng, int dtype) {
  if (ng < 0)
    return kind == 3 ? smem_of<5, 1, 1, true>(dtype, false)
                     : smem_of<1, 3, 1, true>(dtype, false);
  if (kind == 3) return smem_of<5, 1, 1>(dtype, ng != 0);
  return ng == 2 ? smem_of<1, 3, 2>(dtype, true)
                 : smem_of<1, 3, 1>(dtype, ng != 0);
}

// 16-bit elements of one trunk's weight fragments (kind as above)
int egot2x_stem_pool_fragment_elems(int kind) {
  return kind == 2 ? Geo<1, 3>::WFRAG : Geo<5, 1>::WFRAG;
}

const char* egot2x_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
