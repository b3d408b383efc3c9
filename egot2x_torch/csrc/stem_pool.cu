// Fused stems for Hopper: stride-2 conv + folded eval-BN + ReLU + 3x3/2
// pad-1 max-pool, writing only the pooled map. Three kernels:
//
//   stem_pool_kernel       float output. Replaces the TPU kernel
//                          egot2x/ops/pallas_stem.py::fused_stem_pool
//                          (:232, body _stem_kernel). f32 FMAs on the CUDA
//                          cores.
//   stem_pool_q_kernel     int8 output, f32 input: q = min(rint(relu(acc *
//                          scale + bias) / s), 127) per channel, then an
//                          integer 3x3/2 max-pool. Replaces
//                          egot2x/ops/pallas_stem.py::fused_stem_pool_q
//                          (:351, body _stem_kernel_q). NG trunks of 64
//                          channels stack in one launch (the fused LAM+TTM
//                          stem, NG = 2): the frames are read once and each
//                          trunk's channels use their own BN and step s.
//                          Shares the float kernel's staging and conv body.
//   stem_pool_q_tc_kernel  the same function for bf16 input (the int8
//                          path's), on the tensor cores: see its section.
//
// Geometries (each kernel instantiates both):
//   2D  ResNet-18 conv1: (N, H, W, 3) NHWC, 7x7/2 pad 3, 3 -> 64 channels;
//   3D  TalkNet frontend3D: (B, T, H, W) grey, 5x7x7 stride (1,2,2),
//       temporal zero-pad 2 applied per sample (frames of one clip never
//       see frames of the next).
// Output (frames, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64*NG) NHWC: the
// input's dtype (float kernel) or int8 with values in [0, 127]. f32 or
// bf16 in, f32 accumulation, f32 weights (split into two exact bf16 parts
// on the tensor cores).
//
// What bounds it on an H100: at one request (480 frames of 224^2) the int8
// 2D stem with both trunks is 223 GFLOP on in-image taps (zero-pad taps
// need no product): 0.23 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 0.45 ms at TF32's (495), 3.33 ms on the f32 CUDA cores (67); its bytes
// (289 MB of f32 or 145 MB of bf16 input, 193 MB of int8 output) take
// 0.09-0.14 ms. The 3D stem is 44 GFLOP (0.044 ms bf16). So the stems are
// bound by their operations, and on the CUDA cores by 7-15x more than on
// the tensor cores. The design spends nothing on bytes it does not have
// to move: the pre-pool conv map (4x the bytes of the pooled output)
// never leaves shared memory, and each input pixel is read from device
// memory once per tile (plus a small halo) for all stacked trunks.
//
// Block structure (CUDA-core kernels): a persistent block walks (frame,
// 7x7 pooled tile) work items. For one tile it
//   1. stages the input halo (35x35 px x C_in, x5 frames for 3D) in
//      shared memory as f32, split into even/odd columns so the
//      stride-2 conv reads consecutive words (no bank conflicts);
//   2. computes the 15x15x64 conv tile (pooled rows/cols 2p-1..2p+1):
//      each thread owns 4 pixels x 16 channels in registers, weights are
//      warp-uniform broadcasts from shared memory;
//   3. applies scale/bias + ReLU (and, int8, the quantizer), zeroes conv
//      positions outside the image (exact: post-ReLU values are >= 0 and
//      every pool window holds at least one real position) and parks the
//      tile in shared memory: f32, or one byte per value for int8;
//   4. max-pools 3x3/2 from shared memory and writes the 7x7x64 tile.
// The int8 kernel runs steps 2-4 once per stacked trunk on the same
// staged halo. The weights (<= 62.7 KB per trunk) are staged once per
// block.
//
// The quantizer is the JAX package's quantize_static on the BN+ReLU
// output: an IEEE f32 divide by s (no fast math) and a round half to even
// (__float2uint_rn, as rintf, jnp.round and torch.round; roundf would
// round half away from zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUT = 64;                 // channels of one trunk
constexpr int KS = 7;                    // spatial kernel edge
constexpr int PT = 7;                    // pooled tile edge
constexpr int CT = 2 * PT + 1;           // conv tile edge
constexpr int IT = 2 * (CT - 1) + KS;    // input tile edge
constexpr int ITH = (IT + 1) / 2;        // columns of one parity plane
constexpr int NPIX = CT * CT;            // conv pixels per tile
constexpr int PIX = 4;                   // conv pixels per thread
constexpr int CH = 16;                   // channels per thread
constexpr int GROUPS = 64;               // pixel groups: GROUPS * PIX >= NPIX
constexpr int THREADS = GROUPS * (COUT / CH);
constexpr int CSTRIDE = COUT + 4;        // padded pixel stride, f32 tile
constexpr int QSTRIDE = COUT + 16;       // pixel stride in bytes, int8 tile

static_assert(GROUPS * PIX >= NPIX, "pixel groups must cover the conv tile");
static_assert(THREADS == 256, "block shape");
static_assert(QSTRIDE % 16 == 0, "int8 tile rows take 16-byte stores");

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

template <int KT, int CIN>
__host__ __device__ constexpr int weight_floats() {
  return KT * KS * KS * CIN * COUT;
}
template <int KT, int CIN>
__host__ __device__ constexpr int halo_floats() {
  return KT * IT * 2 * ITH * CIN;
}

template <int KT, int CIN>
constexpr int smem_bytes() {
  return (weight_floats<KT, CIN>() + halo_floats<KT, CIN>() +
          NPIX * CSTRIDE) * (int)sizeof(float);
}

template <int KT, int CIN, int NG>
constexpr int smem_bytes_q() {
  return (NG * weight_floats<KT, CIN>() + halo_floats<KT, CIN>()) *
             (int)sizeof(float) + NPIX * QSTRIDE;
}

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

template <int KT, int CIN>
__device__ __forceinline__ void stage_weights(float* w_s, const float* w,
                                              int groups) {
  const int n4 = groups * weight_floats<KT, CIN>() / 4;
  for (int i = threadIdx.x; i < n4; i += THREADS)
    reinterpret_cast<float4*>(w_s)[i] =
        __ldg(reinterpret_cast<const float4*>(w) + i);
}

// this thread's conv pixels g + GROUPS*j as offsets into the parity planes:
// conv pixel (r, c) reads input row 2r+kh, column 2c+kw, which is plane
// kw&1, half-column c + kw/2
template <int CIN>
__device__ __forceinline__ void pixel_bases(int (&xbase)[PIX], int g) {
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    int p = g + GROUPS * j;
    p = p < NPIX ? p : 0;  // idle slots compute pixel 0 and never store
    xbase[j] = (2 * (p / CT) * 2 * ITH + p % CT) * CIN;
  }
}

// 1. input halo -> shared (zeros outside the frame and the clip)
template <typename Tin, int KT, int CIN>
__device__ __forceinline__ void stage_halo(float* x_s, const Tin* x,
                                           const Tile& tc, int tlen, int h,
                                           int wd) {
  const int ir0 = 2 * tc.cr0 - 3, ic0 = 2 * tc.cc0 - 3;
  for (int i = threadIdx.x; i < KT * IT * IT * CIN; i += THREADS) {
    const int ci = i % CIN;
    int rest = i / CIN;
    const int col = rest % IT;
    rest /= IT;
    const int row = rest % IT;
    const int kt = rest / IT;
    const int ts = tc.t + kt - KT / 2;
    const int hy = ir0 + row, wx = ic0 + col;
    float v = 0.f;
    if (ts >= 0 && ts < tlen && hy >= 0 && hy < h && wx >= 0 && wx < wd) {
      const int64_t frame = (int64_t)tc.b * tlen + ts;
      v = load_f32(x + (((frame * h + hy) * wd + wx) * CIN + ci));
    }
    x_s[(((kt * IT + row) * 2 + (col & 1)) * ITH + (col >> 1)) * CIN + ci] = v;
  }
}

// 2. one trunk's conv tile in registers; w_s holds its (KT, 7, 7, CIN, 64)
template <int KT, int CIN>
__device__ __forceinline__ void conv_tile(float (&acc)[PIX][CH],
                                          const float* x_s, const float* w_s,
                                          const int (&xbase)[PIX], int cg) {
#pragma unroll
  for (int j = 0; j < PIX; ++j)
#pragma unroll
    for (int q = 0; q < CH; ++q) acc[j][q] = 0.f;

#pragma unroll 1
  for (int kk = 0; kk < KT * KS; ++kk) {  // (kt, kh)
    const int kt = kk / KS, kh = kk % KS;
    const float* xrow = x_s + (kt * IT + kh) * 2 * ITH * CIN;
    const float* wrow = w_s + kk * KS * CIN * COUT + cg * CH;
#pragma unroll
    for (int kw = 0; kw < KS; ++kw) {
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const int xo = ((kw & 1) * ITH + (kw >> 1)) * CIN + ci;
        float xv[PIX];
#pragma unroll
        for (int j = 0; j < PIX; ++j) xv[j] = xrow[xbase[j] + xo];
        const float4* wp =
            reinterpret_cast<const float4*>(wrow + (kw * CIN + ci) * COUT);
        float wv[CH];
#pragma unroll
        for (int q4 = 0; q4 < CH / 4; ++q4) {
          const float4 v = wp[q4];
          wv[4 * q4 + 0] = v.x;
          wv[4 * q4 + 1] = v.y;
          wv[4 * q4 + 2] = v.z;
          wv[4 * q4 + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < PIX; ++j)
#pragma unroll
          for (int q = 0; q < CH; ++q)
            acc[j][q] = fmaf(xv[j], wv[q], acc[j][q]);
      }
    }
  }
}

// x: (B, T, H, W, CIN); w: (KT, 7, 7, CIN, 64) f32; out: (B*T, Ho, Wo, 64).
template <typename Tio, int KT, int CIN>
__global__ void __launch_bounds__(THREADS, (KT == 1 ? 2 : 1))
stem_pool_kernel(const Tio* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, Tio* __restrict__ out,
                 int tlen, int h, int wd, int hc, int wc, int ho, int wo,
                 int tiles_h, int tiles_w, int total_tiles) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + weight_floats<KT, CIN>();
  float* c_s = x_s + halo_floats<KT, CIN>();

  const int tid = threadIdx.x;
  stage_weights<KT, CIN>(w_s, w, 1);
  const int g = tid % GROUPS;
  const int cg = tid / GROUPS;  // warp-uniform: weight loads broadcast
  int xbase[PIX];
  pixel_bases<CIN>(xbase, g);

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const Tile tc = tile_at(tile, tlen, tiles_h, tiles_w);
    __syncthreads();  // previous tile's pool reads of c_s are done
    stage_halo<Tio, KT, CIN>(x_s, x, tc, tlen, h, wd);
    __syncthreads();

    float acc[PIX][CH];
    conv_tile<KT, CIN>(acc, x_s, w_s, xbase, cg);

    // 3. BN + ReLU epilogue into the shared conv tile
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const float s = __ldg(scale + cg * CH + q), o = __ldg(bias + cg * CH + q);
#pragma unroll
      for (int j = 0; j < PIX; ++j) acc[j][q] = fmaxf(fmaf(acc[j][q], s, o), 0.f);
    }
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int p = g + GROUPS * j;
      if (p < NPIX) {
        const int cr = tc.cr0 + p / CT, cc = tc.cc0 + p % CT;
        const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
        float* dst = c_s + p * CSTRIDE + cg * CH;
#pragma unroll
        for (int q4 = 0; q4 < CH / 4; ++q4) {
          float4 v = make_float4(acc[j][4 * q4], acc[j][4 * q4 + 1],
                                 acc[j][4 * q4 + 2], acc[j][4 * q4 + 3]);
          if (!inside) v = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(dst + 4 * q4) = v;
        }
      }
    }
    __syncthreads();

    // 4. 3x3/2 max-pool: pooled (pr, pc) reads tile rows/cols 2pr..2pr+2
    for (int i = tid; i < PT * PT * (COUT / 4); i += THREADS) {
      const int q4 = i % (COUT / 4);
      const int pp = i / (COUT / 4);
      const int pr = pp / PT, pc = pp % PT;
      const int po = tc.po0 + pr, pcw = tc.pc0 + pc;
      if (po >= ho || pcw >= wo) continue;
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int p = (2 * pr + dr) * CT + 2 * pc + dc;
          m = max4(m, *reinterpret_cast<const float4*>(c_s + p * CSTRIDE +
                                                       4 * q4));
        }
      store4(out + ((((int64_t)tc.n * ho + po) * wo + pcw) * COUT + 4 * q4),
             m);
    }
  }
}

// x: (B, T, H, W, CIN); w: (NG, KT, 7, 7, CIN, 64) f32; scale, bias:
// (64*NG,) f32; qscale: (NG,) f32, the int8 step s of each trunk;
// out: (B*T, Ho, Wo, 64*NG) int8.
template <typename Tin, int KT, int CIN, int NG>
__global__ void __launch_bounds__(THREADS, 2)
stem_pool_q_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ qscale, int8_t* __restrict__ out,
                   int tlen, int h, int wd, int hc, int wc, int ho, int wo,
                   int tiles_h, int tiles_w, int total_tiles) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + NG * weight_floats<KT, CIN>();
  uint8_t* c_q = reinterpret_cast<uint8_t*>(x_s + halo_floats<KT, CIN>());

  const int tid = threadIdx.x;
  stage_weights<KT, CIN>(w_s, w, NG);
  const int g = tid % GROUPS;
  const int cg = tid / GROUPS;
  int xbase[PIX];
  pixel_bases<CIN>(xbase, g);

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const Tile tc = tile_at(tile, tlen, tiles_h, tiles_w);
    // the previous tile ended on a barrier after its last pool, so the
    // halo and the int8 tile are free
    stage_halo<Tin, KT, CIN>(x_s, x, tc, tlen, h, wd);
    __syncthreads();

#pragma unroll 1
    for (int gi = 0; gi < NG; ++gi) {
      float acc[PIX][CH];
      conv_tile<KT, CIN>(acc, x_s, w_s + gi * weight_floats<KT, CIN>(),
                         xbase, cg);

      // 3. BN + ReLU + quantize: the quotient is >= 0, so rounding it
      // half to even is __float2uint_rn (rintf and a conversion in one
      // instruction), and the clip to [-127, 127] is a min with 127. The
      // byte parks in acc's register as bits.
      const float qs = __ldg(qscale + gi);
      const int c0 = gi * COUT + cg * CH;
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        const float s = __ldg(scale + c0 + q), o = __ldg(bias + c0 + q);
#pragma unroll
        for (int j = 0; j < PIX; ++j)
          acc[j][q] = __uint_as_float(min(
              __float2uint_rn(fmaxf(fmaf(acc[j][q], s, o), 0.f) / qs), 127u));
      }
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        const int p = g + GROUPS * j;
        if (p < NPIX) {
          const int cr = tc.cr0 + p / CT, cc = tc.cc0 + p % CT;
          const bool inside = cr >= 0 && cr < hc && cc >= 0 && cc < wc;
          uint32_t word[CH / 4];
#pragma unroll
          for (int q4 = 0; q4 < CH / 4; ++q4) {
            word[q4] = 0u;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              word[q4] |= __float_as_uint(acc[j][4 * q4 + k]) << (8 * k);
            if (!inside) word[q4] = 0u;
          }
          *reinterpret_cast<uint4*>(c_q + p * QSTRIDE + cg * CH) =
              make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      __syncthreads();

      // 4. 3x3/2 max-pool of the bytes, 4 channels per word (values are
      // 0..127, so the unsigned byte max is the int8 max)
      for (int i = tid; i < PT * PT * (COUT / 4); i += THREADS) {
        const int q4 = i % (COUT / 4);
        const int pp = i / (COUT / 4);
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
                                c_q + p * QSTRIDE + 4 * q4));
          }
        *reinterpret_cast<uint32_t*>(
            out + (((int64_t)tc.n * ho + po) * wo + pcw) * (NG * COUT) +
            gi * COUT + 4 * q4) = m;
      }
      __syncthreads();  // pool reads done before the tile is rewritten
    }
  }
}

// ---- The int8 stem on the tensor cores (bf16 input) ----------------------
//
// stem_pool_q_tc_kernel computes what stem_pool_q_kernel does, as an
// implicit GEMM per tile with mma.sync m16n8k16 (bf16 in, f32 sums):
//   M  the tile's conv pixels: one M-tile of 16 is one conv row of the
//      15 x 15 tile (the 16th pixel is computed and dropped);
//   N  64 channels of one trunk: 8 n-tiles;
//   K  the taps, in runs that lie contiguous in the staged bf16 halo: 2D,
//      per kh the 7 kw x 3 ci = 21 values of one NHWC halo row, padded to
//      24 (K 168 -> 11 k-steps, 176); 3D, per (kt, kh) the 7 kw, padded to
//      8 (K 280 -> 18 k-steps, 288). The padded taps have zero weights.
// Conv pixel c of a row reads its run at halo offset 2c CIN, so the A
// fragment's two adjacent taps are one 32-bit shared load, and the words a
// warp loads span fewer than 32 banks: no bank conflicts, no im2col copy.
// The weights are f32 in the plain version; each splits into bf16 w_hi +
// w_lo (the wrapper does it once per weight, see ops/stem.py), and both
// parts multiply the same exact bf16 A fragment: sum x (w_hi + w_lo), good
// to ~2^-16 relative per tap, f32 accumulation. The weights lie in shared
// memory in fragment order, (k-step, n-tile, lane) x [hi b0b1, hi b2b3, lo
// b0b1, lo b2b3]: one 16-byte load per lane feeds four MMAs of two
// M-tiles.
// A block is 8 warps per trunk (both trunks at once for n = 2: 512
// threads, 129 KB of shared memory, one block an SM; n = 1 and 3D: 256
// threads, 70 / 104 KB, two blocks an SM), each warp two conv rows (mg and
// mg + 8) of one trunk. Per tile:
//   1. the halo is staged as bf16 bits, 8 loads in flight a thread;
//   2. the conv, its 11 or 18 k-steps unrolled so that the halo offsets of
//      the K runs are constants;
//   3. the epilogue (scale, bias, ReLU, the divide by s, round half to
//      even, min 127, zero outside the image) parks the bytes in shared
//      memory. It runs on the FP32 pipe (see quantize): with the IEEE
//      divide's reciprocal and the float-to-int conversion, both
//      quarter-rate, it took longer than the MMAs;
//   4. the integer pool runs over all trunks' channels.
// What bounds it, from scratch builds with parts switched off on an H100:
// the MMAs with their fragment loads (two weight passes and the K and M
// padding make 3.2x the in-image products, and each warp reads every
// weight fragment from shared memory: 160 bytes an MMA), then the halo
// staging, which no other block overlaps when n = 2. wgmma, which reads B
// once per warpgroup, is the next step.
// Build (nvcc -Xptxas -v, sm_90a): 128 registers, the launch bound, with
// 44 (2D) to 60 (3D) bytes spilled; shared memory 131,952 (2D, n = 2),
// 71,976 (2D, n = 1) and 106,248 (3D) bytes a block.

template <int KT, int CIN>
struct TcGeo {
  static constexpr int RUN = CIN == 3 ? 24 : 8;    // taps of a run, padded
  static constexpr int HPR = RUN / 8;              // 8-tap halves per run
  static constexpr int RUNS = KT * KS;             // (kt, kh) runs
  static constexpr int KSTEPS = (RUNS * RUN + 15) / 16;
  static constexpr int XCOLS = 40;                 // staged halo columns
  static constexpr int XRS = XCOLS * CIN;          // halo row, bf16
  static constexpr int HALO = KT * IT * XRS;       // bf16 of the halo
  static constexpr int WFRAG = KSTEPS * 8 * 32 * 8;  // bf16 of one trunk
  // the 16th pixel of a conv row (2 * 15 columns on) reads a whole run
  static_assert(2 * 15 * CIN + RUN <= XRS, "halo row too short");
};

template <int NG>
__host__ __device__ constexpr int tc_qstride() {
  return NG * COUT + 16;
}

template <int KT, int CIN, int NG>
constexpr int smem_bytes_tc() {
  using G = TcGeo<KT, CIN>;
  return 2 * (NG * G::WFRAG + G::HALO) + NPIX * tc_qstride<NG>() +
         (2 * NG * COUT + 2 * NG) * (int)sizeof(float);
}

// halo offset (bf16) of 8-tap half h of the K axis; halves past the last
// run have zero weights and read run 0
template <int KT, int CIN>
__device__ __forceinline__ int half_offset(int h) {
  using G = TcGeo<KT, CIN>;
  const int run = h / G::HPR;
  return run >= G::RUNS
             ? 0
             : ((run / KS) * IT + run % KS) * G::XRS + 8 * (h % G::HPR);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// x: (B, T, H, W, CIN) bf16; wf: (NG, KSTEPS, 8, 32, 8) bf16 fragments;
// scale, bias: (64*NG,) f32; qscale: (NG,) f32; out: (B*T, Ho, Wo, 64*NG)
// int8.
template <int KT, int CIN, int NG>
__global__ void __launch_bounds__(THREADS * NG, 2 / NG)
stem_pool_q_tc_kernel(const uint16_t* __restrict__ x,
                      const uint4* __restrict__ wf,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ qscale,
                      int8_t* __restrict__ out, int tlen, int h, int wd,
                      int hc, int wc, int ho, int wo, int tiles_h,
                      int tiles_w, int total_tiles) {
  using G = TcGeo<KT, CIN>;
  constexpr int NTH = THREADS * NG, QS = tc_qstride<NG>();
  constexpr int STAGE = 8;   // halo loads a thread issues before its stores
  extern __shared__ uint4 smem_tc[];
  uint4* w_s = smem_tc;                                    // fragments
  uint8_t* c_q = reinterpret_cast<uint8_t*>(w_s + NG * G::WFRAG / 8);
  uint16_t* x_s = reinterpret_cast<uint16_t*>(c_q + NPIX * QS);
  float* sc_s = reinterpret_cast<float*>(x_s + G::HALO);  // scale, bias, s
  float* bi_s = sc_s + NG * COUT;
  float* qs_s = bi_s + NG * COUT;                          // s, then 1 / s

  const int tid = threadIdx.x;
  for (int i = tid; i < NG * G::WFRAG / 8; i += NTH) w_s[i] = __ldg(wf + i);
  for (int i = tid; i < NG * COUT; i += NTH) {
    sc_s[i] = __ldg(scale + i);
    bi_s[i] = __ldg(bias + i);
  }
  if (tid < NG) {
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
    // 1. halo (KT x 35 rows x 40 cols x CIN) as bf16 bits, zeros outside
    // the frame, the clip and the 35 real columns. The previous tile's
    // pool read only c_q, and its conv finished before its epilogue
    // barrier, so x_s is free.
    {
      const int ir0 = 2 * tc.cr0 - 3, e0 = (2 * tc.cc0 - 3) * CIN;
      const int64_t clip = (int64_t)tc.b * tlen;
#pragma unroll 1
      for (int i0 = tid; i0 < G::HALO; i0 += STAGE * NTH) {
        uint16_t v[STAGE];   // STAGE loads in flight a thread
#pragma unroll
        for (int j = 0; j < STAGE; ++j) {
          const int i = i0 + j * NTH;
          const int r = i / G::XRS, e = i - r * G::XRS;   // halo row, element
          const int kt = r / IT, row = r - kt * IT;
          const int ts = tc.t + kt - KT / 2, hy = ir0 + row, we = e0 + e;
          v[j] = 0;
          if (i < G::HALO && e < IT * CIN && ts >= 0 && ts < tlen &&
              hy >= 0 && hy < h && we >= 0 && we < wd * CIN)
            v[j] = __ldg(x + ((clip + ts) * h + hy) * wd * CIN + we);
        }
#pragma unroll
        for (int j = 0; j < STAGE; ++j)
          if (i0 + j * NTH < G::HALO) x_s[i0 + j * NTH] = v[j];
      }
    }
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
      constexpr int PIX8 = 16 * CIN;   // pixel g + 8, bf16 further on
      const int o0 = half_offset<KT, CIN>(2 * s);
      const int o1 = half_offset<KT, CIN>(2 * s + 1);
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = lds32(xb[i] + o0);
        a[i][1] = lds32(xb[i] + o0 + PIX8);
        a[i][2] = lds32(xb[i] + o1);
        a[i][3] = lds32(xb[i] + o1 + PIX8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint4 w = wt[(s * 8 + nt) * 32];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][nt], a[i], w.z, w.w);   // w_lo first
          mma_bf16(acc[i][nt], a[i], w.x, w.y);
        }
      }
    }

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
        uint8_t* dst = c_q + (rows[i] * CT + c) * QS + tr * COUT + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = tr * COUT + nt * 8 + 2 * t;
          const uint32_t q0 = quantize(acc[i][nt][2 * half], sc_s[ch],
                                       bi_s[ch], qs, rqs);
          const uint32_t q1 = quantize(acc[i][nt][2 * half + 1],
                                       sc_s[ch + 1], bi_s[ch + 1], qs, rqs);
          *reinterpret_cast<uint16_t*>(dst + nt * 8) =
              inside ? (uint16_t)(q0 | (q1 << 8)) : (uint16_t)0;
        }
      }
    }
    __syncthreads();

    // 4. 3x3/2 max-pool of the bytes of every trunk, 4 channels a word
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
          m = __vmaxu4(m, *reinterpret_cast<const uint32_t*>(c_q + p * QS +
                                                              4 * q4));
        }
      *reinterpret_cast<uint32_t*>(
          out + (((int64_t)tc.n * ho + po) * wo + pcw) * (NG * COUT) +
          4 * q4) = m;
    }
    // the next tile's epilogue writes c_q only after its halo barrier,
    // which every thread reaches after this pool
  }
}

// Launches `kernel` as persistent blocks over every (frame, tile) item.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, int smem, int frames,
                      int tlen, int h, int wd, cudaStream_t stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int tiles_h = (ho + PT - 1) / PT, tiles_w = (wo + PT - 1) / PT;
  const long long total = (long long)frames * tiles_h * tiles_w;
  if (total <= 0 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < (long long)sms * per_sm ? total
                                                         : (long long)sms * per_sm);
  kernel<<<grid, threads, smem, stream>>>(args..., tlen, h, wd, hc, wc, ho,
                                          wo, tiles_h, tiles_w, (int)total);
  return (int)cudaGetLastError();
}

template <typename Tio, int KT, int CIN>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int b, int tlen, int h, int wd, cudaStream_t stream) {
  return launch_persistent(
      stem_pool_kernel<Tio, KT, CIN>, THREADS, smem_bytes<KT, CIN>(),
      b * tlen, tlen,
      h, wd, stream, static_cast<const Tio*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<Tio*>(out));
}

template <typename Tin, int KT, int CIN, int NG>
int launch_q(const void* x, const void* w, const void* scale,
             const void* bias, const void* qscale, void* out, int b, int tlen,
             int h, int wd, cudaStream_t stream) {
  return launch_persistent(
      stem_pool_q_kernel<Tin, KT, CIN, NG>, THREADS,
      smem_bytes_q<KT, CIN, NG>(), b * tlen, tlen, h, wd, stream,
      static_cast<const Tin*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(qscale), static_cast<int8_t*>(out));
}

template <int KT, int CIN, int NG>
int launch_q_tc(const void* x, const void* wf, const void* scale,
                const void* bias, const void* qscale, void* out, int b,
                int tlen, int h, int wd, cudaStream_t stream) {
  return launch_persistent(
      stem_pool_q_tc_kernel<KT, CIN, NG>, THREADS * NG,
      smem_bytes_tc<KT, CIN, NG>(), b * tlen, tlen, h, wd, stream,
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wf),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(qscale), static_cast<int8_t*>(out));
}

// kind 2 with ng 1 or 2, kind 3 with ng 1; dtype 0 (f32 x, f32 taps) on
// the CUDA cores, dtype 1 (bf16 x, bf16 fragments) on the tensor cores
int dispatch_q(const void* x, const void* w, const void* scale,
               const void* bias, const void* qscale, void* out, int kind,
               int dtype, int ng, int b, int tlen, int h, int wd,
               cudaStream_t s) {
  if (dtype == 0) {
    if (kind == 2 && ng == 1)
      return launch_q<float, 1, 3, 1>(x, w, scale, bias, qscale, out, b, 1,
                                      h, wd, s);
    if (kind == 2 && ng == 2)
      return launch_q<float, 1, 3, 2>(x, w, scale, bias, qscale, out, b, 1,
                                      h, wd, s);
    if (kind == 3 && ng == 1)
      return launch_q<float, 5, 1, 1>(x, w, scale, bias, qscale, out, b,
                                      tlen, h, wd, s);
  } else if (dtype == 1) {
    if (kind == 2 && ng == 1)
      return launch_q_tc<1, 3, 1>(x, w, scale, bias, qscale, out, b, 1, h,
                                  wd, s);
    if (kind == 2 && ng == 2)
      return launch_q_tc<1, 3, 2>(x, w, scale, bias, qscale, out, b, 1, h,
                                  wd, s);
    if (kind == 3 && ng == 1)
      return launch_q_tc<5, 1, 1>(x, w, scale, bias, qscale, out, b, tlen,
                                  h, wd, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// kind 2: 2D stem, x (b, h, w, 3), w (7, 7, 3, 64)
// kind 3: 3D stem, x (b, tlen, h, w), w (5, 7, 7, 64)
// dtype 0: float32, 1: bfloat16 (x and out). Returns a cudaError_t.
int egot2x_stem_pool(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int kind, int dtype, int b,
                     int tlen, int h, int wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2 && dtype == 0)
    return launch<float, 1, 3>(x, w, scale, bias, out, b, 1, h, wd, s);
  if (kind == 2 && dtype == 1)
    return launch<__nv_bfloat16, 1, 3>(x, w, scale, bias, out, b, 1, h, wd, s);
  if (kind == 3 && dtype == 0)
    return launch<float, 5, 1>(x, w, scale, bias, out, b, tlen, h, wd, s);
  if (kind == 3 && dtype == 1)
    return launch<__nv_bfloat16, 5, 1>(x, w, scale, bias, out, b, tlen, h, wd,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// int8 stems, ng trunks stacked (kind 2: ng 1 or 2; kind 3: ng 1);
// scale, bias (64*ng,); qscale (ng,); out int8 (b*tlen, ho, wo, 64*ng).
// dtype 0: f32 x and f32 taps w (ng, 7, 7, 3, 64) or (1, 5, 7, 7, 64);
// dtype 1: bf16 x and w the bf16 weight fragments (ng, ksteps, 8, 32, 8)
// of ops/stem.py::weight_fragments.
int egot2x_stem_pool_q(const void* x, const void* w, const void* scale,
                       const void* bias, const void* qscale, void* out,
                       int kind, int dtype, int ng, int b, int tlen, int h,
                       int wd, void* stream) {
  return dispatch_q(x, w, scale, bias, qscale, out, kind, dtype, ng, b, tlen,
                    h, wd, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of one block, bytes (kind as above; ng 0 is the
// float kernel; dtype picks the int8 kernel as egot2x_stem_pool_q does)
int egot2x_stem_pool_smem_bytes(int kind, int ng, int dtype) {
  if (ng == 0) return kind == 2 ? smem_bytes<1, 3>() : smem_bytes<5, 1>();
  if (dtype == 1) {
    if (kind == 2) return ng == 1 ? smem_bytes_tc<1, 3, 1>()
                                  : smem_bytes_tc<1, 3, 2>();
    return smem_bytes_tc<5, 1, 1>();
  }
  if (kind == 2) return ng == 1 ? smem_bytes_q<1, 3, 1>()
                                : smem_bytes_q<1, 3, 2>();
  return smem_bytes_q<5, 1, 1>();
}

// bf16 weight fragments of one trunk (kind as above)
int egot2x_stem_pool_q_fragment_elems(int kind) {
  return kind == 2 ? TcGeo<1, 3>::WFRAG : TcGeo<5, 1>::WFRAG;
}

const char* egot2x_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
