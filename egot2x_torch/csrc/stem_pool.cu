// Fused stems for Hopper: stride-2 conv + folded eval-BN + ReLU + 3x3/2
// pad-1 max-pool, writing only the pooled map. Two kernels share the
// input staging and the conv body:
//
//   stem_pool_kernel     float output. Replaces the TPU kernel
//                        egot2x/ops/pallas_stem.py::fused_stem_pool (:232,
//                        body _stem_kernel).
//   stem_pool_q_kernel   int8 output: q = min(rint(relu(acc*scale+bias)/s),
//                        127) per channel, then an integer 3x3/2 max-pool.
//                        Replaces egot2x/ops/pallas_stem.py::fused_stem_pool_q
//                        (:351, body _stem_kernel_q). NG trunks of 64
//                        channels stack in one launch (the fused LAM+TTM
//                        stem, NG = 2): the frames are read once and each
//                        trunk's channels use their own BN and scale s.
//
// Geometries (each kernel instantiates both):
//   2D  ResNet-18 conv1: (N, H, W, 3) NHWC, 7x7/2 pad 3, 3 -> 64 channels;
//   3D  TalkNet frontend3D: (B, T, H, W) grey, 5x7x7 stride (1,2,2),
//       temporal zero-pad 2 applied per sample (frames of one clip never
//       see frames of the next).
// Output (frames, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64*NG) NHWC: the
// input's dtype (float kernel) or int8 with values in [0, 127]. f32 or
// bf16 in, f32 accumulation, f32 weights.
//
// What bounds it on an H100: at the bench batch (4800 frames of 224^2)
// one 2D trunk is 1.12 TFLOP (in-image taps; zero-pad taps need no
// product) against 6.7 GB of f32 input and output, so it is
// compute-bound: ~16.7 ms at 67 TFLOP/s on the f32 CUDA cores. The 3D
// stem is 0.44 TFLOP and 1.2 GB (~6.6 ms). The int8 kernel at 480 frames
// (one request of 16 clips x 30 frames) with both trunks: 223 GFLOP,
// 3.33 ms at 67 TFLOP/s, against 289 MB of f32 input and 193 MB of int8
// output (0.14 ms); 3D 0.656 ms. The design spends nothing on bytes it
// does not have to move: the pre-pool conv map (4x the bytes of the
// pooled output) never leaves shared memory, and each input pixel is
// read from device memory once per tile (plus a small halo) for all
// stacked trunks. The FMAs run on the CUDA cores in f32, so the f32 path
// matches the CPU reference to 1e-4; tensor cores (TF32 or bf16 mma) are
// the next step and would lower the bound 7-15x.
//
// Block structure: a persistent block walks (frame, 7x7 pooled tile)
// work items. For one tile it
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

// Launches `kernel` as persistent blocks over every (frame, tile) item.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int smem, int frames, int tlen, int h,
                      int wd, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int tiles_h = (ho + PT - 1) / PT, tiles_w = (wo + PT - 1) / PT;
  const long long total = (long long)frames * tiles_h * tiles_w;
  if (total <= 0 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < (long long)sms * per_sm ? total
                                                         : (long long)sms * per_sm);
  kernel<<<grid, THREADS, smem, stream>>>(args..., tlen, h, wd, hc, wc, ho,
                                          wo, tiles_h, tiles_w, (int)total);
  return (int)cudaGetLastError();
}

template <typename Tio, int KT, int CIN>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int b, int tlen, int h, int wd, cudaStream_t stream) {
  return launch_persistent(
      stem_pool_kernel<Tio, KT, CIN>, smem_bytes<KT, CIN>(), b * tlen, tlen,
      h, wd, stream, static_cast<const Tio*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<Tio*>(out));
}

template <typename Tin, int KT, int CIN, int NG>
int launch_q(const void* x, const void* w, const void* scale,
             const void* bias, const void* qscale, void* out, int b, int tlen,
             int h, int wd, cudaStream_t stream) {
  return launch_persistent(
      stem_pool_q_kernel<Tin, KT, CIN, NG>, smem_bytes_q<KT, CIN, NG>(),
      b * tlen, tlen, h, wd, stream, static_cast<const Tin*>(x),
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(qscale),
      static_cast<int8_t*>(out));
}

template <typename Tin>
int dispatch_q(const void* x, const void* w, const void* scale,
               const void* bias, const void* qscale, void* out, int kind,
               int ng, int b, int tlen, int h, int wd, cudaStream_t s) {
  if (kind == 2 && ng == 1)
    return launch_q<Tin, 1, 3, 1>(x, w, scale, bias, qscale, out, b, 1, h, wd,
                                  s);
  if (kind == 2 && ng == 2)
    return launch_q<Tin, 1, 3, 2>(x, w, scale, bias, qscale, out, b, 1, h, wd,
                                  s);
  if (kind == 3 && ng == 1)
    return launch_q<Tin, 5, 1, 1>(x, w, scale, bias, qscale, out, b, tlen, h,
                                  wd, s);
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

// int8 stems, ng trunks stacked (kind 2: ng 1 or 2; kind 3: ng 1):
// w (ng, 7, 7, 3, 64) or (1, 5, 7, 7, 64); scale, bias (64*ng,);
// qscale (ng,); out int8 (b*tlen, ho, wo, 64*ng). dtype as above, for x.
int egot2x_stem_pool_q(const void* x, const void* w, const void* scale,
                       const void* bias, const void* qscale, void* out,
                       int kind, int dtype, int ng, int b, int tlen, int h,
                       int wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_q<float>(x, w, scale, bias, qscale, out, kind, ng, b, tlen,
                             h, wd, s);
  if (dtype == 1)
    return dispatch_q<__nv_bfloat16>(x, w, scale, bias, qscale, out, kind, ng,
                                     b, tlen, h, wd, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block, bytes (kind as above; ng 0 is the
// float kernel)
int egot2x_stem_pool_smem_bytes(int kind, int ng) {
  if (ng == 0) return kind == 2 ? smem_bytes<1, 3>() : smem_bytes<5, 1>();
  if (kind == 2) return ng == 1 ? smem_bytes_q<1, 3, 1>()
                                : smem_bytes_q<1, 3, 2>();
  return smem_bytes_q<5, 1, 1>();
}

const char* egot2x_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
