// Fused stem for Hopper: stride-2 conv + folded eval-BN + ReLU + 3x3/2
// pad-1 max-pool, writing only the pooled map.
//
// Replaces the TPU kernel egot2x/ops/pallas_stem.py::fused_stem_pool
// (body _stem_kernel). Two instantiations share one body:
//   2D  ResNet-18 conv1: (N, H, W, 3) NHWC, 7x7/2 pad 3, 3 -> 64 channels;
//   3D  TalkNet frontend3D: (B, T, H, W) grey, 5x7x7 stride (1,2,2),
//       temporal zero-pad 2 applied per sample (frames of one clip never
//       see frames of the next).
// Output (frames, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64) NHWC in the
// input's dtype; f32 or bf16 in, f32 accumulation, f32 weights.
//
// What bounds it on an H100: at the bench batch (4800 frames of 224^2)
// one 2D trunk is 1.12 TFLOP (in-image taps; zero-pad taps need no
// product) against 6.7 GB of f32 input and output, so it is
// compute-bound: ~16.7 ms at 67 TFLOP/s on the f32 CUDA cores. The 3D
// stem is 0.44 TFLOP and 1.2 GB (~6.6 ms). The design spends nothing
// on bytes it does not have to move: the pre-pool conv map (4x the bytes
// of the pooled output) never leaves shared memory, and each input pixel
// is read from device memory once per tile (plus a small halo). The FMAs
// run on the CUDA cores in f32, so the f32 path matches the CPU reference
// to 1e-4; tensor cores (TF32 or bf16 mma) are the next step and would
// lower the bound 7-15x.
//
// Block structure: a persistent block walks (frame, 7x7 pooled tile)
// work items. For one tile it
//   1. stages the input halo (35x35 px x C_in, x5 frames for 3D) in
//      shared memory as f32, split into even/odd columns so the
//      stride-2 conv reads consecutive words (no bank conflicts);
//   2. computes the 15x15x64 conv tile (pooled rows/cols 2p-1..2p+1):
//      each thread owns 4 pixels x 16 channels in registers, weights are
//      warp-uniform broadcasts from shared memory;
//   3. applies scale/bias + ReLU, zeroes conv positions outside the
//      image (exact: post-ReLU values are >= 0 and every pool window
//      holds at least one real position) and parks the tile in shared
//      memory;
//   4. max-pools 3x3/2 from shared memory and writes the 7x7x64 tile.
// The weights (<= 62.7 KB) are staged once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUT = 64;
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
constexpr int CSTRIDE = COUT + 4;        // padded pixel stride of the conv tile

static_assert(GROUPS * PIX >= NPIX, "pixel groups must cover the conv tile");
static_assert(THREADS == 256, "block shape");

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
constexpr int smem_floats() {
  return KT * KS * KS * CIN * COUT       // weights
         + KT * IT * 2 * ITH * CIN       // input halo, parity-split
         + NPIX * CSTRIDE;               // post-ReLU conv tile
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
  float* x_s = w_s + KT * KS * KS * CIN * COUT;
  float* c_s = x_s + KT * IT * 2 * ITH * CIN;

  const int tid = threadIdx.x;
  constexpr int WFLOATS = KT * KS * KS * CIN * COUT;
  for (int i = tid; i < WFLOATS / 4; i += THREADS)
    reinterpret_cast<float4*>(w_s)[i] =
        __ldg(reinterpret_cast<const float4*>(w) + i);

  // this thread's conv work: pixels g + GROUPS*j, channels cg*CH..+CH
  const int g = tid % GROUPS;
  const int cg = tid / GROUPS;  // warp-uniform: weight loads broadcast
  int xbase[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    int p = g + GROUPS * j;
    p = p < NPIX ? p : 0;  // idle slots compute pixel 0 and never store
    // conv pixel (r, c) reads input row 2r+kh, column 2c+kw: in the
    // parity planes that is plane kw&1, half-column c + kw/2
    xbase[j] = (2 * (p / CT) * 2 * ITH + p % CT) * CIN;
  }

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int tw = tile % tiles_w;
    const int th = (tile / tiles_w) % tiles_h;
    const int n = tile / (tiles_w * tiles_h);  // frame = b * tlen + t
    const int b = n / tlen, t = n % tlen;
    const int po0 = th * PT, pc0 = tw * PT;
    const int cr0 = 2 * po0 - 1, cc0 = 2 * pc0 - 1;  // first conv row/col
    const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;  // first input row/col

    __syncthreads();  // previous tile's pool reads of c_s are done
    // 1. input halo -> shared (zeros outside the frame and the clip)
    for (int i = tid; i < KT * IT * IT * CIN; i += THREADS) {
      const int ci = i % CIN;
      int rest = i / CIN;
      const int col = rest % IT;
      rest /= IT;
      const int row = rest % IT;
      const int kt = rest / IT;
      const int ts = t + kt - KT / 2;
      const int hy = ir0 + row, wx = ic0 + col;
      float v = 0.f;
      if (ts >= 0 && ts < tlen && hy >= 0 && hy < h && wx >= 0 && wx < wd) {
        const int64_t frame = (int64_t)b * tlen + ts;
        v = load_f32(x + (((frame * h + hy) * wd + wx) * CIN + ci));
      }
      x_s[(((kt * IT + row) * 2 + (col & 1)) * ITH + (col >> 1)) * CIN + ci] =
          v;
    }
    __syncthreads();

    // 2. conv tile in registers
    float acc[PIX][CH];
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
        const int cr = cr0 + p / CT, cc = cc0 + p % CT;
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
      const int po = po0 + pr, pcw = pc0 + pc;
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
      store4(out + ((((int64_t)n * ho + po) * wo + pcw) * COUT + 4 * q4), m);
    }
  }
}

template <typename Tio, int KT, int CIN>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int b, int tlen, int h, int wd, cudaStream_t stream) {
  auto kernel = stem_pool_kernel<Tio, KT, CIN>;
  const int smem = smem_floats<KT, CIN>() * (int)sizeof(float);
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
  const long long total = (long long)b * tlen * tiles_h * tiles_w;
  if (total <= 0 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < (long long)sms * per_sm ? total
                                                         : (long long)sms * per_sm);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const Tio*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<Tio*>(out), tlen, h, wd, hc, wc, ho, wo, tiles_h, tiles_w,
      (int)total);
  return (int)cudaGetLastError();
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

// dynamic shared memory of one block, bytes (kind as above)
int egot2x_stem_pool_smem_bytes(int kind) {
  return (kind == 2 ? smem_floats<1, 3>() : smem_floats<5, 1>()) *
         (int)sizeof(float);
}

const char* egot2x_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
