// Flash attention for Hopper: unmasked softmax(Q K^T / sqrt(D)) V with an
// online f32 max and sum, never writing the (N, S) score matrix.
// Replaces the TPU kernel egot2x/ops/pallas_attention.py::flash_attention
// (:77, body _flash_kernel :31).
//
// Shapes: q (BH, N, D), k and v (BH, S, D) -> o (BH, N, D), any N, S >= 1
// and D <= 128, f32 or bf16 in, f32 compute, o in q's dtype. Each of the
// four tensors is addressed through (batch, head, row) element strides
// with contiguous D, so the port's (B, T, H, Dh) attention layout is read
// in place: bh = b * nheads + head.
//
// What it computes is the TPU kernel's, not its blocks: the running max
// starts at -1e30, keys past S are masked (the TPU kernel's s_valid), and
// the result is acc / max(l, 1e-30). D is not padded to 128 as the TPU
// layout pads it; it is padded only to G * DPT (below): 16, 32 and 48 for
// D 16, 32 and 40.
//
// What bounds it on an H100: at the main path's shape (TalkNet at T = 2048
// frames, 8 heads: BH 8, N = S = 2048, D 16 or 32) one launch does 4 N S D
// BH = 2.1 (D 16) or 4.3 (D 32) GFLOP and N S BH = 33.6 M exponentials
// against 4 MB (D 16) of f32 input and output. On the f32 CUDA cores
// (67 TFLOP/s) that is 32 / 64 us of FMAs; the exponentials at the MUFU
// rate (16 per clock per SM, reckoned from the data sheet: ~4.2e12/s)
// take 8 us; the bytes 1.3 us. So it is operation-bound, and at D 16 the
// softmax's max, exp and sum per score cost about as much as its two
// D-long dot products. The design keeps every score in registers, reads
// K and V from device memory once per block into shared memory, and has
// no shared-memory traffic for Q, P or the accumulator. Shared memory
// hands a warp one float per thread per cycle while the FMA units take
// four, so each float of K or V a thread reads feeds RPT = 2 query rows:
// a first version with one row a thread ran at the shared-memory rate.
// Tensor cores (mma.sync, or wgmma with TMA) are the next step.
//
// Block structure: 256 threads, 64 query rows. Each thread owns RPT = 2
// rows. G threads share the rows' D (each owns DPT dims, as float4 chunks
// g, g + G, ...) and H = 8 / G threads split their keys (thread h takes
// keys h, h + H, ... of each tile): (DPT, G) is (16, 1) at D 16, (16, 2)
// at D 32 and (12, 4) at D 40, which keeps a thread within 128 registers
// (two blocks an SM).
// The split over keys is what fills the card: at N = 2048 and BH = 8,
// 256 blocks of 8 warps. For each tile of BK keys (128 at H 8, else 64):
//   1. the block stages K and V as f32 in shared memory, zeros past S;
//   2. each thread takes its keys 8 at a time: 8 partial dot products per
//      row from its registers of Q (pre-scaled by log2(e) / sqrt(D), so
//      that exp2 gives the exponential), summed across the G threads with
//      warp shuffles; masked keys take -1e30; the chunk max updates the
//      running max m, alpha = exp2(m_old - m) rescales l and the
//      accumulator once per chunk, and p = exp2(s - m) (0 for masked
//      keys) feeds l and acc += p V from shared memory.
// At the end the H threads of a row merge their (m, l, acc) with warp
// shuffles and one writes O = acc / max(l, 1e-30) in q's dtype.
// A shared-memory row is G (DPT + 4 or 8) floats: the pad puts the 8
// float4 addresses of a quarter warp on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 2;                       // query rows per thread
constexpr int CHUNK = 8;                     // keys per register chunk
constexpr float NEG = -1e30f;                // the TPU kernel's NEG_INF
constexpr unsigned FULL = 0xffffffffu;

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
};

// The tile geometry of G threads per row along D, each owning DPT dims.
template <int DPT_, int G_>
struct Tile {
  static constexpr int DPT = DPT_, G = G_;
  static constexpr int H = 8 / G;                  // threads along the keys
  static constexpr int ROWS = RPT * THREADS / (G * H);
  static constexpr int BK = H == 8 ? 128 : 64;     // keys per staged tile
  // shared row stride, floats: G (DPT + pad) with DPT / 4 + pad / 4 odd,
  // so the 8 float4 reads of a quarter warp (g, h) fall on distinct banks
  static constexpr int RS = G * (DPT + ((DPT / 4) % 2 ? 8 : 4));
  static constexpr int SMEM = 2 * BK * RS * (int)sizeof(float);
};

template <typename T, int DPT, int G>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const Args a) {
  using TL = Tile<DPT, G>;
  constexpr int H = TL::H, BK = TL::BK, RS = TL::RS;
  constexpr int NC = DPT / 4;        // float4 chunks a thread owns
  constexpr int KPT = BK / H;        // keys a thread takes per tile
  static_assert(DPT % 4 == 0 && KPT % CHUNK == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * RS;

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int h = (tid / G) % H;
  const int row0 = blockIdx.x * TL::ROWS + (tid / (G * H)) * RPT;
  const int b = blockIdx.y / a.nheads;
  const int hd = blockIdx.y % a.nheads;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + hd * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hd * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hd * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + hd * a.so.h;

  // dims d .. RS of every row stay 0: the padded dims add 0
  for (int e = tid; e < 2 * BK * RS; e += THREADS) ks[e] = 0.f;

  float qr[RPT][DPT], acc[RPT][DPT], m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool live = row0 + r < a.n;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dd = 4 * (g + G * i) + c;
        qr[r][4 * i + c] =
            (live && dd < a.d)
                ? to_f32(q[(row0 + r) * a.sq.n + dd]) * a.qscale
                : 0.f;
        acc[r][4 * i + c] = 0.f;
      }
    }
    m[r] = NEG;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < a.s; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the zeroing done)
    for (int e = tid; e < BK * a.d; e += THREADS) {
      const int j = e / a.d, dd = e - j * a.d;
      const int kj = k0 + j;
      const bool in = kj < a.s;
      ks[j * RS + dd] = in ? to_f32(k[kj * a.sk.n + dd]) : 0.f;
      vs[j * RS + dd] = in ? to_f32(v[kj * a.sv.n + dd]) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int cc = 0; cc < KPT / CHUNK; ++cc) {
      float s[RPT][CHUNK];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) s[r][c] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int j = h + H * (cc * CHUNK + c);
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + j * RS + 4 * (g + G * i));
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            s[r][c] = fmaf(qr[r][4 * i], kv.x, s[r][c]);
            s[r][c] = fmaf(qr[r][4 * i + 1], kv.y, s[r][c]);
            s[r][c] = fmaf(qr[r][4 * i + 2], kv.z, s[r][c]);
            s[r][c] = fmaf(qr[r][4 * i + 3], kv.w, s[r][c]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
#pragma unroll
          for (int c = 0; c < CHUNK; ++c)
            s[r][c] += __shfl_xor_sync(FULL, s[r][c], off);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float mc = NEG;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          if (k0 + h + H * (cc * CHUNK + c) >= a.s) s[r][c] = NEG;
          mc = fmaxf(mc, s[r][c]);
        }
        const float mn = fmaxf(m[r], mc);
        const float alpha = exp2f(m[r] - mn);
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const bool in = k0 + h + H * (cc * CHUNK + c) < a.s;
          s[r][c] = in ? exp2f(s[r][c] - mn) : 0.f;
          ps += s[r][c];
        }
        l[r] = fmaf(l[r], alpha, ps);
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int j = h + H * (cc * CHUNK + c);
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + j * RS + 4 * (g + G * i));
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[r][4 * i] = fmaf(s[r][c], vv.x, acc[r][4 * i]);
            acc[r][4 * i + 1] = fmaf(s[r][c], vv.y, acc[r][4 * i + 1]);
            acc[r][4 * i + 2] = fmaf(s[r][c], vv.z, acc[r][4 * i + 2]);
            acc[r][4 * i + 3] = fmaf(s[r][c], vv.w, acc[r][4 * i + 3]);
          }
        }
      }
    }
  }

  // merge the H key splits of each row: a split that saw no key has
  // m = -1e30, so its weight exp2(m - mt) is 0
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float mt = m[r];
#pragma unroll
    for (int off = G; off < G * H; off <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    const float f = exp2f(m[r] - mt);
    l[r] *= f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[r][e] *= f;
#pragma unroll
    for (int off = G; off < G * H; off <<= 1) {
      l[r] += __shfl_xor_sync(FULL, l[r], off);
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], off);
    }
    if (row0 + r < a.n && h == 0) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dd = 4 * (g + G * i) + c;
          if (dd < a.d)
            o[(row0 + r) * a.so.n + dd] =
                from_f32<T>(acc[r][4 * i + c] / denom);
        }
      }
    }
  }
}

template <typename T, int DPT, int G>
int launch(const Args& a, int bh, cudaStream_t stream) {
  using TL = Tile<DPT, G>;
  auto kern = flash_attention_kernel<T, DPT, G>;
  if (TL::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.n + TL::ROWS - 1) / TL::ROWS, bh);
  kern<<<grid, THREADS, TL::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// The tile for head dim d: the least padded width G * DPT >= d with DPT
// in {8, 12, 16}, which keeps a thread within 128 registers. f is called
// with a Tile<DPT, G>; -1 for d > 128.
template <typename F>
int by_head_dim(int d, F&& f) {
  if (d <= 8) return f(Tile<8, 1>{});
  if (d <= 16) return f(Tile<16, 1>{});
  if (d <= 24) return f(Tile<12, 2>{});
  if (d <= 32) return f(Tile<16, 2>{});
  if (d <= 48) return f(Tile<12, 4>{});
  if (d <= 64) return f(Tile<16, 4>{});
  if (d <= 96) return f(Tile<12, 8>{});
  if (d <= 128) return f(Tile<16, 8>{});
  return -1;
}

template <typename T>
int dispatch(const Args& a, int bh, cudaStream_t s) {
  const int err = by_head_dim(a.d, [&](auto tile) {
    using TL = decltype(tile);
    return launch<T, TL::DPT, TL::G>(a, bh, s);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
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
  if (bh < 1 || nheads < 1 || n < 1 || s < 1 || d < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, {sqb, sqh, sqn}, {skb, skh, skn}, {svb, svh, svn},
         {sob, soh, son}, nheads, n, s, d,
         (float)(1.4426950408889634 / std::sqrt((double)d))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, bh, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, bh, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block at head dim d, bytes (-1: d > 128)
int egot2x_flash_attention_smem_bytes(int d) {
  return by_head_dim(d, [](auto tile) { return decltype(tile)::SMEM; });
}

const char* egot2x_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
