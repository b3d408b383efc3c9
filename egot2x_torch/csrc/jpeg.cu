// The card's data plane: JPEG decode and encode through nvJPEG, and the
// hand-written crop_resize kernel.
//
// Counterpart of the JAX package's host data plane
// (egot2x/native/dataplane.cpp: libjpeg decode, then crop and bilinear
// resize at :73-130, used by egot2x/data/lam.py:163-182). It replaces no
// TPU kernel: the JAX package decodes and resizes on the host. Here a
// frame is decoded by nvJPEG into device memory as interleaved RGB, and one
// launch of crop_resize cuts and resizes a whole item's frames (a 7-frame
// LAM window, a TTM segment, an ASD track) to (n, s, s, C) uint8.
//
// crop_resize follows dataplane.cpp's arithmetic exactly, so the LAM loader
// gives the JAX package's pixels bit for bit: half-pixel centres
// (src = (dst + 0.5) * crop / s - 0.5, clamped at 0), 11-bit fixed-point
// weights rounded from float32, a horizontal pass in integers, then the
// vertical blend rounded at 2 * 11 bits. Every float operation is an
// explicitly rounded intrinsic, so nvcc contracts none into an FMA, as the
// host code (ISO C++, no contraction) does not. Each thread computes one
// output pixel from its four taps; the host code's row cache only saves
// work. Options, all in the same launch: grey first (cv2's
// COLOR_BGR2GRAY weights in 14-bit fixed point, as egot2x/data/asd.py
// converts before it resizes), a horizontal flip of the output, a fill
// value for taps outside the image (np.pad's constant, as the ASD square
// crop pads with 110) or else the box clamped to the image, and zeros for
// an empty box (dataplane.cpp:78-80).
//
// Bound: bytes. Each output byte needs at most four source bytes read and
// a few integer operations, far below the card's operations per byte; the
// least time is the crops' bytes read once plus the outputs written once,
// at 3.35 TB/s. The design is the simple one: one thread a pixel, the taps
// read through the L1 cache from the decoded frames where they lie.
//
// nvJPEG's decode state is not thread-safe: each host thread owns one
// context (handle, decode state, encoder state and parameters), which the
// Python wrapper keeps per thread.
//
// C ABI (ctypes). Every function returns 0 or an error: nvJPEG's status
// (1-9), or 1000 + a CUDA error.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kShift = 11, kOne = 1 << kShift;
// cv2's COLOR_BGR2GRAY for 8 bits: (R 4899 + G 9617 + B 1868 + 2^13) >> 14
constexpr int kR2Y = 4899, kG2Y = 9617, kB2Y = 1868, kYShift = 14;

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

// One item of a crop_resize launch: 8 int64 words.
//   [0] device pointer to the frame, interleaved (h, w, channels) uint8
//   [1] w | h << 20 | channels << 40
//   [2] flags: bit 0 grey, bit 1 flip; fill + 1 in bits 8-16 (0: clamp)
//   [3..6] box x1, y1, x2, y2 as float32 bits (the crop [x1, x2) x [y1, y2)
//          after truncation to int, as static_cast<int> truncates)
struct Item {
  const unsigned char* src;
  int w, h, channels, grey, flip, fill;
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Item load_item(const long long* d) {
  Item it;
  it.src = reinterpret_cast<const unsigned char*>(d[0]);
  it.w = static_cast<int>(d[1] & 0xFFFFF);
  it.h = static_cast<int>((d[1] >> 20) & 0xFFFFF);
  it.channels = static_cast<int>((d[1] >> 40) & 0xFF);
  it.grey = static_cast<int>(d[2] & 1);
  it.flip = static_cast<int>((d[2] >> 1) & 1);
  it.fill = static_cast<int>((d[2] >> 8) & 0x1FF) - 1;
  it.x1 = __int_as_float(static_cast<int>(d[3]));
  it.y1 = __int_as_float(static_cast<int>(d[4]));
  it.x2 = __int_as_float(static_cast<int>(d[5]));
  it.y2 = __int_as_float(static_cast<int>(d[6]));
  return it;
}

// One source position of the crop: its index, the next one (clamped to the
// crop), and the 11-bit weight of the next one, as dataplane.cpp computes
// them for output position o of s over a crop of length len.
__device__ __forceinline__ void tap(int o, int s, int len, int& i0, int& i1,
                                    int& w) {
  const float scale = __fdiv_rn(static_cast<float>(len),
                                static_cast<float>(s));
  float f = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f),
                                scale), 0.5f);
  if (f < 0.f) f = 0.f;
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, len - 1);
  w = static_cast<int>(__fadd_rn(
      __fmul_rn(__fsub_rn(f, static_cast<float>(i0)),
                static_cast<float>(kOne)), 0.5f));
}

// Channel c of the frame at (x, y), grey first when asked, the fill value
// outside the frame.
__device__ __forceinline__ int pixel(const Item& it, int x, int y, int c) {
  if (x < 0 || y < 0 || x >= it.w || y >= it.h) return it.fill;
  const unsigned char* p =
      it.src + (static_cast<size_t>(y) * it.w + x) * it.channels;
  if (it.grey && it.channels == 3)
    return (p[0] * kR2Y + p[1] * kG2Y + p[2] * kB2Y + (1 << (kYShift - 1)))
           >> kYShift;
  return p[c];
}

__global__ void crop_resize_kernel(const long long* __restrict__ items,
                                   int s, int out_channels,
                                   unsigned char* __restrict__ out) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (ox >= s || oy >= s) return;
  const Item it = load_item(items + 8 * static_cast<size_t>(n));
  unsigned char* dst =
      out + ((static_cast<size_t>(n) * s + oy) * s + ox) * out_channels;
  int x1 = static_cast<int>(it.x1), y1 = static_cast<int>(it.y1);
  int x2 = static_cast<int>(it.x2), y2 = static_cast<int>(it.y2);
  if (it.fill < 0) {  // clamp the box to the frame (dataplane.cpp:74-77)
    x1 = max(0, x1);
    y1 = max(0, y1);
    x2 = min(it.w, x2);
    y2 = min(it.h, y2);
  }
  const int cw = x2 - x1, ch = y2 - y1;
  if (cw <= 0 || ch <= 0) {
    for (int c = 0; c < out_channels; ++c) dst[c] = 0;
    return;
  }
  int xa, xb, wx, ya, yb, wy;
  tap(it.flip ? s - 1 - ox : ox, s, cw, xa, xb, wx);
  tap(oy, s, ch, ya, yb, wy);
  for (int c = 0; c < out_channels; ++c) {
    const int h0 = pixel(it, x1 + xa, y1 + ya, c) * (kOne - wx) +
                   pixel(it, x1 + xb, y1 + ya, c) * wx;
    const int h1 = pixel(it, x1 + xa, y1 + yb, c) * (kOne - wx) +
                   pixel(it, x1 + xb, y1 + yb, c) * wx;
    const long long v = static_cast<long long>(h0) * (kOne - wy) +
                        static_cast<long long>(h1) * wy;
    dst[c] = static_cast<unsigned char>((v + (1LL << (2 * kShift - 1)))
                                        >> (2 * kShift));
  }
}

int cuda_status(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + e; }

}  // namespace

extern "C" {

int egot2x_jpeg_version(int* major, int* minor, int* patch) {
  int s = nvjpegGetProperty(MAJOR_VERSION, major);
  if (!s) s = nvjpegGetProperty(MINOR_VERSION, minor);
  if (!s) s = nvjpegGetProperty(PATCH_LEVEL, patch);
  return s;
}

int egot2x_jpeg_context_create(void** out) {
  Context* ctx = new Context();
  int s = nvjpegCreateSimple(&ctx->handle);
  if (!s) s = nvjpegJpegStateCreate(ctx->handle, &ctx->state);
  if (!s) s = nvjpegEncoderStateCreate(ctx->handle, &ctx->enc_state, 0);
  if (!s) s = nvjpegEncoderParamsCreate(ctx->handle, &ctx->enc_params, 0);
  if (s) {
    delete ctx;
    return s;
  }
  *out = ctx;
  return 0;
}

int egot2x_jpeg_context_destroy(void* p) {
  Context* ctx = static_cast<Context*>(p);
  if (ctx->enc_params) nvjpegEncoderParamsDestroy(ctx->enc_params);
  if (ctx->enc_state) nvjpegEncoderStateDestroy(ctx->enc_state);
  if (ctx->state) nvjpegJpegStateDestroy(ctx->state);
  int s = ctx->handle ? nvjpegDestroy(ctx->handle) : 0;
  delete ctx;
  return s;
}

// Width, height and components of a JPEG in host memory.
int egot2x_jpeg_info(void* p, const unsigned char* data, size_t length,
                     int* width, int* height, int* components) {
  Context* ctx = static_cast<Context*>(p);
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  int s = nvjpegGetImageInfo(ctx->handle, data, length, components,
                             &subsampling, widths, heights);
  *width = widths[0];
  *height = heights[0];
  return s;
}

// Decode a JPEG in host memory into out, device memory of (height, width, 3)
// uint8 RGB, on stream.
int egot2x_jpeg_decode_rgbi(void* p, const unsigned char* data, size_t length,
                            unsigned char* out, int width,
                            cudaStream_t stream) {
  Context* ctx = static_cast<Context*>(p);
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = out;
  img.pitch[0] = static_cast<size_t>(width) * 3;
  return nvjpegDecode(ctx->handle, ctx->state, data, length,
                      NVJPEG_OUTPUT_RGBI, &img, stream);
}

// Encode src, device memory of (height, width, 3) uint8 RGB, as a baseline
// JPEG with 4:2:0 chroma at quality (cv2.imwrite's defaults: 95, 4:2:0) into
// out, host memory of capacity bytes; *length gets the size (when it
// exceeds capacity, nothing is copied and 1 is returned). Synchronises
// stream.
int egot2x_jpeg_encode_rgbi(void* p, const unsigned char* src, int width,
                            int height, int quality, unsigned char* out,
                            size_t capacity, size_t* length,
                            cudaStream_t stream) {
  Context* ctx = static_cast<Context*>(p);
  int s = nvjpegEncoderParamsSetQuality(ctx->enc_params, quality, stream);
  if (!s)
    s = nvjpegEncoderParamsSetSamplingFactors(ctx->enc_params, NVJPEG_CSS_420,
                                              stream);
  if (s) return s;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = const_cast<unsigned char*>(src);
  img.pitch[0] = static_cast<size_t>(width) * 3;
  s = nvjpegEncodeImage(ctx->handle, ctx->enc_state, ctx->enc_params, &img,
                        NVJPEG_INPUT_RGBI, width, height, stream);
  if (s) return s;
  size_t n = 0;
  s = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, nullptr, &n,
                                    stream);
  if (s) return s;
  *length = n;
  if (n > capacity) return 1;
  s = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, out, &n,
                                    stream);
  if (s) return s;
  return cuda_status(cudaStreamSynchronize(stream));
}

// n items (8 int64 words each, device memory, see Item) -> out, device
// memory of (n, s, s, out_channels) uint8, on stream.
int egot2x_crop_resize(const long long* items, int n, int s, int out_channels,
                       unsigned char* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((s + block.x - 1) / block.x, (s + block.y - 1) / block.y, n);
  crop_resize_kernel<<<grid, block, 0, stream>>>(items, s, out_channels, out);
  return cuda_status(cudaGetLastError());
}

}  // extern "C"
