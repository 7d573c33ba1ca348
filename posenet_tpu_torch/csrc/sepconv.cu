// Fused separable conv block of the MobileNetV1 trunk, for Hopper:
//   out = relu6(pw1x1(bf16(relu6(dw3x3(x) + dw_b))) + pw_b)
// stride 1, dilation 1, zero "same" padding, NHWC bf16 in and out.
//
// Replaces the TPU kernel `sepconv_pallas` (posenet_tpu/ops/pallas/
// sepconv.py:228, body `_sepconv_kernel` :72). The numerics are that
// kernel's: the 9 depthwise taps are exact bf16 x bf16 products summed in
// float32 in (dy, dx) order, plus the float32 bias, clamped and rounded
// once to bf16; the pointwise product takes bf16 inputs with float32
// accumulation, plus the float32 bias, clamped and rounded to bf16.
//
// Design: a block owns kBM = 64 consecutive output pixels of the flattened
// (B, H, W) index and all of C_out.
//   1. Depthwise: the block computes the bf16 intermediate for its pixels
//      and every input channel into shared memory (the A tile, kBM x K_pad,
//      row-major). A thread takes 8 channels of one pixel, so a warp's
//      loads are 16-byte vectors over contiguous channels. The zero halo is
//      a bounds check on each tap: no padded copy of x exists. Channels
//      from C_in up to K_pad (C_in rounded up to 16) are written as zeros.
//   2. Pointwise on the tensor cores: for each 128-wide slice of C_out,
//      stage the weights kBK = 64 input channels at a time in shared
//      memory (zero-filled past C_in and C_out) and run WMMA bf16
//      16x16x16 products with float32 accumulators; 8 warps tile the
//      64 x 128 output slice as 2 x 4 warps of 32 x 32.
//   3. Epilogue in registers: each warp stages one 16 x 16 accumulator at a
//      time in its own shared scratch, adds the bias, clamps, rounds to
//      bf16 and stores 8 channels a lane, masked at the pixel tail.
// The intermediate never goes to device memory, and neither does any
// partial sum.
//
// Bound on this card: memory and L2 traffic at the stem's widths (C_in
// 16-128: x is read once from HBM plus the neighbouring rows' halo from
// L2, the output written once), tensor-core throughput at C_in 512-1024, where
// every block also streams the whole C_in x C_out weight matrix from L2.
// WMMA from shared memory, with no cp.async pipelining, TMA or wgmma, is
// the simple first version; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;        // output pixels a block
constexpr int kBN = 128;       // output channels a pass of the block
constexpr int kBK = 64;        // input channels a staged weight tile
constexpr int kThreads = 256;  // 8 warps: 2 (pixels) x 4 (channels)
constexpr int kPad = 8;        // bf16 elements of padding a shared row
constexpr int kLdb = kBK + kPad;
constexpr int kMaxChannels = 1024;

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

__global__ void __launch_bounds__(kThreads) sepconv_kernel(
    const __nv_bfloat16* __restrict__ x,    // (B, H, W, C_in)
    const __nv_bfloat16* __restrict__ dw,   // (9, C_in), tap = dy * 3 + dx
    const float* __restrict__ dw_b,         // (C_in,)
    const __nv_bfloat16* __restrict__ pw,   // (C_out, C_in)
    const float* __restrict__ pw_b,         // (C_out,)
    __nv_bfloat16* __restrict__ out,        // (B, H, W, C_out)
    int64_t m_total, int h, int w, int c_in, int c_out, int k_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = k_pad + kPad;
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // kBM x lda
  __nv_bfloat16* b_s = a_s + kBM * lda;                        // kBN x kLdb
  float* c_s = reinterpret_cast<float*>(b_s + kBN * kLdb);     // 8 x 16 x 16

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t hw = static_cast<int64_t>(h) * w;

  // 1. depthwise 3x3 + bias + ReLU6 -> bf16 A tile
  const int groups = k_pad / 8;
  for (int i = threadIdx.x; i < kBM * groups; i += kThreads) {
    const int p = i / groups;
    const int c = (i - p * groups) * 8;
    const int64_t m = m0 + p;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < m_total && c < c_in) {
      const int64_t b = m / hw;
      const int rem = static_cast<int>(m - b * hw);
      const int y = rem / w;
      const int xq = rem - y * w;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= h) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = xq + dx - 1;
          if (xx < 0 || xx >= w) continue;
          float xv[8], wv[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      x + ((b * h + yy) * w + xx) * c_in + c), xv);
          unpack8(*reinterpret_cast<const uint4*>(dw + (dy * 3 + dx) * c_in + c), wv);
          // A bf16 x bf16 product is exact in float32, so the fused
          // multiply-add rounds once, as acc + x * w does.
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(xv[j], wv[j], acc[j]);
        }
      }
      const float4 b0 = *reinterpret_cast<const float4*>(dw_b + c);
      const float4 b1 = *reinterpret_cast<const float4*>(dw_b + c + 4);
      const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = relu6(__fadd_rn(acc[j], bias[j]));
    }
    *reinterpret_cast<uint4*>(a_s + p * lda + c) = pack8(acc);
  }
  __syncthreads();

  // 2. pointwise on the tensor cores, 3. epilogue
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 32;  // warp's first pixel row in the tile
  const int wn = (warp % 4) * 32;  // warp's first channel in the slice
  float* scratch = c_s + warp * 256;

  for (int n0 = 0; n0 < c_out; n0 += kBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    const bool warp_live = n0 + wn < c_out;  // C_out % 16 == 0

    for (int k0 = 0; k0 < k_pad; k0 += kBK) {
      // weights (n, k) -> b_s[n][k]: B = pw^T in column-major order
      for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
        const int n = i / (kBK / 8);
        const int kk = (i - n * (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < c_out && k0 + kk < c_in)
          v = *reinterpret_cast<const uint4*>(
              pw + static_cast<int64_t>(n0 + n) * c_in + k0 + kk);
        *reinterpret_cast<uint4*>(b_s + n * kLdb + kk) = v;
      }
      __syncthreads();
      if (warp_live) {
        const int k_len = min(kBK, k_pad - k0);  // a multiple of 16
        for (int kk = 0; kk < k_len; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], a_s + (wm + 16 * i) * lda + k0 + kk, lda);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bf[j], b_s + (wn + 16 * j) * kLdb + kk, kLdb);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    if (!warp_live) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + wn + 16 * j;
        if (n >= c_out) continue;
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane / 2;
        const int cc = (lane % 2) * 8;
        const int64_t m = m0 + wm + 16 * i + r;
        if (m < m_total) {
          const float4 b0 = *reinterpret_cast<const float4*>(pw_b + n + cc);
          const float4 b1 = *reinterpret_cast<const float4*>(pw_b + n + cc + 4);
          const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = relu6(__fadd_rn(scratch[r * 16 + cc + e], bias[e]));
          *reinterpret_cast<uint4*>(out + m * c_out + n + cc) = pack8(v);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// Launches the block on `stream` and returns a cudaError_t (0 when the
// launch was accepted). Pointers are device pointers to contiguous,
// 16-byte aligned tensors; C_in % 8 == 0 and C_out % 16 == 0, both at most
// 1024 (the wrapper checks all of it).
extern "C" int posenet_sepconv(
    const void* x, const void* dw, const void* dw_b, const void* pw,
    const void* pw_b, void* out, int b, int h, int w, int c_in, int c_out,
    void* stream) {
  if (c_in <= 0 || c_in > kMaxChannels || c_in % 8 || c_out <= 0 ||
      c_out > kMaxChannels || c_out % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_pad = (c_in + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) * (kBM * (k_pad + kPad) + kBN * kLdb)
                      + sizeof(float) * 8 * 256;
  cudaError_t err = cudaFuncSetAttribute(
      sepconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t m_total = static_cast<int64_t>(b) * h * w;
  const int64_t blocks = (m_total + kBM - 1) / kBM;
  sepconv_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dw),
      static_cast<const float*>(dw_b), static_cast<const __nv_bfloat16*>(pw),
      static_cast<const float*>(pw_b), static_cast<__nv_bfloat16*>(out),
      m_total, h, w, c_in, c_out, k_pad);
  return static_cast<int>(cudaGetLastError());
}
