// K2: the fused separable conv block of the MobileNetV1 trunk, for Hopper.
//   out = relu6(pw1x1(bf16(relu6(dw3x3_rate(x) + dw_b))) + pw_b)
// stride 1, dilation `rate` >= 1 (the depthwise's taps at (y + dy * rate,
// x + dx * rate), dy, dx in -1, 0, 1), zero "same" padding of `rate` on
// every side, NHWC bf16 in and out. Rate 1 takes the stride-1 layers up to
// the output stride; rates 2 and 4 the dilated layers past it (m101 s16's
// layer 13 at rate 2; at s8 layers 7-13, m101's 13 at rate 4). Stride 2 at
// rate 1 takes the stride-2 layers (see the note below).
//
// Replaces the TPU kernel `sepconv_pallas` (posenet_tpu/ops/pallas/
// sepconv.py:228, body `_sepconv_kernel` :72). The numerics are that
// kernel's: the 9 depthwise taps are exact bf16 x bf16 products summed in
// float32 in (dy, dx) order, plus the float32 bias, clamped and rounded
// once to bf16; the pointwise product takes bf16 inputs with float32
// accumulation, plus the float32 bias, clamped and rounded to bf16.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16), per layer of
// one m101 s16 513x513 forward at batch 128, bytes = x read once + the
// output written once (the weights are under 1 MB):
//   257^2  32->64    HBM, 1.62 GB         0.485 ms
//   129^2 128->128   HBM, 1.09 GB         0.326 ms
//    65^2 256->256   HBM, 0.55 GB         0.165 ms
//    33^2 512->512   HBM, 0.29 GB         0.085 ms (73 GFLOP: 0.074 ms)
//    33^2 512->1024  tensor cores, 146 GFLOP  0.148 ms
// and of the dilated layers of the benchmark's cells:
//    33^2 1024->1024 rate 2, b128 (m101 s16's layer 13)   tensor cores, 292 GFLOP  0.296 ms
//    91x161 512->512 rate 2, b4 (m101 s8's 7-11)          HBM, 0.12 GB             0.036 ms
//    91x161 512->1024 rate 2, b4 (layer 12)               tensor cores, 61 GFLOP   0.062 ms
//    91x161 1024->1024 rate 4, b4 (layer 13)              tensor cores, 123 GFLOP  0.124 ms
// The rate moves where the taps lie, not the bytes or the products.
// Every layer sits near the ridge or below it, so the kernel has to keep
// the intermediate out of device memory, read each weight byte from L2 as
// few times as it can, and keep the tensor cores fed while it does.
//
// Design. A block owns BM output pixels of the flattened (B, H, W) index
// and loops over C_out in slices of BN channels. It has WG warpgroups (128
// threads each): all of them compute the depthwise; the first BM / 64 run
// the products and the epilogue, one for each 64 pixels.
//   1. Depthwise: the block computes the bf16 intermediate of its pixels
//      for every input channel straight into the A tile, in the layout
//      wgmma reads: K-major panels of 64 channels (128 bytes a row), the
//      16-byte chunk index XOR (row mod 8) (the 128-byte swizzle). A thread
//      keeps 8 channels over a run of consecutive pixels (and from C_in 128
//      their 9 taps in registers). At rate 1 it slides its 3x3 window along
//      a row, so that a pixel costs 3 new 16-byte loads, not 9; at rate > 1
//      and at stride 2 each pixel loads its 9 (below). Channels from C_in up to the panel's end
//      are zeros: the C_in 16, 24 and 32 stems take one zero-padded panel,
//      which costs shared memory and a few products on zeros, not time,
//      since those layers are bound by memory, not by the tensor cores.
//   2. Pointwise: the flattened (slice, panel) loop streams the weight
//      tiles, BN x 64 channels of `pw` (C_out, C_in) (already the K-major B
//      operand), through a ring of kStages = 4 shared-memory stages, filled
//      with cp.async 16-byte copies (zero-filled past C_in), one commit
//      group a step. The first two stages load during the depthwise phase;
//      while stage s is consumed, stages s+1 and s+2 load, and the ring does
//      not drain at a slice boundary. A warpgroup runs wgmma.m64nBNk16 (A
//      and B from shared memory by descriptor, f32 accumulators in
//      registers) with one commit group in flight while the next stage
//      lands.
//   3. Epilogue at each slice's end: from the wgmma accumulator layout,
//      + bias (f32), ReLU6, bf16 pairs, staged through the two drained ring
//      stages (one a warpgroup), then written as 16-byte vectors of
//      neighbouring channels, masked at the pixel tail.
// The intermediate never goes to device memory, and neither does any
// partial sum.
//
// What this does about the previous version's limits:
//   - Weights staged by plain loads between two barriers: they now load
//     asynchronously, two steps ahead, the first ones during the depthwise.
//   - 64-pixel tiles: BM = 128 (two m64 row groups) up to C_in 512, which
//     halves the L2 reads of the weights (at 33^2 512->512 from 1.14 GB to
//     0.57 GB a layer); BM = 64 above, where the A tile alone is 128 KB.
//   - WMMA 16x16x16 with fragments reloaded at every k step, half the warps
//     idle at C_out 64: wgmma reads both operands from shared memory, and
//     BN is the widest of 128, 96, 64, 48, 32, 16 that divides C_out, so no
//     slice is partial.
//   - An epilogue through one 16x16 fragment at a time: the accumulators
//     are read in registers and each slice is staged once.
//   - Depthwise and pointwise never overlap: still so within a block (a
//     producer warpgroup computing tile i+1's A tile during tile i's
//     products is later work). At C_in >= 256, where shared memory allows
//     one block (or two) an SM, WG = 4 puts twice the threads on the
//     depthwise instead.
// What bounds it now (PERF.md): the depthwise's instructions and load latency,
// the per-block overhead of the 66K blocks at 257^2, and, at C_in 512, the
// weights' L2 traffic, which only a larger pixel tile or a cluster
// multicast of the weight tiles would cut.
//
// The dilated layers. A rate-r pixel's taps share no column with its
// neighbour's, so the sliding window does not apply as it is. Two ways were
// measured (NVIDIA H100 80GB HBM3, 700 W, CUDA events, variants in turns):
// (a) visit a run's pixels in r passes of stride r, x, x + r, x + 2r, ...,
// each writing its own A-tile row, so that the window slides and a pixel
// still costs 3 new loads; (b) load all 9 taps of every pixel, in order,
// and let L1 and L2 serve the repeated reads (each input row is read by 3
// output rows and each column by 3 pixels). (b) was as fast or faster at
// every dilated shape, ms a layer (a) / (b): b128 33^2 1024->1024 r2
// 2.026 / 2.019; b4 91x161 512->512 r2 0.253 / 0.218, 512->1024 r2
// 0.383 / 0.349, 1024->1024 r4 0.849 / 0.841; b16 65^2 r2 256->256
// 0.118 / 0.101, 384->384 0.206 / 0.178, 512->512 0.299 / 0.259. (a)'s
// passes need more registers (128 with 104 bytes of spills at 512 threads,
// 162 at 256) and issue their loads three at a time; (b)'s 9 independent
// loads keep more in flight with no spill. So the rate > 1 instantiations
// (kDilated, only BN 128 and BN 16, at BM 128 / WG 4 up to C_in 512 and
// BM 64 / WG 2 above, the configurations of C_in 256 to 1024 that every
// dilated layer of the four models has) take (b); the rate-1 ones are the
// code they were, rate a constant 1. The dilated layers run at 6.0-7.2x
// their bound (PERF.md), where the rate-1 layers run at 4.2x: at C_in 512
// the 9 loads a pixel; at 1024->1024 (BM 64) the weights' L2 traffic, a
// 2 MB weight matrix read again for every 64 pixels, as at m101 s32's
// last layer.
//
// Stride 2 (layers 2, 4 and 6 of every model up to its output stride, and
// m101 s32's layer 12). Output pixel (y, x) reads input (2y + dy, 2x + dx),
// one zero row and column of padding on each side; a block owns BM pixels
// of the flattened output index, and each pixel's taps are addressed from
// (image, 2y, 2x) of the input. The epilogues add the biases rounded to
// bf16 (`load_bias4`), as the conv pair these layers ran as before does.
// Bound at the cells' shapes, the input read once and the output written
// once (the input has four times the output's pixels):
//   b256 257^2  64->128   HBM, 3.25 GB   0.972 ms (m101 s16 layer 2)
//   b256 129^2 128->256   HBM, 1.64 GB   0.491 ms (layer 4)
//   b256  65^2 256->512   HBM, 0.84 GB   0.251 ms (layer 6; 73 GFLOP: 0.074 ms)
//   b32 361x641  64->128  HBM, 1.42 GB   0.425 ms (m101 s8 720p layer 2)
//   b32 181x321 128->256  HBM, 0.72 GB   0.214 ms (layer 4)
// A pixel's window shares one column with its neighbour's. Two ways were
// measured (NVIDIA H100 80GB HBM3, 700 W, CUDA events, variants in turns),
// ms a layer at those shapes, (a) slide the window two columns, 6 new
// loads a pixel / (b) load all 9 taps of every pixel and let L1 and L2
// serve the repeats: 1.9120 / 1.8981, 0.8670 / 0.7785, 0.6450 / 0.6290,
// 0.8269 / 0.8288, 0.3986 / 0.3599. (b) is kept: as fast or faster at
// every shape but one, within 0.3% there. The stride-2 instantiations take
// the rate-1 configurations of their C_in (C_in 32 to 512 in the four
// models) and BN 128, 96 or 64 (16 for any other C_out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;              // input channels a K panel
constexpr int kRow = kBK * 2;        // bytes of a panel row: one 128-byte swizzle row
constexpr int kStages = 4;           // weight ring stages
constexpr int kMaxChannels = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past `src_bytes` (0 or
// 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma's operand reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from reading the accumulators before a wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart, the tile's
// base 1024-byte aligned (a k16 step adds 32 bytes to the start address).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)             // leading offset: unused
         | (static_cast<uint64_t>(1024 >> 4) << 32)     // stride offset
         | (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

// D(64 x N, f32 registers) (+)= A(64 x 16) * B(16 x N), both K-major in
// shared memory; `accumulate` 0 overwrites D. The accumulator of thread t
// of the warpgroup holds, at d[j], row 16 * (t / 32) + (t % 32) / 4 +
// 8 * ((j / 2) % 2), column 8 * (j / 4) + 2 * (t % 4) + j % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23 "
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four of the depthwise's biases, and two of the pointwise's, as the
// epilogues add them to their float32 sums: float32 at stride 1, as the
// TPU kernel; rounded to bf16 at stride 2, as the conv pair those layers
// ran as before (`F.conv2d` with the bias cast to bf16) adds them.
template <bool kStrided>
__device__ __forceinline__ float4 load_bias4(const float* p) {
  const float4 b = *reinterpret_cast<const float4*>(p);
  if constexpr (!kStrided) return b;
  return make_float4(bf16_round(b.x), bf16_round(b.y), bf16_round(b.z), bf16_round(b.w));
}

template <bool kStrided>
__device__ __forceinline__ float2 load_bias2(const float* p) {
  const float2 b = *reinterpret_cast<const float2*>(p);
  if constexpr (!kStrided) return b;
  return make_float2(bf16_round(b.x), bf16_round(b.y));
}

template <int BM, int BN, int WG, bool kTapRegs, bool kDilated, bool kStrided>
__global__ void __launch_bounds__(128 * WG) sepconv_kernel(
    const __nv_bfloat16* __restrict__ x,    // (B, H, W, C_in)
    const __nv_bfloat16* __restrict__ dw,   // (9, C_in), tap = dy * 3 + dx
    const float* __restrict__ dw_b,         // (C_in,)
    const __nv_bfloat16* __restrict__ pw,   // (C_out, C_in)
    const float* __restrict__ pw_b,         // (C_out,)
    __nv_bfloat16* __restrict__ out,        // (B, H_out, W_out, C_out)
    int64_t m_total, int h, int w, int c_in, int c_out, int rate_arg, int h_out_arg,
    int w_out_arg) {
  // WG warpgroups: all of them compute the depthwise; the first BM / 64
  // run the products and the epilogue, one for each 64 pixels.
  constexpr int kThreads = 128 * WG;
  // The dilation rate: a constant 1 in the rate-1 instantiations.
  const int rate = kDilated ? rate_arg : 1;
  // The output map: the input's at stride 1; at stride 2 (kStrided)
  // output pixel (y, x) centres its window on input (2y, 2x).
  const int h_out = kStrided ? h_out_arg : h;
  const int w_out = kStrided ? w_out_arg : w;
  constexpr int kSlot = BN * kRow;    // bytes of a ring stage = 64 x BN bf16
  constexpr int kChunks = BN / 8;     // 16-byte chunks of an output row's slice
  // Staging swizzle: chunk XOR (row mod kSwz), within a row of kChunks.
  constexpr int kSwz = kChunks % 8 == 0 ? 8 : kChunks % 4 == 0 ? 4 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int k_panels = (c_in + kBK - 1) / kBK;
  unsigned char* a_s = smem;                            // k_panels x BM x kRow
  unsigned char* ring = smem + k_panels * BM * kRow;    // kStages x kSlot
  const int tid = threadIdx.x;
  const int steps = c_out / BN * k_panels;              // (slice, panel), panel fastest
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;

  // Step t's weight tile -> ring stage t % kStages, row n at n * 128 bytes,
  // chunk ch at (ch ^ (n % 8)) * 16; one commit group a call, empty past
  // the last step, so that a wait on the group count finds step t.
  auto load_stage = [&](int t) {
    if (t < steps) {
      const int n0 = t / k_panels * BN;
      const int k0 = t % k_panels * kBK;
      unsigned char* dst = ring + t % kStages * kSlot;
      for (int i = tid; i < BN * 8; i += kThreads) {
        const int n = i >> 3;
        const int ch = i & 7;
        const int k = k0 + ch * 8;
        const bool live = k < c_in;
        cp_async16(dst + n * kRow + ((ch ^ (n & 7)) << 4),
                   pw + static_cast<int64_t>(n0 + n) * c_in + (live ? k : 0), live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) load_stage(t);

  // 1. depthwise 3x3, taps `rate` pixels apart, + bias + ReLU6 -> bf16 A
  // tile. Thread (lane, g) takes channels 8g..8g+7 of a run of consecutive
  // pixels of the tile, so its 9 taps and 8 biases load once and its
  // pixel's (y, x) advance without a division. A warp's loads are 16-byte
  // vectors over contiguous channels. At rate 1 the 3x3 window slides
  // along a row: 3 new loads a pixel, not 9. At rate > 1 a pixel's taps
  // share nothing with its neighbour's, and each pixel loads its 9, as it
  // does at stride 2 (see the notes at the top). The loads of a pixel are unconditional, so that
  // they are in flight together: a tap off the image reads x[0] and adds
  // zero, as the plain version's zero padding does.
  const int groups = c_in / 8;             // at most kThreads (C_in <= 16 * BM)
  const int lanes = kThreads / groups;
  const int run = (BM + lanes - 1) / lanes;
  const int lane = tid / groups;
  const int g = tid - lane * groups;
  const int c = g * 8;
  const int p_end = min(BM, (lane + 1) * run);
  if (lane * run < p_end) {
    // kTapRegs: the 9 taps stay in registers. Below C_in 128 they are read
    // from L1 at each pixel instead, which saves the 36 registers that let
    // a third block onto an SM: those layers are bound by latency.
    uint4 taps[9];
    if constexpr (kTapRegs) {
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[t] = *reinterpret_cast<const uint4*>(dw + t * c_in + c);
    }
    const float4 b0 = load_bias4<kStrided>(dw_b + c);
    const float4 b1 = load_bias4<kStrided>(dw_b + c + 4);
    const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const int64_t hw = static_cast<int64_t>(h_out) * w_out;
    int64_t m = m0 + lane * run;
    const int rem = static_cast<int>(m % hw);
    int y = rem / w_out;
    int xq = rem - y * w_out;
    // kStrided: image `img`'s input pixel (2y, 2x), the window's centre.
    int64_t img = kStrided ? m / hw : 0;
    int64_t centre = kStrided ? (img * h + 2 * y) * w + 2 * xq : 0;
    uint4 xt[9];        // the window, tap t = (dy + 1) * 3 + dx + 1
    bool fresh = true;  // the window holds nothing of this pixel's taps
    for (int p = lane * run; p < p_end; ++p, ++m) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (m < m_total) {
        if (!fresh) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            xt[3 * r] = xt[3 * r + 1];
            xt[3 * r + 1] = xt[3 * r + 2];
          }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int dy = (t / 3 - 1) * rate;
          const int dx = (t % 3 - 1) * rate;
          if (dx < rate && !fresh) continue;
          // Two forms of one address, each the one measured fastest for its
          // instantiations: either form for both cost the stride-1 kernels
          // up to 6%, or the stride-2 ones up to 12% (PERF.md).
          if constexpr (kStrided) {
            const int iy = 2 * y + dy;
            const int ix = 2 * xq + dx;
            const bool in = iy >= 0 && iy < h && ix >= 0 && ix < w;
            xt[t] = *reinterpret_cast<const uint4*>(
                x + (in ? (centre + dy * w + dx) * c_in + c : 0));
            if (!in) xt[t] = make_uint4(0u, 0u, 0u, 0u);
          } else {
            const bool in = y + dy >= 0 && y + dy < h && xq + dx >= 0 && xq + dx < w;
            xt[t] = *reinterpret_cast<const uint4*>(x + (in ? (m + dy * w + dx) * c_in + c : 0));
            if (!in) xt[t] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float xv[8], wv[8];
          unpack8(xt[t], xv);
          if constexpr (kTapRegs) {
            unpack8(taps[t], wv);
          } else {
            unpack8(*reinterpret_cast<const uint4*>(dw + t * c_in + c), wv);
          }
          // A bf16 x bf16 product is exact in float32, so the fused
          // multiply-add rounds once, as acc + x * w does.
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(xv[j], wv[j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = relu6(__fadd_rn(acc[j], bias[j]));
      }
      *reinterpret_cast<uint4*>(a_s + (g >> 3) * (BM * kRow) + p * kRow +
                                (((g & 7) ^ (p & 7)) << 4)) = pack8(acc);
      const bool row_end = ++xq == w_out;
      if (row_end) {
        xq = 0;
        if (++y == h_out) {
          y = 0;
          if constexpr (kStrided) ++img;
        }
      }
      if constexpr (kStrided) centre = row_end ? (img * h + 2 * y) * w : centre + 2;
      fresh = kDilated || kStrided || row_end;
    }
  }
  // Zeros in the K padding, channels C_in to the last panel's end.
  const int pad = k_panels * 8 - groups;
  for (int i = tid; i < BM * pad; i += kThreads) {
    const int p = i / pad;
    const int g8 = groups + i - p * pad;
    *reinterpret_cast<uint4*>(a_s + (g8 >> 3) * (BM * kRow) + p * kRow +
                              (((g8 & 7) ^ (p & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
  }

  // 2. pointwise on the tensor cores, 3. epilogue at each slice's end
  // The warpgroup's index, read from lane 0 so that the compiler sees it is
  // uniform (wgmma under a branch it cannot prove uniform is serialized).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wt = tid % 128;
  if (wg >= BM / 64) {
    // A helper warpgroup: its share of the weight copies, and the barriers.
    for (int t = 0; t < steps; ++t) {
      cp_async_wait<kStages - 3>();
      fence_proxy_async();
      __syncthreads();
      load_stage(t + kStages - 2);
      if (t % k_panels + 1 == k_panels) __syncthreads();
    }
    return;
  }
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 3>();   // this thread's copies of step t have landed
    fence_proxy_async();
    __syncthreads();      // everyone's have; step t - 2's products are done
    load_stage(t + kStages - 2);    // into step t - 2's stage
    const int kp = t % k_panels;
    const uint32_t a_addr = smem_u32(a_s + kp * (BM * kRow) + wg * (64 * kRow));
    const uint32_t b_addr = smem_u32(ring + t % kStages * kSlot);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      Wgmma<BN>::mma(acc, smem_desc(a_addr + 32 * j), smem_desc(b_addr + 32 * j),
                     kp > 0 || j > 0);
    wgmma_commit();
    if (kp + 1 < k_panels) {
      wgmma_wait<1>();    // step t - 1's products are done
      fence_regs(acc);
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();      // the products are done with stages t - 1 and t

    const int n0 = t / k_panels * BN;
    unsigned char* st = ring + (t + kStages - 1 + wg) % kStages * kSlot;
    const int warp = wt / 32;
    const int lane = wt % 32;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const float2 bias = load_bias2<kStrided>(pw_b + n0 + q * 8 + (lane & 3) * 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = warp * 16 + (lane >> 2) + half * 8;
        *reinterpret_cast<__nv_bfloat162*>(
            st + row * (BN * 2) + ((q ^ (row % kSwz)) << 4) + (lane & 3) * 4) =
            __floats2bfloat162_rn(relu6(__fadd_rn(acc[4 * q + 2 * half], bias.x)),
                                  relu6(__fadd_rn(acc[4 * q + 2 * half + 1], bias.y)));
      }
    }
    named_barrier(1 + wg, 128);
    for (int i = wt; i < 64 * kChunks; i += 128) {
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      const int64_t m = m0 + wg * 64 + row;
      if (m < m_total)
        *reinterpret_cast<uint4*>(out + m * c_out + n0 + ch * 8) =
            *reinterpret_cast<const uint4*>(st + row * (BN * 2) + ((ch ^ (row % kSwz)) << 4));
    }
    // The next step's first barrier orders these reads before the stages
    // are loaded again.
  }
}

template <int BM, int BN, int WG, bool kTapRegs, bool kDilated, bool kStrided>
cudaError_t launch(const void* x, const void* dw, const void* dw_b, const void* pw,
                   const void* pw_b, void* out, int b, int h, int w,
                   int c_in, int c_out, int rate, cudaStream_t stream) {
  // Shared memory: the A tile (C_in rounded up to 64) x BM bf16, the ring
  // of 4 x 64 x BN bf16, and 1 KB to align both to 1024 bytes. At most:
  // BM 128, C_in 512, BN 128: 128 KB + 64 KB + 1 KB = 197,632 bytes;
  // BM 64, C_in 1024, BN 128: 128 KB + 64 KB + 1 KB = 197,632 bytes;
  // of the 232,448 a block may have.
  const int k_panels = (c_in + kBK - 1) / kBK;
  const size_t smem = static_cast<size_t>(k_panels) * BM * kRow +
                      static_cast<size_t>(kStages) * BN * kRow + 1024;
  auto kernel = sepconv_kernel<BM, BN, WG, kTapRegs, kDilated, kStrided>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int h_out = kStrided ? (h - 1) / 2 + 1 : h;
  const int w_out = kStrided ? (w - 1) / 2 + 1 : w;
  const int64_t m_total = static_cast<int64_t>(b) * h_out * w_out;
  const int64_t blocks = (m_total + BM - 1) / BM;
  kernel<<<static_cast<unsigned>(blocks), 128 * WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dw),
      static_cast<const float*>(dw_b), static_cast<const __nv_bfloat16*>(pw),
      static_cast<const float*>(pw_b), static_cast<__nv_bfloat16*>(out),
      m_total, h, w, c_in, c_out, rate, h_out, w_out);
  return cudaGetLastError();
}

// Rate 1: BN is the widest of 128, 96, 64, 48, 32, 16 that divides C_out.
template <int BM, int WG, bool kTapRegs>
cudaError_t launch_bn(const void* x, const void* dw, const void* dw_b, const void* pw,
                      const void* pw_b, void* out, int b, int h, int w,
                      int c_in, int c_out, cudaStream_t s) {
  if (c_out % 128 == 0)
    return launch<BM, 128, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  if (c_out % 96 == 0)
    return launch<BM, 96, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  if (c_out % 64 == 0)
    return launch<BM, 64, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  if (c_out % 48 == 0)
    return launch<BM, 48, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  if (c_out % 32 == 0)
    return launch<BM, 32, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  return launch<BM, 16, WG, kTapRegs, false, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
}

// Rate > 1: the dilated layers of the four models have C_out 256, 384, 512
// or 1024, so BN = 128; any other C_out takes BN = 16, right but slower.
// Four instantiations in all, so that the first build stays short.
template <int BM, int WG>
cudaError_t launch_dilated(const void* x, const void* dw, const void* dw_b, const void* pw,
                           const void* pw_b, void* out, int b, int h, int w,
                           int c_in, int c_out, int rate, cudaStream_t s) {
  if (c_out % 128 == 0)
    return launch<BM, 128, WG, true, true, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, rate, s);
  return launch<BM, 16, WG, true, true, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, rate, s);
}

// Stride 2: the stride-2 layers of the four models have C_out 64, 96, 128
// or 192 below C_in 128 and a multiple of 128 from it, so BN is 128, 96 or
// 64; any other C_out takes BN = 16, right but slower. Eight instantiations.
template <int WG, bool kTapRegs>
cudaError_t launch_strided(const void* x, const void* dw, const void* dw_b, const void* pw,
                           const void* pw_b, void* out, int b, int h, int w,
                           int c_in, int c_out, cudaStream_t s) {
  if (c_out % 128 == 0)
    return launch<128, 128, WG, kTapRegs, false, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  if constexpr (!kTapRegs) {
    if (c_out % 96 == 0)
      return launch<128, 96, WG, false, false, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
    if (c_out % 64 == 0)
      return launch<128, 64, WG, false, false, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
  }
  return launch<128, 16, WG, kTapRegs, false, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, 1, s);
}

}  // namespace

// Launches the block on `stream` and returns a cudaError_t (0 when the
// launch was accepted). Pointers are device pointers to contiguous,
// 16-byte aligned tensors; x is (b, h, w, C_in), the output (b, (h - 1) /
// stride + 1, (w - 1) / stride + 1, C_out); C_in % 8 == 0 and C_out % 16 ==
// 0, both at most 1024, rate >= 1, stride 1 or 2, stride 2 only at rate 1
// and C_in <= 512 (the wrapper checks all of it). Rate 1: BM = 128 up to
// C_in 512, else 64; WG = 4 warpgroups at BM 128 from C_in 256, else 2;
// the taps in registers from C_in 128. Rate > 1 (the dilated layers, all
// of C_in 256 to 1024 in the four models): BM 128 and WG 4 up to C_in 512,
// else BM 64 and WG 2, the taps in registers. Stride 2 (every stride-2
// layer of the four models has C_in 32 to 512): the rate-1 configurations.
extern "C" int posenet_sepconv(
    const void* x, const void* dw, const void* dw_b, const void* pw,
    const void* pw_b, void* out, int b, int h, int w, int c_in, int c_out,
    int rate, int stride, void* stream) {
  if (c_in <= 0 || c_in > kMaxChannels || c_in % 8 || c_out <= 0 ||
      c_out > kMaxChannels || c_out % 16 || rate < 1 || stride < 1 || stride > 2 ||
      (stride == 2 && (rate > 1 || c_in > 512)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stride == 2 && c_in >= 256)
    err = launch_strided<4, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else if (stride == 2 && c_in >= 128)
    err = launch_strided<2, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else if (stride == 2)
    err = launch_strided<2, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else if (rate > 1 && c_in > 512)
    err = launch_dilated<64, 2>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, rate, s);
  else if (rate > 1)
    err = launch_dilated<128, 4>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, rate, s);
  else if (c_in > 512)
    err = launch_bn<64, 2, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else if (c_in >= 256)
    err = launch_bn<128, 4, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else if (c_in >= 128)
    err = launch_bn<128, 2, true>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  else
    err = launch_bn<128, 2, false>(x, dw, dw_b, pw, pw_b, out, b, h, w, c_in, c_out, s);
  return static_cast<int>(err);
}
