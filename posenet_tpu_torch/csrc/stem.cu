// The PoseNet ResNet50 stem, fused, for Hopper:
//   out = maxpool3x3_s2_pad1(bf16(relu(conv7x7_s2_pad3(x, w) + b)))
// x NHWC bf16 (B, H, W, 3), RGB plus the ImageNet mean; w (64, 7, 7, 3)
// bf16 (the channels_last memory of the (64, 3, 7, 7) kernel); b (64,)
// bf16, added in float32; out NHWC bf16 (B, ceil(H/4), ceil(W/4), 64).
// The products are exact bf16 x bf16 products summed in float32; the bias
// is added, the ReLU applied and the sum rounded once to bf16. Rounding is
// monotone, so the max of the rounded values is the rounded max; after a
// ReLU every value is >= 0, so the pool's zero padding gives what
// F.max_pool2d's -inf padding gives (each window holds a pixel of the map).
//
// Replaces no TPU kernel: ResNet50 has no JAX counterpart. It replaces the
// stem's cuDNN conv (torch.cudnn_convolution_relu over 3 channels, which
// cuDNN pads and runs as an sm80 "indexed" implicit GEMM) and
// F.max_pool2d, which wrote the conv's output to device memory and read it
// back: (256, 64, 257, 257) bf16, 2.16 GB a b256 513x513 call, of which
// the pool keeps a quarter.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16), at b256 513x513:
//   products: 256 x 257^2 conv pixels x 64 x 147 x 2 = 318 GFLOP   0.32 ms
//   bytes: 0.40 GB of frames read, 0.55 GB of pooled features written  0.28 ms
// so it sits at the ridge, and the conv's output must never reach device
// memory.
//
// Design. One block an SM walks tiles of 8 x 8 pooled pixels (17 x 17 conv
// pixels, 13% of them recomputed for the pool's halo): a helper warpgroup
// prepares each tile's input patch two tiles ahead; three product
// warpgroups run the conv on the tensor cores, then pool. Named barriers
// hand the two patch buffers over (kPatchFull, kPatchEmpty).
//   1. The patch, the 39 input rows x 40 pixels x 3 channels that the
//      tile's conv pixels read, zeros outside the image. The helpers stage
//      its rows with 16-byte cp.async copies (tile k + 1's in flight while
//      tile k is unpacked), then unpack them, each value shifted so that
//      every conv pixel's 21 values of a kernel row (7 columns x 3
//      channels, 6 * lx values into the row) start on a 4-byte word: they
//      are then 11 aligned bf16 pairs (the 11th pair's second value is the
//      next column's, under a zero weight). An NHWC row of an odd width
//      starts at an odd value every other row, so copies alone cannot.
//   2. Implicit GEMM with wgmma m64n64k16: M 64 conv pixels, N the 64
//      channels, K 7 kernel rows x 11 pairs = 77 pairs, padded to 80 (10
//      k16 steps, 8% over 147). A comes from registers: each thread loads
//      its fragment's pairs straight from the patch at (2 * ly + ky) *
//      kRowWords + 3 * lx + jp, so there is no im2col copy. The row stride
//      kRowWords is 11 modulo 32, so a pair's word lies at its K index
//      modulo 32 from the pixel's start and a fragment load touches 32
//      banks. B, the weights, sits in shared memory for the whole walk (3
//      panels of 64 K values, the 128-byte swizzle). Each pair of k16
//      steps is issued as soon as its fragments are loaded, so the next
//      pair's loads run under it.
//   3. Epilogue: + bias, ReLU, bf16, into a conv tile in shared memory (two,
//      alternating), 128 bytes a pixel, the 16-byte chunks XOR-swizzled by
//      the pixel's index mod 8.
//   4. Pool, after a barrier of the product warps: a thread of the first
//      two warpgroups takes 8 channels of a pooled column over 2 pooled
//      rows, reads each of the 5 conv rows' 3 columns once and writes
//      16-byte vectors (a warp writes 4 whole pixels, 512 bytes).
// Measured (NVIDIA H100 80GB HBM3, 700 W, CUDA events): 2.08-2.15 ms at
// b256 513x513, 6.7x the bound; cuDNN's conv-bias-ReLU + F.max_pool2d took
// 16.6 ms. Cut out one at a time, the products' side alone takes ~1.97 ms
// (the pool 0.55 of it, wgmma 0.33, the epilogue 0.21, the A loads and the
// rest 0.85) and the helpers' alone about as long, so the two sides are
// balanced and each waits on latency more than on a unit: on paper shared
// memory bounds the kernel at ~0.8 ms (per 64 conv pixels 20 KB of A
// fragments, 20 KB of B read by wgmma, the conv tile and the pool's reads).
// Slower designs measured on the way (same card, same shapes): mma.sync
// with the weights in registers and the phases in series, 3.2 ms (2.9 ms
// with the patch staged ahead); mma.sync with warp specialisation, 4.4 ms;
// wgmma with the helpers pooling, 2.9 ms; the product warps pooling, 2.4
// ms; their A loads under the products, 2.1 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;
constexpr int kTaps = 7 * 7 * 3;                  // values of one output channel's kernel
constexpr int kRowValues = 7 * 3;                 // values of one kernel row
constexpr int kPairsPerRow = 11;                  // bf16 pairs covering a kernel row
constexpr int kPairs = 7 * kPairsPerRow;          // 77
constexpr int kSteps = 10;                        // k16 steps: 80 pairs
constexpr int kTPY = 8;                           // pooled tile
constexpr int kTPX = 8;
constexpr int kCH = 2 * kTPY + 1;                 // conv tile: 17 x 17
constexpr int kCW = 2 * kTPX + 1;
constexpr int kPH = 2 * kCH + 5;                  // patch: 39 input rows
constexpr int kPW = 2 * kCW + 6;                  // of 40 input pixels
constexpr int kPatchValues = kPW * 3;             // 120 values a patch row
constexpr int kPatchWords = kPatchValues / 2;
// Words a patch row: at least kPatchWords, and 11 modulo 32 (see 2.).
constexpr int kRowWords = (kPatchWords + 20) / 32 * 32 + 11;
// A staged row: 16-byte copies from the boundary at or below the row's
// first value in the image, so at most 14 + 240 bytes.
constexpr int kStageChunks = (2 * kPatchValues + 14 + 15) / 16;
constexpr int kStageRow = 16 * kStageChunks;
constexpr int kSlot = kCout * 2;                  // bytes a conv pixel: 128
// The weights as wgmma's B operand: 64 rows (channels) of K values in
// panels of 64 (128 bytes a row, the 128-byte swizzle), K padded to 192.
constexpr int kPanels = 3;
constexpr int kPanelBytes = kCout * 128;
// Warpgroups: 3 run the products and pool, 1 stages and unpacks the
// patches.
constexpr int kMmaGroups = 3;
constexpr int kMmaThreads = 128 * kMmaGroups;
constexpr int kHelperThreads = 128;
constexpr int kHelperWarps = kHelperThreads / 32;
constexpr int kThreads = kMmaThreads + kHelperThreads;
// Dynamic shared memory, each section 1024-byte aligned: B, two patches,
// two conv tiles, two sets of staged rows, the biases.
constexpr int align1k(int n) { return (n + 1023) / 1024 * 1024; }
constexpr int kBBytes = kPanels * kPanelBytes;
constexpr int kPatchBytes = align1k(kPH * kRowWords * 4);
constexpr int kConvBytes = align1k(kCH * kCW * kSlot);
constexpr int kStageBytes = align1k(kPH * kStageRow);
constexpr int kSmemBytes = kBBytes + 2 * kPatchBytes + 2 * kConvBytes + 2 * kStageBytes +
                           kCout * 4 + 1024;
// Named barriers (0 is __syncthreads): + buffer 0 or 1.
constexpr int kPatchFull = 1;
constexpr int kPatchEmpty = 3;
constexpr int kHelpers = 5;
constexpr int kProducts = 6;

static_assert(kRowWords >= kPatchWords && kRowWords % 32 == 11, "patch row stride");
static_assert(kStageChunks <= 32 && kPatchWords <= 64, "a staged row is one copy a lane");
static_assert(2 * kPairs <= 64 * kPanels, "B's panels hold K");
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert(8 * kTPX * (kTPY / 2) == 256 && kTPY % 2 == 0, "the pool's threads: two warpgroups");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Producer / consumer handshakes between the two kinds of warps: the
// producers arrive, the consumers wait; every barrier counts all threads.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kHelpers), "n"(kHelperThreads) : "memory");
}

__device__ __forceinline__ void products_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kProducts), "n"(kMmaThreads) : "memory");
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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading the accumulators before wgmma_wait_all.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

// D (64 x 64, f32 registers) (+)= A (64 x 16, bf16 registers) * B (16 x
// 64, K-major in shared memory); `accumulate` 0 overwrites D. Thread t of
// the warpgroup, in warp q = t / 32 with g = t % 32 / 4 and u = t % 4,
// holds A's rows 16q + g (a0, a2) and 16q + g + 8 (a1, a3) at K 2u, 2u + 1
// (a0, a1) and 2u + 8, 2u + 9 (a2, a3), the lower K in the low half; and
// D's rows 16q + g + 8 * ((j / 2) % 2) at columns 8 * (j / 4) + 2u + j % 2
// in d[j].
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The patch word of pair p (kernel row p / 11, pair p % 11 of that row)
// relative to a conv pixel's start; pairs past the last read the start
// (their weights are zero).
__device__ __forceinline__ int pair_word(int p) {
  return p < kPairs ? p / kPairsPerRow * kRowWords + p % kPairsPerRow : 0;
}

// Where a tile lies: its image, its first pooled row and column.
struct Tile {
  int64_t b;
  int py0, px0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_y, int tiles_x) {
  Tile r;
  const int rest = tile / tiles_x;
  r.px0 = (tile - rest * tiles_x) * kTPX;
  r.py0 = rest % tiles_y * kTPY;
  r.b = rest / tiles_y;
  return r;
}

// A patch row's place in the image: the input row iy = 4 * py0 - 5 + r and
// columns from ix0 = 4 * px0 - 5; the values [e_lo, e_hi) of the row lie
// inside the image (none when the row is outside it), and `first` is the
// address of value e_lo.
struct PatchRow {
  int e_lo, e_hi;
  uintptr_t first;
};

__device__ __forceinline__ PatchRow patch_row(const uint16_t* x, const Tile& tl, int r, int h,
                                              int w_in) {
  PatchRow pr;
  const int iy = 4 * tl.py0 - 5 + r;
  const int ix0 = 4 * tl.px0 - 5;
  const int lo = max(ix0, 0);
  const int hi = min(ix0 + kPW, w_in);
  const bool in = iy >= 0 && iy < h && lo < hi;
  pr.e_lo = in ? 3 * (lo - ix0) : 0;
  pr.e_hi = in ? 3 * (hi - ix0) : 0;
  pr.first = reinterpret_cast<uintptr_t>(x + ((tl.b * h + (in ? iy : 0)) * w_in + lo) * 3);
  return pr;
}

// 1a. The patch rows of a tile, staged: a row a warp, a 16-byte copy a
// lane (asynchronous; the caller waits).
__device__ __forceinline__ void stage_patch(unsigned char* stage, const uint16_t* x,
                                            const Tile& tl, int h, int w_in, int hw, int lane) {
#pragma unroll
  for (int i = 0; i < (kPH + kHelperWarps - 1) / kHelperWarps; ++i) {
    const int r = hw + i * kHelperWarps;
    if (r >= kPH) break;
    const PatchRow pr = patch_row(x, tl, r, h, w_in);
    const uintptr_t a0 = pr.first & ~uintptr_t(15);
    const uintptr_t end = pr.first + 2 * (pr.e_hi - pr.e_lo);
    if (lane < kStageChunks && a0 + 16 * lane < end)
      cp_async16(stage + r * kStageRow + 16 * lane, reinterpret_cast<const void*>(a0 + 16 * lane));
  }
}

// 1b. The staged rows -> a patch, each value shifted to its place in the
// row (so that every conv pixel starts on a word), zeros outside the image:
// a row a warp, two words (4 values) a lane.
__device__ __forceinline__ void unpack_patch(uint32_t* patch, const unsigned char* stage,
                                             const uint16_t* x, const Tile& tl, int h, int w_in,
                                             int hw, int lane) {
#pragma unroll
  for (int i = 0; i < (kPH + kHelperWarps - 1) / kHelperWarps; ++i) {
    const int r = hw + i * kHelperWarps;
    if (r >= kPH) break;
    const PatchRow pr = patch_row(x, tl, r, h, w_in);
    // value e of the row is staged value e + sh
    const int sh = static_cast<int>((pr.first & 15) >> 1) - pr.e_lo;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(stage + r * kStageRow);
    const uint16_t* row16 = reinterpret_cast<const uint16_t*>(row);
    uint32_t* dst = patch + r * kRowWords;
    if (2 * lane >= kPatchWords) continue;
    const int e = 4 * lane;   // values e .. e + 3
    uint32_t v0, v1;
    if (pr.e_lo == 0 && pr.e_hi == kPatchValues) {
      const int k = e + sh;   // staged values k .. k + 3, k >= 0
      if ((k & 1) == 0) {
        v0 = row[k >> 1];
        v1 = row[(k >> 1) + 1];
      } else {
        const uint32_t w0 = row[k >> 1], w1 = row[(k >> 1) + 1], w2 = row[(k >> 1) + 2];
        v0 = __funnelshift_r(w0, w1, 16);
        v1 = __funnelshift_r(w1, w2, 16);
      }
    } else {
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = e + i >= pr.e_lo && e + i < pr.e_hi ? row16[e + i + sh] : 0u;
      v0 = q[0] | q[1] << 16;
      v1 = q[2] | q[3] << 16;
    }
    dst[2 * lane] = v0;
    dst[2 * lane + 1] = v1;
  }
}

// The larger of each bf16 of two vectors of 8.
__device__ __forceinline__ uint4 max8(uint4 a, const uint4& b) {
  __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) pa[i] = __hmax2(pa[i], pb[i]);
  return a;
}

__global__ void __launch_bounds__(kThreads, 1) stem_conv_relu_maxpool_kernel(
    const uint16_t* __restrict__ x,         // (B, H, W, 3) bf16
    const uint16_t* __restrict__ w,         // (64, 7, 7, 3) bf16
    const __nv_bfloat16* __restrict__ bias, // (64,)
    __nv_bfloat16* __restrict__ out,        // (B, HP, WP, 64)
    int h, int w_in, int hc, int wc, int hp, int wp, int tiles_y, int tiles_x, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* b_s = smem;
  uint32_t* patches = reinterpret_cast<uint32_t*>(b_s + kBBytes);
  unsigned char* convs = b_s + kBBytes + 2 * kPatchBytes;
  unsigned char* stage = convs + 2 * kConvBytes;
  float* bias_s = reinterpret_cast<float*>(stage + 2 * kStageBytes);
  // The block's tiles: blockIdx.x, + gridDim.x, ...
  const int n = (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                static_cast<int>(gridDim.x);
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  // B: element (o, k) of row o, K index k = 2 * pair + (0 or 1), at panel
  // k / 64, row o, 16-byte chunk (k % 64 / 8) ^ (o % 8); zero past the
  // kernel's 147 values. Written as bf16 pairs (4-byte words).
  for (int i = tid; i < kCout * kPanels * 32; i += kThreads) {
    const int o = i / (kPanels * 32);
    const int kw = i - o * (kPanels * 32);   // word index along K: pair kw
    uint32_t v = 0u;
    if (kw < kPairs) {
      const int j = 2 * (kw % kPairsPerRow);
      const uint16_t* row = w + o * kTaps + kw / kPairsPerRow * kRowValues;
      v = row[j] | (j + 1 < kRowValues ? static_cast<uint32_t>(row[j + 1]) << 16 : 0u);
    }
    const int k = 2 * kw;
    *reinterpret_cast<uint32_t*>(b_s + k / 64 * kPanelBytes + o * 128 +
                                 ((k % 64 / 8) ^ (o % 8)) * 16 + k % 8 * 2) = v;
  }
  if (tid < kCout) bias_s[tid] = __bfloat162float(bias[tid]);
  fence_proxy_async();
  __syncthreads();

  // Warpgroup-uniform role: read from lane 0, so that the compiler sees it.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kMmaGroups) {
    // The helper warpgroup: each tile's patch, two tiles ahead of the
    // products.
    const int hw = tid / 32 - kMmaThreads / 32;
    // The staged rows alternate too: tile k + 1's copies are in flight
    // while tile k is unpacked.
    stage_patch(stage, x, tile_at(blockIdx.x, tiles_y, tiles_x), h, w_in, hw, lane);
    cp_async_commit();
    for (int k = 0; k < n; ++k) {
      const Tile tl = tile_at(blockIdx.x + k * gridDim.x, tiles_y, tiles_x);
      helpers_sync();   // tile k - 1's staged rows are unpacked
      if (k + 1 < n) {
        stage_patch(stage + ((k + 1) & 1) * kStageBytes, x,
                    tile_at(blockIdx.x + (k + 1) * gridDim.x, tiles_y,
                            tiles_x), h, w_in, hw, lane);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      helpers_sync();   // every row of tile k is staged
      if (k >= 2) bar_sync(kPatchEmpty + (k & 1));   // the products of tile k - 2 are done
      unpack_patch(patches + (k & 1) * (kPatchBytes / 4), stage + (k & 1) * kStageBytes, x, tl,
                   h, w_in, hw, lane);
      bar_arrive(kPatchFull + (k & 1));
    }
    return;
  }

  // The product warpgroups: M tiles of 64 conv pixels, each all 64
  // channels, shared out in turn (the first of tile k to warpgroup k % 3);
  // then the first two pool the tile.
  const int q = tid / 32 % 4;   // warp in the warpgroup
  const int g = lane / 4;
  const int u = lane % 4;
  uint32_t offs[kSteps];   // the A fragment's pair words, low and high half-steps
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    offs[s] = pair_word(8 * s + u) | pair_word(8 * s + 4 + u) << 16;
  const uint32_t b_addr = smem_u32(b_s);
  // The pool's share of a thread: 8 channels (chunk) of pooled column px,
  // pooled rows 2 * pr0 and 2 * pr0 + 1.
  const int chunk = tid & 7;
  const int ppx = (tid >> 3) % kTPX;
  const int pr0 = tid / (8 * kTPX);

  for (int k = 0; k < n; ++k) {
    const int buf = k & 1;
    const Tile tl = tile_at(blockIdx.x + k * gridDim.x, tiles_y, tiles_x);
    const uint32_t* patch = patches + buf * (kPatchBytes / 4);
    unsigned char* conv = convs + buf * kConvBytes;
    const int cy0 = 2 * tl.py0 - 1;   // the conv tile's first row and column
    const int cx0 = 2 * tl.px0 - 1;
    // 2. the conv pixels of the tile inside the image: local rows
    // [ly_lo, ly_hi), columns [lx_lo, lx_hi), flattened row-major.
    const int ly_lo = cy0 < 0 ? 1 : 0;
    const int lx_lo = cx0 < 0 ? 1 : 0;
    const int ly_hi = min(kCH, hc - cy0);
    const int lx_hi = min(kCW, wc - cx0);
    const int n_lx = lx_hi - lx_lo;
    const int m_total = (ly_hi - ly_lo) * n_lx;
    const int m_tiles = (m_total + 63) / 64;
    bar_sync(kPatchFull + buf);
    for (int mt = (wg + kMmaGroups - k % kMmaGroups) % kMmaGroups; mt < m_tiles;
         mt += kMmaGroups) {
      int base[2], slot[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 64 + 16 * q + g + 8 * hh;
        const int mc = min(m, m_total - 1);   // rows past the end redo the last pixel
        // A whole row of the tile (all but the image's last column of
        // tiles) divides by a constant.
        const int ly = ly_lo + (n_lx == kCW ? mc / kCW : mc / n_lx);
        const int lx = lx_lo + (n_lx == kCW ? mc % kCW : mc % n_lx);
        base[hh] = 2 * ly * kRowWords + 3 * lx;
        slot[hh] = m < m_total ? ly * kCW + lx : -1;
      }
      // The A fragments, two k16 steps at a time, each pair's products
      // issued as soon as it is loaded, so that the next pair's loads run
      // under them (each step keeps its own registers until the wait).
      uint32_t a[kSteps][4];
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int lo = offs[s] & 0xffff;
        const int hi = offs[s] >> 16;
        a[s][0] = patch[base[0] + lo];
        a[s][1] = patch[base[1] + lo];
        a[s][2] = patch[base[0] + hi];
        a[s][3] = patch[base[1] + hi];
        if (s % 2 == 1) {
          wgmma_fence();
          wgmma_rs(acc, a[s - 1], smem_desc(b_addr + (s - 1) / 4 * kPanelBytes +
                                            32 * ((s - 1) % 4)), s > 1);
          wgmma_rs(acc, a[s], smem_desc(b_addr + s / 4 * kPanelBytes + 32 * (s % 4)), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      // 3. + bias, ReLU, bf16 -> the conv tile.
      float2 bv[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        bv[nt] = *reinterpret_cast<const float2*>(bias_s + nt * 8 + 2 * u);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (slot[hh] < 0) continue;
        unsigned char* px = conv + slot[hh] * kSlot + 4 * u;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(px + ((nt ^ (slot[hh] & 7)) << 4)) =
              __floats2bfloat162_rn(fmaxf(__fadd_rn(acc[4 * nt + 2 * hh], bv[nt].x), 0.0f),
                                    fmaxf(__fadd_rn(acc[4 * nt + 2 * hh + 1], bv[nt].y), 0.0f));
      }
    }
    if (k + 2 < n) bar_arrive(kPatchEmpty + buf);
    products_sync();   // the conv tile is whole
    // 4. The pool, by the first two warpgroups: each row's max over its 3
    // columns read once. The loads have no branch, so that they are in
    // flight together; a conv pixel outside the map reads a stale slot and
    // counts as 0. The conv tiles alternate, so the next tile's epilogue
    // never writes the one being pooled.
    if (wg < 2 && tl.px0 + ppx < wp) {
      auto row_max = [&](int ly) {
        const bool row_in = cy0 + ly >= 0 && cy0 + ly < hc;
        uint4 m = make_uint4(0u, 0u, 0u, 0u);   // 8 bf16 zeros
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int lx = 2 * ppx + dx;
          const int s = ly * kCW + lx;
          const uint4 v = *reinterpret_cast<const uint4*>(conv + s * kSlot +
                                                          ((chunk ^ (s & 7)) << 4));
          if (row_in && cx0 + lx >= 0 && cx0 + lx < wc) m = max8(m, v);
        }
        return m;
      };
      uint4 top = row_max(4 * pr0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int py = 2 * pr0 + r;
        const uint4 mid = row_max(2 * py + 1);
        const uint4 bottom = row_max(2 * py + 2);
        if (tl.py0 + py < hp)
          *reinterpret_cast<uint4*>(out + ((tl.b * hp + tl.py0 + py) * wp + tl.px0 + ppx) *
                                    kCout + chunk * 8) = max8(max8(top, mid), bottom);
        top = bottom;
      }
    }
  }
}

}  // namespace

// Launches the stem on `stream` and returns a cudaError_t (0 when the
// launch was accepted). Pointers are device pointers to contiguous tensors,
// `out` 16-byte aligned; B >= 1, H and W >= 7 (the wrapper checks all of
// it). The grid is one block an SM, at most one a tile.
extern "C" int posenet_stem(const void* x, const void* w, const void* bias, void* out,
                            int b, int h, int w_in, void* stream) {
  if (b < 1 || h < 7 || w_in < 7) return static_cast<int>(cudaErrorInvalidValue);
  const int hc = (h - 1) / 2 + 1;
  const int wc = (w_in - 1) / 2 + 1;
  const int hp = (hc - 1) / 2 + 1;
  const int wp = (wc - 1) / 2 + 1;
  const int tiles_y = (hp + kTPY - 1) / kTPY;
  const int tiles_x = (wp + kTPX - 1) / kTPX;
  const int64_t tiles = static_cast<int64_t>(b) * tiles_y * tiles_x;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(stem_conv_relu_maxpool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = tiles < sms ? tiles : sms;
  stem_conv_relu_maxpool_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), h, w_in, hc,
      wc, hp, wp, tiles_y, tiles_x, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
