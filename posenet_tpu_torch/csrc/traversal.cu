// K-parallel kinematic-tree walk of the multi-pose decoder, for Hopper.
//
// Replaces the TPU kernel `traverse_all_candidates_pallas`
// (posenet_tpu/ops/pallas/traversal.py:551). That kernel turned every row
// fetch into one-hot matmuls over bf16-split tables held in VMEM, because
// gathers were slow on the TPU. Here a fetch is a plain load.
//
// What bounds it on an H100:
// - Bytes: each candidate reads its score, keypoint and root (16 B) and
//   writes 17 scores, coordinate pairs and offset pairs (340 B); each hop
//   that fetches reads a displacement pair (8 B) and the landing cell's
//   score and offset pair (12 B). At B = K = 128 on 33x33 peaked heads that
//   is about 8 MB, 0.0024 ms at 3.35 TB/s (chip_smoke.k1_bound_ms).
// - Latency, which is what sets its time: a candidate's walk is a chain.
//   The tree has 8 dependency levels (backward 2, 4, 6, 4 hops, forward 4,
//   6, 4, 2), and each level is two dependent fetches (the displacement at
//   the source cell, then score and offset at the landing cell), mostly L2
//   hits: 16 dependent loads, plus the launch.
//
// Design, point by point:
// 1. State in registers. The 32 hops are a compile-time table (`hop`) and
//    the walk is unrolled through templates, so every index into the
//    17-keypoint state (score, y, x, offset y, offset x) is a constant and
//    the 85 floats stay in registers: ptxas reports a 0-byte stack frame
//    (chip_smoke prints it). The C entry compares the hop table it is
//    passed (ops/traversal.hop_table(), held to the JAX package's by the
//    tests) with this one, and launches nothing if they differ.
// 2. Level-batched fetches. A level issues the displacement fetch of every
//    hop that may fill, then every landing fetch, then applies the fills in
//    hop order: 16 dependent loads instead of 64. Within a level no hop's
//    source is another's target, so the fetches see the state the
//    hop-by-hop walk would. Targets do repeat in the backward levels (four
//    hops target the nose; 5 and 6 are targeted twice), and a hop that
//    lands on a zero score leaves its target empty for the next hop of the
//    level. So the fetches are speculative, for every hop whose source is
//    filled and whose target was empty when the level began, and the test
//    `score[target] == 0` runs at the fill, after the previous hop's fill.
// 3. Blocks of kThreads candidates, flattened over (image, candidate): at
//    B * K = 16384 that is 256 blocks of 64, about two on each of the 132
//    SMs. Builds with 32, 64 and 128 a block timed the same within 2% on
//    an H100 (PERF.md): the walk is one latency chain. A candidate without
//    a filled root issues no fetch.
// 4. Coalesced stores. A block's outputs are contiguous (340 B a
//    candidate), so each thread stages its state in shared memory and the
//    block writes the three ranges with 16-byte stores.
// 5. Rows read where they are. Each input is (B, H*W, C) rows with unit
//    column stride and any batch and row stride, so the kernel can read
//    the heads as the forward wrote them.
//
// Exactness: the plain version is the contract, bit for bit. So every
// operation rounds as it does there: build with -fmad=false (and the
// products below are __fmul_rn / __fadd_rn besides), IEEE division (no
// fast math, default -prec-div=true), rintf (half to even, as
// torch.round), and clipping with fminf/fmaxf before the int conversion.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kNumKeypoints = 17;
constexpr int kNumEdges = 16;
constexpr int kNumHops = 2 * kNumEdges;
constexpr int kNumLevels = 8;
constexpr int kThreads = 64;

// The C entry's return value when the hop table it is passed is not this
// one (cudaError_t values are >= 0).
constexpr int kHopTableMismatch = -1;

struct Hop {
  int edge, source, target;
};

// Hop i reads edge's displacement at keypoint source and fills keypoint
// target: the 16 backward hops (over dbwd), then the 16 forward ones (over
// dfwd), level by level, in the decoder's order (decode._tree_levels).
__host__ __device__ constexpr Hop hop(int i) {
  constexpr Hop kHops[kNumHops] = {
      {9, 15, 13}, {15, 16, 14},
      {6, 9, 7}, {8, 13, 11}, {12, 10, 8}, {14, 14, 12},
      {1, 3, 1}, {3, 4, 2}, {5, 7, 5}, {7, 11, 5}, {11, 8, 6}, {13, 12, 6},
      {0, 1, 0}, {2, 2, 0}, {4, 5, 0}, {10, 6, 0},
      {0, 0, 1}, {2, 0, 2}, {4, 0, 5}, {10, 0, 6},
      {1, 1, 3}, {3, 2, 4}, {5, 5, 7}, {7, 5, 11}, {11, 6, 8}, {13, 6, 12},
      {6, 7, 9}, {8, 11, 13}, {12, 8, 10}, {14, 12, 14},
      {9, 13, 15}, {15, 14, 16}};
  return kHops[i];
}

// Level l is hops [level_start(l), level_start(l + 1)).
__host__ __device__ constexpr int level_start(int l) {
  constexpr int kStart[kNumLevels + 1] = {0, 2, 6, 12, 16, 20, 26, 30, 32};
  return kStart[l];
}

// (B, H*W, C) float32 rows, unit column stride; strides in elements.
struct Rows {
  const float* data;
  int64_t batch_stride;
  int64_t row_stride;
};

struct Params {
  const float* cand_scores;  // (B, K)
  const int* cand_kp;        // (B, K)
  const float* root_coords;  // (B, K, 2)
  Rows scores;               // heatmap scores, 17 columns
  Rows offsets;              // [y || x], 34 columns
  Rows dfwd;                 // [y || x], 32 columns
  Rows dbwd;
  float* out_scores;         // (B, K, 17)
  float* out_coords;         // (B, K, 17, 2)
  float* out_offsets;        // (B, K, 17, 2)
  int64_t total;             // B * K
  int k, w;
  float hmax, wmax, stride;
};

// One candidate's 17-keypoint state; indexed only by constants.
struct Walk {
  float score[kNumKeypoints], y[kNumKeypoints], x[kNumKeypoints];
  float oy[kNumKeypoints], ox[kNumKeypoints];
};

// One image's rows and grid.
struct Image {
  const float* scores;
  const float* offsets;
  const float* dfwd;
  const float* dbwd;
  int64_t scores_row, offsets_row, dfwd_row, dbwd_row;
  int w;
  float hmax, wmax, stride;
};

// What one hop fetched in its level.
struct Fetch {
  bool live;  // source filled and target empty when the level began
  float dy, dx, ty, tx, score, oy, ox;
};

// clip(round_half_even(coord / stride), 0, hi)
__device__ __forceinline__ float grid_cell(float coord, float stride, float hi) {
  return fminf(fmaxf(rintf(__fdiv_rn(coord, stride)), 0.0f), hi);
}

template <int I>
__device__ __forceinline__ void fetch_displacement(const Walk& st, const Image& im, Fetch& f) {
  constexpr Hop h = hop(I);
  constexpr bool backward = I < kNumEdges;
  f.live = st.score[h.source] > 0.0f && st.score[h.target] == 0.0f;
  f.dy = f.dx = 0.0f;
  if (f.live) {
    const int cell = static_cast<int>(grid_cell(st.y[h.source], im.stride, im.hmax)) * im.w
                     + static_cast<int>(grid_cell(st.x[h.source], im.stride, im.wmax));
    const float* row = backward ? im.dbwd + cell * im.dbwd_row : im.dfwd + cell * im.dfwd_row;
    f.dy = __ldg(row + h.edge);
    f.dx = __ldg(row + kNumEdges + h.edge);
  }
}

template <int I>
__device__ __forceinline__ void fetch_landing(const Walk& st, const Image& im, Fetch& f) {
  constexpr Hop h = hop(I);
  f.ty = f.tx = f.score = f.oy = f.ox = 0.0f;
  if (f.live) {
    f.ty = grid_cell(__fadd_rn(st.y[h.source], f.dy), im.stride, im.hmax);
    f.tx = grid_cell(__fadd_rn(st.x[h.source], f.dx), im.stride, im.wmax);
    const int cell = static_cast<int>(f.ty) * im.w + static_cast<int>(f.tx);
    const float* off = im.offsets + cell * im.offsets_row;
    f.score = __ldg(im.scores + cell * im.scores_row + h.target);
    f.oy = __ldg(off + h.target);
    f.ox = __ldg(off + kNumKeypoints + h.target);
  }
}

template <int I>
__device__ __forceinline__ void fill(Walk& st, const Image& im, const Fetch& f) {
  constexpr Hop h = hop(I);
  // A keypoint fills once, from a filled source. An earlier hop of this
  // level may have filled the target since the fetch was issued.
  if (f.live && st.score[h.target] == 0.0f) {
    st.score[h.target] = f.score;
    st.y[h.target] = __fadd_rn(__fmul_rn(f.ty, im.stride), f.oy);
    st.x[h.target] = __fadd_rn(__fmul_rn(f.tx, im.stride), f.ox);
    st.oy[h.target] = f.oy;
    st.ox[h.target] = f.ox;
  }
}

template <int First, int... Is>
__device__ __forceinline__ void walk_hops(Walk& st, const Image& im,
                                          std::integer_sequence<int, Is...>) {
  Fetch f[sizeof...(Is)];
  (fetch_displacement<First + Is>(st, im, f[Is]), ...);
  (fetch_landing<First + Is>(st, im, f[Is]), ...);
  (fill<First + Is>(st, im, f[Is]), ...);
}

template <int L>
__device__ __forceinline__ void walk_level(Walk& st, const Image& im) {
  walk_hops<level_start(L)>(
      st, im, std::make_integer_sequence<int, level_start(L + 1) - level_start(L)>{});
}

template <int... Ls>
__device__ __forceinline__ void walk(Walk& st, const Image& im, std::integer_sequence<int, Ls...>) {
  (walk_level<Ls>(st, im), ...);
}

// dst[0:count] = src[0:count]: 16-byte stores from the whole block, then
// the ragged tail. dst and src are 16-byte aligned.
__device__ __forceinline__ void store_block(float* __restrict__ dst, const float* src, int count) {
  const int n4 = count / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = src4[i];
  for (int i = 4 * n4 + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) traverse_kernel(const Params p) {
  __shared__ __align__(16) float s_scores[kThreads * kNumKeypoints];
  __shared__ __align__(16) float2 s_coords[kThreads * kNumKeypoints];
  __shared__ __align__(16) float2 s_offsets[kThreads * kNumKeypoints];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t cand = first + threadIdx.x;
  if (cand < p.total) {
    const int64_t b = cand / p.k;
    const Image im = {p.scores.data + b * p.scores.batch_stride,
                      p.offsets.data + b * p.offsets.batch_stride,
                      p.dfwd.data + b * p.dfwd.batch_stride,
                      p.dbwd.data + b * p.dbwd.batch_stride,
                      p.scores.row_stride, p.offsets.row_stride,
                      p.dfwd.row_stride, p.dbwd.row_stride,
                      p.w, p.hmax, p.wmax, p.stride};
    const int root = p.cand_kp[cand];
    const float root_score = p.cand_scores[cand];
    const float root_y = p.root_coords[2 * cand];
    const float root_x = p.root_coords[2 * cand + 1];
    Walk st;
#pragma unroll
    for (int j = 0; j < kNumKeypoints; ++j) {
      const bool is_root = j == root;
      st.score[j] = is_root ? root_score : 0.0f;
      st.y[j] = is_root ? root_y : 0.0f;
      st.x[j] = is_root ? root_x : 0.0f;
      st.oy[j] = 0.0f;
      st.ox[j] = 0.0f;
    }

    walk(st, im, std::make_integer_sequence<int, kNumLevels>{});

    // Rows of 17 floats (odd) and of 17 float2s (a half-warp's 8-byte
    // stores fall in distinct banks): no bank conflicts.
    const int base = threadIdx.x * kNumKeypoints;
#pragma unroll
    for (int j = 0; j < kNumKeypoints; ++j) {
      s_scores[base + j] = st.score[j];
      s_coords[base + j] = make_float2(st.y[j], st.x[j]);
      s_offsets[base + j] = make_float2(st.oy[j], st.ox[j]);
    }
  }
  __syncthreads();

  const int64_t left = p.total - first;
  const int n = left < kThreads ? static_cast<int>(left) : kThreads;
  store_block(p.out_scores + first * kNumKeypoints, s_scores, n * kNumKeypoints);
  store_block(p.out_coords + first * 2 * kNumKeypoints,
              reinterpret_cast<const float*>(s_coords), n * 2 * kNumKeypoints);
  store_block(p.out_offsets + first * 2 * kNumKeypoints,
              reinterpret_cast<const float*>(s_offsets), n * 2 * kNumKeypoints);
}

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or kHopTableMismatch, launching nothing, when
// `hops` (a host array of 3 x 32 int32: edges, sources, targets) is not
// the table compiled in. Device pointers: cand_scores, cand_kp,
// root_coords and the outputs contiguous, the outputs 16-byte aligned; the
// row tensors scores (B, H*W, 17), offsets (B, H*W, 34) = [y || x], dfwd
// and dbwd (B, H*W, 32) = [y || x], each with unit column stride, and
// `strides` a host array of their (batch, row) strides in elements, in
// that order (8 values).
extern "C" int posenet_traverse_all_candidates(
    const void* cand_scores, const void* cand_kp, const void* root_coords,
    const void* scores, const void* offsets, const void* dfwd, const void* dbwd,
    const int64_t* strides, void* out_scores, void* out_coords, void* out_offsets,
    int b, int k, int h, int w, float stride, const int* hops, void* stream) {
  for (int i = 0; i < kNumHops; ++i) {
    const Hop e = hop(i);
    if (hops[i] != e.edge || hops[kNumHops + i] != e.source
        || hops[2 * kNumHops + i] != e.target) {
      return kHopTableMismatch;
    }
  }
  Params p;
  p.cand_scores = static_cast<const float*>(cand_scores);
  p.cand_kp = static_cast<const int*>(cand_kp);
  p.root_coords = static_cast<const float*>(root_coords);
  p.scores = {static_cast<const float*>(scores), strides[0], strides[1]};
  p.offsets = {static_cast<const float*>(offsets), strides[2], strides[3]};
  p.dfwd = {static_cast<const float*>(dfwd), strides[4], strides[5]};
  p.dbwd = {static_cast<const float*>(dbwd), strides[6], strides[7]};
  p.out_scores = static_cast<float*>(out_scores);
  p.out_coords = static_cast<float*>(out_coords);
  p.out_offsets = static_cast<float*>(out_offsets);
  p.total = static_cast<int64_t>(b) * k;
  p.k = k;
  p.w = w;
  p.hmax = static_cast<float>(h - 1);
  p.wmax = static_cast<float>(w - 1);
  p.stride = stride;
  const int64_t blocks = (p.total + kThreads - 1) / kThreads;
  traverse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
