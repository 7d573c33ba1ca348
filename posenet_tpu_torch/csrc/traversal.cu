// K-parallel kinematic-tree walk of the multi-pose decoder, for Hopper.
//
// Replaces the TPU kernel `traverse_all_candidates_pallas`
// (posenet_tpu/ops/pallas/traversal.py:551). That kernel turned every row
// fetch into one-hot matmuls over bf16-split tables held in VMEM, because
// gathers were slow on the TPU. Here a fetch is a plain load, so the
// kernel reads the float32 row tables directly, at any grid size.
//
// Design: one thread per (image, candidate); grid (B, ceil(K/128)), 128
// threads a block. A thread keeps its candidate's 17-keypoint state
// (score, coord y/x, offset y/x) in local arrays and walks the 32 hops in
// sequence: the 16 edges backward over the dbwd table, then forward over
// dfwd, in the decoder's level order. Hop-sequential order equals the
// level-batched order of the plain version, because within a level no
// edge's source is another's target.
//
// Bound: latency of dependent loads. A hop is two dependent row fetches
// (displacement at the source cell, then score + offset at the landing
// cell), 32 hops in a chain, and the flagship shape has only B*K = 16k
// threads. A flagship batch's tables are ~64 MB, so the rows mostly come
// from L2. Making it fast (more candidates in flight per warp, prefetching
// the next level) is later work.
//
// Exactness: the plain version is the contract, bit for bit. So every
// operation rounds as it does there: build with -fmad=false (and the
// products below are __fmul_rn / __fadd_rn besides), IEEE division
// (no fast math, default -prec-div=true), rintf (half to even, as
// torch.round), and clipping with fminf/fmaxf before the int conversion.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNumKeypoints = 17;
constexpr int kNumEdges = 16;
constexpr int kNumHops = 2 * kNumEdges;
constexpr int kSovCols = 3 * kNumKeypoints;  // [scores || off-y || off-x]
constexpr int kDispCols = 2 * kNumEdges;     // [y || x]
constexpr int kThreads = 128;

// Hop h reads edge[h]'s displacement at keypoint source[h] and fills
// keypoint target[h]. Hops 0-15 use dbwd, hops 16-31 dfwd. Passed by
// value, so it lives in the kernel's constant parameter space.
struct HopTable {
  int edge[kNumHops];
  int source[kNumHops];
  int target[kNumHops];
};

// clip(round_half_even(coord / stride), 0, hi)
__device__ __forceinline__ float grid_cell(float coord, float stride, float hi) {
  return fminf(fmaxf(rintf(__fdiv_rn(coord, stride)), 0.0f), hi);
}

__global__ void __launch_bounds__(kThreads) traverse_kernel(
    const float* __restrict__ cand_scores,   // (B, K)
    const int* __restrict__ cand_kp,         // (B, K)
    const float* __restrict__ root_coords,   // (B, K, 2)
    const float* __restrict__ sov,           // (B, H*W, 51)
    const float* __restrict__ dfwd,          // (B, H*W, 32)
    const float* __restrict__ dbwd,          // (B, H*W, 32)
    float* __restrict__ out_scores,          // (B, K, 17)
    float* __restrict__ out_coords,          // (B, K, 17, 2)
    float* __restrict__ out_offsets,         // (B, K, 17, 2)
    int k, int h, int w, float stride, HopTable hops) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= k) return;
  const int64_t b = blockIdx.x;
  const int64_t cand = b * k + c;
  const int64_t cells = static_cast<int64_t>(h) * w;
  const float* sov_b = sov + b * cells * kSovCols;
  const float* dfwd_b = dfwd + b * cells * kDispCols;
  const float* dbwd_b = dbwd + b * cells * kDispCols;
  const float hmax = static_cast<float>(h - 1);
  const float wmax = static_cast<float>(w - 1);

  float score[kNumKeypoints], cy[kNumKeypoints], cx[kNumKeypoints];
  float oy[kNumKeypoints], ox[kNumKeypoints];
  const int root = cand_kp[cand];
  const float root_score = cand_scores[cand];
  const float root_y = root_coords[2 * cand];
  const float root_x = root_coords[2 * cand + 1];
#pragma unroll
  for (int j = 0; j < kNumKeypoints; ++j) {
    const bool is_root = j == root;
    score[j] = is_root ? root_score : 0.0f;
    cy[j] = is_root ? root_y : 0.0f;
    cx[j] = is_root ? root_x : 0.0f;
    oy[j] = 0.0f;
    ox[j] = 0.0f;
  }

  for (int i = 0; i < kNumHops; ++i) {
    const int e = hops.edge[i];
    const int s = hops.source[i];
    const int t = hops.target[i];
    // A keypoint fills once, from a filled source; skipping the fetches
    // otherwise changes no output.
    if (!(score[s] > 0.0f && score[t] == 0.0f)) continue;

    const float ys = cy[s];
    const float xs = cx[s];
    const int src = static_cast<int>(grid_cell(ys, stride, hmax)) * w
                    + static_cast<int>(grid_cell(xs, stride, wmax));
    const float* drow = (i < kNumEdges ? dbwd_b : dfwd_b)
                        + static_cast<int64_t>(src) * kDispCols;
    const float tiy = grid_cell(__fadd_rn(ys, drow[e]), stride, hmax);
    const float tix = grid_cell(__fadd_rn(xs, drow[kNumEdges + e]), stride, wmax);
    const float* trow = sov_b + (static_cast<int64_t>(tiy) * w
                                 + static_cast<int64_t>(tix)) * kSovCols;
    const float off_y = trow[kNumKeypoints + t];
    const float off_x = trow[2 * kNumKeypoints + t];
    score[t] = trow[t];
    cy[t] = __fadd_rn(__fmul_rn(tiy, stride), off_y);
    cx[t] = __fadd_rn(__fmul_rn(tix, stride), off_x);
    oy[t] = off_y;
    ox[t] = off_x;
  }

#pragma unroll
  for (int j = 0; j < kNumKeypoints; ++j) {
    const int64_t o = cand * kNumKeypoints + j;
    out_scores[o] = score[j];
    out_coords[2 * o] = cy[j];
    out_coords[2 * o + 1] = cx[j];
    out_offsets[2 * o] = oy[j];
    out_offsets[2 * o + 1] = ox[j];
  }
}

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). `hops` is a host array of 3 x 32 int32: edges,
// sources, targets. Pointers are device pointers to contiguous tensors.
extern "C" int posenet_traverse_all_candidates(
    const void* cand_scores, const void* cand_kp, const void* root_coords,
    const void* sov, const void* dfwd, const void* dbwd,
    void* out_scores, void* out_coords, void* out_offsets,
    int b, int k, int h, int w, float stride, const int* hops, void* stream) {
  HopTable table;
  for (int i = 0; i < kNumHops; ++i) {
    table.edge[i] = hops[i];
    table.source[i] = hops[kNumHops + i];
    table.target[i] = hops[2 * kNumHops + i];
  }
  const dim3 grid(b, (k + kThreads - 1) / kThreads);
  traverse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand_scores), static_cast<const int*>(cand_kp),
      static_cast<const float*>(root_coords), static_cast<const float*>(sov),
      static_cast<const float*>(dfwd), static_cast<const float*>(dbwd),
      static_cast<float*>(out_scores), static_cast<float*>(out_coords),
      static_cast<float*>(out_offsets), k, h, w, stride, table);
  return static_cast<int>(cudaGetLastError());
}
