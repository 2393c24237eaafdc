// Predecessor-chain path walk over a lane-minor class table for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package walks with a lax.scan
// (mesh_navigation_tpu/ops/pallas_banded.py:2644, extract_paths_cls), which
// XLA compiles into one loop on the TPU. The port's plain version
// (ops/banded_gpu.extract_paths_cls_plain) is a Python loop that launches
// ~10 small PyTorch ops a step (~15 with the residual decode) on a few
// kilobytes each: on the card a walk of ~2,000 steps is ~2,000 x ~170 us of
// host launches and nothing else. Here one launch walks every lane to its
// end, with no chunks and no host read.
//
// What it computes. For each lane b < B, from v = start[b]: at step i it
// writes path[i, b] = v and valid[i, b] = 1 while the lane walks; then
// k = cls[v, b] and next = v + delta[k], delta = (-1, 1, -C-1, -C, -C+1,
// C-1, C, C+1, 0, 0) in class order; the lane stops after the step where
// v == goal[b] or k == 8. With the residual tables (the RESIDUAL
// instantiation, irregular plans), class 9 decodes through the jump table:
// row = clamp(row_map[v], 0, n_rows), slot = clamp(choice[row, b], 0, 7),
// next = jump[row, slot]. After a lane stops, every later step writes its
// terminal vertex with valid 0, up to max_len. This is the plain loop's
// rule step for step, so the two agree path for path, bit for bit.
// steps[b], where given, is the lane's count of valid steps.
//
// What bounds it on this card. The chain of dependent loads, not bytes. A
// step's class load needs the vertex the previous load decided: at the
// fleet's shape (V = 1,048,576, 4,096 lanes) the class table is 4.3 GB, so
// nearly every step is a miss to device memory at ~0.6-1 us, and the
// longest of 4,096 lanes walks ~2,000 steps: ~1.2-2 ms of latency. A
// class-9 step adds two more dependent loads (the choice, then the jump;
// the row map is read beside the class, since both need only v). The
// bytes are small: 3,072 steps x 4,096 lanes x (8 + 1) B = 113 MB of path
// and valid written, ~34 us at 3.35 TB/s, and ~2,000 x 4,096 32-byte
// sectors of class reads, ~0.08 ms.
//
// What the design does about it. One thread a lane walks its own chain to
// its end, so the critical path is the longest lane's chain and nothing
// waits for the host or for other lanes. Blocks are one warp: 4,096 lanes
// are 128 warps, so each warp gets an SM of its own (132 on the card) and
// its own load pipe and L1. The 32 threads of a warp go through the steps
// together, so at step i neighbouring lanes store to neighbouring
// addresses (one 256-byte path store and one 32-byte valid store a warp);
// a lane that has stopped only stores.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;

// the vertex step of class k (0..7 in class order; 8 and 9 do not move)
__device__ __forceinline__ long long class_step(int k, long long C) {
  switch (k) {
    case 0: return -1;
    case 1: return 1;
    case 2: return -C - 1;
    case 3: return -C;
    case 4: return -C + 1;
    case 5: return C - 1;
    case 6: return C;
    case 7: return C + 1;
    default: return 0;
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(WARP) walk_kernel(
    const int8_t* __restrict__ cls, long long ld_cls, long long V,
    const long long* __restrict__ start, const long long* __restrict__ goal,
    const int* __restrict__ row_map, const int* __restrict__ jump,
    const int8_t* __restrict__ choice, long long ld_choice, int n_rows,
    long long* __restrict__ path, uint8_t* __restrict__ valid, int* __restrict__ steps,
    int B, int max_len, long long C) {
  const int b = blockIdx.x * WARP + threadIdx.x;
  if (b >= B) return;
  long long v = start[b];
  const long long g = goal[b];
  bool alive = true;
  int n = 0;
  for (int i = 0; i < max_len; ++i) {
    const long long o = (long long)i * B + b;
    path[o] = v;
    valid[o] = alive;
    if (!alive) continue;
    ++n;
    if (v == g) {
      alive = false;
      continue;
    }
    assert(v >= 0 && v < V && "walk: a vertex outside the class table");
    int row = 0;
    if (RESIDUAL) row = row_map[v];
    const int k = cls[v * ld_cls + b];
    assert(k >= 0 && k <= 9 && "walk: a class outside 0..9");
    if (k == 8) {
      alive = false;
    } else if (RESIDUAL && k == 9) {
      row = min(max(row, 0), n_rows);
      const int slot = min(max((int)choice[row * ld_choice + b], 0), 7);
      v = jump[row * 8 + slot];
    } else {
      v += class_step(k, C);
    }
  }
  if (steps != nullptr) steps[b] = n;
}

}  // namespace

// `row_map`, `jump` and `choice` are all given (the residual decode) or all
// null. `steps` may be null. path [max_len, B] int64, valid [max_len, B]
// uint8, both contiguous.
extern "C" int walk_launch(const int8_t* cls, long long ld_cls, long long V,
                           const long long* start, const long long* goal, const int* row_map,
                           const int* jump, const int8_t* choice, long long ld_choice,
                           int n_rows, long long* path, uint8_t* valid, int* steps, int B,
                           int max_len, long long C, void* stream) {
  const bool residual = row_map != nullptr;
  if (B < 1 || max_len < 0 || ld_cls < B || V < 1 ||
      residual != (jump != nullptr) || residual != (choice != nullptr) ||
      (residual && (ld_choice < B || n_rows < 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + WARP - 1) / WARP));
  cudaStream_t s = (cudaStream_t)stream;
  if (residual)
    walk_kernel<true><<<grid, WARP, 0, s>>>(cls, ld_cls, V, start, goal, row_map, jump, choice,
                                           ld_choice, n_rows, path, valid, steps, B, max_len, C);
  else
    walk_kernel<false><<<grid, WARP, 0, s>>>(cls, ld_cls, V, start, goal, nullptr, nullptr,
                                            nullptr, 0, 0, path, valid, steps, B, max_len, C);
  return (int)cudaGetLastError();
}
