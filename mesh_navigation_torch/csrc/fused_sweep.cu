// Fused offset-shift relaxation sweep for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_sweep.py::_sweep_kernel (:40),
// launched by fused_sweep (:58) from batched_field_structured
// (mesh_navigation_tpu/ops/structured.py:207) -- the structured Dijkstra
// tier's sweep.
//
// What it computes. d is the [T + Vp + T, B] f32 label matrix (lanes
// contiguous) with one +inf tile at each end; planes is [K, Vp] f32, the
// weight of the edge arriving at v from v + off_k (+inf: no edge). For each
// tile i of T rows, the centre tile c = d[(i+1)T : (i+2)T] is relaxed
// n_inner times, Jacobi-style, against a halo frozen at the sweep's input:
//     c'[r] = min(c[r], min_k (x[r + off_k] + planes[k, iT + r]))
// where x[s] is c[s] for 0 <= s < T (the current iterate) and the input's
// row (i+1)T + s otherwise (the neighbour tiles, as they came in). The
// result of tile i goes to the same rows of `out`, a buffer apart from d:
// no block reads what another block writes, so the result does not depend
// on the order blocks run in. Every value is one f32 add and a min, so the
// kernel equals the plain PyTorch version bit for bit.
//
// What bounds it on this card. One read and one write of the matrix plus
// one read of the planes: (2 (Vp + 2T) B + K Vp) * 4 bytes, 1.10 GB at the
// 1M-vertex shape (Vp = 1,049,600, T = 1280, B = 128, K = 6), about 0.33 ms
// at 3.35 TB/s. The n_inner * K add + min pairs per element are ~15x below
// the f32 rate: bound by bytes.
//
// What the design does about it. A block owns one tile and a group of LG
// lanes (LG chosen by the launcher so the block's shared memory fits, up to
// 8). It loads the window of rows [(i+1)T - lo, (i+2)T + hi) once into
// shared memory, lo and hi being the largest negative and positive offset,
// and the tile's K x T plane weights beside it, by cp.async with all of
// the block's copies in flight before one wait, and runs all n_inner
// relaxations there: each relaxation writes its centre to a second shared
// buffer and copies it back after a barrier. K is a template parameter, so
// the offset loop unrolls and the K reads of an element are in flight
// together. Device memory sees each element read about (1 + (lo + hi) / T)
// times, the halo rows mostly from L2 since the neighbouring tiles' blocks
// run at the same time, and written once. Threads of a warp cover 32 / LG
// consecutive rows of LG lanes, so shared reads at any offset are free of
// bank conflicts. Row indices are 64-bit: (Vp + 2T) B passes 2^31 at large
// batches.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define THREADS 256
#define MAX_K 16
// dynamic shared memory a block may ask for: the card's 232,448 bytes
#define MAX_SMEM 232448
// at most this, two blocks fit on an SM
#define SHARED_SMEM (113 * 1024)
// returned when no lane group's window fits in a block's shared memory
#define FS_NO_FIT (-1)

namespace {

struct Offsets {
  int k[MAX_K];
};

template <int K>
__global__ void __launch_bounds__(THREADS) fused_sweep_kernel(
    const float* __restrict__ d, const float* __restrict__ planes,
    float* __restrict__ out, Offsets offs, long long Vp, int T, int B,
    int n_inner, int LG, int lo, int hi) {
  extern __shared__ float sm[];
  const int W = lo + T + hi;
  float* win = sm;                              // [W][LG], centre at row lo
  float* nxt = win + (long long)W * LG;         // [T][LG]
  float* pw = nxt + (long long)T * LG;          // [K][T]
  int off[K > 0 ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) off[k] = offs.k[k];
  const int n_lg = (B + LG - 1) / LG;
  const long long tile = blockIdx.x / n_lg;
  const int lane = (blockIdx.x % n_lg) * LG + threadIdx.x % LG;
  const int l = threadIdx.x % LG;
  const int r0 = threadIdx.x / LG;
  const int rpp = THREADS / LG;
  const bool live = lane < B;
  const long long row0 = (tile + 1) * T - lo;   // padded row of window row 0

  // every copy of the window and the planes in flight before one wait
  for (int r = r0; r < W; r += rpp) {
    if (live)
      __pipeline_memcpy_async(win + r * LG + l, d + (row0 + r) * B + lane,
                              sizeof(float));
    else
      win[r * LG + l] = CUDART_INF_F;
  }
  const float* pl = planes + tile * T;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int r = threadIdx.x; r < T; r += THREADS)
      __pipeline_memcpy_async(pw + k * T + r, pl + k * Vp + r, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int it = 0; it < n_inner; ++it) {
    for (int r = r0; r < T; r += rpp) {
      float best = win[(lo + r) * LG + l];
#pragma unroll
      for (int k = 0; k < K; ++k)
        best = fminf(best, win[(lo + r + off[k]) * LG + l] + pw[k * T + r]);
      nxt[r * LG + l] = best;
    }
    __syncthreads();
    for (int r = r0; r < T; r += rpp) win[(lo + r) * LG + l] = nxt[r * LG + l];
    __syncthreads();
  }
  if (live) {
    float* o = out + (tile + 1) * T * B + lane;
    for (int r = r0; r < T; r += rpp) o[(long long)r * B] = win[(lo + r) * LG + l];
  }
}

template <int K>
int launch(const float* d, const float* planes, float* out, const Offsets& o,
           long long Vp, int T, int B, int n_inner, int LG, int lo, int hi,
           size_t smem, unsigned n_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_sweep_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_sweep_kernel<K><<<n_blocks, THREADS, smem, stream>>>(
      d, planes, out, o, Vp, T, B, n_inner, LG, lo, hi);
  return (int)cudaGetLastError();
}

// Lanes a block owns: the most of 8, 4, 2, 1 (no more than B unless 1) whose
// window of lo + 2T + hi rows, beside the K x T plane weights, fits two
// blocks to an SM, else the most that fits one; 0 when none fits. Sets
// *smem to the block's shared memory.
int lanes_per_block(int lo, int hi, int T, int K, int B, size_t* smem) {
  const size_t budgets[2] = {SHARED_SMEM, MAX_SMEM};
  for (size_t budget : budgets)
    for (int lg = 8; lg >= 1; lg /= 2) {
      if (lg > B && lg > 1) continue;
      const size_t s =
          ((size_t)(lo + 2 * T + hi) * lg + (size_t)K * T) * sizeof(float);
      if (s <= budget) {
        *smem = s;
        return lg;
      }
    }
  return 0;
}

}  // namespace

// offs: K offsets in host memory. Returns cudaGetLastError() after the
// launch, FS_NO_FIT when the window does not fit in a block's shared memory,
// or cudaErrorInvalidValue for another shape the kernel does not take.
extern "C" int fused_sweep_launch(const float* d, const float* planes,
                                  float* out, const int* offs, int K,
                                  long long Vp, int T, int B, int n_inner,
                                  void* stream) {
  if (K < 0 || K > MAX_K || T < 1 || B < 1 || n_inner < 0 || Vp % T != 0)
    return (int)cudaErrorInvalidValue;
  Offsets o = {};
  int lo = 0, hi = 0;
  for (int k = 0; k < K; ++k) {
    if (offs[k] > T || offs[k] < -T) return (int)cudaErrorInvalidValue;
    o.k[k] = offs[k];
    lo = offs[k] < -lo ? -offs[k] : lo;
    hi = offs[k] > hi ? offs[k] : hi;
  }
  size_t smem = 0;
  const int LG = lanes_per_block(lo, hi, T, K, B, &smem);
  if (LG == 0) return FS_NO_FIT;
  const long long n_blocks = (Vp / T) * ((B + LG - 1) / LG);
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)n_blocks;
#define FS_CASE(k)                                                          \
  case k:                                                                   \
    return launch<k>(d, planes, out, o, Vp, T, B, n_inner, LG, lo, hi, smem, \
                     nb, st);
  switch (K) {
    FS_CASE(0) FS_CASE(1) FS_CASE(2) FS_CASE(3) FS_CASE(4) FS_CASE(5)
    FS_CASE(6) FS_CASE(7) FS_CASE(8) FS_CASE(9) FS_CASE(10) FS_CASE(11)
    FS_CASE(12) FS_CASE(13) FS_CASE(14) FS_CASE(15) FS_CASE(16)
  }
#undef FS_CASE
  return (int)cudaErrorInvalidValue;
}
