// Banded Gauss-Seidel directional pass for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_banded.py::_pass_kernel (:827),
// launched by _directional_pass_pallas (:1061), in the configuration of the
// main path: full scan depth, no residual edges, skip=True, use_dirty=False,
// `force` on the first down pass of a solve.
//
// What it computes. One pass over every row of the field d[Rp, Cp, Bp] (f32,
// lanes contiguous), down (r = 0..Rp-1) or up (reverse). For each row:
//   cand = min over s in {-1,0,+1} of prev[c+s] + cross[r, s+1, c]
//   row0 = min(cur, cand)
//   imp  = any over the block's lanes of cand*(1+rtol)+atol < cur
//   need = imp | (force & any(row0 < inf))
//   need: row = lateral min-plus closure of row0 (forward, then backward)
//   else: row = cur (left in place)
// and the row as written is the carry `prev` of the next row. `changed` is
// the OR of `imp` over all rows and blocks.
//
// What bounds it on this card. The field is read once and the improved rows
// written once per pass: at the main path's 1024 x 1024 x 1024 f32 field that
// is 4.3 GB each way, about 2.6 ms at 3.35 TB/s. The arithmetic (a few adds
// and mins per element plus the scan) is far below the f32 rate, so the pass
// is bound by bytes, and in this first version by the latency of the
// row-after-row dependency inside each block.
//
// What the design does about it.
// - Row order: CUDA blocks run in no order, so one block owns one batch block
//   of LANES lanes and walks all rows itself, keeping the carried row in
//   shared memory (Cp*LANES floats, 32 KB at Cp=1024). Nothing crosses blocks
//   except the changed flag (atomicOr into one int).
// - Occupancy: the batch is the only parallel axis. Narrow blocks of 8 lanes
//   give Bp/8 = 128 blocks at Bp=1024 for the 132 SMs; a row's Cp columns
//   are spread one per thread (Cp <= 1024), each thread holding its column's
//   8 lanes (32 contiguous bytes, two float4 loads).
// - The lateral scan is a block-wide min-plus scan of (weight, value) pairs:
//   element c carries f_c(x) = min(b_c, x + a_c), a_c the +-1 lateral chain
//   weight (level 0 of the plan's a_fwd / a_bwd stacks). Warp shuffles scan
//   within a warp, one warp scans the warp totals, and a last step folds the
//   prefix back: two barriers per direction instead of one per Hillis-Steele
//   level. The fixed point does not depend on the in-row scheme
//   (pallas_banded.py:18-22); sums are taken in another order than the
//   chain tables, so the port and JAX agree within the stopping tolerance,
//   not bit for bit.
// - The next row's values are loaded before the current row is processed,
//   so the load latency overlaps the scan.
// - Offsets into the field are 64-bit (Rp*Cp*Bp exceeds 2^31 at 1M x 1024).
// - The flag arithmetic uses __fmul_rn/__fadd_rn so no multiply-add is fused
//   and `imp` matches the plain PyTorch version on equal inputs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LANES 8
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ void load8(const float* p, float (&v)[LANES]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[LANES]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Inclusive min-plus scan of (a, b[LANES]) pairs along the columns of a
// block: fwd takes prefixes from the left (column 0 first), !fwd suffixes
// from the right. Combining an earlier pair (ao, bo) into (a, b) gives
// (ao + a, min(b, bo + a)); the identity is (0, +inf). On return b holds the
// closure value of this column. wt_a/wt_b hold the warp totals.
__device__ __forceinline__ void block_scan(
    float (&b)[LANES], float a, bool fwd, float* wt_a, float* wt_b,
    int lane_id, int warp, int nwarps) {
  #pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ao = fwd ? __shfl_up_sync(FULL_MASK, a, off)
                         : __shfl_down_sync(FULL_MASK, a, off);
    float bo[LANES];
    #pragma unroll
    for (int l = 0; l < LANES; ++l)
      bo[l] = fwd ? __shfl_up_sync(FULL_MASK, b[l], off)
                  : __shfl_down_sync(FULL_MASK, b[l], off);
    const bool ok = fwd ? (lane_id >= off) : (lane_id + off < 32);
    if (ok) {
      #pragma unroll
      for (int l = 0; l < LANES; ++l) b[l] = fminf(b[l], bo[l] + a);
      a = ao + a;
    }
  }
  if (lane_id == (fwd ? 31 : 0)) {
    wt_a[warp] = a;
    #pragma unroll
    for (int l = 0; l < LANES; ++l) wt_b[warp * LANES + l] = b[l];
  }
  __syncthreads();
  if (warp == 0) {
    float ta = 0.f;
    float tb[LANES];
    #pragma unroll
    for (int l = 0; l < LANES; ++l) tb[l] = CUDART_INF_F;
    if (lane_id < nwarps) {
      ta = wt_a[lane_id];
      #pragma unroll
      for (int l = 0; l < LANES; ++l) tb[l] = wt_b[lane_id * LANES + l];
    }
    #pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ao = fwd ? __shfl_up_sync(FULL_MASK, ta, off)
                           : __shfl_down_sync(FULL_MASK, ta, off);
      float bo[LANES];
      #pragma unroll
      for (int l = 0; l < LANES; ++l)
        bo[l] = fwd ? __shfl_up_sync(FULL_MASK, tb[l], off)
                    : __shfl_down_sync(FULL_MASK, tb[l], off);
      const bool ok = fwd ? (lane_id >= off) : (lane_id + off < 32);
      if (ok) {
        #pragma unroll
        for (int l = 0; l < LANES; ++l) tb[l] = fminf(tb[l], bo[l] + ta);
        ta = ao + ta;
      }
    }
    if (lane_id < nwarps) {
      #pragma unroll
      for (int l = 0; l < LANES; ++l) wt_b[lane_id * LANES + l] = tb[l];
    }
  }
  __syncthreads();
  const int src = fwd ? warp - 1 : warp + 1;
  if (src >= 0 && src < nwarps) {
    #pragma unroll
    for (int l = 0; l < LANES; ++l)
      b[l] = fminf(b[l], wt_b[src * LANES + l] + a);
  }
}

__global__ void __launch_bounds__(1024) banded_pass_kernel(
    float* __restrict__ d, const float* __restrict__ cross,
    const float* __restrict__ af, long long af_rs,
    const float* __restrict__ ab, long long ab_rs,
    int* __restrict__ chg, int Rp, int Cp, int Bp, int reverse, int force,
    float k_rtol, float atol) {
  extern __shared__ float smem[];
  float* prev = smem;                          // [Cp][LANES] carried row
  float* wt_b_f = prev + (size_t)Cp * LANES;   // [32][LANES] warp totals
  float* wt_b_b = wt_b_f + 32 * LANES;
  float* wt_a_f = wt_b_b + 32 * LANES;         // [32]
  float* wt_a_b = wt_a_f + 32;

  const int c = threadIdx.x;
  const bool col_ok = c < Cp;
  const int lane_id = c & 31;
  const int warp = c >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * LANES;
  const long long row_stride = (long long)Cp * Bp;
  const long long col_off = (long long)c * Bp + b0;

  for (int i = threadIdx.x; i < Cp * LANES; i += blockDim.x) prev[i] = CUDART_INF_F;
  __syncthreads();

  const int step = reverse ? -1 : 1;
  int r = reverse ? Rp - 1 : 0;
  float nxt[LANES];   // thread-padding columns stay +inf (scan identity)
  #pragma unroll
  for (int l = 0; l < LANES; ++l) nxt[l] = CUDART_INF_F;
  if (col_ok) load8(d + r * row_stride + col_off, nxt);
  int changed = 0;

  for (int it = 0; it < Rp; ++it, r += step) {
    float cur[LANES];
    #pragma unroll
    for (int l = 0; l < LANES; ++l) cur[l] = nxt[l];
    if (col_ok && it + 1 < Rp) load8(d + (r + step) * row_stride + col_off, nxt);

    float x0 = CUDART_INF_F, x1 = CUDART_INF_F, x2 = CUDART_INF_F;
    float a_f = 0.f, a_b = 0.f;   // scan identity for thread-padding columns
    if (col_ok) {
      const float* cr = cross + (long long)r * 3 * Cp + c;
      x0 = cr[0];
      x1 = cr[Cp];
      x2 = cr[2 * Cp];
      a_f = af[(long long)r * af_rs + c];
      a_b = ab[(long long)r * ab_rs + c];
    }
    float row[LANES];
    int imp = 0, fin = 0;
    #pragma unroll
    for (int l = 0; l < LANES; ++l) {
      float cand = CUDART_INF_F;
      if (col_ok) {
        const float pl = c > 0 ? prev[(c - 1) * LANES + l] : CUDART_INF_F;
        const float pc = prev[c * LANES + l];
        const float pr = c + 1 < Cp ? prev[(c + 1) * LANES + l] : CUDART_INF_F;
        cand = fminf(fminf(pl + x0, pc + x1), pr + x2);
      }
      row[l] = fminf(cur[l], cand);
      imp |= __fadd_rn(__fmul_rn(cand, k_rtol), atol) < cur[l];
      fin |= row[l] < CUDART_INF_F;
    }
    // block-wide any; also the barrier after which `prev` may be rewritten
    const int any_imp = __syncthreads_or(imp);
    int need = any_imp;
    if (force) need |= __syncthreads_or(fin);
    changed |= any_imp;
    if (need) {
      block_scan(row, a_f, true, wt_a_f, wt_b_f, lane_id, warp, nwarps);
      block_scan(row, a_b, false, wt_a_b, wt_b_b, lane_id, warp, nwarps);
      if (col_ok) {
        store8(d + r * row_stride + col_off, row);
        #pragma unroll
        for (int l = 0; l < LANES; ++l) prev[c * LANES + l] = row[l];
      }
    } else if (col_ok) {
      #pragma unroll
      for (int l = 0; l < LANES; ++l) prev[c * LANES + l] = cur[l];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && changed) atomicOr(chg, 1);
}

}  // namespace

extern "C" int banded_pass_launch(
    float* d, const float* cross, const float* af, long long af_rs,
    const float* ab, long long ab_rs, int* chg, int Rp, int Cp, int Bp,
    int reverse, int force, float k_rtol, float atol, void* stream) {
  if (Cp < 1 || Cp > 1024 || Bp % LANES != 0 || Rp < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = (Cp + 31) / 32 * 32;
  const size_t smem =
      ((size_t)Cp * LANES + 2 * 32 * LANES + 2 * 32) * sizeof(float);
  banded_pass_kernel<<<Bp / LANES, threads, smem, (cudaStream_t)stream>>>(
      d, cross, af, af_rs, ab, ab_rs, chg, Rp, Cp, Bp, reverse, force,
      k_rtol, atol);
  return (int)cudaGetLastError();
}
