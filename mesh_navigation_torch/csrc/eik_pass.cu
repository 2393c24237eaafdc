// Banded fast-sweeping eikonal pass (CVP unfolding update) for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_eikonal.py::_eik_pass_kernel
// (:278), launched by _eik_directional_pass (:428).
//
// What it computes. One directional pass over the field d[Rp, Cp, Bp] (f32,
// lanes contiguous) into a new field `out` of the same shape, which the
// caller fills with a copy of d first (a skipped row is then left alone); d
// is only read, so the row after the current one is always the stale value
// of d (the reference's aliasing hazard, pallas_eikonal.py:499-504, cannot
// arise).
// Rows go down (r = 0..Rp-1) or up (reverse). For row r of a block of 32
// lanes:
//   need = prev_imp | dirty_in[j, r-1] | dirty_in[j, r] | dirty_in[j, r+1] | force
//   not needed: out[r] = d[r], dirty_out[j, r] = 0, prev_imp = 0
//   needed: the columns are visited one by one in `cdir` (+1: left to
//     right); column c takes
//       new[c] = min(d[r][c], min over the K classes of unfold(u1, u2, a, b, c))
//     with u1, u2 read from the 3x3 neighbourhood of (r, c): the row before as
//     this pass wrote it (fresh), the own row with the neighbour behind c in
//     cdir fresh (just computed) and the one ahead stale, the row after
//     stale; one +inf halo column on each side and +inf outside the rows.
//     imp = any over the block of new*(1+rtol)+atol < d[r]; out[r] = imp ?
//     new : d[r]; dirty_out[j, r] = imp; prev_imp = imp & any(new < d[r]).
// `changed` is the OR of imp over all rows and blocks. The reference's force
// term asks for a finite value near the row as well; a row with none computes
// to d[r] unchanged, so the plain rule gives the same output.
//
// In-row freshness. The reference updates a row in cw-column chunks, each
// repeated n_inner times as a Jacobi sweep (cw = n_inner = 8 on the CVP scale
// path), because a row-parallel update with a stale own row moves the
// wavefront about one column per pass. Here each lane walks the row's columns
// in order, carrying the fresh value behind it in a register: along cdir a
// wavefront crosses the whole row in one pass, at least as fresh as the
// reference's chunks. The fixed point does not depend on the in-row scheme.
//
// Layout. A CUDA block serves 32 lanes (the reference's block is 128): the
// row skip, `imp` and the dirty table [Bp / 32, Rp] are per 32-lane block.
// Each lane is served by CT = 8 consecutive threads of one warp; thread t of
// a lane evaluates classes t and t + 8, each reading its two supports as
// streams along their rows (two columns ahead of use) or, for the own-row
// neighbour behind, the last new value; three xor-shuffles take the minimum
// over the classes, so every thread of the lane holds the new value. A
// lane's threads load neighbouring addresses of one row; the side lengths
// abc[r, 3k + {0,1,2}, c] are the same for every lane.
//
// What bounds it on this card. The work is K unfolding updates per element
// of a computed row (81 operations each as written here with its minimum,
// 5 divisions and 3 square roots among them): about 1 ms of f32 operations at 1024 x 1024 x
// 128, K = 6; the bytes (one read of the field and of abc, one
// write of what changes) take less. The kernel is bound instead by the
// latency of each lane's column-after-column chain: column c's update waits
// for column c-1's new value, and a warp issues in order, so every
// instruction of one update (IEEE divisions and square roots are long
// sequences) stands on the chain. With Bp / 32 blocks of 8 warps, 4 blocks
// at the CVP path's 128 lanes, 4 of 132 SMs work. A skewed (hyperplane)
// schedule that fills the card is a later redesign.
//
// Rounding. Built with --fmad=false, so no multiply-add is contracted and
// unfold() rounds exactly as the plain PyTorch version's operations do; the
// clamps propagate NaN as torch.clamp does; a minimum is exact in any order.
// Kernel and plain agree bit for bit.
//
// Offsets into the field are 64-bit (Rp*Cp*Bp is 134M at 1024 x 1024 x 128
// and passes 2^31 at wider batches).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define WARP 32
#define CT 8                    // threads per lane, one class each (two if K > 8)
#define KMAX (2 * CT)
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);   // NaN stays NaN, as torch.clamp
}

// CVP unfolding update value (pallas_eikonal.py:55-100), in the operation
// order of ops/eikonal_gpu.py::unfolding_value.
__device__ __forceinline__ float unfold(float u1, float u2, float a, float b, float c) {
  const float INF = CUDART_INF_F;
  const float EPS = 1e-12f;
  const bool valid = c < INF;
  const bool both = isfinite(u1) && isfinite(u2) && valid;
  const float u1s = both ? u1 : 0.f;
  const float u2s = both ? u2 : 0.f;
  a = valid ? a : 1.f;
  b = valid ? b : 1.f;
  c = valid ? c : 1.f;
  const float c_safe = clamp_min(c, EPS);
  const float sx = (c * c + u1s * u1s - u2s * u2s) / (2.f * c_safe);
  const float sy = -sqrtf(clamp_min(u1s * u1s - sx * sx, 0.f));
  const float p = (b * b + c * c - a * a) / (2.f * c_safe);
  const float hc = sqrtf(clamp_min(b * b - p * p, 0.f));
  const float dx = p - sx;
  const float dy = hc - sy;
  const float u3_sq = dx * dx + dy * dy;
  const float u3 = sqrtf(u3_sq);
  const float u3_safe = clamp_min(u3, EPS);
  const float t0a = (a * a + b * b - c * c) / clamp_min(2.f * a * b, EPS);
  const float t1a = (u3_sq + b * b - u1s * u1s) / (2.f * u3_safe * clamp_min(b, EPS));
  const float t2a = (a * a + u3_sq - u2s * u2s) / (2.f * clamp_min(a, EPS) * u3_safe);
  const float fb1 = u1s + b;
  const float fb2 = u2s + a;
  float value;
  if (fabsf(t1a) > 1.f) value = fb1;
  else if (fabsf(t2a) > 1.f) value = fb2;
  else if (t1a > t0a && t2a > t0a) value = u3;
  else value = t1a > t2a ? fb1 : fb2;
  return (both && isfinite(value)) ? value : INF;
}

__device__ __forceinline__ float load_or_inf(const float* row, int c, int Cp, long long Bp) {
  return (row != nullptr && c >= 0 && c < Cp) ? row[(long long)c * Bp] : CUDART_INF_F;
}

// One support of a class along a row: the values of `row` at column c + off
// for the columns c of the walk, loaded two columns ahead of their use.
struct Support {
  const float* row;
  int off;
  float q0, q1;

  __device__ __forceinline__ void start(const float* r, int o, int c0, int cdir, int Cp,
                                        long long Bp) {
    row = r;
    off = o;
    q0 = load_or_inf(r, c0 + o, Cp, Bp);
    q1 = load_or_inf(r, c0 + cdir + o, Cp, Bp);
  }
  // the value at column c; queues the one at c + 2 * cdir
  __device__ __forceinline__ float next(int c, int cdir, int Cp, long long Bp) {
    const float v = q0;
    q0 = q1;
    q1 = load_or_inf(row, c + 2 * cdir + off, Cp, Bp);
    return v;
  }
};

// The class's supports at slots s1, s2 ((dr + 1) * 3 + (dc + 1)) for row r:
// the row before in pass order is this pass's output (fresh), the own row
// and the row after are read from d (stale), except the own-row neighbour
// behind the column in cdir, which is the walk's last new value.
struct Class {
  Support u1, u2;
  bool behind1, behind2;
  const float* t;   // this class's side lengths a, b, c in row r

  __device__ __forceinline__ void start(int s1, int s2, const float* up, const float* cur,
                                        const float* dn, const float* planes, int c0,
                                        int cdir, int Cp, long long Bp) {
    u1.start(s1 < 3 ? up : s1 < 6 ? cur : dn, s1 % 3 - 1, c0, cdir, Cp, Bp);
    u2.start(s2 < 3 ? up : s2 < 6 ? cur : dn, s2 % 3 - 1, c0, cdir, Cp, Bp);
    behind1 = s1 == 4 - cdir;
    behind2 = s2 == 4 - cdir;
    t = planes;
  }
  __device__ __forceinline__ float update(int c, int cdir, int Cp, long long Bp, float prev) {
    float v1 = u1.next(c, cdir, Cp, Bp), v2 = u2.next(c, cdir, Cp, Bp);
    v1 = behind1 ? prev : v1;
    v2 = behind2 ? prev : v2;
    return unfold(v1, v2, t[c], t[Cp + c], t[2 * Cp + c]);
  }
};

__global__ void __launch_bounds__(WARP * CT) eik_pass_kernel(
    const float* __restrict__ d, float* __restrict__ out,
    const float* __restrict__ abc, const int* __restrict__ cls,
    const int* __restrict__ dirty_in, int* __restrict__ dirty_out,
    int* __restrict__ chg, int Rp, int Cp, int Bp, int K, int reverse,
    int cdir, int force, float k_rtol, float atol) {
  const int j = blockIdx.x;
  const int kt = threadIdx.x % CT;            // this thread's class slot
  const long long b = (long long)j * WARP + threadIdx.x / CT;
  const long long row_stride = (long long)Cp * Bp;
  // the thread's classes kt and kt + CT (absent ones are never evaluated)
  const bool has0 = kt < K, has1 = kt + CT < K;
  const int s1a = has0 ? cls[2 * kt] : 4, s2a = has0 ? cls[2 * kt + 1] : 4;
  const int s1b = has1 ? cls[2 * (kt + CT)] : 4, s2b = has1 ? cls[2 * (kt + CT) + 1] : 4;
  const int* din = dirty_in + (long long)j * Rp;
  int prev_imp = 0, changed = 0;
  for (int it = 0; it < Rp; ++it) {
    const int r = reverse ? Rp - 1 - it : it;
    const float* cur = d + r * row_stride + b;
    float* orow = out + r * row_stride + b;
    const int need = prev_imp | force | din[r] | din[r > 0 ? r - 1 : 0] |
                     din[r + 1 < Rp ? r + 1 : Rp - 1];   // the same in the whole block
    if (!need) {   // out[r] already holds d[r]
      if (threadIdx.x == 0) dirty_out[(long long)j * Rp + r] = 0;
      prev_imp = 0;
      continue;
    }
    // the row before in pass order was written by this pass (fresh; the
    // barriers at the end of the row made it visible); the row after is
    // read from d (stale)
    const int rb = reverse ? r + 1 : r - 1;
    const int ra = reverse ? r - 1 : r + 1;
    const float* fresh = (rb >= 0 && rb < Rp) ? out + rb * row_stride + b : nullptr;
    const float* stale = (ra >= 0 && ra < Rp) ? d + ra * row_stride + b : nullptr;
    const float* up = reverse ? stale : fresh;
    const float* dn = reverse ? fresh : stale;
    const float* planes = abc + (long long)r * 3 * K * Cp;
    const int c0 = cdir > 0 ? 0 : Cp - 1;
    Support own;
    own.start(cur, 0, c0, cdir, Cp, Bp);
    Class ka, kb;
    if (has0) ka.start(s1a, s2a, up, cur, dn, planes + 3LL * kt * Cp, c0, cdir, Cp, Bp);
    if (has1) kb.start(s1b, s2b, up, cur, dn, planes + 3LL * (kt + CT) * Cp, c0, cdir, Cp, Bp);
    float prev = CUDART_INF_F;   // the halo column behind the first one
    int imp_l = 0, lt_l = 0;
    for (int t = 0; t < Cp; ++t) {
      const int c = cdir > 0 ? t : Cp - 1 - t;
      const float cv = own.next(c, cdir, Cp, Bp);
      float best = cv;
      if (has0) best = fminf(best, ka.update(c, cdir, Cp, Bp, prev));
      if (has1) best = fminf(best, kb.update(c, cdir, Cp, Bp, prev));
      #pragma unroll
      for (int m = 1; m < CT; m <<= 1) best = fminf(best, __shfl_xor_sync(FULL_MASK, best, m));
      if (kt == 0) orow[(long long)c * Bp] = best;
      imp_l |= __fadd_rn(__fmul_rn(best, k_rtol), atol) < cv;
      lt_l |= best < cv;
      prev = best;
    }
    const int imp = __syncthreads_or(imp_l);
    const int lt = __syncthreads_or(lt_l);
    if (!imp) {   // put the row back: the lane's 8 threads share its columns
      for (int c = kt; c < Cp; c += CT) orow[(long long)c * Bp] = cur[(long long)c * Bp];
      __syncthreads();
    }
    prev_imp = imp & lt;
    if (threadIdx.x == 0) dirty_out[(long long)j * Rp + r] = imp;
    changed |= imp;
  }
  if (threadIdx.x == 0 && changed) atomicOr(chg, 1);
}

}  // namespace

extern "C" int eik_pass_launch(
    const float* d, float* out, const float* abc, const int* cls,
    const int* dirty_in, int* dirty_out, int* chg, int Rp, int Cp, int Bp,
    int K, int reverse, int cdir, int force, float k_rtol, float atol,
    void* stream) {
  if (Rp < 1 || Cp < 1 || Bp < WARP || Bp % WARP != 0 || K < 1 || K > KMAX ||
      (cdir != 1 && cdir != -1) || d == out)
    return (int)cudaErrorInvalidValue;
  eik_pass_kernel<<<Bp / WARP, WARP * CT, 0, (cudaStream_t)stream>>>(
      d, out, abc, cls, dirty_in, dirty_out, chg, Rp, Cp, Bp, K, reverse, cdir,
      force, k_rtol, atol);
  return (int)cudaGetLastError();
}
