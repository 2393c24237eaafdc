// Banded fast-sweeping eikonal pass (CVP unfolding update) for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_eikonal.py::_eik_pass_kernel
// (:278), launched by _eik_directional_pass (:428).
//
// What it computes. One directional pass over the field d[Rp, Cp, Bp] (f32,
// lanes contiguous) into a new field `out` of the same shape, which the
// caller fills with a copy of d first (a strip-row that is not written keeps
// d); d is only read, so the row after the current one is always the stale
// value of d (the reference's aliasing hazard, pallas_eikonal.py:499-504,
// cannot arise). Rows go down (r = 0..Rp-1) or up (reverse); the columns of
// a row are visited in `cdir` (+1: left to right). Column c of row r takes
//   new[c] = min(d[r][c], min over the K classes of unfold(u1, u2, a, b, c))
// with u1, u2 read from the 3x3 neighbourhood of (r, c): the row before in
// pass order as this pass wrote it (fresh), the own row with the neighbour
// behind c in cdir fresh and the one ahead stale, the row after stale; +inf
// outside the field.
//
// Gating by strip-row. The columns, in cdir order, are cut into strips of W
// (the last one shorter where Cp % W != 0). The unit of gating is strip s of
// row r for one block of 32 lanes (j):
//   need = force | dirty_in[j, r-1 .. r+1] | carry
//   carry = g(s-1, rb) | g(s, rb) | g(s+1, rb) | g(s-1, r)   (rb: row before)
//   imp  = any over the strip's columns and the block's lanes of
//          new * (1 + rtol) + atol < d[r];  out = imp ? new : d[r]
//   g    = imp & any(new < d[r]);  dirty_out[j, r] |= imp;  changed |= imp.
// A strip that is not needed computes nothing (g = 0). With W >= Cp the one
// strip is the row, and this is the reference's row rule. The plain PyTorch
// version (ops/eikonal_gpu.py::_eik_pass_plain) runs the same rule in the
// plain order: rows, strips, columns.
//
// Schedule. Strip-row (s, r) reads fresh values only from strips s-1 .. s+1
// of the row before and from strip s-1 of its own row, so it may run once
// (s-1, r) and (s+1, r-1) are done; that implies (s, r-1) and (s-1, r-1). One
// block of 8 warps owns each (s, j) column of strip-rows and walks its rows
// in pass order: a skewed wavefront whose critical path is 2 Rp + S
// strip-rows of W columns, instead of Rp * Cp columns. At 1024 x 1024, W = 8,
// 128 lanes that is 512 blocks on all 132 SMs and 17K dependent column
// steps, against 4 blocks on 4 SMs and 1M steps for the row-serial walk it
// replaces.
//
// No deadlock: a block waits only on blocks of the same launch, and the
// launch is cooperative (cudaLaunchCooperativeKernel refuses a grid whose
// blocks cannot all be resident). Where the (s, j) columns outnumber what
// fits, block (s, y) walks the lane blocks j = y, y + G, ... in turn (G from
// the occupancy query); every block takes them in the same order, so a block
// waits only on items of its own or an earlier lane block. A launch that
// cannot hold even one lane block's S blocks at once is refused.
//
// Progress and visibility. progress[j * S + s] (zeroed by the caller each
// launch) holds (rows done << 2) | g(row before last) << 1 | g(last row).
// When (s, r) reads the word of s-1 it is exactly r's (s-1 cannot pass row r
// before (s, r) is done) and that of s+1 exactly r-1's, so the two words
// carry every g that `carry` needs. The producer stores its strip, every
// thread fences (__threadfence), the block syncs, and thread 0 publishes with
// st.release.gpu; thread 0 of a consumer spins on ld.acquire.gpu, the block
// syncs, and rows of `out` are read through L2 (__ldcg). `d` and abc are
// read-only (__ldg).
//
// Per step. Each lane is served by CT = 8 consecutive threads of one warp;
// thread t of a lane evaluates classes t and t + 8, and three xor-shuffles
// take the minimum over the classes (the IEEE divisions and square roots
// branch, so classes in one thread would run one after another). For each
// tile of up to TILE columns the block stages the 3 rows x (tile + 2)
// columns of its lanes' neighbourhood in shared memory (the own row is
// updated in place as the walk goes, as the plain version's buffer is) and,
// once for all 32 lanes, the terms of unfold() that depend on the side
// lengths only (p, hc, t0a and the masked sides, by the same operations as
// unfold(), so nothing rounds otherwise). What comes from d (the own row, the
// row after, the side terms) is staged before the wait where the dirty table
// already asks for the strip-row, so its loads overlap the wait. A strip
// longer than a tile writes its earlier tiles through and puts d back where
// it does not improve.
//
// What bounds it on this card. The work is K unfolding updates per element
// of a computed strip-row, about 1 ms of f32 operations at 1024 x 1024 x 128,
// K = 6. The kernel is bound by the critical path: 2 Rp + S handoffs between
// SMs (a fence, a release and an acquire through L2) and, for each, W columns
// of one unfolding update whose IEEE divisions and square roots stand on the
// chain, and the class minimum.
//
// Rounding. Built with --fmad=false, so no multiply-add is contracted and
// unfold() rounds exactly as the plain PyTorch version's operations do; the
// clamps propagate NaN as torch.clamp does; a minimum is exact in any order.
// Kernel and plain agree bit for bit.
//
// Offsets into the field are 64-bit (Rp*Cp*Bp is 134M at 1024 x 1024 x 128
// and passes 2^31 at wider batches).

#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define WARP 32
#define TILE 16                 // columns staged in shared memory at a time
#define KMAX 10
#define NBW (TILE + 2)          // staged columns: the tile and one on each side
#define LS (WARP + 1)           // shared stride of a staged column: 32 lanes + 1
#define CT 8                    // threads per lane, one class each (two if K > 8)
#define THREADS (WARP * CT)     // a block: the 32 lanes of one lane block
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);   // NaN stays NaN, as torch.clamp
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// spin until the strip whose progress word is *p has done `rows` rows, and
// return the word. A wait past WAIT_LIMIT_CYCLES (~20 s at 1.98 GHz) can
// only be a broken schedule: fail a device-side assertion (its message names
// this wait), so that the launch fails instead of holding the card. The
// limit counts the SM's own cycles: %globaltimer follows the host's wall
// clock, so a step of that clock would fail a healthy wait.
#define WAIT_LIMIT_CYCLES 40000000000LL
__device__ __forceinline__ unsigned wait_rows(const unsigned* p, int rows) {
  unsigned v = ld_acquire(p);
  if ((int)(v >> 2) >= rows) return v;
  const long long t0 = clock64();
  while ((int)((v = ld_acquire(p)) >> 2) < rows) {
    assert(clock64() - t0 <= WAIT_LIMIT_CYCLES && "eik_pass: a strip waited past ~20 s");
  }
  return v;
}

// The terms of unfold() (pallas_eikonal.py:55-100, in the operation order of
// ops/eikonal_gpu.py::unfolding_value) that depend on the side lengths only:
// q0 = (valid, c*c, 2 c_safe, p), q1 = (hc, t0a, b*b, max(b, eps)),
// q2 = (a*a, 2 max(a, eps), a, b), with absent entries' sides set to 1.
__device__ __forceinline__ void side_terms(float a, float b, float c, float4& q0, float4& q1,
                                           float4& q2) {
  const float INF = CUDART_INF_F;
  const float EPS = 1e-12f;
  const bool valid = c < INF;
  a = valid ? a : 1.f;
  b = valid ? b : 1.f;
  c = valid ? c : 1.f;
  const float c_safe = clamp_min(c, EPS);
  const float p = (b * b + c * c - a * a) / (2.f * c_safe);
  const float hc = sqrtf(clamp_min(b * b - p * p, 0.f));
  const float t0a = (a * a + b * b - c * c) / clamp_min(2.f * a * b, EPS);
  q0 = make_float4(valid ? 1.f : 0.f, c * c, 2.f * c_safe, p);
  q1 = make_float4(hc, t0a, b * b, clamp_min(b, EPS));
  q2 = make_float4(a * a, 2.f * clamp_min(a, EPS), a, b);
}

// CVP unfolding update value from the supports and the side terms; the rest
// of unfold() in the same operation order.
__device__ __forceinline__ float unfold(float u1, float u2, const float4 q0, const float4 q1,
                                        const float4 q2) {
  const float INF = CUDART_INF_F;
  const float EPS = 1e-12f;
  const bool both = isfinite(u1) && isfinite(u2) && q0.x != 0.f;
  const float u1s = both ? u1 : 0.f;
  const float u2s = both ? u2 : 0.f;
  const float u1q = u1s * u1s, u2q = u2s * u2s;
  const float sx = (q0.y + u1q - u2q) / q0.z;
  const float sy = -sqrtf(clamp_min(u1q - sx * sx, 0.f));
  const float dx = q0.w - sx;
  const float dy = q1.x - sy;
  const float u3_sq = dx * dx + dy * dy;
  const float u3 = sqrtf(u3_sq);
  const float u3_safe = clamp_min(u3, EPS);
  const float t1a = (u3_sq + q1.z - u1q) / (2.f * u3_safe * q1.w);
  const float t2a = (q2.x + u3_sq - u2q) / (q2.y * u3_safe);
  const float fb1 = u1s + q2.w;
  const float fb2 = u2s + q2.z;
  float value;
  if (fabsf(t1a) > 1.f) value = fb1;
  else if (fabsf(t2a) > 1.f) value = fb2;
  else if (t1a > q1.y && t2a > q1.y) value = u3;
  else value = t1a > t2a ? fb1 : fb2;
  return (both && isfinite(value)) ? value : INF;
}

template <int K>
__global__ void __launch_bounds__(THREADS, 4) eik_pass_kernel(
    const float* __restrict__ d, float* out, const float* __restrict__ abc,
    const int* __restrict__ cls, const int* __restrict__ dirty_in, int* dirty_out, int* chg,
    unsigned* progress, int* sm_ids, int Rp, int Cp, int Bp, int reverse, int cdir, int force,
    int W, float k_rtol, float atol) {
  // rows r-1, r, r+1 (actual order) x NBW walk positions x 32 lanes (stride
  // LS); walk position q holds column c_first + cdir * (t0 + q - 1) of the
  // tile at t0
  __shared__ float nb[3 * NBW * LS];
  __shared__ float4 terms[TILE * K * 3];
  __shared__ float behind[WARP];   // each lane's last new value, behind the next tile
  __shared__ unsigned words[2];    // the progress words of strips s-1 and s+1
  const float INF = CUDART_INF_F;
  const int tid = threadIdx.x;
  const int l = tid / CT, kt = tid % CT;       // the walk: lane, class slot
  const int sl = tid % WARP, sq = tid / WARP;  // staging and writes: lane, position group
  const int s = blockIdx.x, S = gridDim.x;
  const int nj = Bp / WARP;
  const long long row_stride = (long long)Cp * Bp;
  if (sm_ids != nullptr && tid == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    sm_ids[blockIdx.y * S + s] = (int)id;
  }
  // this thread's classes kt and kt + CT: their supports as offsets into nb
  // at walk position 0 (absent classes are never evaluated)
  const bool has0 = kt < K, has1 = kt + CT < K;
  int o1a = 0, o2a = 0, o1b = 0, o2b = 0;
  {
    auto off = [&](int slot) { return ((slot / 3) * NBW + 1 + cdir * (slot % 3 - 1)) * LS + l; };
    if (has0) o1a = off(cls[2 * kt]), o2a = off(cls[2 * kt + 1]);
    if (has1) o1b = off(cls[2 * (kt + CT)]), o2b = off(cls[2 * (kt + CT) + 1]);
  }
  const int c_first = cdir > 0 ? s * W : Cp - 1 - s * W;
  const int n_cols = min(W, Cp - s * W);
  const int fresh_slot = reverse ? 2 : 0, stale_slot = reverse ? 0 : 2;
  float* own_nb = nb + NBW * LS;
  int changed = 0;
  for (int j = blockIdx.y; j < nj; j += gridDim.y) {
    const long long lane_off = (long long)j * WARP + sl;
    unsigned* prog = progress + (long long)j * S;
    const int* din = dirty_in + (long long)j * Rp;
    int g_prev = 0;   // g of this strip in the row before
    for (int it = 0; it < Rp; ++it) {
      const int r = reverse ? Rp - 1 - it : it;
      const int rb = reverse ? r + 1 : r - 1;
      const int ra = reverse ? r - 1 : r + 1;
      const float* fresh = (rb >= 0 && rb < Rp) ? out + rb * row_stride + lane_off : nullptr;
      const float* stale = (ra >= 0 && ra < Rp) ? d + ra * row_stride + lane_off : nullptr;
      const float* own_d = d + r * row_stride + lane_off;
      float* own_o = out + r * row_stride + lane_off;
      const float* planes = abc + (long long)r * 3 * K * Cp;
      // the parts of a tile that do not depend on this pass's other strips:
      // the own row and the row after from d, and the side terms
      auto stage_d = [&](int t0, int n) {
        for (int q = sq; q < n + 2; q += CT) {
          const int c = c_first + cdir * (t0 + q - 1);
          const bool in = c >= 0 && c < Cp;
          const long long co = (long long)c * Bp;
          nb[(stale_slot * NBW + q) * LS + sl] = (in && stale != nullptr) ? __ldg(stale + co) : INF;
          if (q > 0) own_nb[q * LS + sl] = in ? __ldg(own_d + co) : INF;
        }
        for (int i = tid; i < n * K; i += THREADS) {
          const int t = i / K, k = i % K;
          const long long pc = 3LL * k * Cp + c_first + cdir * (t0 + t);
          side_terms(__ldg(planes + pc), __ldg(planes + pc + Cp), __ldg(planes + pc + 2 * Cp),
                     terms[3 * i], terms[3 * i + 1], terms[3 * i + 2]);
        }
      };
      // the parts this pass writes: the row before, the own-row value behind
      auto stage_fresh = [&](int t0, int n) {
        for (int q = sq; q < n + 2; q += CT) {
          const int c = c_first + cdir * (t0 + q - 1);
          const bool in = c >= 0 && c < Cp;
          const long long co = (long long)c * Bp;
          nb[(fresh_slot * NBW + q) * LS + sl] = (in && fresh != nullptr) ? __ldcg(fresh + co) : INF;
          if (q == 0) own_nb[sl] = !in ? INF : t0 == 0 ? __ldcg(own_o + co) : behind[sl];
        }
      };
      const int near = force | din[r] | din[r > 0 ? r - 1 : 0] | din[r + 1 < Rp ? r + 1 : Rp - 1];
      if (near) stage_d(0, min(TILE, n_cols));   // overlaps the wait
      if (tid == 0) {
        words[0] = s > 0 ? wait_rows(prog + s - 1, it + 1) : 0u;
        words[1] = (s + 1 < S && it > 0) ? wait_rows(prog + s + 1, it) : 0u;
      }
      __syncthreads();
      const unsigned wl = words[0], wr = words[1];
      const int need = near | (wl & 1) | ((wl >> 1) & 1) | (wr & 1) | g_prev;
      int imp = 0, g = 0;
      if (need) {
        int imp_l = 0, lt_l = 0, t0 = 0, n = min(TILE, n_cols);
        if (!near) stage_d(0, n);
        for (;;) {
          stage_fresh(t0, n);
          __syncthreads();
          float best = 0.f;
          for (int t = 0; t < n; ++t) {
            const float cv = own_nb[(t + 1) * LS + l];
            best = cv;
            if (has0) {
              const float4* q = terms + 3 * (t * K + kt);
              best = fminf(best, unfold(nb[o1a + t * LS], nb[o2a + t * LS], q[0], q[1], q[2]));
            }
            if (has1) {
              const float4* q = terms + 3 * (t * K + kt + CT);
              best = fminf(best, unfold(nb[o1b + t * LS], nb[o2b + t * LS], q[0], q[1], q[2]));
            }
#pragma unroll
            for (int m = 1; m < CT; m <<= 1) best = fminf(best, __shfl_xor_sync(FULL_MASK, best, m));
            if (kt == 0) own_nb[(t + 1) * LS + l] = best;   // the lane's own row, in place
            __syncwarp();
            imp_l |= __fadd_rn(__fmul_rn(best, k_rtol), atol) < cv;
            lt_l |= best < cv;
          }
          if (t0 + n >= n_cols) break;
          if (kt == 0) behind[l] = best;
          __syncthreads();
          for (int q = sq; q < n; q += CT)   // an earlier tile of a long strip: write through
            own_o[(long long)(c_first + cdir * (t0 + q)) * Bp] = own_nb[(q + 1) * LS + sl];
          __syncthreads();
          t0 += TILE;
          n = min(TILE, n_cols - t0);
          stage_d(t0, n);
        }
        imp = __syncthreads_or(imp_l);
        g = imp & __syncthreads_or(lt_l);
        if (imp) {
          for (int q = sq; q < n; q += CT)
            own_o[(long long)(c_first + cdir * (t0 + q)) * Bp] = own_nb[(q + 1) * LS + sl];
        } else {
          for (int q = sq; q < t0; q += CT) {   // put the written tiles back
            const long long co = (long long)(c_first + cdir * q) * Bp;
            own_o[co] = __ldg(own_d + co);
          }
        }
        __threadfence();
      }
      __syncthreads();   // the strip-row is stored (and fenced) by every thread
      if (tid == 0) {
        if (imp) atomicOr(dirty_out + (long long)j * Rp + r, 1);
        st_release(prog + s, ((unsigned)(it + 1) << 2) | ((unsigned)g_prev << 1) | (unsigned)g);
      }
      g_prev = g;
      changed |= imp;
    }
  }
  if (tid == 0 && changed) atomicOr(chg, 1);
}

// strips, lane-block groups, resident blocks an SM and SMs for one launch
template <int K>
cudaError_t grid_for(int Cp, int Bp, int W, int* S, int* G, int* per_sm, int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, eik_pass_kernel<K>, THREADS, 0);
  if (err != cudaSuccess) return err;
  *S = (Cp + W - 1) / W;
  const long long cap = (long long)*per_sm * *n_sm;
  const long long g = cap / *S;
  *G = (int)(g < Bp / WARP ? g : Bp / WARP);
  return *G < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <int K>
cudaError_t launch(const float* d, float* out, const float* abc, const int* cls,
                   const int* dirty_in, int* dirty_out, int* chg, unsigned* progress,
                   int* sm_ids, int Rp, int Cp, int Bp, int reverse, int cdir, int force, int W,
                   float k_rtol, float atol, cudaStream_t stream) {
  int S, G, per_sm, n_sm;
  cudaError_t err = grid_for<K>(Cp, Bp, W, &S, &G, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  void* args[] = {&d, &out, &abc, &cls, &dirty_in, &dirty_out, &chg, &progress, &sm_ids,
                  &Rp, &Cp, &Bp, &reverse, &cdir, &force, &W, &k_rtol, &atol};
  return cudaLaunchCooperativeKernel((const void*)eik_pass_kernel<K>, dim3(S, G), dim3(THREADS),
                                     args, 0, stream);
}

}  // namespace

#define EIK_DISPATCH(K, CALL) \
  switch (K) {                \
    case 1: CALL(1);          \
    case 2: CALL(2);          \
    case 3: CALL(3);          \
    case 4: CALL(4);          \
    case 5: CALL(5);          \
    case 6: CALL(6);          \
    case 7: CALL(7);          \
    case 8: CALL(8);          \
    case 9: CALL(9);          \
    case 10: CALL(10);        \
  }

// info[0..3] = strips S, lane-block groups G (the grid is S x G one-warp
// blocks), resident blocks an SM, SMs of the card
extern "C" int eik_pass_grid(int Cp, int Bp, int K, int W, int* info) {
  if (Cp < 1 || Bp < WARP || Bp % WARP != 0 || K < 1 || K > KMAX || W < 1)
    return (int)cudaErrorInvalidValue;
#define EIK_GRID(KK) return (int)grid_for<KK>(Cp, Bp, W, info, info + 1, info + 2, info + 3)
  EIK_DISPATCH(K, EIK_GRID)
#undef EIK_GRID
  return (int)cudaErrorInvalidValue;
}

extern "C" int eik_pass_launch(
    const float* d, float* out, const float* abc, const int* cls, const int* dirty_in,
    int* dirty_out, int* chg, unsigned* progress, int* sm_ids, int Rp, int Cp, int Bp, int K,
    int reverse, int cdir, int force, int W, float k_rtol, float atol, void* stream) {
  if (Rp < 1 || Cp < 1 || Bp < WARP || Bp % WARP != 0 || K < 1 || K > KMAX || W < 1 ||
      (cdir != 1 && cdir != -1) || d == out)
    return (int)cudaErrorInvalidValue;
#define EIK_LAUNCH(KK)                                                                        \
  return (int)launch<KK>(d, out, abc, cls, dirty_in, dirty_out, chg, progress, sm_ids, Rp, Cp, \
                         Bp, reverse, cdir, force, W, k_rtol, atol, (cudaStream_t)stream)
  EIK_DISPATCH(K, EIK_LAUNCH)
#undef EIK_LAUNCH
  return (int)cudaErrorInvalidValue;
}
