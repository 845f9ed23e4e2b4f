// Baumberg affine-shape adaptation, the whole iteration in one launch,
// for NVIDIA Hopper (sm_90a).
//
// Replaces, on the card, the loop of
// mods_tpu_torch/detectors/baumberg.py::smm_loop_plain (reference
// mods_tpu/detectors/baumberg.py:130-187): per iteration the TPU path
// launches its window sampler (mods_tpu/ops/sampler.py::_make_sample_kernel)
// on windows prefetched once, then the second-moment matrix, its inverse
// square root and the convergence logic as separate array operations.
// Only the shape matrix changes between iterations, never the window.
//
// Design: one block per keypoint.  The block computes its window origin
// (sampling::window_origin), stages the (96, 128) window of its level
// plane into shared memory ONCE with 16-byte cp.async row copies (left
// edge aligned down to 16 bytes, so 132 columns: 50,688 bytes of dynamic
// shared memory), and then iterates entirely on the SM: sample the P x P
// patch from shared memory (the sampler's rule, csrc/sampling.cuh);
// one-sided/central patch gradient; the three masked sums by a block
// reduction (warp shuffles, then the warps' partial sums in warp order);
// every thread then does the same 2x2 arithmetic on the same sums, which
// saves a broadcast and a barrier.  `done` is absorbing in the plain
// version, so the block stops at the iteration its keypoint fails or
// converges; a keypoint that enters invalid exits before staging.
// Nothing but u, conv and the iteration count goes back to device memory.
//
// The whole window is staged, not the smaller box that the reach bound
// of _prepare_smm_windows would allow: taps are clamped into the window
// exactly as in the plain version whatever norm the shape matrix takes,
// and with one block per keypoint and some hundreds of keypoints a launch
// shared memory does not limit how many blocks run at once.
//
// Numbers: this source must be compiled with -fmad=false (csrc/__init__.py
// does), with nvcc's default IEEE division and square root.  The 2x2
// arithmetic below copies the plain version's expressions, operation by
// operation, with its NaN and where() semantics.  What differs is the
// order of the three sums.
//
// Bound on this card: see PERF.md; the work depends on the data (the
// iterations each keypoint runs), which the kernel reports.

#include <math.h>

#include "sampling.cuh"

namespace {

constexpr int WIN_ROWS = 96;
constexpr int WIN_COLS = 128;
constexpr int STAGE_COLS = WIN_COLS + 4;  // left edge aligned to 16 bytes
constexpr int THREADS = 384;              // 12 warps: 361 samples at P = 19
constexpr int WARPS = THREADS / 32;

// max/min that hand a NaN on, as torch.maximum / torch.minimum do
__device__ __forceinline__ float nan_max(float x, float z) {
  return (x != x || z != z) ? NAN : fmaxf(x, z);
}
__device__ __forceinline__ float nan_min(float x, float z) {
  return (x != x || z != z) ? NAN : fminf(x, z);
}

// Closed-form inverse square root of [[a, b], [b, c]], normalised to unit
// determinant (baumberg.py::inv_sqrt_2x2).
__device__ __forceinline__ void inv_sqrt_2x2(float a, float b, float c,
                                             float& na, float& nb, float& nc,
                                             float& l1, float& l2) {
  const bool nz = b != 0.0f;
  const float r = nz ? (c - a) / (2.0f * (nz ? b : 1.0f)) : 1.0f;
  const float t =
      nz ? (r >= 0.0f ? 1.0f / (r + sqrtf(1.0f + r * r))
                      : -1.0f / (-r + sqrtf(1.0f + r * r)))
         : 0.0f;
  const float cs = nz ? 1.0f / sqrtf(1.0f + t * t) : 1.0f;
  const float sn = t * cs;
  float x = 1.0f / sqrtf(cs * cs * a - 2.0f * cs * sn * b + sn * sn * c);
  float z = 1.0f / sqrtf(sn * sn * a + 2.0f * cs * sn * b + cs * cs * c);
  const float d = sqrtf(x * z);
  x = x / d;
  z = z / d;
  l1 = nan_max(x, z);
  l2 = nan_min(x, z);
  na = cs * cs * x + sn * sn * z;
  nb = -cs * sn * x + sn * cs * z;
  nc = sn * sn * x + cs * cs * z;
}

template <int PT>
__global__ void __launch_bounds__(THREADS) baumberg_smm_kernel(
    const float* __restrict__ big,       // (planes, hc, wc) level stack
    int planes, int hc, int wc,
    const int* __restrict__ lvl,         // (K,) plane per keypoint
    const float* __restrict__ xy,        // (K, 2) centres in that plane
    const float* __restrict__ inv_scale, // (K,) 0.5 on decimated planes
    const float* __restrict__ ratio,     // (K,) scale / initial sigma
    const unsigned char* __restrict__ valid,  // (K,) bool
    const float* __restrict__ mask,      // (P, P) Gaussian window
    int p_runtime, int max_iterations, float threshold,
    float* __restrict__ u_out,           // (K, 2, 2)
    unsigned char* __restrict__ conv_out,  // (K,) bool
    int* __restrict__ iters_out) {       // (K,) iterations run
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.x;
  const int P = PT ? PT : p_runtime;
  const int N = P * P;
  const int half = P / 2;
  const float npix = (float)N;
  float* win = smem;                              // (96, 132)
  float* patch = win + WIN_ROWS * STAGE_COLS;     // (P, P)
  float* part = patch + N;                        // (3, WARPS)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float u00 = 1.0f, u01 = 0.0f, u10 = 0.0f, u11 = 1.0f;
  bool conv = false;
  int it = 0;
  if (valid[k]) {
    sampling::PatchGeom g;
    g.cx = xy[2 * k];
    g.cy = xy[2 * k + 1];
    g.rows = WIN_ROWS;
    g.cols = WIN_COLS;
    const int y0 = sampling::window_origin(g.cy, WIN_ROWS, hc);
    const int x0 = sampling::window_origin(g.cx, WIN_COLS, wc);
    g.oy = (float)y0;
    g.ox = (float)x0;
    g.vhm1 = __fsub_rn((float)hc, 1.0f);
    g.vwm1 = __fsub_rn((float)wc, 1.0f);
    const int plane = min(max(lvl[k], 0), planes - 1);
    // shared column 0 is canvas column xa (a multiple of 4); the copy
    // stops at the canvas' right edge, which the taps never pass
    const int xa = x0 & ~3;
    const int sx = x0 - xa;
    const int ncols = min(STAGE_COLS, wc - xa);
    sampling::stage_box_async(
        win, STAGE_COLS, big + ((size_t)plane * hc + y0) * wc + xa, wc,
        WIN_ROWS, ncols);
    const float rt = ratio[k];
    const float is = inv_scale[k];
    float act = 0.0f;
    sampling::stage_wait();

    bool done = false;
    while (it < max_iterations && !done) {
      ++it;
      // A = (u * ratio) * inv_scale
      g.a00 = __fmul_rn(__fmul_rn(u00, rt), is);
      g.a01 = __fmul_rn(__fmul_rn(u01, rt), is);
      g.a10 = __fmul_rn(__fmul_rn(u10, rt), is);
      g.a11 = __fmul_rn(__fmul_rn(u11, rt), is);
      for (int n = threadIdx.x; n < N; n += THREADS) {
        const int j = n / P;
        const int i = n - j * P;
        const sampling::Tap t = sampling::patch_tap(g, i, j, half);
        const float* r0 = win + t.yi * STAGE_COLS + t.xi + sx;
        const float val = sampling::bilinear(
            r0[0], r0[1], r0[STAGE_COLS], r0[STAGE_COLS + 1], t.wx, t.wy);
        patch[n] = t.ok ? val : 0.0f;
      }
      __syncthreads();
      // second-moment sums of the masked patch gradient
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
      for (int n = threadIdx.x; n < N; n += THREADS) {
        const int j = n / P;
        const int i = n - j * P;
        const int il = i > 0 ? i - 1 : 0, ir = i < P - 1 ? i + 1 : P - 1;
        const int ju = j > 0 ? j - 1 : 0, jd = j < P - 1 ? j + 1 : P - 1;
        const float fx = patch[j * P + ir] - patch[j * P + il];
        const float fy = patch[jd * P + i] - patch[ju * P + i];
        const float m = mask[n];
        sa += fx * fx * m;
        sb += fx * fy * m;
        sc += fy * fy * m;
      }
      for (int off = 16; off > 0; off >>= 1) {
        sa += __shfl_down_sync(0xffffffffu, sa, off);
        sb += __shfl_down_sync(0xffffffffu, sb, off);
        sc += __shfl_down_sync(0xffffffffu, sc, off);
      }
      if (lane == 0) {
        part[warp] = sa;
        part[WARPS + warp] = sb;
        part[2 * WARPS + warp] = sc;
      }
      __syncthreads();
      // from here every thread computes the same values
      float a = 0.0f, b = 0.0f, c = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        a += part[w];
        b += part[WARPS + w];
        c += part[2 * WARPS + w];
      }
      a = a / npix;
      b = b / npix;
      c = c / npix;
      float na, nb, nc, l1, l2;
      inv_sqrt_2x2(a, b, c, na, nb, nc, l1, l2);
      const bool nan_bad = !(isfinite(na) && isfinite(nb) && isfinite(nc));
      const float new_bef = act;
      const float new_act = 1.0f - l2 / l1;
      // nu = S @ u
      const float n00 = na * u00 + nb * u10;
      const float n01 = na * u01 + nb * u11;
      const float n10 = nb * u00 + nc * u10;
      const float n11 = nb * u01 + nc * u11;
      // eigenvalues of nu (baumberg.py::eigenvalues_2x2)
      const float tr = n00 + n11;
      const float disc = (n00 - n11) * (n00 - n11) + 4.0f * n01 * n10;
      const bool real = disc >= 0.0f;
      const float sq = sqrtf(disc != disc ? disc : fmaxf(disc, 0.0f));
      const float e1 = (tr + sq) / 2.0f;
      const float e2 = (tr - sq) / 2.0f;
      const bool aniso_bad = (e1 / e2 > 6.0f) || (e2 / e1 > 6.0f);
      const bool fail = nan_bad || !real || aniso_bad;
      if (!fail) {
        u00 = n00;
        u01 = n01;
        u10 = n10;
        u11 = n11;
        act = new_act;
        conv = (new_act < threshold) && (new_bef < threshold);
      }
      done = fail || conv;
    }
  }
  if (threadIdx.x == 0) {
    u_out[4 * k] = u00;
    u_out[4 * k + 1] = u01;
    u_out[4 * k + 2] = u10;
    u_out[4 * k + 3] = u11;
    conv_out[k] = conv ? 1 : 0;
    iters_out[k] = it;
  }
}

template <int PT>
cudaError_t launch(const void* big, int planes, int hc, int wc,
                   const void* lvl, const void* xy, const void* inv_scale,
                   const void* ratio, const void* valid, const void* mask,
                   int P, int max_iterations, float threshold, void* u,
                   void* conv, void* iters, int K, cudaStream_t stream) {
  const size_t smem =
      (size_t)(WIN_ROWS * STAGE_COLS + P * P + 3 * WARPS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      baumberg_smm_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  baumberg_smm_kernel<PT><<<K, THREADS, smem, stream>>>(
      (const float*)big, planes, hc, wc, (const int*)lvl, (const float*)xy,
      (const float*)inv_scale, (const float*)ratio,
      (const unsigned char*)valid, (const float*)mask, P, max_iterations,
      threshold, (float*)u, (unsigned char*)conv, (int*)iters);
  return cudaGetLastError();
}

}  // namespace

// big must be 16-byte aligned with wc a multiple of 4, hc >= 96 and
// wc >= 128 (a padded canvas).  Returns the CUDA error of the launch (0:
// none).
extern "C" int baumberg_smm(const void* big, int planes, int hc, int wc,
                            const void* lvl, const void* xy,
                            const void* inv_scale, const void* ratio,
                            const void* valid, const void* mask, int P,
                            int max_iterations, float threshold, void* u,
                            void* conv, void* iters, int K, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 19)
    return (int)launch<19>(big, planes, hc, wc, lvl, xy, inv_scale, ratio,
                           valid, mask, P, max_iterations, threshold, u,
                           conv, iters, K, s);
  return (int)launch<0>(big, planes, hc, wc, lvl, xy, inv_scale, ratio,
                        valid, mask, P, max_iterations, threshold, u, conv,
                        iters, K, s);
}
