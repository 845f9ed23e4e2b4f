// Device routines shared by the sampling kernels (window_sampler.cu,
// baumberg_smm.cu): the window-origin rule, the per-sample coordinate,
// tap-clamp and fill rule, the bilinear mix, and the cp.async staging of a
// box of a level plane into shared memory.  One source of truth for the
// index rule of mods_tpu_torch/ops/sampler.py (prepare_windows,
// sample_from_windows_plain).
//
// Every float operation of the sampling arithmetic is written with an
// explicit round-to-nearest intrinsic, in the plain PyTorch version's
// order, so that nvcc cannot contract a multiply and an add into an FMA:
// kernel and plain version then agree bit for bit, and floor() picks the
// same taps and the same fill positions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sampling {

// Window origin along one axis for a centre coordinate c: floor(c) as an
// index (NaN -> 0, saturating at +-2^30, as ops/warp.py::to_index), minus
// size/2 - 1, clamped so that the window lies inside the canvas
// (prepare_windows).
__device__ __forceinline__ int window_origin(float c, int size, int canvas) {
  float f = floorf(c);
  f = (f != f) ? 0.0f : fminf(fmaxf(f, -1073741824.0f), 1073741824.0f);
  return min(max((int)f - (size / 2 - 1), 0), canvas - size);
}

// What is fixed for one keypoint's patch.
struct PatchGeom {
  float a00, a01, a10, a11;  // sampling matrix (level px per patch px)
  float cx, cy;              // centre, level coordinates
  float ox, oy;              // window origin in level coordinates
  float vwm1, vhm1;          // the level's valid width and height, minus 1
  int rows, cols;            // window size: taps are clamped into it
};

// One patch sample: the top-left tap inside the window, the bilinear
// fractions, and whether the sample is inside the level's valid extent.
struct Tap {
  int xi, yi;
  float wx, wy;
  bool ok;
};

// Sample (i, j) of a patch whose centre sample is (half, half):
//   gx = (a00 * dx + a01 * dy) + cx,  gy = (a10 * dx + a11 * dy) + cy
//   relx = gx - ox, xi = clamp(floor(relx), 0, cols - 2), wx = relx -
//   floor(relx); the same for y with rows;
//   ok iff floor(gx) in [0, vw - 2] and floor(gy) in [0, vh - 2].
__device__ __forceinline__ Tap patch_tap(const PatchGeom& g, int i, int j,
                                         int half) {
  const float dx = (float)(i - half);
  const float dy = (float)(j - half);
  const float gx = __fadd_rn(
      __fadd_rn(__fmul_rn(g.a00, dx), __fmul_rn(g.a01, dy)), g.cx);
  const float gy = __fadd_rn(
      __fadd_rn(__fmul_rn(g.a10, dx), __fmul_rn(g.a11, dy)), g.cy);
  const float relx = __fsub_rn(gx, g.ox);
  const float rely = __fsub_rn(gy, g.oy);
  const float xf = floorf(relx);
  const float yf = floorf(rely);
  Tap t;
  t.wx = __fsub_rn(relx, xf);
  t.wy = __fsub_rn(rely, yf);
  // fmaxf drops a NaN operand, so NaN coordinates read tap 0 (their
  // sample is filled); the float clamp keeps the int conversion in range
  t.xi = min(max((int)fminf(fmaxf(xf, -1.0f), (float)g.cols), 0),
             g.cols - 2);
  t.yi = min(max((int)fminf(fmaxf(yf, -1.0f), (float)g.rows), 0),
             g.rows - 2);
  const float gxf = floorf(gx);
  const float gyf = floorf(gy);
  t.ok = (gxf >= 0.0f) && (gyf >= 0.0f) && (gxf < g.vwm1) &&
         (gyf < g.vhm1);
  return t;
}

// Bilinear mix of the 2x2 taps, rows first.
__device__ __forceinline__ float bilinear(float p00, float p01, float p10,
                                          float p11, float wx, float wy) {
  const float uy = __fsub_rn(1.0f, wy);
  const float ux = __fsub_rn(1.0f, wx);
  const float c0 = __fadd_rn(__fmul_rn(uy, p00), __fmul_rn(wy, p10));
  const float c1 = __fadd_rn(__fmul_rn(uy, p01), __fmul_rn(wy, p11));
  return __fadd_rn(__fmul_rn(ux, c0), __fmul_rn(wx, c1));
}

// Start the asynchronous copy of an (nrows, ncols) box of floats from
// device memory (row stride src_stride) into shared memory (row stride
// dst_stride), all threads of the block taking part, and commit it as
// one cp.async group.  The copies are 16 bytes each: src, dst and both
// strides must be 16-byte aligned and ncols a multiple of 4.
// Neighbouring threads copy neighbouring addresses of a row.
__device__ __forceinline__ void stage_box_async(float* dst, int dst_stride,
                                                const float* src,
                                                int src_stride, int nrows,
                                                int ncols) {
  const int c4 = ncols >> 2;
  for (int n = threadIdx.x; n < nrows * c4; n += blockDim.x) {
    const int r = n / c4;
    const int c = (n - r * c4) << 2;
    const uint32_t d =
        (uint32_t)__cvta_generic_to_shared(dst + r * dst_stride + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + (size_t)r * src_stride + c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's staged copies, then for the block's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

}  // namespace sampling
