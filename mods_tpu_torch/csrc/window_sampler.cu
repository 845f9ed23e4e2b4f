// Window sampler: per-keypoint affine bilinear patch sampling from
// prefetched (rows, cols) windows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mods_tpu/ops/sampler.py::_make_sample_kernel
// (launched by _pallas_sample_fn, sampler.py:231-285, wrapped by
// _sample_from_windows_pallas, sampler.py:288-316).  It computes what that
// kernel plus its wrapper compute, with the index rule of the JAX
// package's default einsum path (_sample_chunk, sampler.py:92-114):
//
//   for keypoint k and patch sample n = j * P + i,
//     (dx, dy) = (i - P/2, j - P/2)
//     gx = (a00 * dx + a01 * dy) + x_k,   gy = (a10 * dx + a11 * dy) + y_k
//     relx = gx - x0_k,                   rely = gy - y0_k
//     xi = clamp(floor(relx), 0, cols-2), wx = relx - floor(relx)  (same
//     for y with rows), and the bilinear mix of the 2x2 taps at (yi, xi);
//   the sample is `fill` unless floor(gx) in [0, vw_k - 2] and floor(gy)
//   in [0, vh_k - 2] (the reference's safe interpolate rule).
//
// Every float operation is written with an explicit round-to-nearest
// intrinsic, in the same order as the plain PyTorch version
// (mods_tpu_torch/ops/sampler.py::sample_from_windows_plain), so that
// nvcc cannot contract a multiply and an add into an FMA: the two then
// agree bit for bit, and floor() picks the same taps and the same fill
// positions.
//
// Design: one block per keypoint, threads strided over the P*P samples,
// each thread a direct 4-tap read from the window in device memory (the
// reads of one keypoint stay inside its window, so they hit L1/L2).  The
// TPU kernel's tent weights and (P*P, rows) @ (rows, 128) matmul existed
// to feed the MXU; on Hopper a gather is cheap and the matmul would
// multiply mostly zeros.
//
// Bound on this card: bytes.  The function reads K windows of rows*cols
// float32 (48 KB each at rows=96) and writes K*P*P floats; it does about
// 20 float operations per sample.  At K=1536, P=19 that is 75.5 MB moved
// against 11 MFLOP, so device-memory bandwidth bounds it.  The window
// tensor itself is the cost: folding the prepare_windows gather into the
// kernel, so that it reads the level stack directly, is the next step.

#include <cuda_runtime.h>

namespace {

__global__ void window_sample_kernel(
    const float* __restrict__ win,   // (K, rows, cols)
    const float* __restrict__ xy,    // (K, 2) level coords
    const float* __restrict__ A,     // (K, 2, 2) sampling matrix
    const int* __restrict__ y0,      // (K,) window origin row
    const int* __restrict__ x0,      // (K,) window origin col
    const float* __restrict__ vw,    // (K,) valid width of the level
    const float* __restrict__ vh,    // (K,) valid height of the level
    float* __restrict__ out,         // (K, P, P)
    int P, int rows, int cols, float fill) {
  const int k = blockIdx.x;
  const float* w = win + (size_t)k * rows * cols;
  const float cx = xy[2 * k], cy = xy[2 * k + 1];
  const float a00 = A[4 * k], a01 = A[4 * k + 1];
  const float a10 = A[4 * k + 2], a11 = A[4 * k + 3];
  const float ox = (float)x0[k], oy = (float)y0[k];
  const float vwm1 = __fsub_rn(vw[k], 1.0f);
  const float vhm1 = __fsub_rn(vh[k], 1.0f);
  const int half = P / 2;
  const int N = P * P;
  float* o = out + (size_t)k * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float dx = (float)(n % P - half);
    const float dy = (float)(n / P - half);
    const float gx =
        __fadd_rn(__fadd_rn(__fmul_rn(a00, dx), __fmul_rn(a01, dy)), cx);
    const float gy =
        __fadd_rn(__fadd_rn(__fmul_rn(a10, dx), __fmul_rn(a11, dy)), cy);
    const float relx = __fsub_rn(gx, ox);
    const float rely = __fsub_rn(gy, oy);
    const float xf = floorf(relx);
    const float yf = floorf(rely);
    const float wx = __fsub_rn(relx, xf);
    const float wy = __fsub_rn(rely, yf);
    // fmaxf drops a NaN operand, so NaN coordinates read tap 0 (their
    // sample is filled below); the float clamp keeps the int conversion
    // in range
    const int xi = min(max((int)fminf(fmaxf(xf, -1.0f), (float)cols), 0),
                       cols - 2);
    const int yi = min(max((int)fminf(fmaxf(yf, -1.0f), (float)rows), 0),
                       rows - 2);
    const float* r0 = w + yi * cols + xi;
    const float* r1 = r0 + cols;
    const float p00 = __ldg(r0), p01 = __ldg(r0 + 1);
    const float p10 = __ldg(r1), p11 = __ldg(r1 + 1);
    const float uy = __fsub_rn(1.0f, wy);
    const float ux = __fsub_rn(1.0f, wx);
    const float c0 = __fadd_rn(__fmul_rn(uy, p00), __fmul_rn(wy, p10));
    const float c1 = __fadd_rn(__fmul_rn(uy, p01), __fmul_rn(wy, p11));
    const float val = __fadd_rn(__fmul_rn(ux, c0), __fmul_rn(wx, c1));
    const float gxf = floorf(gx);
    const float gyf = floorf(gy);
    const bool ok = (gxf >= 0.0f) && (gyf >= 0.0f) && (gxf < vwm1) &&
                    (gyf < vhm1);
    o[n] = ok ? val : fill;
  }
}

}  // namespace

extern "C" int window_sample(const void* win, const void* xy, const void* A,
                             const void* y0, const void* x0, const void* vw,
                             const void* vh, void* out, int K, int P,
                             int rows, int cols, float fill, void* stream) {
  if (K > 0) {
    window_sample_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
        (const float*)win, (const float*)xy, (const float*)A,
        (const int*)y0, (const int*)x0, (const float*)vw, (const float*)vh,
        (float*)out, P, rows, cols, fill);
  }
  return (int)cudaGetLastError();
}
