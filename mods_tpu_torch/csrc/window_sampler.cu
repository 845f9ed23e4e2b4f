// Window sampler: per-keypoint affine bilinear patch sampling straight
// from a (planes, H, W) level stack, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mods_tpu/ops/sampler.py::_make_sample_kernel
// (launched by _pallas_sample_fn, sampler.py:231-285, wrapped by
// _sample_from_windows_pallas, sampler.py:288-316) together with the
// window gather that feeds it (prepare_windows, sampler.py:154-182).  It
// computes sample_affine_patches (sampler.py:359-380) with the index rule
// of the JAX package's default einsum path (_sample_chunk,
// sampler.py:92-114); csrc/sampling.cuh holds that rule.
//
// Two callers, one kernel:
//   * stack mode (lvl given): the keypoint's window is the (rows, cols)
//     box of plane lvl_k whose origin the block computes from the centre
//     (sampling::window_origin); the valid extent is valid_hw[lvl_k].  No
//     (K, rows, cols) window tensor exists.
//   * window mode (lvl null): src is a K-plane stack whose plane k IS the
//     window of keypoint k (a WindowSource).  The address origin is (0, 0)
//     and the coordinate origin (x0_k, y0_k) and the valid extent
//     (vw_k, vh_k) come per keypoint.
//
// Design: one block per keypoint; P is a template parameter for the sizes
// the engine uses (19, 31, 32, 41; 0 is the generic instance), so the
// sample index splits into (j, i) without a run-time division.  The four
// patch corners give the bounding box of the taps (each coordinate is
// monotone in i and in j, also after rounding, so the extremes are at the
// corners).  The block copies that box, its left edge aligned down to 16
// bytes, from the plane into shared memory with coalesced 16-byte cp.async
// row copies and takes the four taps of every sample from shared memory.
// The rows of src must therefore be 16-byte aligned (W a multiple of 4 and
// an aligned base); the wrapper checks it.  A variant that read the taps
// with __ldg straight from the plane was slower at the main path's shape;
// PERF.md has both times.
//
// Bound on this card: bytes.  The function must read the distinct texels
// its valid samples interpolate from and write K*P*P floats; it does 27
// float operations a sample.

#include "sampling.cuh"

namespace {

struct SamplerArgs {
  const float* src;     // (planes, H, W)
  int planes, H, W;
  const int* lvl;       // (K,) plane per keypoint; null: window mode
  const int* valid_hw;  // (planes, 2) valid (h, w) per plane; stack mode
  const int* y0;        // (K,) coordinate origin row; window mode
  const int* x0;        // (K,) coordinate origin column; window mode
  const float* vw;      // (K,) valid width; window mode
  const float* vh;      // (K,) valid height; window mode
  const float* xy;      // (K, 2) centres, level coordinates
  const float* A;       // (K, 2, 2) sampling matrices
  float* out;           // (K, P, P)
  int P, rows, cols;    // patch size; window size
  float fill;
};

template <int PT>
__global__ void window_sample_kernel(const SamplerArgs a) {
  extern __shared__ __align__(16) float box[];
  const int k = blockIdx.x;
  const int P = PT ? PT : a.P;
  const int half = P / 2;
  const int N = P * P;
  const int W = a.W;

  sampling::PatchGeom g;
  g.cx = a.xy[2 * k];
  g.cy = a.xy[2 * k + 1];
  g.a00 = a.A[4 * k];
  g.a01 = a.A[4 * k + 1];
  g.a10 = a.A[4 * k + 2];
  g.a11 = a.A[4 * k + 3];
  g.rows = a.rows;
  g.cols = a.cols;
  int plane, ay0, ax0;  // where the window's (0, 0) lies in src
  if (a.lvl != nullptr) {
    plane = min(max(a.lvl[k], 0), a.planes - 1);
    ay0 = sampling::window_origin(g.cy, a.rows, a.H);
    ax0 = sampling::window_origin(g.cx, a.cols, W);
    g.oy = (float)ay0;
    g.ox = (float)ax0;
    g.vhm1 = __fsub_rn((float)a.valid_hw[2 * plane], 1.0f);
    g.vwm1 = __fsub_rn((float)a.valid_hw[2 * plane + 1], 1.0f);
  } else {
    plane = k;
    ay0 = 0;
    ax0 = 0;
    g.oy = (float)a.y0[k];
    g.ox = (float)a.x0[k];
    g.vhm1 = __fsub_rn(a.vh[k], 1.0f);
    g.vwm1 = __fsub_rn(a.vw[k], 1.0f);
  }
  const float* win = a.src + ((size_t)plane * a.H + ay0) * W + ax0;

  // the box of taps [bx0, bx1 + 1] x [by0, by1 + 1] in window
  // coordinates; shared column 0 is window column sx0, 16-byte aligned in
  // src, and the box's width is rounded up to 4 floats
  const sampling::Tap c0 = sampling::patch_tap(g, 0, 0, half);
  const sampling::Tap c1 = sampling::patch_tap(g, P - 1, 0, half);
  const sampling::Tap c2 = sampling::patch_tap(g, 0, P - 1, half);
  const sampling::Tap c3 = sampling::patch_tap(g, P - 1, P - 1, half);
  const int bx0 = min(min(c0.xi, c1.xi), min(c2.xi, c3.xi));
  const int bx1 = max(max(c0.xi, c1.xi), max(c2.xi, c3.xi));
  const int by0 = min(min(c0.yi, c1.yi), min(c2.yi, c3.yi));
  const int by1 = max(max(c0.yi, c1.yi), max(c2.yi, c3.yi));
  const int sx0 = ((ax0 + bx0) & ~3) - ax0;
  const int ncols = (bx1 + 2 - sx0 + 3) & ~3;
  sampling::stage_box_async(box, ncols, win + (size_t)by0 * W + sx0, W,
                            by1 + 2 - by0, ncols);
  sampling::stage_wait();

  float* o = a.out + (size_t)k * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int j = n / P;
    const int i = n - j * P;
    const sampling::Tap t = sampling::patch_tap(g, i, j, half);
    // a tap leaves the corners' box only for non-finite coordinates,
    // whose samples are filled: keep its address inside the box
    const int xi = min(max(t.xi, bx0), bx1) - sx0;
    const int yi = min(max(t.yi, by0), by1) - by0;
    const float* r0 = box + yi * ncols + xi;
    const float val = sampling::bilinear(r0[0], r0[1], r0[ncols],
                                         r0[ncols + 1], t.wx, t.wy);
    o[n] = t.ok ? val : a.fill;
  }
}

template <int PT>
cudaError_t launch(const SamplerArgs& a, int K, cudaStream_t stream) {
  const int P = PT ? PT : a.P;
  const int threads = P * P <= 512 ? 128 : 256;
  // the box is at most the window, widened by the 16-byte alignment of
  // its left edge and of its width
  const size_t smem =
      (size_t)a.rows * (((a.cols + 3) & ~3) + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_sample_kernel<PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  window_sample_kernel<PT><<<K, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Stack mode: lvl and valid_hw given, y0/x0/vw/vh null.  Window mode: lvl
// and valid_hw null, y0/x0/vw/vh given and planes == K.  src is 16-byte
// aligned and W a multiple of 4.  Returns the CUDA error of the launch
// (0: none).
extern "C" int window_sample(const void* src, int planes, int H, int W,
                             const void* lvl, const void* valid_hw,
                             const void* y0, const void* x0, const void* vw,
                             const void* vh, const void* xy, const void* A,
                             void* out, int K, int P, int rows, int cols,
                             float fill, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  SamplerArgs a;
  a.src = (const float*)src;
  a.planes = planes;
  a.H = H;
  a.W = W;
  a.lvl = (const int*)lvl;
  a.valid_hw = (const int*)valid_hw;
  a.y0 = (const int*)y0;
  a.x0 = (const int*)x0;
  a.vw = (const float*)vw;
  a.vh = (const float*)vh;
  a.xy = (const float*)xy;
  a.A = (const float*)A;
  a.out = (float*)out;
  a.P = P;
  a.rows = rows;
  a.cols = cols;
  a.fill = fill;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 19: return (int)launch<19>(a, K, s);
    case 31: return (int)launch<31>(a, K, s);
    case 32: return (int)launch<32>(a, K, s);
    case 41: return (int)launch<41>(a, K, s);
    default: return (int)launch<0>(a, K, s);
  }
}
