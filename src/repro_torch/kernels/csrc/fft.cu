// One split-stream radix-2 FFT stage for mod2f, in CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fft.py:36
// (fft_stage_kernel): on the (n/2, 2) re/im view of the data, column 0 is
// the even stream and column 1 the odd one, and the stage writes
//     up   = even + odd             (row 0 of the (2, n/2) output)
//     down = (even - odd) * tw      (row 1)
// so that the (2, n/2) output read flat is the paper's cat(up, down).
// One thread computes one butterfly.  The TPU code tiles the stage's
// twiddle prefix tw[0:m] to n/2 entries before every stage; here the kernel
// reads tw[u % m] from the untiled table, which computes the same thing and
// moves n/2 fewer twiddles per stage.
//
// Bound on this card: bytes.  A stage reads 2 n values and writes 2 n
// (16 n bytes in f32), and does 10 flops per butterfly; at n = 2^20 the
// 20 stages of one transform move about 336 MB, about 100 us at 3.35 TB/s.
// Fusing stages in shared memory, so that a transform reads the data once,
// is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename R>
__global__ void __launch_bounds__(THREADS)
    fft_stage_kernel(const R* __restrict__ re, const R* __restrict__ im,
                     const R* __restrict__ tw_re, const R* __restrict__ tw_im,
                     R* __restrict__ out_re, R* __restrict__ out_im, int half,
                     int m) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= half) return;
  const R er = re[2 * u], orr = re[2 * u + 1];
  const R ei = im[2 * u], oi = im[2 * u + 1];
  const R wr = tw_re[u % m], wi = tw_im[u % m];
  out_re[u] = er + orr;
  out_im[u] = ei + oi;
  const R dr = er - orr, di = ei - oi;
  out_re[half + u] = dr * wr - di * wi;
  out_im[half + u] = dr * wi + di * wr;
}

template <typename R>
void launch(const void* re, const void* im, const void* twr, const void* twi,
            void* ore, void* oim, int half, int m, cudaStream_t s) {
  const int blocks = (half + THREADS - 1) / THREADS;
  fft_stage_kernel<R><<<blocks, THREADS, 0, s>>>(
      static_cast<const R*>(re), static_cast<const R*>(im),
      static_cast<const R*>(twr), static_cast<const R*>(twi),
      static_cast<R*>(ore), static_cast<R*>(oim), half, m);
}

}  // namespace

// dtype codes: 0 = float32, 2 = float64.  Returns cudaGetLastError().
extern "C" int fft_stage_launch(const void* re, const void* im,
                                const void* tw_re, const void* tw_im,
                                void* out_re, void* out_im, int half, int m,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch<float>(re, im, tw_re, tw_im, out_re, out_im, half, m, s);
  else if (dtype == 2)
    launch<double>(re, im, tw_re, tw_im, out_re, out_im, half, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
