// Split-stream radix-2 FFT stages for mod2f, in CUDA for sm_90a: up to
// KMAX consecutive stages per launch, run in shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fft.py:36
// (fft_stage_kernel), which src/repro/kernels/ops.py:179 (_fft_stages)
// launches once per stage.  One stage, on the (n/2, 2) re/im view of the
// data (column 0 the even stream, column 1 the odd one), writes
//     up   = even + odd             (row 0 of the (2, n/2) output)
//     down = (even - odd) * tw      (row 1)
// so that the (2, n/2) output read flat is the paper's cat(up, down).  The
// TPU code tiles the stage's twiddle prefix tw[0:m] to n/2 entries; here
// the kernel reads tw[u % m] from the untiled table.
//
// Index scheme.  A stage sends input 2u + b to output b * n/2 + u: a right
// rotation of the L = log2 n index bits.  So k consecutive stages starting
// at global stage s0 mix only the points whose indices share bits k..L-1,
// the contiguous group [g * 2^k, (g + 1) * 2^k).  A pass reads each group
// (coalesced), runs the k stages on it in shared memory as split-stream
// stages of length 2^k, and writes its local point r to g + r * 2^(L-k).
// At local stage t the pair at local index c = 2r sits at the global
// position
//     pos = ((c >> (k-t)) << (L-t)) | (g << (k-t)) | (c & (2^(k-t) - 1))
// and takes the twiddle tw[(pos >> 1) % m], m = (n/2) >> (s0 + t).  The
// wrapper's plain version is the chain of one-stage passes; the CPU tests
// hold a model of this mapping against it.
//
// Bound on this card: bytes.  A transform must read n points and the n/2
// twiddles and write n points: 20 B a point in f32, about 6 us at 3.35 TB/s
// for n = 2^20.  One stage per launch moved 16 B a point per stage (20
// passes over the data, and 20 launches with a host gap each).  A pass here
// takes up to KMAX = 10 stages, so 2^20 takes two passes (about 36 B a
// point with the twiddles) enqueued by one host call; the pass before the
// last writes to a scratch buffer.  A CTA holds POINTS = 4096 points: at
// k = KMAX that is G = 4 adjacent groups, so each strided write of the
// last step is a run of 4 values (16 B in f32) rather than one.  The
// groups live in shared memory (32 KB f32, 64 KB f64), re and im apart;
// 512 threads take at most 64 registers each, so two CTAs share an SM and
// the 256 CTAs of a pass at n = 2^20 are all resident at once.  A thread
// reads four consecutive points (one 16-byte load per array), runs two
// stages on them in registers (a radix-4 unit of the split-stream chain:
// the same butterflies and twiddles) and writes the four results back in
// place after a barrier, so a pass of k stages takes ceil(k / 2) rounds
// through shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KMAX = 10;        // stages per pass
constexpr int POINTS = 4096;    // points per CTA (when n >= POINTS)
constexpr int THREADS = 512;
constexpr int QPT = POINTS / 4 / THREADS;  // radix-4 units per thread

// up = e + o, down = (e - o) * w, in re/im
template <typename R>
__device__ __forceinline__ void butterfly(R er, R ei, R orr, R oi, R wr,
                                          R wi, R& ur, R& ui, R& dr, R& di) {
  ur = er + orr;
  ui = ei + oi;
  const R xr = er - orr, xi = ei - oi;
  dr = xr * wr - xi * wi;
  di = xr * wi + xi * wr;
}

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// One pass of k stages.  The CTA owns npts = min(POINTS, n) points: G =
// npts >> k groups of 2^k.  m0 is the first stage's twiddle count, (n/2)
// >> s0; for k = 1 (the one-stage wrapper) any m0 that divides n/2 works,
// and n need not be a power of two.
template <typename R>
__global__ void __launch_bounds__(THREADS, 2)
    fft_stages_kernel(const R* __restrict__ re, const R* __restrict__ im,
                      const R* __restrict__ tw_re,
                      const R* __restrict__ tw_im, R* __restrict__ out_re,
                      R* __restrict__ out_im, int n, int npts, int k,
                      int m0) {
  extern __shared__ __align__(16) unsigned char smem[];
  R* sre = reinterpret_cast<R*>(smem);
  R* sim = sre + npts;
  const int G = npts >> k;
  const int ngroups = n >> k;
  const int g0 = blockIdx.x * G;
  const int base = g0 << k;
  const int valid = min(npts, n - base);

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im)) &
       15) == 0;
  if (valid == POINTS && blockDim.x == THREADS && aligned) {
    // a full CTA: every thread issues all its 16-byte loads before the
    // first store, so that enough bytes are in flight to cover HBM latency
    using Vec = typename std::conditional<sizeof(R) == 4, float4,
                                          double2>::type;
    constexpr int CH = POINTS * sizeof(R) / sizeof(Vec) / THREADS;
    const Vec* gre = reinterpret_cast<const Vec*>(re + base);
    const Vec* gim = reinterpret_cast<const Vec*>(im + base);
    Vec vr[CH], vi[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      vr[j] = gre[threadIdx.x + j * THREADS];
      vi[j] = gim[threadIdx.x + j * THREADS];
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      reinterpret_cast<Vec*>(sre)[threadIdx.x + j * THREADS] = vr[j];
      reinterpret_cast<Vec*>(sim)[threadIdx.x + j * THREADS] = vi[j];
    }
  } else {
    for (int e = threadIdx.x; e < npts; e += blockDim.x) {
      const bool ok = e < valid;
      sre[e] = ok ? re[base + e] : R(0);
      sim[e] = ok ? im[base + e] : R(0);
    }
  }
  __syncthreads();

  // the twiddle of local stage t for the pair at local index c of group
  // g0 + gi: tw[(pos >> 1) % m] with pos as in the note above.  m divides
  // 2^(L-1-t), so the bits of pos >> 1 from L-1-t up (c's top t bits) drop
  // out of the modulus and u keeps only the rest.
  auto twiddle = [&](int t, int gi, int c, R& wr, R& wi) {
    const int sh = k - t;
    const int u = ((g0 + gi) << (sh - 1)) + ((c & ((1 << sh) - 1)) >> 1);
    const int m = m0 >> t;
    const int w = (m & (m - 1)) == 0 ? (u & (m - 1)) : (u % m);
    wr = __ldg(tw_re + w);
    wi = __ldg(tw_im + w);
  };
  const int h = 1 << (k - 1);  // half a group
  int t = 0;
  // stages t and t + 1 in one round: the unit at local 4q .. 4q + 3 gives
  // stage t's pairs (4q, 4q + 1) -> 2q, 2q + h and (4q + 2, 4q + 3) ->
  // 2q + 1, 2q + 1 + h; stage t + 1 pairs those outputs (2q, 2q + 1) ->
  // q, q + h and (2q + h, 2q + 1 + h) -> q + h/2, q + h/2 + h
  for (; t + 1 < k; t += 2) {
    R o_r[QPT][4], o_i[QPT][4];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int u4 = threadIdx.x + j * blockDim.x;
      if (u4 < npts / 4) {
        const int gi = u4 >> (k - 2);
        const int q = u4 & (h / 2 - 1);
        R xr[4], xi[4];
        load4(sre + (gi << k) + 4 * q, xr);
        load4(sim + (gi << k) + 4 * q, xi);
        R wr, wi;
        twiddle(t, gi, 4 * q, wr, wi);
        R ur0, ui0, dr0, di0, ur1, ui1, dr1, di1;
        butterfly(xr[0], xi[0], xr[1], xi[1], wr, wi, ur0, ui0, dr0, di0);
        twiddle(t, gi, 4 * q + 2, wr, wi);
        butterfly(xr[2], xi[2], xr[3], xi[3], wr, wi, ur1, ui1, dr1, di1);
        twiddle(t + 1, gi, 2 * q, wr, wi);
        butterfly(ur0, ui0, ur1, ui1, wr, wi, o_r[j][0], o_i[j][0],
                  o_r[j][2], o_i[j][2]);
        twiddle(t + 1, gi, 2 * q + h, wr, wi);
        butterfly(dr0, di0, dr1, di1, wr, wi, o_r[j][1], o_i[j][1],
                  o_r[j][3], o_i[j][3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int u4 = threadIdx.x + j * blockDim.x;
      if (u4 < npts / 4) {
        const int at = ((u4 >> (k - 2)) << k) + (u4 & (h / 2 - 1));
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // q, q + h/2, q + h, q + 3h/2
          sre[at + e * (h / 2)] = o_r[j][e];
          sim[at + e * (h / 2)] = o_i[j][e];
        }
      }
    }
    __syncthreads();
  }
  if (t < k) {  // an odd stage count ends with one radix-2 stage
    R o_r[2 * QPT][2], o_i[2 * QPT][2];
#pragma unroll
    for (int j = 0; j < 2 * QPT; ++j) {
      const int bf = threadIdx.x + j * blockDim.x;
      if (bf < npts / 2) {
        const int gi = bf >> (k - 1);
        const int c = 2 * (bf & (h - 1));
        const int at = (gi << k) + c;
        R wr, wi;
        twiddle(t, gi, c, wr, wi);
        butterfly(sre[at], sim[at], sre[at + 1], sim[at + 1], wr, wi,
                  o_r[j][0], o_i[j][0], o_r[j][1], o_i[j][1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2 * QPT; ++j) {
      const int bf = threadIdx.x + j * blockDim.x;
      if (bf < npts / 2) {
        const int at = ((bf >> (k - 1)) << k) + (bf & (h - 1));
        sre[at] = o_r[j][0];
        sim[at] = o_i[j][0];
        sre[at + h] = o_r[j][1];
        sim[at + h] = o_i[j][1];
      }
    }
    __syncthreads();
  }

  // local point r of group gi goes to g + r * 2^(L-k); neighbouring
  // threads take neighbouring groups, so each write is a run of G values
  for (int e = threadIdx.x; e < npts; e += blockDim.x) {
    const int gi = e % G, r = e / G;
    const int g = g0 + gi;
    if (g < ngroups) {
      out_re[g + r * ngroups] = sre[(gi << k) + r];
      out_im[g + r * ngroups] = sim[(gi << k) + r];
    }
  }
}

// Enqueue the passes of `count` stages: pass p takes count / passes stages
// (one more for the first count % passes), reads the previous pass's
// output and writes out or scratch, alternating so that the last pass
// writes out.  The input is never written.
template <typename R>
int run(const R* re, const R* im, const R* twr, const R* twi, R* ore,
        R* oim, R* sre, R* sim, int n, int count, int m0, cudaStream_t s) {
  const int passes = (count + KMAX - 1) / KMAX;
  const int npts = n < POINTS ? n : POINTS;
  const size_t bytes = 2 * sizeof(R) * npts;
  auto kernel = fft_stages_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const R* src_re = re;
  const R* src_im = im;
  for (int p = 0; p < passes; ++p) {
    const int k = count / passes + (p < count % passes ? 1 : 0);
    const bool last = (passes - 1 - p) % 2 == 0;
    R* dst_re = last ? ore : sre;
    R* dst_im = last ? oim : sim;
    const int groups_per_cta = npts >> k;
    const int blocks = ((n >> k) + groups_per_cta - 1) / groups_per_cta;
    const int threads = npts / 2 < THREADS ? npts / 2 : THREADS;
    kernel<<<blocks, threads, bytes, s>>>(src_re, src_im, twr, twi, dst_re,
                                          dst_im, n, npts, k, m0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    m0 >>= k;
    src_re = dst_re;
    src_im = dst_im;
  }
  return 0;
}

}  // namespace

// `count` split-stream stages over the tangled data re, im (length n),
// starting from the stage whose twiddle count is m0 = (n/2) >> s0; out_*
// get the result, scratch_* (length n) are needed when there is more than
// one pass (count > 10).  count > 1 needs n a power of two; count == 1
// takes any even n and any m0 that divides n/2.  dtype codes: 0 =
// float32, 2 = float64.  Returns cudaGetLastError() of the first failed
// launch, or 0.
extern "C" int fft_stages_launch(const void* re, const void* im,
                                 const void* tw_re, const void* tw_im,
                                 void* out_re, void* out_im, void* scratch_re,
                                 void* scratch_im, int n, int count, int m0,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2 || n % 2 || count < 1 || m0 < 1 || (count > 1 && (n & (n - 1))) ||
      (count > KMAX && (scratch_re == nullptr || scratch_im == nullptr)) ||
      ((m0 >> (count - 1)) < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(tw_re), static_cast<const float*>(tw_im),
        static_cast<float*>(out_re), static_cast<float*>(out_im),
        static_cast<float*>(scratch_re), static_cast<float*>(scratch_im), n,
        count, m0, s);
  if (dtype == 2)
    return run<double>(
        static_cast<const double*>(re), static_cast<const double*>(im),
        static_cast<const double*>(tw_re), static_cast<const double*>(tw_im),
        static_cast<double*>(out_re), static_cast<double*>(out_im),
        static_cast<double*>(scratch_re), static_cast<double*>(scratch_im),
        n, count, m0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
