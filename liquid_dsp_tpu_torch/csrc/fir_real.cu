// Stride-1 real-tap FIR over float32 rows, for Hopper (sm_90a).
//
// Replaces liquid_dsp_tpu/ops/kernels/pallas_fir.py:fir_pallas_real (and
// its wrapper fir_apply_pallas), the TPU kernel behind
// firfilt(backend="pallas").  Complex streams arrive as rows: the re and
// im planes stacked, as the TPU wrapper stacks them.
//
// What it computes, per row r and output t in [0, T):
//   y[r, t] = sum_{j<L} h[j] * xp[r, t + L-1 - j],   xp = [carry | x]
// where carry [R, L-1] is the previous block's last L-1 input samples.
//
// Bound on this card: at the taps of a real filter (tens to hundreds) the
// float32 FMAs (L per output) outweigh the 8 bytes per sample moved.  The
// TPU kernel multiplied pre-overlapped windows by a banded [L+127, 128]
// matrix (mostly zeros) on the MXU; here the direct form does only the
// L nonzero products per output, as mix_fir_decim.cu does:
//   * one block per (row, tile of TILE outputs) loads its own window of
//     TILE + L - 1 samples into shared memory, the halo from the carry for
//     tile 0 (CUDA blocks run in no order, so nothing rides between them);
//     samples past the end of the row read as zeros, so any T works;
//   * each thread computes R consecutive outputs, sliding an R-sample
//     register window along the shared window: one shared load per R
//     FMAs, taps as warp-wide broadcasts;
//   * one pad word per R words keeps the lanes' stride-R loads on 32
//     distinct banks;
//   * outputs leave as 16-byte vectors where the row allows it.
// L <= LMAX = 4096 keeps the shared memory under 48 KB.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;    // outputs per block
constexpr int THREADS = 128;
constexpr int R = 8;          // consecutive outputs per thread
constexpr int LMAX = 4096;

__device__ __forceinline__ int padded(int k) { return k + k / R; }

struct Layout {        // shared-memory layout, the same on host and device
  int Ap, K, Ks;
  __host__ __device__ explicit Layout(int L) {
    Ap = (L + R - 1) / R * R;     // taps padded to R
    K = TILE + Ap;                // window entries
    Ks = K + K / R + 1;           // padded stride
  }
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(Ap) + Ks;
  }
};

__global__ void __launch_bounds__(THREADS)
fir_real_kernel(const float* __restrict__ x, const float* __restrict__ carry,
                const float* __restrict__ h, float* __restrict__ y,
                int T, int L, int ntiles) {
  extern __shared__ float smem[];
  const Layout lay(L);
  float* g = smem;               // [Ap] reversed taps: g[a] = h[L-1-a]
  float* w = g + lay.Ap;         // [Ks] the tile's input window, padded

  const int t = blockIdx.x % ntiles;
  const int r = blockIdx.x / ntiles;
  const long long xrow = static_cast<long long>(r) * T;
  const long long crow = static_cast<long long>(r) * (L - 1);
  const int start = t * TILE;    // xp index of window position 0

  for (int a = threadIdx.x; a < lay.Ap; a += THREADS)
    g[a] = a < L ? h[L - 1 - a] : 0.f;
  for (int q = threadIdx.x; q < lay.K; q += THREADS) {
    const int n = start + q;     // xp index
    float v = 0.f;
    if (n < L - 1)
      v = carry[crow + n];
    else if (n - (L - 1) < T)
      v = x[xrow + n - (L - 1)];
    w[padded(q)] = v;
  }
  __syncthreads();

  for (int o0 = threadIdx.x * R; o0 < TILE; o0 += THREADS * R) {
    const int ot = start + o0;   // output index of this thread's first
    if (ot >= T) break;
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.f;
    // xw[i] holds w[o0 + a0 + i] for i >= s and w[o0 + a0 + R + i] for
    // i < s (already replaced): a circular register window
    float xw[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xw[i] = w[padded(o0 + i)];
    for (int a0 = 0; a0 < lay.Ap; a0 += R) {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const float gs = g[a0 + s];
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = fmaf(gs, xw[(s + k) % R], acc[k]);
        xw[s] = w[padded(o0 + a0 + s + R)];
      }
    }
    float* yp = y + xrow + ot;
    if ((T & 3) == 0 && ot + R <= T) {
      float4* q = reinterpret_cast<float4*>(yp);
      q[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      q[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (ot + k < T) yp[k] = acc[k];
    }
  }
}

}  // namespace

// x: [rows, T] float32, contiguous.  carry: [rows, L-1] float32.  h: [L]
// float32, 1 <= L <= 4096.  y: [rows, T] float32, 16-byte aligned.
// rows * ceil(T / 1024) < 2^31.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fir_real_launch(const void* x, const void* carry,
                               const void* h, void* y, int rows, int T, int L,
                               void* stream) {
  if (L < 1 || L > LMAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (T + TILE - 1) / TILE;
  const dim3 grid(ntiles * rows);
  const size_t smem = sizeof(float) * Layout(L).floats();
  fir_real_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(carry),
      static_cast<const float*>(h), static_cast<float*>(y), T, L, ntiles);
  return static_cast<int>(cudaGetLastError());
}
