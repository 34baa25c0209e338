// Batched blocked no-pivot LU factorization (K1) and block substitution
// (K2) for NVIDIA Hopper (sm_90a), f32, with a plain C interface for
// ctypes (wrappers and argument checks: rac2d_torch/ops/kernels.py; plain
// PyTorch twins: rac2d_torch/ops/blocklu.py).
//
// What they replace.  The JAX package's Pallas TPU kernels in
// ops/pallas/blocklu_pallas.py:
//   K1 blocklu_factor_kernel <- block_lu_batched_pallas / _lu_kernel
//      (with _factor_block_c, _unit_lower_inv_c, _upper_inv_c, _bmm);
//   K2 blocklu_solve_kernel  <- block_lu_solve_batched_pallas /
//      _solve_kernel.
// Both sit inside the Newton solve of the coupled chemistry+temperature
// BDF sweep (bdf._bfac / bdf._bsolve).  They compute what the TPU kernels
// compute: right-looking blocked LU without pivoting in BK=64 panels;
// pivots with |p| < 1e-20 floored to +-1e-20 keeping the sign; explicit
// inverses of each diagonal block's unit-lower and upper triangles; then
// substitution as block matrix-vector products with those inverses.
//
// What bounds them on this card, and what the design does about it.
//   The TPU kernels keep CB=2 whole matrices resident in VMEM.  One
//   512x512 f32 matrix is 1 MB and an SM has at most 227 KB of shared
//   memory, so here the matrix lives in device memory (in the output `lu`
//   buffer, which is factored in place) and one CTA per lane streams
//   64x64 tiles through shared memory.
//   K1 at N=512: ~2/3 N^3 = 89 MFLOP per lane, 23 GFLOP for 256 lanes,
//   against ~1.2 GB of tile traffic (mostly L2-resident panels).  Its
//   floor is the f32 FMA rate (67 TFLOP/s dense, no tensor cores: the
//   factorization must keep full f32, so no TF32) and the 3 x 64
//   sequential, barrier-separated steps per panel of the diagonal-block
//   factor and inverses, which no other CTA can help with.  The design
//   gives each lane its own CTA (256 lanes fill 132 SMs at 3 CTAs/SM),
//   register-blocks the tile products 4x4 per thread from padded
//   (conflict-free) shared memory, and computes the two triangular
//   inverses in one barrier loop.  wgmma/TMA and several lanes per CTA
//   are left to later work.
//   K2 reads each lane's packed LU once (~1 MB) plus the block inverses
//   (256 KB): it is bound by device-memory bandwidth (3.35 TB/s).  One
//   CTA per lane keeps the 512-vector in shared memory; each warp reduces
//   whole 64-wide rows with coalesced 256-byte reads and shuffles.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 64;            // panel size (same as the JAX package)
constexpr int LD = BK + 1;        // padded shared-memory row stride
constexpr int NT = 256;           // threads per CTA
constexpr int NWARP = NT / 32;
constexpr float PIV_FLOOR = 1e-20f;
constexpr size_t FACTOR_SMEM = 4 * BK * LD * sizeof(float);

__device__ __forceinline__ float floor_pivot(float p) {
  return fabsf(p) < PIV_FLOOR ? (p < 0.f ? -PIV_FLOOR : PIV_FLOOR) : p;
}

// Tile (r0, c0) of a row-major N x N matrix <-> shared memory.  M is
// written by this kernel too, so it must not be read through the
// read-only cache (no __restrict__ here).
__device__ __forceinline__ void load_tile(float* S, const float* M, int N,
                                          int r0, int c0) {
  for (int e = threadIdx.x; e < BK * BK; e += NT) {
    const int i = e >> 6, j = e & 63;
    S[i * LD + j] = M[(size_t)(r0 + i) * N + c0 + j];
  }
}

__device__ __forceinline__ void store_tile(float* M, const float* S, int N,
                                           int r0, int c0) {
  for (int e = threadIdx.x; e < BK * BK; e += NT) {
    const int i = e >> 6, j = e & 63;
    M[(size_t)(r0 + i) * N + c0 + j] = S[i * LD + j];
  }
}

// acc[r][c] = sum_k A[ty + 16 r][k] * B[k][tx + 16 c] for this thread's
// 4x4 outputs of a 64x64 tile product, both operands in shared memory.
__device__ __forceinline__ void tile_mm(const float* A, const float* B,
                                        float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * LD + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[k * LD + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// M[tile] = acc (sub=false) or M[tile] -= acc (sub=true).
__device__ __forceinline__ void store_acc(float* M, int N, int r0, int c0,
                                          float acc[4][4], bool sub) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t o = (size_t)(r0 + ty + 16 * r) * N + c0 + tx + 16 * c;
      M[o] = sub ? M[o] - acc[r][c] : acc[r][c];
    }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// K1: one CTA factors one lane.  A: [B, n, n]; lu: [B, N, N] (padded with
// identity, factored in place); linv, uinv: [B, K, BK, BK].
__global__ void __launch_bounds__(NT)
blocklu_factor_kernel(const float* __restrict__ A, int n, int N, float* lu,
                      float* __restrict__ linv, float* __restrict__ uinv) {
  extern __shared__ float smem[];
  float* D = smem;                  // diagonal block, then colp tile
  float* Li = smem + BK * LD;
  float* Ui = smem + 2 * BK * LD;
  float* T = smem + 3 * BK * LD;    // staging tile
  __shared__ float colm[BK];        // multipliers of the current column
  __shared__ float dfl[BK];         // floored diagonal of U

  const int tid = threadIdx.x;
  const int K = N / BK;
  const float* Ab = A + (size_t)blockIdx.x * n * n;
  float* L = lu + (size_t)blockIdx.x * N * N;
  float* LI = linv + (size_t)blockIdx.x * K * BK * BK;
  float* UI = uinv + (size_t)blockIdx.x * K * BK * BK;

  // pad: identity on the rows/columns beyond n
  for (size_t e = tid; e < (size_t)N * N; e += NT) {
    const int i = (int)(e / N), j = (int)(e % N);
    L[e] = (i < n && j < n) ? Ab[(size_t)i * n + j] : (i == j ? 1.f : 0.f);
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const int kb = k * BK;
    load_tile(D, L, N, kb, kb);
    __syncthreads();

    // (1) unblocked no-pivot LU of the diagonal block
    for (int j = 0; j < BK; ++j) {
      const float piv = floor_pivot(D[j * LD + j]);
      if (tid < BK) colm[tid] = tid > j ? D[tid * LD + j] / piv : 0.f;
      __syncthreads();
      for (int e = tid; e < BK * BK; e += NT) {
        const int i = e >> 6, c = e & 63;
        if (i > j) {
          if (c > j) D[i * LD + c] -= colm[i] * D[j * LD + c];
          else if (c == j) D[i * LD + j] = colm[i];
        } else if (i == j && c == j) {
          D[j * LD + j] = piv;
        }
      }
      __syncthreads();
    }

    // (2) Li = inverse of the unit-lower triangle (forward), Ui = inverse
    //     of the upper triangle (backward), one barrier per step for both
    for (int e = tid; e < BK * BK; e += NT) {
      const int i = e >> 6, c = e & 63;
      float d = D[i * LD + i];
      d = fabsf(d) < PIV_FLOOR ? PIV_FLOOR : d;
      Li[i * LD + c] = (i == c) ? 1.f : 0.f;
      Ui[i * LD + c] = (i == c) ? 1.f / d : 0.f;
    }
    if (tid < BK) {
      const float d = D[tid * LD + tid];
      dfl[tid] = fabsf(d) < PIV_FLOOR ? PIV_FLOOR : d;
    }
    __syncthreads();
    for (int s = 0; s < BK; ++s) {
      const int jl = s, ju = BK - 1 - s;
      for (int e = tid; e < BK * BK; e += NT) {
        const int i = e >> 6, c = e & 63;
        if (i > jl) Li[i * LD + c] -= D[i * LD + jl] * Li[jl * LD + c];
        if (i < ju)
          Ui[i * LD + c] -= (D[i * LD + ju] / dfl[i]) * Ui[ju * LD + c];
      }
      __syncthreads();
    }

    store_tile(L, D, N, kb, kb);
    for (int e = tid; e < BK * BK; e += NT) {
      const int i = e >> 6, c = e & 63;
      LI[(size_t)k * BK * BK + e] = Li[i * LD + c];
      UI[(size_t)k * BK * BK + e] = Ui[i * LD + c];
    }
    __syncthreads();

    if (kb + BK < N) {
      float acc[4][4];
      // (3) row panel: U_k* = Li @ A_k*
      for (int c0 = kb + BK; c0 < N; c0 += BK) {
        load_tile(T, L, N, kb, c0);
        __syncthreads();
        tile_mm(Li, T, acc);
        store_acc(L, N, kb, c0, acc, false);
        __syncthreads();
      }
      // (4) column panel: L_*k = A_*k @ Ui
      for (int r0 = kb + BK; r0 < N; r0 += BK) {
        load_tile(T, L, N, r0, kb);
        __syncthreads();
        tile_mm(T, Ui, acc);
        store_acc(L, N, r0, kb, acc, false);
        __syncthreads();
      }
      // (5) trailing update: A22 -= L_*k @ U_k*
      for (int r0 = kb + BK; r0 < N; r0 += BK) {
        load_tile(D, L, N, r0, kb);
        for (int c0 = kb + BK; c0 < N; c0 += BK) {
          load_tile(T, L, N, kb, c0);
          __syncthreads();
          tile_mm(D, T, acc);
          store_acc(L, N, r0, c0, acc, true);
          __syncthreads();
        }
      }
    }
  }
}

// K2: one CTA solves one lane.  b, x: [B, n]; the padded tail of the
// working vector is zero.
__global__ void __launch_bounds__(NT)
blocklu_solve_kernel(const float* __restrict__ lu,
                     const float* __restrict__ linv,
                     const float* __restrict__ uinv,
                     const float* __restrict__ bvec, int n, int N,
                     float* __restrict__ x) {
  extern __shared__ float y[];      // [N]
  __shared__ float part[BK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = N / BK;
  const float* L = lu + (size_t)blockIdx.x * N * N;
  const float* LI = linv + (size_t)blockIdx.x * K * BK * BK;
  const float* UI = uinv + (size_t)blockIdx.x * K * BK * BK;

  for (int i = tid; i < N; i += NT)
    y[i] = i < n ? bvec[(size_t)blockIdx.x * n + i] : 0.f;
  __syncthreads();

  // forward: y_k = Linv_k (b_k - L_{k,<k} y_{<k})
  for (int k = 0; k < K; ++k) {
    const int kb = k * BK;
    const float* M = LI + (size_t)k * BK * BK;
    for (int r = warp; r < BK; r += NWARP) {
      const float s = warp_sum(M[r * BK + lane] * y[kb + lane]
                               + M[r * BK + lane + 32] * y[kb + lane + 32]);
      if (lane == 0) part[r] = s;
    }
    __syncthreads();
    if (tid < BK) y[kb + tid] = part[tid];
    __syncthreads();
    for (int r = kb + BK + warp; r < N; r += NWARP) {
      const float* row = L + (size_t)r * N + kb;
      const float s = warp_sum(row[lane] * y[kb + lane]
                               + row[lane + 32] * y[kb + lane + 32]);
      if (lane == 0) y[r] -= s;
    }
    __syncthreads();
  }
  // backward: x_k = Uinv_k (y_k - U_{k,>k} x_{>k})
  for (int k = K - 1; k >= 0; --k) {
    const int kb = k * BK;
    const float* M = UI + (size_t)k * BK * BK;
    for (int r = warp; r < BK; r += NWARP) {
      const float s = warp_sum(M[r * BK + lane] * y[kb + lane]
                               + M[r * BK + lane + 32] * y[kb + lane + 32]);
      if (lane == 0) part[r] = s;
    }
    __syncthreads();
    if (tid < BK) y[kb + tid] = part[tid];
    __syncthreads();
    for (int r = warp; r < kb; r += NWARP) {
      const float* row = L + (size_t)r * N + kb;
      const float s = warp_sum(row[lane] * y[kb + lane]
                               + row[lane + 32] * y[kb + lane + 32]);
      if (lane == 0) y[r] -= s;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += NT) x[(size_t)blockIdx.x * n + i] = y[i];
}

}  // namespace

// Plain C entry points.  Each launches on `stream` (a cudaStream_t passed
// as a pointer), does not synchronise, and returns cudaGetLastError().

extern "C" int rac2d_blocklu_factor(const float* A, float* lu, float* linv,
                                    float* uinv, int B, int n, int N,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blocklu_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FACTOR_SMEM);
  if (err != cudaSuccess) return (int)err;
  blocklu_factor_kernel<<<B, NT, FACTOR_SMEM, (cudaStream_t)stream>>>(
      A, n, N, lu, linv, uinv);
  return (int)cudaGetLastError();
}

extern "C" int rac2d_blocklu_solve(const float* lu, const float* linv,
                                   const float* uinv, const float* b,
                                   float* x, int B, int n, int N,
                                   void* stream) {
  blocklu_solve_kernel<<<B, NT, N * sizeof(float), (cudaStream_t)stream>>>(
      lu, linv, uinv, b, n, N, x);
  return (int)cudaGetLastError();
}

extern "C" const char* rac2d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
