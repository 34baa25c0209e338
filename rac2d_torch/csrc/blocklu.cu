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
// What bounds K1 on this card.  The function needs, per lane at n=485,
// the no-pivot LU of the n x n matrix (sum of m + 2 m^2 over m < n, about
// 2/3 n^3: 7.59e7 flop) and the inverses of the 8 diagonal blocks' two
// triangles (about 2/3 s^3 for a block of s rows, 1.2e6): 7.72e7 flop, 1.98e10 at B=256 lanes, or 0.29 ms at the
// 67 TFLOP/s f32 FMA rate.  The factorization keeps full f32 (no TF32,
// no tensor cores), so that is K1's bound; reading A and writing lu, linv
// and uinv once (576 MB at B=256, n=485) would take 0.17 ms.  The blocked
// algorithm itself does 1.08e8 flop a lane at N=512 (the padded panels,
// and the panel products through the block inverses, which are dense
// products where a triangular solve would do half).
//
// The design.  A 512x512 f32 matrix is 1 MB, an SM holds at most 227 KB,
// so the matrix is factored in place in device memory (the `lu` output)
// by one CTA of 256 threads per lane (256 lanes: 2 waves over 132 SMs).
// For each panel k:
//   - the diagonal block is factored and both triangles inverted with
//     the block held in registers, 16 values per thread, four steps per
//     barrier group: a group's 4 rows (and 4 columns) go through shared
//     memory, each thread finishes them at its own column and applies the
//     4 steps in their one-at-a-time order (one barrier per group of
//     the factor and of the inverses: 32 a panel instead of 192).
//     Multipliers are x * (1/pivot), not x / pivot (one rounding apart);
//   - the row panel U_k* = Linv_k A_k* (64 x up to 448 columns, 112 KB)
//     is copied in with cp.async, multiplied in place and then stays in
//     shared memory for the whole trailing update: it is read from device
//     memory once per panel;
//   - the trailing matrix is walked by 64-row blocks: each block's column
//     panel tile L_r,k = A_r,k Uinv_k is computed, stored and used at once
//     to update that block row of A22 in chunks of 64 x 256.  A chunk's
//     A22 values are copied into shared memory with cp.async before its
//     FMAs start and waited for only at its epilogue, which subtracts the
//     product (held in registers) and stores the result with 128-bit
//     stores.  Each A22 element is read once and written once per panel.
//   - the trailing product runs 8x8 register tiles per thread: per k
//     step 4 conflict-free 128-bit shared loads (the L tile kept k-major,
//     a warp-wide broadcast; the row panel row-major) feed 64 FMAs, 4
//     FMAs per 32-bit word read.
// Its own traffic floor is the A22 row blocks through device memory once
// per panel: sum_k m_k^2 * 8 B = 4.6 MB, ~5.5 MB with the panels, per
// lane; 1.4 GB or 0.42 ms at 3.35 TB/s for 256 lanes, above the
// function's FMA bound.  Panel 0 reads A itself, padded with identity on
// the fly (4-byte zero-filling cp.async, since A's rows are not 16-byte
// aligned), and writes every element of lu, so there is no separate
// padding pass.  With one 215 KB CTA per SM the 256 lanes run in two
// waves, and the diagonal block's serial steps are not overlapped with
// other work.  Left for later work: a thread-block cluster per lane (so that
// the working set of the lanes in flight fits in the 50 MB L2 and the
// diagonal block's serial steps overlap the previous panel's trailing
// update), and a second micro-tile for the ragged last chunk of a row.
// For N > 512 the trailing columns are taken in slabs of at most 448, the
// row panel slab by slab (each slab re-reads the finished L tiles).
//
// What bounds K2.  The substitution does one FMA per entry of the factor
// that it needs: the off-diagonal blocks of lu inside n, the strict lower
// triangle of each Linv_k (its diagonal is 1) and the upper triangle of
// each Uinv_k, at the diagonal block's real size: n^2 floats a lane, plus
// b read and x written, 4 (n^2 + 2n) B.  At B=256, n=485 that is 2.42e8 B,
// 0.0722 ms at 3.35 TB/s; the FMAs would take 0.0018 ms at 67 TFLOP/s.
// So K2 is bound by device-memory bandwidth, and nothing it reads depends
// on the vector it solves for.
//
// The design.  One CTA of 256 threads per lane, 72 KB of shared memory
// at N=512, two CTAs per SM (256 lanes in one wave).  The tiles of the
// factor (Linv_k, then L_r,k for r > k; later Uinv_k, then U_r,k for
// r < k) stream in the order the sweep consumes them through a ring of 4
// stages of 64 rows each, filled by cp.async 16-byte copies that run 3
// tiles ahead of the substitution (up to 48 KB a CTA in flight): only the
// 16-byte chunks that hold needed entries are fetched (rows < n of the
// forward blocks, columns < n of the backward ones, the two triangles, the
// real part of the last diagonal block), 1.2% more than the n^2 floats at
// n=485.  A tile's product runs from shared memory: 4 threads a row, each
// over 16 columns with four 128-bit loads of the tile (row stride 68
// floats, so a quarter warp's 8 rows fall in 8 bank groups) and of the
// vector (a broadcast), entries outside the needed ones selected to 0, and
// two shuffle levels a row.  One barrier a tile; a tile reads its input
// segment of one of two vectors and writes its output segment of the
// other, so no second barrier guards a read-then-write.  f32 FFMA only.
// Left for later work: a cluster of CTAs per lane sharing the vectors
// through distributed shared memory (more SMs per lane where B is small),
// and several of _bsolve's right-hand sides per pass over the factor if
// the refinement is ever restructured to give them at once.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 64;            // panel size (same as the JAX package)
constexpr int NT = 256;           // threads per CTA
constexpr float PIV_FLOOR = 1e-20f;

// K1 shared memory (floats).  LDT: row stride of the 64x64 tiles, a
// multiple of 4 for 128-bit access; SW: widest row-panel slab; CW: the
// trailing update's chunk width (8 columns per thread, 32 threads).
constexpr int LDT = BK + 4;
constexpr int TILE = BK * LDT;
constexpr int SW = 448;
constexpr int CW = 256;
constexpr int RP_FLOATS = BK * SW;          // row panel slab, 112 KB
constexpr int A22_FLOATS = BK * CW;         // A22 chunk, 64 KB
constexpr size_t FACTOR_SMEM =
    (size_t)(RP_FLOATS + A22_FLOATS + 2 * TILE) * sizeof(float);

constexpr int DQ = BK * BK / NT;       // diagonal-block values per thread

__device__ __forceinline__ float floor_pivot(float p) {
  return fabsf(p) < PIV_FLOOR ? (p < 0.f ? -PIV_FLOOR : PIV_FLOOR) : p;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 64 rows x w columns (w a multiple of 4) of a row-major matrix with row
// stride ld_src, from device memory into shared memory (row stride
// ld_dst), 16 bytes per cp.async.  Commits one group.
__device__ __forceinline__ void copy_rows_async(float* dst, int ld_dst,
                                                const float* src,
                                                size_t ld_src, int w) {
  for (int i = threadIdx.x >> 6; i < BK; i += NT / 64)
    for (int j = (threadIdx.x & 63) << 2; j < w; j += 256)
      cp_async16(dst + i * ld_dst + j, src + i * ld_src + j);
  cp_async_commit();
}

// A [n, n] as the padded N x N matrix: identity beyond n
__device__ __forceinline__ float a_pad(const float* A, int n, int i, int j) {
  return (i < n && j < n) ? A[(size_t)i * n + j] : (i == j ? 1.f : 0.f);
}

// copy_rows_async for panel 0, straight from A [n, n], whose rows are not
// 16-byte aligned: 4 bytes per cp.async, rows row0.., columns col0..
// col0+w-1, zero-filled beyond n (the callers' blocks hold no diagonal
// entry, or set the padding's ones themselves).  Commits one group.
__device__ __forceinline__ void copy_rows_async_a(float* dst, int ld_dst,
                                                  const float* A, int n,
                                                  int row0, int col0, int w) {
  for (int i = threadIdx.x >> 6; i < BK; i += NT / 64)
    for (int j = threadIdx.x & 63; j < w; j += 64) {
      const int gi = row0 + i, gj = col0 + j;
      const bool in = gi < n && gj < n;
      const float* src = in ? A + (size_t)gi * n + gj : A;
      const unsigned s =
          (unsigned)__cvta_generic_to_shared(dst + i * ld_dst + j);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                   "l"(src), "r"(in ? 4 : 0));
    }
  cp_async_commit();
}

// copy_rows_async_a fills A22 with zeros beyond n: put back the padding's
// ones on the diagonal (row gr, columns gc..gc+3)
__device__ __forceinline__ void pad_ones(float4& v, int gr, int gc, int n) {
  if (gr >= n) {
    const int e = gr - gc;
    v.x = e == 0 ? 1.f : v.x;
    v.y = e == 1 ? 1.f : v.y;
    v.z = e == 2 ? 1.f : v.z;
    v.w = e == 3 ? 1.f : v.w;
  }
}

// dst[j][i] = src[i][j] for a 64x64 tile (dst in shared memory, row
// stride LDT; src row-major with stride ld_src, shared or device memory:
// it may be the `lu` buffer, which this kernel writes, so no __restrict__).
__device__ __forceinline__ void tile_regs(float v[DQ], const float* src,
                                          size_t ld_src) {
#pragma unroll
  for (int t = 0; t < DQ; ++t) {
    const int e = threadIdx.x + t * NT;
    v[t] = src[(e >> 6) * ld_src + (e & 63)];
  }
}
__device__ __forceinline__ void store_tile_t(float* dst, const float v[DQ]) {
#pragma unroll
  for (int t = 0; t < DQ; ++t) {
    const int e = threadIdx.x + t * NT;
    dst[(e & 63) * LDT + (e >> 6)] = v[t];
  }
}
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
                                            size_t ld_src) {
  float v[DQ];                          // all loads in flight, then stores
  tile_regs(v, src, ld_src);
  store_tile_t(dst, v);
}

// acc[i][j] = sum_k Xt[k][ty4*4 + i] * Y[k][tx4*4 + j]: this thread's 4x4
// outputs of a 64x64 product whose left operand is kept k-major (Xt, row
// stride LDT) and right operand row-major (Y, row stride ldy); two
// 128-bit shared loads per 16 FMAs.
__device__ __forceinline__ void tile_mm_4x4(const float* Xt, const float* Y,
                                            int ldy, float acc[4][4]) {
  const int tx4 = threadIdx.x & 15, ty4 = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(Xt + k * LDT + ty4 * 4);
    const float4 b = *reinterpret_cast<const float4*>(Y + k * ldy + tx4 * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// v[q] for a q known only at run time, without local memory
__device__ __forceinline__ float pick(const float v[DQ], int q) {
  float x = v[0];
#pragma unroll
  for (int t = 1; t < DQ; ++t)
    if (t == q) x = v[t];
  return x;
}

__device__ __forceinline__ float4 row4(const float acc[4][4], int i) {
  return make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// K1: one CTA factors one lane.  A: [B, n, n]; lu: [B, N, N] (padded with
// identity, factored in place); linv, uinv: [B, K, BK, BK].
__global__ void __launch_bounds__(NT, 1)
blocklu_factor_kernel(const float* __restrict__ A, int n, int N, float* lu,
                      float* __restrict__ linv, float* __restrict__ uinv) {
  extern __shared__ __align__(16) float smem[];
  float* RP = smem;                     // row panel slab [64][SW]
  float* A22 = RP + RP_FLOATS;          // A22 chunk [64][CW]
  float* D = A22;                       // factored diagonal block and
  float* S = A22 + TILE;                // U[i][j] / d_i (both alias A22)
  float* Ui = A22 + A22_FLOATS;         // upper inverse [64][LDT]
  float* T = Ui + TILE;                 // Linv^T, A_r,k^T, then L_r,k^T
  __shared__ __align__(16) float pubA[2][4 * BK];   // published rows and
  __shared__ __align__(16) float pubB[2][4 * BK];   // columns of a group
  __shared__ float dfl[BK];             // floored diagonal of U

  const int tid = threadIdx.x;
  const int tx4 = tid & 15, ty4 = tid >> 4;     // 4x4 products
  const int tx = tid & 31, ty = tid >> 5;       // 8x8 trailing products
  const int g = tid >> 6, cc = tid & 63;        // diagonal block: rows
                                                // g + 4q of column cc
  const int K = N / BK;
  const float* Ab = A + (size_t)blockIdx.x * n * n;
  float* L = lu + (size_t)blockIdx.x * N * N;
  float* LI = linv + (size_t)blockIdx.x * K * BK * BK;
  float* UI = uinv + (size_t)blockIdx.x * K * BK * BK;

  for (int k = 0; k < K; ++k) {
    const int kb = k * BK;
    // Panel 0 reads A itself (padded with identity on the fly) and writes
    // every element of lu; later panels read lu.  Their cp.async reads
    // (which bypass L1) must see the previous panel's stores by every
    // thread: each fences its own to the device before the barrier.
    __threadfence();
    __syncthreads();
    // (1) unblocked no-pivot LU of the diagonal block, held in registers
    //     (thread (g, cc) holds rows g + 4q of column cc), four steps per
    //     group: the group's 4 rows and 4 columns are published through
    //     shared memory (double-buffered); every thread forms the 4x4
    //     block's factors and its rows' 4 multipliers and applies the 4
    //     steps to its values in the same order as one step at a time.
    //     One barrier per 4 steps.
    float d[DQ];
#pragma unroll
    for (int q = 0; q < DQ; ++q)
      d[q] = k == 0 ? a_pad(Ab, n, g + 4 * q, cc)
                    : L[(size_t)(kb + g + 4 * q) * N + kb + cc];
    // the first row-panel slab comes in while the diagonal block factors
    if (kb + BK < N) {
      if (k == 0)
        copy_rows_async_a(RP, SW, Ab, n, 0, BK, min(SW, N - BK));
      else
        copy_rows_async(RP, SW, L + (size_t)kb * N + kb + BK, N,
                        min(SW, N - kb - BK));
    }
    for (int j = 0; j < BK; j += 4) {
      const int b = (j >> 2) & 1;
      float* R = pubA[b];               // [4][BK]: rows j..j+3
      float* C = pubB[b];               // [BK][4]: columns j..j+3
      R[g * BK + cc] = pick(d, j >> 2);
      if (cc >= j && cc < j + 4) {
#pragma unroll
        for (int q = 0; q < DQ; ++q) C[(g + 4 * q) * 4 + cc - j] = d[q];
      }
      __syncthreads();
      // every thread forms the 4x4 block's L\U (no second barrier)
      float m[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int t = 0; t < 4; ++t) m[a][t] = R[a * BK + j + t];
      float rp[4];                      // multipliers: x * (1 / pivot)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = floor_pivot(m[t][t]);
        rp[t] = 1.f / p;
#pragma unroll
        for (int a = t + 1; a < 4; ++a) {
          m[a][t] = m[a][t] * rp[t];
#pragma unroll
          for (int u = t + 1; u < 4; ++u)
            m[a][u] = fmaf(-m[a][t], m[t][u], m[a][u]);
        }
      }
      // rows j..j+3 of U at this thread's column
      const float u0 = R[cc];
      const float u1 = fmaf(-m[1][0], u0, R[BK + cc]);
      const float u2 = fmaf(-m[2][1], u1, fmaf(-m[2][0], u0, R[2 * BK + cc]));
      const float u3 = fmaf(-m[3][2], u2, fmaf(-m[3][1], u1,
                                               fmaf(-m[3][0], u0,
                                                    R[3 * BK + cc])));
      const int t = cc - j;
      float4 cr[DQ];
#pragma unroll
      for (int q = 0; q < DQ; ++q)
        cr[q] = *reinterpret_cast<const float4*>(C + (g + 4 * q) * 4);
#pragma unroll
      for (int q = 0; q < DQ; ++q) {
        const int r = g + 4 * q;
        const int a = r - j;            // row inside the 4x4 block
        // this row's 4 multipliers, in step order
        const float c0 = cr[q].x * rp[0];
        const float c1 = fmaf(-c0, m[0][1], cr[q].y) * rp[1];
        const float c2 = fmaf(-c1, m[1][2], fmaf(-c0, m[0][2], cr[q].z))
                         * rp[2];
        const float c3 = fmaf(-c2, m[2][3], fmaf(-c1, m[1][3],
                                                 fmaf(-c0, m[0][3], cr[q].w)))
                         * rp[3];
        const float below = fmaf(-c3, u3, fmaf(-c2, u2,
                            fmaf(-c1, u1, fmaf(-c0, u0, d[q]))));
        const float uin = a == 0 ? u0 : a == 1 ? u1 : a == 2 ? u2 : u3;
        const float ct = t == 0 ? c0 : t == 1 ? c1 : t == 2 ? c2 : c3;
        // inside the 4x4 block, at column j+t: L left of the diagonal
        // (the same chain as the rows below), the pivot on it, U right
        const float blk = t < a ? ct : (t == a ? floor_pivot(uin) : uin);
        // selects, not branches: t differs along the warp
        const float right = r > j + 3 ? below : (r >= j ? uin : d[q]);
        const float grp = r > j + 3 ? ct : (r >= j ? blk : d[q]);
        d[q] = t >= 4 ? right : (t >= 0 ? grp : d[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int r = g + 4 * q;
      D[r * LDT + cc] = d[q];
      L[(size_t)(kb + r) * N + kb + cc] = d[q];
    }
    __syncthreads();
    if (tid < BK) {
      const float v = D[tid * LDT + tid];
      dfl[tid] = fabsf(v) < PIV_FLOOR ? PIV_FLOOR : v;
    }
    __syncthreads();

    // (2) Li = inverse of the unit-lower triangle (forward) and Ui =
    //     inverse of the upper triangle (backward), in registers as in
    //     (1), four steps of each per barrier: the 4 rows of each group
    //     are published, every thread finishes them at its column and
    //     applies the 4 steps to its own rows in step order.
    float yl[DQ], yu[DQ];
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int r = g + 4 * q;
      S[r * LDT + cc] = d[q] / dfl[r];
      yl[q] = r == cc ? 1.f : 0.f;
      yu[q] = r == cc ? 1.f / dfl[r] : 0.f;
    }
    __syncthreads();
    for (int jl = 0; jl < BK; jl += 4) {
      const int b = (jl >> 2) & 1;
      const int j0 = BK - 4 - jl;       // Ui's group: rows j0..j0+3,
      float* RL = pubA[b];              // taken from j0+3 down
      float* RU = pubB[b];
      RL[g * BK + cc] = pick(yl, jl >> 2);
      RU[g * BK + cc] = pick(yu, j0 >> 2);
      __syncthreads();
      const float* dj = D + jl * LDT + jl;    // D[jl + a][jl + t]
      const float y0 = RL[cc];
      const float y1 = fmaf(-dj[LDT], y0, RL[BK + cc]);
      const float y2 = fmaf(-dj[2 * LDT + 1], y1,
                            fmaf(-dj[2 * LDT], y0, RL[2 * BK + cc]));
      const float y3 = fmaf(-dj[3 * LDT + 2], y2,
                            fmaf(-dj[3 * LDT + 1], y1,
                                 fmaf(-dj[3 * LDT], y0, RL[3 * BK + cc])));
      const float* sj = S + j0 * LDT + j0;    // S[j0 + a][j0 + t]
      const float v0 = RU[3 * BK + cc];
      const float v1 = fmaf(-sj[2 * LDT + 3], v0, RU[2 * BK + cc]);
      const float v2 = fmaf(-sj[LDT + 2], v1,
                            fmaf(-sj[LDT + 3], v0, RU[BK + cc]));
      const float v3 = fmaf(-sj[1], v2,
                            fmaf(-sj[2], v1, fmaf(-sj[3], v0, RU[cc])));
      float4 cl[DQ], cu[DQ];
#pragma unroll
      for (int q = 0; q < DQ; ++q) {
        cl[q] = *reinterpret_cast<const float4*>(D + (g + 4 * q) * LDT + jl);
        cu[q] = *reinterpret_cast<const float4*>(S + (g + 4 * q) * LDT + j0);
      }
#pragma unroll
      for (int q = 0; q < DQ; ++q) {
        const int r = g + 4 * q;
        float x = yl[q];
        x = r > jl ? fmaf(-cl[q].x, y0, x) : x;
        x = r > jl + 1 ? fmaf(-cl[q].y, y1, x) : x;
        x = r > jl + 2 ? fmaf(-cl[q].z, y2, x) : x;
        yl[q] = r > jl + 3 ? fmaf(-cl[q].w, y3, x) : x;
        float z = yu[q];
        z = r < j0 + 3 ? fmaf(-cu[q].w, v0, z) : z;
        z = r < j0 + 2 ? fmaf(-cu[q].z, v1, z) : z;
        z = r < j0 + 1 ? fmaf(-cu[q].y, v2, z) : z;
        yu[q] = r < j0 ? fmaf(-cu[q].x, v3, z) : z;
      }
    }

#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int r = g + 4 * q;
      LI[(size_t)k * BK * BK + r * BK + cc] = yl[q];
      UI[(size_t)k * BK * BK + r * BK + cc] = yu[q];
      Ui[r * LDT + cc] = yu[q];
      T[cc * LDT + r] = yl[q];           // Linv^T for the row panel
    }
    if (kb + BK >= N) break;
    __syncthreads();

    for (int c_lo = kb + BK; c_lo < N; c_lo += SW) {
      const int w = min(SW, N - c_lo);
      // (3) row panel slab: U_k,slab = Li @ A_k,slab, kept in RP
      if (c_lo > kb + BK) {
        load_tile_t(T, LI + (size_t)k * BK * BK, BK);
        if (k == 0)
          copy_rows_async_a(RP, SW, Ab, n, 0, c_lo, w);
        else
          copy_rows_async(RP, SW, L + (size_t)kb * N + c_lo, N, w);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int t = 0; t < w; t += BK) {
        float acc[4][4];
        tile_mm_4x4(T, RP + t, SW, acc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty4 * 4 + i, c = t + tx4 * 4;
          *reinterpret_cast<float4*>(RP + r * SW + c) = row4(acc, i);
          *reinterpret_cast<float4*>(L + (size_t)(kb + r) * N + c_lo + c) =
              row4(acc, i);
        }
      }
      __syncthreads();

      // (4)+(5) walk the trailing rows by 64-row blocks
      for (int r0 = kb + BK; r0 < N; r0 += BK) {
        float* Arow = L + (size_t)r0 * N;
        // A_r,k^T (L_r,k^T after slab 0); its loads go out before the
        // first A22 chunk's copy, which is in flight while the L tile forms
        float v[DQ];
        if (k == 0 && c_lo == kb + BK) {
#pragma unroll
          for (int t = 0; t < DQ; ++t) {
            const int e = tid + t * NT;
            v[t] = a_pad(Ab, n, r0 + (e >> 6), e & 63);
          }
        } else {
          tile_regs(v, Arow + kb, N);
        }
        if (k == 0)
          copy_rows_async_a(A22, CW, Ab, n, r0, c_lo, min(CW, w));
        else
          copy_rows_async(A22, CW, Arow + c_lo, N, min(CW, w));
        store_tile_t(T, v);
        __syncthreads();
        if (c_lo == kb + BK) {
          // L_r,k = A_r,k @ Ui: stored to lu and kept k-major in T
          float acc[4][4];
          tile_mm_4x4(T, Ui, LDT, acc);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(Arow + (size_t)(ty4 * 4 + i) * N +
                                       kb + tx4 * 4) = row4(acc, i);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(T + (tx4 * 4 + j) * LDT + ty4 * 4) =
                make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          __syncthreads();
        }
        for (int c = 0; c < w; c += CW) {
          const int cw = min(CW, w - c);
          if (c > 0) {
            if (k == 0)
              copy_rows_async_a(A22, CW, Ab, n, r0, c_lo + c, cw);
            else
              copy_rows_async(A22, CW, Arow + c_lo + c, N, cw);
          }
          // this thread's 8 rows and 2 x 4 columns of the 64 x cw chunk;
          // a thread whose columns lie beyond cw reads column 0 and
          // stores nothing
          const bool v0 = tx * 4 < cw, v1 = CW / 2 + tx * 4 < cw;
          const int cr0 = v0 ? c + tx * 4 : 0;
          const int cr1 = v1 ? c + CW / 2 + tx * 4 : 0;
          float acc[8][8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(T + kk * LDT + ty * 8);
            const float4 a1 =
                *reinterpret_cast<const float4*>(T + kk * LDT + ty * 8 + 4);
            const float4 b0 =
                *reinterpret_cast<const float4*>(RP + kk * SW + cr0);
            const float4 b1 =
                *reinterpret_cast<const float4*>(RP + kk * SW + cr1);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          cp_async_wait_all();
          __syncthreads();
          // epilogue: A22 - L_r,k U_k,chunk, 128-bit stores
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = ty * 8 + i;
            float* g = Arow + (size_t)r * N + c_lo + c;
            if (v0) {
              float4 v = *reinterpret_cast<const float4*>(A22 + r * CW +
                                                          tx * 4);
              if (k == 0) pad_ones(v, r0 + r, c_lo + c + tx * 4, n);
              v.x -= acc[i][0]; v.y -= acc[i][1];
              v.z -= acc[i][2]; v.w -= acc[i][3];
              *reinterpret_cast<float4*>(g + tx * 4) = v;
            }
            if (v1) {
              float4 v = *reinterpret_cast<const float4*>(
                  A22 + r * CW + CW / 2 + tx * 4);
              if (k == 0)
                pad_ones(v, r0 + r, c_lo + c + CW / 2 + tx * 4, n);
              v.x -= acc[i][4]; v.y -= acc[i][5];
              v.z -= acc[i][6]; v.w -= acc[i][7];
              *reinterpret_cast<float4*>(g + CW / 2 + tx * 4) = v;
            }
          }
          __syncthreads();
        }
      }
    }
  }
}

// K2's ring: S2 stages of one 64-row tile each (row stride LDT), then the
// two working vectors y and z of N floats each.
constexpr int S2 = 4;
constexpr size_t solve_smem(int N) {
  return ((size_t)S2 * TILE + 2 * (size_t)N) * sizeof(float);
}

// One tile of K2's sweep.  The forward sweep takes, for k = 0..K-1, Linv_k
// (r == k) and then the column blocks L_r,k for r = k+1..K-1; the backward
// sweep takes, for k = K-1..0, Uinv_k (r == k) and then U_r,k for r =
// 0..k-1.  fwd is 0 once the walk is past the forward sweep; k < 0 ends it.
struct SolveStep {
  int fwd, k, r;
};

__device__ __forceinline__ void solve_next(SolveStep& s, int K) {
  if (s.fwd) {
    if (++s.r == K) {
      if (++s.k == K) {
        s.fwd = 0;
        s.k = s.r = K - 1;
      } else {
        s.r = s.k;
      }
    }
  } else {
    s.r = s.r == s.k ? 0 : s.r + 1;
    if (s.r == s.k) s.r = --s.k;
  }
}

// What of a tile the function needs: rows < nrows, and in row i the
// columns lo..hi-1 (mode 0: 0..width-1; mode 1, the unit-lower inverse:
// 0..i-1, its diagonal is 1; mode 2, the upper inverse: i..width-1).
struct SolveTile {
  const float* src;      // row 0, column 0 of the tile in device memory
  int ld, nrows, width, mode;
};

__device__ __forceinline__ SolveTile solve_tile(const SolveStep& s,
                                                const float* L,
                                                const float* LI,
                                                const float* UI, int n,
                                                int N) {
  const int kb = s.k * BK;
  const int w = min(BK, n - kb);
  if (s.r == s.k)
    return {(s.fwd ? LI : UI) + (size_t)s.k * BK * BK, BK, w, w,
            s.fwd ? 1 : 2};
  // the forward blocks below the diagonal (k < K-1: all 64 columns lie
  // inside n, rows stop at n) and the backward ones above it (all 64 rows
  // lie inside n, columns stop at n)
  return {L + (size_t)s.r * BK * N + kb, N, min(BK, n - s.r * BK), w, 0};
}

__device__ __forceinline__ void solve_cols(const SolveTile& t, int i,
                                           int& lo, int& hi) {
  lo = t.mode == 2 ? i : 0;
  hi = i >= t.nrows ? lo : (t.mode == 1 ? i : t.width);
}

// The needed 16-byte chunks of a tile into a ring stage (row stride LDT),
// one cp.async each; commits one group (empty past the end of the sweep).
__device__ __forceinline__ void solve_fetch(float* dst, const SolveStep& s,
                                            const float* L, const float* LI,
                                            const float* UI, int n, int N) {
  if (s.k >= 0) {
    const SolveTile t = solve_tile(s, L, LI, UI, n, N);
#pragma unroll
    for (int u = 0; u < BK * BK / 4 / NT; ++u) {
      const int e = threadIdx.x + u * NT;
      const int i = e >> 4, c = (e & 15) << 2;
      int lo, hi;
      solve_cols(t, i, lo, hi);
      if (lo < hi && c + 4 > lo && c < hi)
        cp_async16(dst + i * LDT + c, t.src + (size_t)i * t.ld + c);
    }
  }
  cp_async_commit();
}

// K2: one CTA solves one lane.  b, x: [B, n].  The tiles of the factor
// stream through an S2-stage cp.async ring in the order the sweep takes
// them; the copies run S2 - 1 tiles ahead of the substitution, one
// barrier per tile.  y holds b, the forward residuals and at the end x;
// z the forward result y_k and the backward residuals.  A tile reads its
// input segment of one vector and writes its output segment of the
// other (Linv_k: y_k -> z_k; L_r,k: z_k -> y_r; Uinv_k: z_k -> y_k;
// U_r,k: y_k -> z_r), so no tile reads what it writes.  Entries of both
// vectors at n and beyond stay 0.
__global__ void __launch_bounds__(NT, 2)
blocklu_solve_kernel(const float* __restrict__ lu,
                     const float* __restrict__ linv,
                     const float* __restrict__ uinv,
                     const float* __restrict__ bvec, int n, int N,
                     float* __restrict__ x) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // [S2][BK][LDT]
  float* y = ring + S2 * TILE;          // [N]
  float* z = y + N;                     // [N]
  const int tid = threadIdx.x, lane = tid & 31;
  // 4 threads a row (xor 8 and 16 apart), each over columns 4(q + 4j),
  // j = 0..3: a quarter warp reads 8 rows at one column, which the row
  // stride LDT = 68 puts in 8 different bank groups
  const int i = (tid >> 5) * 8 + (lane & 7), q = lane >> 3;
  const int K = N / BK;
  const float* L = lu + (size_t)blockIdx.x * N * N;
  const float* LI = linv + (size_t)blockIdx.x * K * BK * BK;
  const float* UI = uinv + (size_t)blockIdx.x * K * BK * BK;

  SolveStep put = {1, 0, 0}, get = {1, 0, 0};
  for (int st = 0; st < S2 - 1; ++st) {
    solve_fetch(ring + st * TILE, put, L, LI, UI, n, N);
    if (put.k >= 0) solve_next(put, K);
  }
  for (int e = tid; e < N; e += NT) {
    y[e] = e < n ? bvec[(size_t)blockIdx.x * n + e] : 0.f;
    z[e] = 0.f;
  }
  for (int st = 0; get.k >= 0; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S2 - 2) : "memory");
    __syncthreads();                    // tile st is in, tile st-1 is done
    solve_fetch(ring + (st + S2 - 1) % S2 * TILE, put, L, LI, UI, n, N);
    if (put.k >= 0) solve_next(put, K);

    const SolveTile t = solve_tile(get, L, LI, UI, n, N);
    const bool in_y = get.fwd == (get.r == get.k);
    const float* vin = (in_y ? y : z) + get.k * BK;
    float* vout = (in_y ? z : y) + get.r * BK;
    const float* row = ring + st % S2 * TILE + i * LDT;
    int lo, hi;
    solve_cols(t, i, lo, hi);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * (q + 4 * j);
      const float4 a = *reinterpret_cast<const float4*>(row + c);
      const float4 v = *reinterpret_cast<const float4*>(vin + c);
      // entries outside lo..hi-1 were not fetched (or are not needed)
      acc = fmaf(c >= lo && c < hi ? a.x : 0.f, v.x, acc);
      acc = fmaf(c + 1 >= lo && c + 1 < hi ? a.y : 0.f, v.y, acc);
      acc = fmaf(c + 2 >= lo && c + 2 < hi ? a.z : 0.f, v.z, acc);
      acc = fmaf(c + 3 >= lo && c + 3 < hi ? a.w : 0.f, v.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (q == 0 && i < t.nrows)
      vout[i] = t.mode == 0 ? vout[i] - acc
                            : (t.mode == 1 ? vin[i] + acc : acc);
    solve_next(get, K);
  }
  __syncthreads();
  for (int e = tid; e < n; e += NT) x[(size_t)blockIdx.x * n + e] = y[e];
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
  const size_t smem = solve_smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      blocklu_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocklu_solve_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      lu, linv, uinv, b, n, N, x);
  return (int)cudaGetLastError();
}

extern "C" const char* rac2d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
