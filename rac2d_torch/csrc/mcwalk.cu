// Monte Carlo dust transport for NVIDIA Hopper (sm_90a): the packet walk
// (K3, mc_walk_kernel) and the terminal tally fold (K4,
// fold_terminal_kernel), f32, with a plain C interface for ctypes
// (wrappers, argument checks and the struct mirrors:
// rac2d_torch/ops/kernels.py; plain PyTorch twins: rac2d_torch/ops/mcrt.py
// _walk_plain and _fold_terminal_plain).
//
// What they replace.  The JAX package's walk, rac2d_tpu/ops/mcrt.py
// _mc_walk (:349-829), is plain JAX: each step is a batch of indexed ops
// under lax.scan, with the tallies leaving the loop as an event log that
// is scattered after the scan (:744-815), because an in-loop scatter was
// slow on the TPU.  The TPU toolchain probes tools/probe_pallas2.py,
// probe_pallas3.py and probe_pallas_gather.py (P1-P3) measured the
// primitives of that walk as Pallas kernels: row and flat gathers of the
// cell/optics/re-emission tables, chains of dependent gathers inside one
// kernel, in-kernel RNG, and scatter-adds.  Here those primitives are what
// one CUDA thread does per packet: indexed loads through the read-only
// path, the step loop inside the kernel, xorshift128 in registers, and
// atomicAdd into the tallies inside the step (no event log).  K4 computes
// _fold_terminal (:832-897): the escape collector (the scatter-add of
// P1-C and P3-4), the image-plane bins and the water deposit; it also
// counts the lanes of each status code for the pass's fates.
//
// Semantics.  K3 computes what _mc_walk(..., finalize=False) computes for
// max_steps steps, per lane, in the same f32 operation order (built with
// --fmad=false and without fast math): the xorshift128 + Knuth scramble
// stream with 10 draws per step, the event-channel running sum in the
// JAX channel order, truncating float->int conversions, first-true event
// selection.  Unlike JAX, a lane leaves the loop once it is no longer
// ST_ACTIVE, so a dead lane's RNG words stop advancing (they are never
// read again).  Tallies are added in another order than the JAX fold, so
// they agree to f32 roundoff, not bit for bit.  Two departures from the
// JAX walk, made in _walk_plain too, end lanes that it walks for ever: a
// crossing through a z face lands strictly past the face, and a stuck
// lane whose relocation leaves it where it was ends as ST_PREMATURE.
//
// What bounds them on this card, and what the design does about it.
//   K3 is neither bytes- nor FLOP-bound: a 64-step chunk of 262144 lanes
//   moves 35 MB (0.01 ms at 3.35 TB/s), but each lane-step issues a few
//   thousand instructions of precise libm (logf, sincosf, sqrtf,
//   divisions; 2800 SASS instructions in the kernel) behind chains of
//   dependent table reads that stay in L2, and branches on its own event.
//   Stage timers (k3_stages.py, -DRAC2D_K3_STAGES) found that in the
//   first layout, one thread per lane over a grid covering the batch,
//   about half of the threads' cycles went idle: about 68% of a fresh
//   chunk's lanes stop inside the chunk, and a warp ran on to its last
//   live lane.  The busy cycles went first to the optics and Lyman-alpha
//   rows, then locate, the new direction and wavelength, the cell row
//   and the draws; the tallies took about 1%.  So K3 runs a persistent
//   grid (K3_MIN_BLOCKS CTAs of K3_THREADS per SM, the most threads that
//   keep every value in registers) in which a thread whose lane stops
//   takes the next unwalked lane from a global counter, one atomicAdd a
//   warp: warps stay full until the batch runs out.  A new wavelength,
//   its re-emission quantile and the scattering angles are computed only
//   for lanes that take them, and an MRW step leaves the step at once.
//   The tables stay behind __ldg: staging the locate and optics tables in
//   shared memory (cp.async, once per CTA) measured no faster, and the
//   warp-aggregated tally atomics were not tried for a stage of 1%.  What
//   stays idle (about a third) is the drain of the chunk's last lanes,
//   each walking up to max_steps steps after the counter runs out.
//   K4 moves little (a status per lane, eight fields per escaped lane:
//   3.6 MB, 0.001 ms at 3.35 TB/s, at 262144 lanes after a 64-step
//   chunk), so what bounds it is latency: a status load, then the escaped
//   lanes' field loads, then precise libm math, then atomics, behind a
//   launch.  Two things cost the most on the H100 (measured, PERF.md):
//   same-address global atomics on the collector's few crowded bins and
//   on the fate counters, and too few warps to hide the load-then-math
//   chain (four lanes a thread measured slower than two).  So a
//   thread takes two lanes (an int2 status load, a warp 64 lanes), its
//   warp lists the escaped ones and takes them two a thread with all
//   field loads issued first, the collector goes through a histogram in
//   shared memory per CTA, the fate counts through shared memory, and the
//   grid is sized from the device's SMs and the kernel's occupancy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

// The argument structs are outside the anonymous namespace: the exported
// C functions take them.
// Field for field the Python mirror kernels._WalkArgs.
struct WalkArgs {
  float *x, *y, *z, *vx, *vy, *vz, *lam, *en, *tau;
  int *cell, *status, *e_count;
  unsigned *rs0, *rs1, *rs2, *rs3;
  const float *cellmat, *tabmat, *lya_pair, *reemit_lam, *mrw_lnx,
      *r_lut_pack, *zc_pack;
  float *flux, *mrw_path, *phc, *en_gain_abso, *cr_count, *dir_flux;
  int* counters;   // [0] lanes still active after the launch, [1] the
                   // next unwalked lane; zeroed by rac2d_mc_walk
  unsigned long long* stage_clk;   // [K3_STAGES], RAC2D_K3_STAGES builds
  int B, max_steps, n_cells, nlam, n_dust, C, K, nT, n_quantile, n_mrw,
      n_tlya, n_lut, ncol, max_nz, nmax_encounter, use_mrw, save_counts,
      save_dir;
  int seg_i0[3], seg_n[3];
  int lya_i0, lya_n2;
  float lam_lo, lam_hi, xr_lo, xr_hi, lnT0, inv_dlnT, td_cold, lnT_lo_lya,
      inv_dlnT_lya, mrw_gamma, mrw_lam_min, star_k, r_lut_log0, r_lut_inv_d,
      rmin_dom, rmax_dom, zmax_dom;
  float seg_log0[3], seg_inv_d[3];
  float b_mid, b_lya, b_high, lya_a, lya_inv_d, lya_K, lam0, lya_xmin;
};

// Field for field the Python mirror kernels._FoldArgs.
struct FoldArgs {
  const float *x, *y, *z, *vx, *vy, *vz, *lam, *en;
  const int *cell, *status;
  float *collector, *collector_img, *ab_en_water;
  unsigned long long* fates;   // [N_CODES] lanes per status code, or null
  double seg_log0[3], seg_inv_d[3];
  double b_mid, b_lya, b_high;
  int B, nlam, n_mu, n_r, n_phi, n_cells;
  int seg_i0[3], seg_n[3];
  int lya_i0, lya_n2;
  float lya_a, lya_inv_d, lya_K, lam0, lya_xmin, r0, log_ratio;
};

namespace {

constexpr int ST_ACTIVE = 0, ST_ESCAPED = 1, ST_DESTRUCTED = 2,
              ST_PREMATURE = 3, ST_DESTR_WATER = 5;
constexpr int MAX_DUST = 4;
// K3's CTA: threads, and CTAs per SM that __launch_bounds__ asks the
// register allocation to allow.  384 x 2 is the widest shape measured
// (PERF.md, "CTA shapes") that spills nothing.
constexpr int K3_THREADS = 384;
constexpr int K3_MIN_BLOCKS = 2;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_V = 2;     // lanes a K4 thread takes at a time (an int2)
constexpr int N_CODES = 6;    // status codes 0-5 that K4 counts
constexpr float AU2CM = 1.49597871e13f;
constexpr float C_CGS = 2.99792458e10f;
constexpr float FL_BIG = 1e30f, MIN_LEN = 1e-30f, MIN_VZ = 1e-20f;
constexpr float MIN_VXY = 1e-30f, MIN_LEN_FRAC = 1e-6f;
constexpr float F32_ULP8 = 8.0f * 1.1920928955078125e-07f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float PI_F = 3.141592653589793f;
constexpr float PI2 = 9.869604401089358f;

// Stage timers of K3's step (kernels.K3_STAGE_NAMES): a build with
// -DRAC2D_K3_STAGES adds each stage's clock() cycles per thread and sums
// them into a.stage_clk; other builds compile them away.
constexpr int K3_STAGES = 11;
struct StageClock {
#ifdef RAC2D_K3_STAGES
  unsigned c[K3_STAGES];
  unsigned last;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < K3_STAGES; ++k) c[k] = 0;
    last = (unsigned)clock();
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned t = (unsigned)clock();
    c[k] += t - last;
    last = t;
  }
  // a lane-less thread's wait for its warp lands in stage k
  __device__ __forceinline__ void sync_mark(int k) {
    __syncwarp();
    mark(k);
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (out == nullptr) return;
#pragma unroll
    for (int k = 0; k < K3_STAGES; ++k)
      atomicAdd(out + k, (unsigned long long)c[k]);
  }
#else
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void sync_mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
#endif
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// Marsaglia xorshift128 + Knuth multiplicative scramble, top 24 bits.
struct Xorshift {
  uint32_t s0, s1, s2, s3;
  __device__ __forceinline__ float next() {
    uint32_t t = s3 ^ (s3 << 11);
    t = t ^ (t >> 8);
    t = t ^ s0 ^ (s0 >> 19);
    s3 = s2;
    s2 = s1;
    s1 = s0;
    s0 = t;
    return (float)((t * 2654435761u) >> 8) * (1.0f / 16777216.0f);
  }
};

// The Lyman-alpha ladder part of lam_to_bin (f32 in both callers).
template <class A>
__device__ __forceinline__ int lya_bin(const A& a, float lam) {
  float dl = a.lam0 - lam;
  float adx = fabsf(dl) * a.lya_K * (a.lam0 / lam);
  float t = (log10f(fmaxf(adx, 1e-30f)) - a.lya_a) * a.lya_inv_d;
  int n2 = a.lya_n2;
  int m_pos = (int)clampf(ceilf(t), 0.f, (float)(n2 - 1));
  int k_pos = n2 - 1 - m_pos;
  int m_neg = (int)clampf(floorf(t), 0.f, (float)(n2 - 1));
  int k_neg = adx < a.lya_xmin ? n2 - 1 : n2 + m_neg;
  return a.lya_i0 + (dl > 0.f ? k_pos : k_neg);
}

// lam_to_bin with the segment constants in f32 (the walk).
__device__ int lam_to_bin32(const WalkArgs& a, float lam) {
  float ll = logf(fmaxf(lam, 1e-30f));
  auto lu = [&](int k) {
    int j = (int)floorf((ll - a.seg_log0[k]) * a.seg_inv_d[k]);
    return a.seg_i0[k] + clampi(j, 0, a.seg_n[k] - 1);
  };
  int i = lu(0);
  if (lam >= a.b_mid) i = lu(1);
  if (lam >= a.b_lya) i = lya_bin(a, lam);
  if (lam >= a.b_high) i = lu(2);
  return i;
}

// lam_to_bin with the segment constants in f64 (the terminal fold reads
// the host tables' f64 values, as JAX's _fold_terminal does).
__device__ int lam_to_bin64(const FoldArgs& a, float lam) {
  double ll = (double)logf(fmaxf(lam, 1e-30f));
  double lamd = (double)lam;
  auto lu = [&](int k) {
    int j = (int)floor((ll - a.seg_log0[k]) * a.seg_inv_d[k]);
    return a.seg_i0[k] + clampi(j, 0, a.seg_n[k] - 1);
  };
  int i = lu(0);
  if (lamd >= a.b_mid) i = lu(1);
  if (lamd >= a.b_lya) i = lya_bin(a, lam);
  if (lamd >= a.b_high) i = lu(2);
  return i;
}

struct Exit {
  float length, eps;
  bool found;
  int side;   // the first candidate at the min: 0 top, 1 bottom, 2-5 cylinders
  float s;    // mirror sign of z (ray_exit_mirror)
};

// geometry.ray_cell_exit: six candidate surfaces, masked min.
__device__ Exit ray_exit(float x, float y, float z, float vx, float vy,
                         float vz, float rmin, float rmax, float zmin,
                         float zmax) {
  float L[6];
  bool vz_ok = fabsf(vz) >= MIN_VZ;
  float vzs = vz_ok ? vz : 1.f;
  L[0] = vz_ok ? (zmax - z) / vzs : -1.f;
  L[1] = vz_ok ? (zmin - z) / vzs : -1.f;
  float rmin2 = rmin * rmin, rmax2 = rmax * rmax;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float tx = x + L[k] * vx, ty = y + L[k] * vy;
    float rr = tx * tx + ty * ty;
    if (!(L[k] >= 0.f && rr >= rmin2 && rr <= rmax2)) L[k] = -1.f;
  }
  float A = vx * vx + vy * vy;
  float Bq = 2.f * (x * vx + y * vy);
  float rr0 = x * x + y * y;
  bool A_ok = fabsf(A) > MIN_VXY;
  float As = A_ok ? A : 1.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float Cq = rr0 - (k == 0 ? rmin2 : rmax2);
    float D = Bq * Bq - 4.f * A * Cq;
    bool ok = D > 0.f && A_ok;
    float sq = sqrtf(fmaxf(D, 0.f));
    float La = (-Bq + sq) / (2.f * As);
    float Lb = (-Bq - sq) / (2.f * As);
    float za = z + vz * La, zb = z + vz * Lb;
    L[2 + 2 * k] = (ok && za >= zmin && za <= zmax) ? La : -1.f;
    L[3 + 2 * k] = (ok && zb >= zmin && zb <= zmax) ? Lb : -1.f;
  }
  float length = FL_BIG;
  bool found = false;
  int side = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    bool valid = L[k] > MIN_LEN;
    found = found || valid;
    if (valid && L[k] < length) {
      length = L[k];
      side = k;
    }
  }
  float pos_scale = fabsf(x) + fabsf(y) + fabsf(z) + length;
  float eps = fmaxf(fminf(rmax - rmin, zmax - zmin) * MIN_LEN_FRAC,
                    pos_scale * F32_ULP8);
  return {found ? length : 0.f, eps, found, side, 1.f};
}

__device__ __forceinline__ Exit ray_exit_mirror(float x, float y, float z,
                                                float vx, float vy, float vz,
                                                float rmin, float rmax,
                                                float zmin, float zmax) {
  float s = (z >= zmin && z <= zmax) ? 1.f : -1.f;
  Exit e = ray_exit(x, y, z * s, vx, vy, vz * s, rmin, rmax, zmin, zmax);
  e.s = s;
  return e;
}

// geometry.locate, packed f32 path: two row reads; the count of z edges
// <= |z| by binary search over the sorted ladder (+inf padded).
__device__ __forceinline__ int locate(const WalkArgs& a, float rsq,
                                      float zabs) {
  float r = sqrtf(rsq);
  int slot = (int)floorf((logf(fmaxf(r, 1e-30f)) - a.r_lut_log0) *
                         a.r_lut_inv_d);
  slot = clampi(slot, 0, a.n_lut - 1);
  const float* prow = a.r_lut_pack + 3 * (size_t)slot;
  int ic = (int)ld(prow) + (r >= ld(prow + 2) ? 1 : 0) -
           (r < ld(prow + 1) ? 1 : 0);
  ic = clampi(ic, 0, a.ncol - 1);
  const int W = 2 * a.max_nz + 1;
  const float* zc = a.zc_pack + (size_t)ic * W;
  int lo = 0, hi = a.max_nz + 1;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ld(zc + mid) <= zabs) lo = mid + 1; else hi = mid;
  }
  int iz = clampi(lo - 1, 0, a.max_nz - 1);
  int cell = (int)ld(zc + a.max_nz + 1 + iz);
  float z0 = ld(zc);
  bool inside = r >= a.rmin_dom && r <= a.rmax_dom && zabs <= a.zmax_dom &&
                zabs >= z0 && cell >= 0;
  return inside ? cell : -1;
}

__device__ __forceinline__ float doppler(float k, float x, float y, float z,
                                         float vx, float vy) {
  float rr = x * x + y * y;
  float r3 = sqrtf(rr + z * z);
  float v = sqrtf(k / fmaxf(r3, 1e-30f));
  return (-y * vx + x * vy) * v / sqrtf(fmaxf(rr, 1e-30f));
}

// io/bethell.dust_blanketing for f32: the closed form cancels below
// tau ~ 0.1, so tau < 0.3 takes its Taylor series.
__device__ __forceinline__ float blanketing(float sraw, float G, float a) {
  float tau = sraw / fmaxf(G, 0.f) * 0.477464829275686f / fmaxf(a * a, 0.f);
  tau = fmaxf(tau, 1e-8f);
  float f;
  if (tau < 0.3f)
    f = 1.f + tau * (-0.375f +
                     tau * (0.1f + tau * (-1.f / 48.f + tau * (1.f / 280.f))));
  else
    f = 1.5f / tau *
        (1.f - 2.f / (tau * tau) *
                   (1.f - (tau + 1.f) * expf(-fminf(tau, 200.f))));
  return sraw > 0.f ? f : 1.f;
}

__device__ __forceinline__ float thomson_cost(float u) {
  float y = 8.f * u - 4.f;
  float x = y / 3.5f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x = x - (x * x * x + 3.f * x - y) / (3.f * x * x + 3.f);
  return clampf(x, -1.f, 1.f);
}

__device__ __forceinline__ float hg_cost(float u, float g) {
  bool small = fabsf(g) <= 1e-2f;
  float gs = small ? 1.f : g;
  float t = (1.f - g * g) / (1.f + g * (2.f * u - 1.f));
  float ch = 0.5f / gs * (1.f + g * g - t * t);
  return clampf(small ? 2.f * u - 1.f : ch, -1.f, 1.f);
}

// One packet's state, in registers while it walks.
struct Lane {
  float x, y, z, vx, vy, vz, lam, tau, en;
  int cell, status, ecount;
  Xorshift rng;
};

__device__ __forceinline__ void load_lane(const WalkArgs& a, int i, Lane& p) {
  p.x = a.x[i]; p.y = a.y[i]; p.z = a.z[i];
  p.vx = a.vx[i]; p.vy = a.vy[i]; p.vz = a.vz[i];
  p.lam = a.lam[i]; p.tau = a.tau[i]; p.en = a.en[i];
  p.cell = a.cell[i]; p.status = a.status[i]; p.ecount = a.e_count[i];
  p.rng = {a.rs0[i], a.rs1[i], a.rs2[i], a.rs3[i]};
}

__device__ __forceinline__ void store_lane(const WalkArgs& a, int i,
                                           const Lane& p) {
  a.x[i] = p.x; a.y[i] = p.y; a.z[i] = p.z;
  a.vx[i] = p.vx; a.vy[i] = p.vy; a.vz[i] = p.vz;
  a.lam[i] = p.lam; a.tau[i] = p.tau;
  a.cell[i] = p.cell; a.status[i] = p.status; a.e_count[i] = p.ecount;
  a.rs0[i] = p.rng.s0; a.rs1[i] = p.rng.s1;
  a.rs2[i] = p.rng.s2; a.rs3[i] = p.rng.s3;
}

// One walk step of an ST_ACTIVE lane: _walk_plain's step body in its f32
// operation order, with the tallies added by atomics.
__device__ __forceinline__ void walk_step(const WalkArgs& a, Lane& p,
                                          StageClock& sc) {
  float x = p.x, y = p.y, z = p.z, vx = p.vx, vy = p.vy, vz = p.vz;
  float lam = p.lam, tau = p.tau;
  const float en = p.en;
  const int cellv = p.cell, status = p.status, ecount = p.ecount;
  const int nd = a.n_dust;
  const int c_mfp = 12 + 3 * nd, c_base = 13 + 3 * nd;
  const float fnq = (float)a.n_quantile;

  float u[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) u[k] = p.rng.next();
  const float u_tau = fmaxf(u[0], 1e-12f);
  const float u_ev = u[1], u_d1 = u[2], u_d2 = u[3], u_q = u[4];
  sc.mark(0);

  const int cell = clampi(cellv, 0, a.n_cells - 1);
  const float* crow = a.cellmat + (size_t)cell * a.C;
  const float rmin = ld(crow), rmax = ld(crow + 1);
  const float zmin = ld(crow + 2), zmax = ld(crow + 3);
  const bool using_c = ld(crow + 4) > 0.5f;
  const float n_gas = ld(crow + 5), n_HI = ld(crow + 6);
  const float n_H2O = ld(crow + 7);
  const float Tg = fmaxf(ld(crow + 8), 1.f);

  // Modified Random Walk: inscribed-sphere radius and the test
  if (a.use_mrw) {
    float r_pk = sqrtf(x * x + y * y);
    float az = fabsf(z);
    float dz_lo = zmin <= 0.f ? FL_BIG : az - zmin;
    const float R0 =
        fminf(fminf(r_pk - rmin, rmax - r_pk), fminf(dz_lo, zmax - az)) *
        0.999f;
    if (using_c && lam > a.mrw_lam_min &&
        (R0 * AU2CM * ld(crow + c_mfp) > a.mrw_gamma)) {
      // MRW diffusion step: first-passage path, exit on the sphere with
      // a thermal wavelength.  The rest of the step leaves such a lane's
      // cell, status and tallies as they are (it is not active there), so
      // it ends here; the plain walk computes the rest and discards it.
      sc.mark(1);
      float lnx = ld(a.mrw_lnx +
                     clampi((int)(u[5] * (float)a.n_mrw), 0, a.n_mrw - 1));
      float R0cm = R0 * AU2CM;
      float L_cm =
          fmaxf(-3.f * R0cm * R0cm * ld(crow + c_mfp) * lnx / PI2, R0cm);
      atomicAdd(a.mrw_path + cell, L_cm / AU2CM * en);
      const int iqm = clampi((int)(u[7] * fnq), 0, a.n_quantile - 1);
      float mw = 2.f * u[6] - 1.f;
      float mphi = TWO_PI * u[8];
      float ms = sqrtf(fmaxf(1.f - mw * mw, 0.f));
      float msn, mcs;
      sincosf(mphi, &msn, &mcs);
      float mx = ms * mcs, my = ms * msn, mz = mw;
      p.x = x + R0 * mx;
      p.y = y + R0 * my;
      p.z = z + R0 * mz;
      p.vx = mx;
      p.vy = my;
      p.vz = mz;
      p.lam = ld(a.reemit_lam + (int)ld(crow + c_base) + iqm);
      p.tau = -logf(fmaxf(u[9], 1e-12f));
      p.ecount = ecount + 1;
      sc.mark(8);
      return;
    }
  }
  sc.mark(1);

  const Exit ex = ray_exit_mirror(x, y, z, vx, vy, vz, rmin, rmax, zmin, zmax);
  // a ray that misses its own cell relocates (below)
  const bool stuck = !ex.found, active = ex.found;
  sc.mark(2);

  const float vd = doppler(a.star_k, x, y, z, vx, vy);
  const float lam_local = lam * (1.f + vd / C_CGS);
  const int ilam = lam_to_bin32(a, lam_local);
  const bool in_grid = lam_local >= a.lam_lo && lam_local < a.lam_hi;
  const bool usingm = using_c && in_grid;
  const float tT = clampf((logf(Tg) - a.lnT_lo_lya) * a.inv_dlnT_lya, 0.f,
                          (float)(a.n_tlya - 1));
  const int iT = (int)tT;
  const float fT = tT - (float)iT;
  const float* sl = a.lya_pair + 2 * ((size_t)ilam * a.n_tlya + iT);
  const float sigma_lya = ld(sl) * (1.f - fT) + ld(sl + 1) * fT;
  const float* trow = a.tabmat + (size_t)ilam * a.K;
  const float ab_gas = ld(trow) * n_gas;
  const float sc_gas = ld(trow + 1) * n_gas + sigma_lya * n_HI;
  const float ab_h2o = ld(trow + 2) * n_H2O;
  float ab_d[MAX_DUST], sc_d[MAX_DUST];
  float sum_ab = 0.f, sum_sc = 0.f;
#pragma unroll
  for (int d = 0; d < MAX_DUST; ++d) {
    ab_d[d] = sc_d[d] = 0.f;
    if (d < nd) {
      float rho = ld(crow + 12 + 3 * d);
      float ab = ld(trow + 5 + 3 * d) * rho;
      float sc = ld(trow + 6 + 3 * d) * rho;
      if (d == nd - 1) {
        // X-ray dust terms ride on the last component
        float epsd = ld(crow + 9);
        float sraw = ld(trow + 3) * epsd;
        float f = blanketing(sraw, ld(crow + 10), ld(crow + 11));
        ab = ab + f * sraw * n_gas;
        sc = sc + ld(trow + 4) * n_gas * epsd;
      }
      ab_d[d] = ab;
      sc_d[d] = sc;
      sum_ab = sum_ab + ab;
      sum_sc = sum_sc + sc;
    }
  }
  const float ext_ab = ab_gas + ab_h2o + sum_ab;
  const float ext_sc = sc_gas + sum_sc;
  const float ext_tot = usingm ? ext_ab + ext_sc : 0.f;
  sc.mark(3);

  const float tau_this = ext_tot * AU2CM * ex.length;
  const bool enc = tau_this >= tau && active && tau_this > 0.f;
  const float move_len = enc ? ex.length * tau / fmaxf(tau_this, 1e-33f)
                             : ex.length + ex.eps;
  const float nx = x + vx * move_len;
  const float ny = y + vy * move_len;
  float nz = z + vz * move_len;
  // a crossing through a z face ends strictly past the face: at a grazing
  // angle vz * eps is below one ulp of z, and a packet left on its cell's
  // bottom face is located back in that cell (the JAX walk keeps it
  // there; see _walk_plain)
  if (active && !enc && ex.side <= 1) {
    const float face = ex.s * (ex.side == 0 ? zmax : zmin);
    const bool up = vz > 0.f;
    const float past = nextafterf(face, up ? INFINITY : -INFINITY);
    nz = up ? fmaxf(nz, past) : fminf(nz, past);
  }
  const bool tmask = active && usingm;
  const float wflux = tmask ? move_len * en : 0.f;

  // event selection: the first channel whose running sum exceeds u *
  // total, channels in the JAX order (gas abs, gas sca, water, 0, then
  // abs/sca per dust)
  float tot = ab_gas;
  tot = tot + sc_gas;
  tot = tot + ab_h2o;
  tot = tot + 0.f;
#pragma unroll
  for (int d = 0; d < MAX_DUST; ++d)
    if (d < nd) {
      tot = tot + ab_d[d];
      tot = tot + sc_d[d];
    }
  const float u_ev2 = u_ev * tot;
  int ev = 0;
  {
    bool got = false;
    float cum = 0.f;
    auto chk = [&](float pr, int ch) {
      cum = cum + pr;
      if (!got && cum > u_ev2) {
        ev = ch;
        got = true;
      }
    };
    chk(ab_gas, 0);
    chk(sc_gas, 1);
    chk(ab_h2o, 2);
    chk(0.f, 3);
#pragma unroll
    for (int d = 0; d < MAX_DUST; ++d)
      if (d < nd) {
        chk(ab_d[d], 4 + 2 * d);
        chk(sc_d[d], 5 + 2 * d);
      }
  }
  const bool is_x = lam_local >= a.xr_lo && lam_local <= a.xr_hi;
  const bool ev_gas_abs = enc && ev == 0;
  const bool ev_gas_sca = enc && ev == 1;
  const bool ev_h2o_abs = enc && ev == 2;
  const int idust_ev = clampi(ev >= 4 ? (ev - 4) / 2 : -1, 0, nd - 1);
  const bool ev_dust = enc && ev >= 4;
  const bool ev_dust_abs = ev_dust && (ev % 2 == 0);
  const bool ev_dust_sca = ev_dust && (ev % 2 == 1);
  const bool dust_abs_keep = ev_dust_abs && !is_x;
  sc.mark(4);

  // new directions
  const float phi = TWO_PI * u_d2;
  const float g_pk = ld(trow + 7 + 3 * idust_ev);
  float cost_sca;
  if (ev_gas_sca && is_x) cost_sca = thomson_cost(u_d1);
  else if (ev_dust_sca) cost_sca = hg_cost(u_d1, g_pk);
  else cost_sca = 2.f * u_d1 - 1.f;
  const bool scatterish = ev_gas_sca || ev_dust_sca;
  const bool reemitish = dust_abs_keep;
  float nvx = vx, nvy = vy, nvz = vz;
  if (scatterish || reemitish) {
    float sphi, cphi;
    sincosf(phi, &sphi, &cphi);
    if (scatterish) {
      // rotate (sint cos phi, sint sin phi, cost) from the z axis into the
      // frame of (vx, vy, vz)
      float sint = sqrtf(fmaxf(1.f - cost_sca * cost_sca, 0.f));
      float ux = sint * cphi, uy = sint * sphi, uz = cost_sca;
      float st = sqrtf(fmaxf(1.f - vz * vz, 0.f));
      bool safe = st > 0.f;
      float cp = safe ? vx / st : 0.f;
      float sp = safe ? vy / st : 1.f;
      float ux2 = ux * vz + uz * st;
      float uz2 = uz * vz - ux * st;
      nvx = ux2 * cp - uy * sp;
      nvy = uy * cp + ux2 * sp;
      nvz = uz2;
    } else {
      float rz = 2.f * u_d1 - 1.f;
      float rs = sqrtf(fmaxf(1.f - rz * rz, 0.f));
      nvx = cphi * rs;
      nvy = sphi * rs;
      nvz = rz;
    }
  }

  // new wavelengths, computed only where a lane takes them: Doppler-
  // shifted out after a scattering; a warm re-emission draws from the
  // re-emission quantiles at the frozen Tdust
  const float Td = ld(crow + 13 + 3 * idust_ev);
  const bool cold = Td <= a.td_cold;
  float new_lam = lam;
  if (scatterish) {
    const float vd_new = doppler(a.star_k, nx, ny, nz, nvx, nvy);
    new_lam = lam_local * (1.f - vd_new / C_CGS);
  } else if (reemitish && !cold) {
    const int itd = (int)clampf(
        ceilf((logf(fmaxf(Td, 1e-30f)) - a.lnT0) * a.inv_dlnT), 0.f,
        (float)(a.nT - 1));
    const int iq = clampi((int)(u_q * fnq), 0, a.n_quantile - 1);
    new_lam = ld(a.reemit_lam + (idust_ev * a.nT + itd) * a.n_quantile + iq);
  }
  sc.mark(5);

  // status updates
  const bool destro_water = enc && ev_h2o_abs;
  const bool destro = enc && (ev_gas_abs || (ev_dust_abs && is_x) ||
                              (dust_abs_keep && cold));
  int new_status = (active && destro) ? ST_DESTRUCTED : status;
  if (active && destro_water) new_status = ST_DESTR_WATER;
  const int ec2 = ecount + ((enc || stuck) ? 1 : 0);
  if ((active || stuck) && ec2 >= a.nmax_encounter) new_status = ST_PREMATURE;

  // non-encounter: next cell or escape; stuck lanes relocate
  const bool crossed = active && !enc;
  const float rsq_new = stuck ? x * x + y * y : nx * nx + ny * ny;
  const float z_q = stuck ? z : nz;
  const int ncl = locate(a, rsq_new, fabsf(z_q));
  const bool escaped = (crossed || stuck) && ncl < 0;
  if (escaped) new_status = ST_ESCAPED;
  const int new_cell = (crossed || stuck) ? max(ncl, 0) : cellv;
  const bool stuck_same = stuck && ncl == cellv;
  float s_r = 1.f, z_t = 0.f;
  if (stuck_same) {
    float rc = sqrtf(rsq_new);
    float r_t = fminf(fmaxf(rc, rmin * 1.000002f), rmax * 0.999998f);
    s_r = r_t / fmaxf(rc, 1e-30f);
    float dz6 = 2e-6f * (zmax - zmin);
    float sg = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
    z_t = sg * fminf(fmaxf(fabsf(z), zmin + dz6), zmax - dz6);
    // a relocation that leaves the packet where it was is a fixed point
    // (stuck again at every step, tallying nothing) that would walk to
    // the encounter cap: it ends now, with the cap's fate
    if (x * s_r == x && y * s_r == y && z_t == z) new_status = ST_PREMATURE;
  }
  float new_tau = tau - tau_this;
  if (enc) new_tau = -logf(u_tau);
  new_tau = fmaxf(new_tau, 0.f);
  sc.mark(6);

  // tallies (they read this step's state before its update)
  if (tmask) {
    const int flat = cell * a.nlam + ilam;
    atomicAdd(a.flux + flat, wflux);
    if (a.save_counts) atomicAdd(a.phc + flat, 1.f);
    if (a.save_dir) {
      atomicAdd(a.dir_flux + 3 * cell, wflux * vx);
      atomicAdd(a.dir_flux + 3 * cell + 1, wflux * vy);
      atomicAdd(a.dir_flux + 3 * cell + 2, wflux * vz);
    }
  }
  if (a.save_counts) {
    if (dust_abs_keep && active)
      atomicAdd(a.en_gain_abso + idust_ev * a.n_cells + cell, en);
    else if (crossed && !escaped)
      atomicAdd(a.cr_count + new_cell, 1.f);
  }
  sc.mark(7);

  if (stuck_same) {
    x = x * s_r;
    y = y * s_r;
    z = z_t;
  } else if (active) {
    x = nx;
    y = ny;
    z = nz;
  }
  if (enc) {
    vx = nvx;
    vy = nvy;
    vz = nvz;
    lam = new_lam;
  }
  if (enc || crossed) tau = new_tau;
  p.x = x; p.y = y; p.z = z;
  p.vx = vx; p.vy = vy; p.vz = vz;
  p.lam = lam; p.tau = tau;
  p.cell = new_cell;
  p.status = new_status;
  p.ecount = ec2;
  sc.mark(8);
}

// K3: a persistent grid (a few CTAs per SM, sized by the occupancy of
// this kernel); each thread walks lanes one after another.  A thread
// whose lane stops (no longer ST_ACTIVE, or max_steps steps taken) stores
// it and takes the next unwalked lane of the batch from a global counter
// (one atomicAdd a warp for all its threads that need one), so warps stay
// full while lanes die; lanes that arrive stopped cost one status read.
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
    mc_walk_kernel(const WalkArgs a) {
  StageClock sc;
  sc.init();
  const unsigned FULL = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  Lane p;
  int i = 0, steps = 0, n_alive = 0;
  bool have = false, done = false;
  for (;;) {
    // hand-off: threads without a lane take the next ones of the batch
    for (;;) {
      const bool need = !have && !done;
      const unsigned m = __ballot_sync(FULL, need);
      if (m == 0) break;
      const int leader = __ffs(m) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(a.counters + 1, __popc(m));
      base = __shfl_sync(FULL, base, leader);
      if (need) {
        i = base + __popc(m & ((1u << lane) - 1u));
        if (i >= a.B) {
          done = true;
        } else if (a.status[i] == ST_ACTIVE) {
          load_lane(a, i, p);
          have = true;
          steps = 0;
        }
      }
    }
    sc.mark(9);
    if (!__any_sync(FULL, have)) break;
    if (have) {
      walk_step(a, p, sc);
      if (++steps == a.max_steps || p.status != ST_ACTIVE) {
        store_lane(a, i, p);
        n_alive += p.status == ST_ACTIVE ? 1 : 0;
        have = false;
      }
    }
    sc.sync_mark(10);
  }
  // live-lane count: one atomic per warp
  const int s = __reduce_add_sync(FULL, n_alive);
  if (lane == 0 && s) atomicAdd(a.counters, s);
  sc.flush(a.stage_clk);
}

// One escaped lane: its image-plane bin takes en; returns its collector
// bin imu * nlam + ilam.
__device__ __forceinline__ int fold_escaped(const FoldArgs& a, float x,
                                            float y, float z, float vx,
                                            float vy, float vz, float lam,
                                            float en) {
  const int imu = clampi((int)(fabsf(vz) * (float)a.n_mu), 0, a.n_mu - 1);
  const int ilam = clampi(lam_to_bin64(a, lam), 0, a.nlam - 1);
  // image-plane bins: displacement orthogonal to the ray, in a frame
  // with the ray as z axis (x-axis fallback near the pole)
  const float dotp = x * vx + y * vy + z * vz;
  const float rox = x - dotp * vx, roy = y - dotp * vy, roz = z - dotp * vz;
  const bool degen = fabsf(vz) >= 0.99f;
  const float uxn = sqrtf(fmaxf(vx * vx + vy * vy, 1e-30f));
  const float ux_x = degen ? 1.f : -vy / uxn;
  const float ux_y = degen ? 0.f : vx / uxn;
  const float ux_z = 0.f;
  const float uy_x = degen ? 0.f : vy * ux_z - vz * ux_y;
  const float uy_y = degen ? 1.f : vz * ux_x - vx * ux_z;
  const float uy_z = degen ? 0.f : vx * ux_y - vy * ux_x;
  const float r_o_x = rox * ux_x + roy * ux_y + roz * ux_z;
  const float r_o_y = rox * uy_x + roy * uy_y + roz * uy_z;
  const float r_img = sqrtf(r_o_x * r_o_x + r_o_y * r_o_y);
  const float phi_img = atan2f(r_o_y, r_o_x);
  int ir = clampi((int)(logf(fmaxf(r_img, 1e-30f) / a.r0) / a.log_ratio *
                        (float)(a.n_r - 1)) + 1,
                  0, a.n_r - 1);
  if (r_img < a.r0) ir = 0;
  const int iphi = clampi(
      (int)((phi_img + PI_F) / TWO_PI * (float)a.n_phi), 0, a.n_phi - 1);
  const size_t flat =
      ((size_t)((imu * a.n_r + ir) * a.n_phi + iphi)) * a.nlam + ilam;
  atomicAdd(a.collector_img + flat, en);
  return imu * a.nlam + ilam;
}

// K4.  Each warp takes 32 * FOLD_V consecutive lanes at a time (a
// warp-uniform grid-stride loop).  A thread loads the statuses of its
// FOLD_V lanes in one vector load, counts them per code, adds the water
// deposits of its water-destroyed lanes (cell and en loaded first), and
// the warp lists its escaped lanes in shared memory (ballot and prefix
// count, no atomics).  Then the warp's threads take the list's lanes,
// two each at a time: both lanes' eight field loads are issued before
// any math, so the math runs once per escaped lane in converged warps,
// with no barrier between warps.  The collector bins go to a histogram
// in shared memory (escaped lanes crowd into few of its n_mu * nlam
// bins, and global atomics on one address serialize), flushed with one
// global atomic per non-zero bin at the CTA's end; the image-plane bins
// and the water deposit take global atomics.  The lanes of each status
// code are summed per warp, then per CTA in shared memory, and added
// with one global atomic per CTA and code.
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_terminal_kernel(const FoldArgs a) {
  extern __shared__ float hist[];          // [n_mu * nlam]
  __shared__ int esc_list[FOLD_THREADS * FOLD_V];
  __shared__ unsigned long long cta_fates[N_CODES];
  const unsigned FULL = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int* wlist = esc_list + (threadIdx.x & ~31u) * FOLD_V;
  const int nbin = a.n_mu * a.nlam;
  for (int k = threadIdx.x; k < nbin; k += FOLD_THREADS) hist[k] = 0.f;
  if (threadIdx.x < N_CODES) cta_fates[threadIdx.x] = 0;
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(a.status) & 7u) == 0;
  const int ngroups = (a.B + FOLD_V - 1) / FOLD_V;
  int cnt[N_CODES];
#pragma unroll
  for (int c = 0; c < N_CODES; ++c) cnt[c] = 0;
  for (int g0 = blockIdx.x * FOLD_THREADS + (threadIdx.x & ~31u);
       g0 < ngroups; g0 += gridDim.x * FOLD_THREADS) {
    const int i0 = (g0 + (int)lane) * FOLD_V;
    int st[FOLD_V];
    if (vec && i0 + FOLD_V <= a.B) {
      const int2 s2 = __ldg(reinterpret_cast<const int2*>(a.status + i0));
      st[0] = s2.x;
      st[1] = s2.y;
    } else {
#pragma unroll
      for (int k = 0; k < FOLD_V; ++k)
        st[k] = i0 + k < a.B ? __ldg(a.status + i0 + k) : -1;
    }
    int wcell[FOLD_V];
    float wen[FOLD_V];
    int n = 0;
#pragma unroll
    for (int k = 0; k < FOLD_V; ++k) {
#pragma unroll
      for (int c = 0; c < N_CODES; ++c) cnt[c] += st[k] == c ? 1 : 0;
      if (st[k] == ST_DESTR_WATER) {
        wcell[k] = __ldg(a.cell + i0 + k);
        wen[k] = __ldg(a.en + i0 + k);
      }
      const unsigned m = __ballot_sync(FULL, st[k] == ST_ESCAPED);
      if (st[k] == ST_ESCAPED) wlist[n + __popc(m & lt)] = i0 + k;
      n += __popc(m);
    }
#pragma unroll
    for (int k = 0; k < FOLD_V; ++k)
      if (st[k] == ST_DESTR_WATER)
        atomicAdd(a.ab_en_water + clampi(wcell[k], 0, a.n_cells - 1),
                  wen[k]);
    __syncwarp();
    for (int j = (int)lane; j < n; j += 64) {
      const bool on[2] = {true, j + 32 < n};
      float f[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!on[r]) continue;
        const int i = wlist[j + 32 * r];
        f[r][0] = __ldg(a.x + i); f[r][1] = __ldg(a.y + i);
        f[r][2] = __ldg(a.z + i); f[r][3] = __ldg(a.vx + i);
        f[r][4] = __ldg(a.vy + i); f[r][5] = __ldg(a.vz + i);
        f[r][6] = __ldg(a.lam + i); f[r][7] = __ldg(a.en + i);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!on[r]) continue;
        const int key = fold_escaped(a, f[r][0], f[r][1], f[r][2], f[r][3],
                                     f[r][4], f[r][5], f[r][6], f[r][7]);
        atomicAdd(hist + key, f[r][7]);
      }
    }
    __syncwarp();
  }
  if (a.fates != nullptr) {
#pragma unroll
    for (int c = 0; c < N_CODES; ++c) {
      const int s = __reduce_add_sync(FULL, cnt[c]);
      if (lane == 0 && s) atomicAdd(cta_fates + c, (unsigned long long)s);
    }
  }
  __syncthreads();
  if (a.fates != nullptr && threadIdx.x < N_CODES && cta_fates[threadIdx.x])
    atomicAdd(a.fates + threadIdx.x, cta_fates[threadIdx.x]);
  for (int k = threadIdx.x; k < nbin; k += FOLD_THREADS)
    if (hist[k] != 0.f) atomicAdd(a.collector + k, hist[k]);
}

// K3's launch for these arguments.
struct WalkPlan {
  int threads, blocks_per_sm, grid, regs, local_bytes, smem, sms;
};

// What the plan takes from the device and the build (occupancy, SMs,
// registers), read once per device.
cudaError_t device_plan(int dev, WalkPlan* p) {
  cudaFuncAttributes fa;
  cudaError_t e =
      cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, mc_walk_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p->blocks_per_sm, mc_walk_kernel, K3_THREADS, 0);
  if (e != cudaSuccess) return e;
  p->threads = K3_THREADS;
  p->regs = fa.numRegs;
  p->local_bytes = (int)fa.localSizeBytes;
  p->smem = (int)fa.sharedSizeBytes;
  return cudaSuccess;
}

// A grid of (CTAs per SM by the kernel's occupancy) x SMs on the current
// device, no larger than a batch of B lanes needs.
cudaError_t walk_plan(int B, WalkPlan* p) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static WalkPlan cache[MAX_DEVICES];
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev]) {
      e = device_plan(dev, &cache[dev]);
      if (e != cudaSuccess) return e;
      ready[dev] = true;
    }
    *p = cache[dev];
  }
  const int need = (B + K3_THREADS - 1) / K3_THREADS;
  const int full = p->blocks_per_sm * p->sms;
  p->grid = full < need ? full : need;
  return cudaSuccess;
}

}  // namespace

// K3's launch: the counters zeroed on the stream, then the kernel.
extern "C" int rac2d_mc_walk(const WalkArgs* a, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(a->counters, 0, 2 * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (a->B <= 0) return (int)cudaGetLastError();
  WalkPlan p;
  e = walk_plan(a->B, &p);
  if (e != cudaSuccess) return (int)e;
  mc_walk_kernel<<<p.grid, p.threads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// K3's launch for these arguments, as 7 ints: threads per CTA, CTAs per
// SM, grid, registers and local memory bytes a thread, shared memory
// bytes a CTA, SMs.
extern "C" int rac2d_mc_walk_plan(const WalkArgs* a, int* out) {
  WalkPlan p;
  const cudaError_t e = walk_plan(a->B, &p);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {p.threads, p.blocks_per_sm, p.grid, p.regs,
                    p.local_bytes, p.smem, p.sms};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

namespace {

// K4's launch: CTAs per SM by the kernel's occupancy (with its
// histogram's shared memory) and SMs, read once per device; the grid is
// the smaller of what B lanes need (FOLD_V a thread) and a full card.
struct FoldPlan {
  int threads, blocks_per_sm, grid, regs, sms;
};

cudaError_t fold_device_plan(int dev, size_t smem, FoldPlan* p) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncSetAttribute(
      fold_terminal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fold_terminal_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p->blocks_per_sm, fold_terminal_kernel, FOLD_THREADS, smem);
  if (e != cudaSuccess) return e;
  p->threads = FOLD_THREADS;
  p->regs = fa.numRegs;
  return cudaSuccess;
}

cudaError_t fold_plan(const FoldArgs* a, FoldPlan* p) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static FoldPlan cache[MAX_DEVICES];
  static size_t cache_smem[MAX_DEVICES];
  static bool ready[MAX_DEVICES];
  const size_t smem = (size_t)a->n_mu * a->nlam * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev] || cache_smem[dev] != smem) {
      e = fold_device_plan(dev, smem, &cache[dev]);
      if (e != cudaSuccess) return e;
      cache_smem[dev] = smem;
      ready[dev] = true;
    }
    *p = cache[dev];
  }
  const int lanes = FOLD_THREADS * FOLD_V;
  const int need = (a->B + lanes - 1) / lanes;
  const int full = p->blocks_per_sm * p->sms;
  p->grid = full < need ? full : need;
  return cudaSuccess;
}

}  // namespace

extern "C" int rac2d_fold_terminal(const FoldArgs* a, cudaStream_t stream) {
  if (a->B <= 0) return (int)cudaGetLastError();
  FoldPlan p;
  const cudaError_t e = fold_plan(a, &p);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)a->n_mu * a->nlam * sizeof(float);
  fold_terminal_kernel<<<p.grid, p.threads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// K4's launch for these arguments, as 5 ints: threads per CTA, CTAs per
// SM, grid, registers a thread, SMs.
extern "C" int rac2d_fold_terminal_plan(const FoldArgs* a, int* out) {
  FoldPlan p;
  const cudaError_t e = fold_plan(a, &p);
  if (e != cudaSuccess) return (int)e;
  const int v[5] = {p.threads, p.blocks_per_sm, p.grid, p.regs, p.sms};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
  return 0;
}
