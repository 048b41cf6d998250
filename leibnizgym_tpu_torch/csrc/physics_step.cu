// TriFinger physics control step on an H100: solver rows built once per
// substep by a team of warps, kept in shared memory, swept by one lane per env.
// Beside it, fingertip_state_kernel computes the env's fingertip kinematics
// from the stepped joints (see its own note, near the end of this file).
//
// Replaces the TPU kernel leibnizgym_tpu/ops/pallas_engine.py::_kernel
// (launched by physics_step_pallas), whose body is
// leibnizgym_tpu/ops/engine_v2.py::_substep_fields. The plain PyTorch version
// of the same step is leibnizgym_tpu_torch/ops/engine_v2.py; this file
// computes what it computes, contact by contact and row by row in the same
// order (groups A, B, C, F, D, E in each iteration, then the TGS mini-step).
//
// What bounds it. One control step is ~2.9e5 elementwise operations per env
// at the training setting (4 substeps x 8 TGS iterations, every contact gate
// on; ops/cuda_engine.step_flops counts them from the plain version): at
// 8192 envs ~2.4 GFLOP, 0.036 ms at the card's 67 TFLOP/s in float32. The
// bytes (31 + 40 + 9 floats in, 31 + 18 out per env, 4.2 MB) take 1.3 us at
// 3.35 TB/s. So the bound is operations, but the step cannot reach it: each
// env is one Gauss-Seidel sweep, a sequential chain of row updates through
// the cube's and fingers' velocities. 8192 envs give 256 warps of sweeping
// lanes for 132 SMs, two per SM, so the time is one env's dependent chain.
// The first version of this kernel re-derived every row's Jacobian inside the
// sweep (~20-30 dependent ops per row) from per-contact records that spilled
// to local memory (255 registers, 3.5 KB of spill loads per thread), and
// built the rows with one thread per env (28.6% of its time at 8192 envs on
// the D1 state, H100 80GB HBM3 at 700 W; chip_smoke.py phase 4).
//
// What this design does about it:
//  - Rows built once per substep. Every row (a contact's normal, two
//    tangents and, where it applies, its torsion) is stored with what stays
//    frozen through the iterations: the cube direction d (linear part), the
//    angular part k_w, the finger part k_q and 1/w. The sweep runs in
//    mass-normalised velocities: the cube's angular velocity as
//    y = diag(sqrt(I)) R^-1 w (R^-1, not R^T: R from a quaternion a few ulps
//    off unit length is not exactly orthogonal) and each finger's joint
//    velocity as yq = L^T qd (M = L L^T, the finger's Cholesky factor). In them the
//    Jacobian and the response of a row are one vector:
//      k_w = sqrt(I^-1) R^T (r x d)   (u_w = (r x d).w, dw = I_w^-1 (r x d) dl)
//      k_q = -+ L^-1 J^T d            (u_q = -+(J^T d).qd, dqd = -+M^-1 J^T d dl)
//    so a row update is u = d.v + k_w.y + k_q.yq (at most 9 products), the
//    reference's normal_step / friction_step clamp (with 1/w stored, a
//    multiply where the reference divides), and v += (dl / m) d,
//    y += dl k_w, yq += dl k_q: at most 9 independent FMAs. Nothing of the
//    contact geometry, the cube inertia or the finger mass matrices is
//    evaluated inside the iteration loop.
//  - Rows kept on chip. 882 floats per env: rows 824 (A 8 x 18, B 8 x 31,
//    C 3 x 40, F 6 x 35, D 3 x 17, E 3 x 17, lambdas and TGS depths
//    included), the state handed between warps 31, the fingers' normalised
//    velocities and factors 27: 3,528 B. They live in shared memory laid out
//    [field][env-in-block], so a warp's lanes read consecutive words (no
//    bank conflicts) at offsets known when the kernel is compiled. The sweep
//    loads a contact's whole record at the contact's start, so its later rows
//    arrive ahead of their use and none is read on the chain twice; the
//    velocities (3 + 3 + 9) and per-env constants stay in registers, with no
//    spills (loading the next contact's record as well spilled and ran
//    slower on the H100; PERF.md).
//  - All 8192 envs in one wave. A block holds 32 envs (112,896 B of dynamic
//    shared memory, set with cudaFuncSetAttribute since it is above 48 KB)
//    and 4 warps, so an SM holds 2 blocks: 64 envs, 256 threads (255
//    registers each fit the 64K register file). 8192 envs are 256 blocks:
//    every env resident at once on 128+ SMs. leibniz_physics_step_occupancy
//    reports the resident blocks per SM; chip_smoke.py checks them.
//  - The build spread over a team. Per substep warp 0 builds the cube rows
//    (groups A, B) and warps 1-3 each build one finger (FK, mass matrix and
//    Cholesky, RNEA, free velocity) and its rows (groups C, F, D, E); a
//    barrier; warp 0 sweeps and integrates; a barrier; warps 1-3 sum their
//    finger's tip impulses while warp 0 builds the next substep's cube rows.
//  - One launch per control step, as before: the rollout is launch-bound.
//
// Every per-env function is LG_HD over a storage pointer and a stride fixed
// at compile time (Env<ST>): on the card ST is the envs per block (LG_EPB);
// the same source compiles as C++ for the host (g++ -x c++
// -DLG_REAL=double), where leibniz_physics_step_host runs the same phases
// one after another with ST = 1. Only the thread mapping is device-only.
//
// Numerics: no fast math. The normalised velocities, the stored 1/w and the
// row dot products associate sums differently from the plain version, and
// nvcc contracts a*b+c into FMAs; the contact solve amplifies such
// differences (the cube's inverse inertia is ~1.8e4). The float64 host build
// is held to the plain version at 1e-11, measured 9.8e-14
// (tests/test_torch_kernel_host.py); on the card the float32 kernel is held
// to the plain version within chip_smoke.KERNEL_TOL.
//
// Build (route: nvcc into a shared library with a plain C entry point,
// loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LG_HD __host__ __device__ __forceinline__
#define LG_HD_MEMBER __host__ __device__ __forceinline__
#else
#define LG_HD static inline
#define LG_HD_MEMBER inline
#endif

// The working type. The GPU build uses float; a host build with
// -DLG_REAL=double checks the formulas against the plain version in float64.
#ifndef LG_REAL
#define LG_REAL float
#endif
typedef LG_REAL real;
// a constant of the reference's Python code, rounded once to the working type
#define R(x) ((real)(x))

LG_HD float lg_sqrt(float x) { return sqrtf(x); }
LG_HD double lg_sqrt(double x) { return sqrt(x); }
// max / min as jnp.maximum / torch.maximum compute them: NaN in either operand
// gives NaN (fmaxf / fminf follow IEEE maxNum and return the operand that is
// not NaN, so a clamp would turn a NaN velocity into its bound). On the card
// float uses the one-instruction max.NaN / min.NaN of sm_80+ (the select
// below made the kernel ~11% slower on the H100; PERF.md); elsewhere a select.
LG_HD float lg_fmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || a > b) ? a : b;
#endif
}
LG_HD double lg_fmax(double a, double b) { return (a != a || a > b) ? a : b; }
LG_HD float lg_fmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || a < b) ? a : b;
#endif
}
LG_HD double lg_fmin(double a, double b) { return (a != a || a < b) ? a : b; }
LG_HD float lg_fabs(float x) { return fabsf(x); }
LG_HD double lg_fabs(double x) { return fabs(x); }
LG_HD float lg_sin(float x) { return sinf(x); }
LG_HD double lg_sin(double x) { return sin(x); }
LG_HD float lg_cos(float x) { return cosf(x); }
LG_HD double lg_cos(double x) { return cos(x); }

#define LG_STATE_ROWS 31
#define LG_PARAM_ROWS 40
#define LG_NUM_SAMPLES 2
// envs per block (one warp of envs), and warps (roles) per block: 0 = cube
// rows + sweep, 1-3 = one finger each
#define LG_EPB 32
#define LG_ROLES 4

// Filled by the Python wrapper (ops/cuda_engine.py, _KernelConsts); field
// order and types must match it exactly.
struct LgConsts {
  real o2[3], o3[3], tip[3];
  real mount_z, tip_off_z;
  real base_masses[3];
  real coms[3][3];
  real inertias[3][3][3];
  real mount_c[3], mount_s[3];
  real sample_frac[LG_NUM_SAMPLES], sample_radius[LG_NUM_SAMPLES];
  real jlow[9], jhigh[9];
  real contact_slop, w_min, finger_bias_cap, max_cube_angvel;
  // Python-double expressions of the reference, rounded once to real
  real h, h_it, half_h, half_h_it, baum_over_h, tgs_over_h_it;
  int32_t substeps, solver_iterations, solver_type, object_shape;
  int32_t enable_cube_wall, enable_tip_ground, enable_tip_wall;
  int32_t enable_link_cube, enable_torsion;
};

// packed parameter rows (ops/engine_v2.py PARAM_FIELDS order)
enum {
  P_GRAV = 0, P_LINK_MASS = 3, P_JDAMP = 6, P_ARM = 9, P_VLIM = 12,
  P_CMASS = 13, P_HALF = 14, P_INERTIA = 17, P_LIN_DAMP = 20, P_ANG_DAMP = 21,
  P_MU_TIP_CUBE = 22, P_MU_CUBE_GROUND = 23, P_MU_CUBE_WALL = 24,
  P_MU_TIP_GROUND = 25, P_REST_TIP_CUBE = 26, P_REST_CUBE_GROUND = 27,
  P_REST_TIP_GROUND = 28, P_TIP_RADIUS = 29, P_BOUNCE = 30, P_WALL_R = 31,
  P_WALL_SLOPE = 32, P_WALL_KNEE = 33, P_MU_TIP_WALL = 34,
  P_REST_TIP_WALL = 35, P_MU_LINK_CUBE = 36, P_REST_LINK_CUBE = 37,
  P_MU_TORSION = 38, P_TORSION_R = 39
};

// ---------------------------------------------------------------------------
// per-env storage: field f of an env at p[f * ST]
// ---------------------------------------------------------------------------

// Contact records, one after another per group; each record holds its rows
// (A: k_w[3], 1/w; B: d[3], k_w[3], 1/w; C, F: d[3], k_w[3], k_q[3], 1/w;
// D, E: k_q[3], 1/w), then torsion (k_w[3], 1/w) where it applies, the
// target (PGS) or restitution target (TGS), the TGS depth and the lambdas.
enum {
  A_ROW = 4, A_TGT = 12, A_DEP, A_LN, A_L1, A_L2, A_LT, A_NF,
  B_ROW = 7, B_KT = 21, B_IWT = 24, B_TGT, B_DEP, B_LN, B_L1, B_L2, B_LT, B_NF,
  C_ROW = 10, C_KT = 30, C_IWT = 33, C_TGT, C_DEP, C_LN, C_L1, C_L2, C_LT, C_NF,
  F_ROW = 10, F_TGT = 30, F_DEP, F_LN, F_L1, F_L2, F_NF,
  D_ROW = 4, D_TGT = 12, D_DEP, D_LN, D_L1, D_L2, D_NF,
  A_OFF = 0,
  B_OFF = A_OFF + 8 * A_NF,
  C_OFF = B_OFF + 8 * B_NF,
  F_OFF = C_OFF + 3 * C_NF,
  D_OFF = F_OFF + 3 * LG_NUM_SAMPLES * F_NF,
  E_OFF = D_OFF + 3 * D_NF,
  // the state at the start of the substep, in the packed state's row order
  X_STATE = E_OFF + 3 * D_NF,
  // per finger: yq[3], then l00, l10, l11, l20, l21, l22
  X_FINGER = X_STATE + LG_STATE_ROWS,
  LG_ENV_FLOATS = X_FINGER + 3 * 9
};

template <int ST>
struct Env {
  real* p;
  LG_HD_MEMBER real& operator[](int f) const { return p[f * ST]; }
};

template <int NF, int ST>
LG_HD void load_rec(const Env<ST>& S, int base, real (&r)[NF]) {
  for (int k = 0; k < NF; ++k) r[k] = S[base + k];
}

// ---------------------------------------------------------------------------
// vec3 / mat3 helpers (ops/soa.py; same evaluation order)
// ---------------------------------------------------------------------------

struct V3 { real x, y, z; };
struct M3 { real m[3][3]; };

LG_HD V3 mk(real x, real y, real z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
LG_HD real comp(const V3& a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
LG_HD V3 add(const V3& a, const V3& b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
LG_HD V3 sub(const V3& a, const V3& b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
LG_HD V3 scale(const V3& a, real s) { return mk(a.x * s, a.y * s, a.z * s); }
LG_HD real dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
LG_HD V3 cross(const V3& a, const V3& b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
LG_HD V3 matvec(const M3& m, const V3& v) {
  return mk(m.m[0][0] * v.x + m.m[0][1] * v.y + m.m[0][2] * v.z,
            m.m[1][0] * v.x + m.m[1][1] * v.y + m.m[1][2] * v.z,
            m.m[2][0] * v.x + m.m[2][1] * v.y + m.m[2][2] * v.z);
}
LG_HD V3 matTvec(const M3& m, const V3& v) {
  return mk(m.m[0][0] * v.x + m.m[1][0] * v.y + m.m[2][0] * v.z,
            m.m[0][1] * v.x + m.m[1][1] * v.y + m.m[2][1] * v.z,
            m.m[0][2] * v.x + m.m[1][2] * v.y + m.m[2][2] * v.z);
}
LG_HD M3 mul(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
  return r;
}
LG_HD M3 transpose(const M3& a) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
  return r;
}
LG_HD M3 inverse(const M3& a) {
  const real (*m)[3] = a.m;
  M3 r;
  r.m[0][0] = m[1][1] * m[2][2] - m[1][2] * m[2][1];
  r.m[0][1] = m[0][2] * m[2][1] - m[0][1] * m[2][2];
  r.m[0][2] = m[0][1] * m[1][2] - m[0][2] * m[1][1];
  r.m[1][0] = m[1][2] * m[2][0] - m[1][0] * m[2][2];
  r.m[1][1] = m[0][0] * m[2][2] - m[0][2] * m[2][0];
  r.m[1][2] = m[0][2] * m[1][0] - m[0][0] * m[1][2];
  r.m[2][0] = m[1][0] * m[2][1] - m[1][1] * m[2][0];
  r.m[2][1] = m[0][1] * m[2][0] - m[0][0] * m[2][1];
  r.m[2][2] = m[0][0] * m[1][1] - m[0][1] * m[1][0];
  const real inv_det = R(1.) / (m[0][0] * r.m[0][0] + m[0][1] * r.m[1][0] + m[0][2] * r.m[2][0]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = r.m[i][j] * inv_det;
  return r;
}
LG_HD M3 rot_x(real c, real s) {
  M3 r = {{{R(1.), R(0.), R(0.)}, {R(0.), c, -s}, {R(0.), s, c}}};
  return r;
}
LG_HD M3 rot_y(real c, real s) {
  M3 r = {{{c, R(0.), s}, {R(0.), R(1.), R(0.)}, {-s, R(0.), c}}};
  return r;
}
LG_HD real clipf_(real x, real lo, real hi) { return lg_fmin(lg_fmax(x, lo), hi); }
LG_HD real signf_(real x) { return x > R(0.) ? R(1.) : (x < R(0.) ? -R(1.) : x); }

struct Quat { real x, y, z, w; };

LG_HD M3 quat_to_m3(const Quat& q) {
  real xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  real xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  real wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  M3 r = {{{R(1.) - R(2.) * (yy + zz), R(2.) * (xy - wz), R(2.) * (xz + wy)},
           {R(2.) * (xy + wz), R(1.) - R(2.) * (xx + zz), R(2.) * (yz - wx)},
           {R(2.) * (xz - wy), R(2.) * (yz + wx), R(1.) - R(2.) * (xx + yy)}}};
  return r;
}

// quat_integrate4 with the factor 0.5 * dt already rounded to real
LG_HD Quat quat_integrate(const Quat& q, const V3& w, real half_dt) {
  // dq = (w, 0) * q, Hamilton product
  real dx = R(0.) * q.x + w.x * q.w + w.y * q.z - w.z * q.y;
  real dy = R(0.) * q.y - w.x * q.z + w.y * q.w + w.z * q.x;
  real dz = R(0.) * q.z + w.x * q.y - w.y * q.x + w.z * q.w;
  real dw = R(0.) * q.w - w.x * q.x - w.y * q.y - w.z * q.z;
  Quat p;
  p.x = q.x + half_dt * dx;
  p.y = q.y + half_dt * dy;
  p.z = q.z + half_dt * dz;
  p.w = q.w + half_dt * dw;
  real nrm = lg_sqrt(lg_fmax(p.x * p.x + p.y * p.y + p.z * p.z + p.w * p.w, R(1e-12)));
  real inv = R(1.) / nrm;
  p.x = p.x * inv; p.y = p.y * inv; p.z = p.z * inv; p.w = p.w * inv;
  return p;
}

struct Chol { real l00, l10, l11, l20, l21, l22; };

LG_HD Chol chol3_factor(const M3& a) {
  Chol c;
  c.l00 = lg_sqrt(lg_fmax(a.m[0][0], R(1e-12)));
  c.l10 = a.m[1][0] / c.l00;
  c.l20 = a.m[2][0] / c.l00;
  c.l11 = lg_sqrt(lg_fmax(a.m[1][1] - c.l10 * c.l10, R(1e-12)));
  c.l21 = (a.m[2][1] - c.l20 * c.l10) / c.l11;
  c.l22 = lg_sqrt(lg_fmax(a.m[2][2] - c.l20 * c.l20 - c.l21 * c.l21, R(1e-12)));
  return c;
}

// L^-1 b (forward substitution)
LG_HD V3 chol3_lower(const Chol& c, const V3& b) {
  real y0 = b.x / c.l00;
  real y1 = (b.y - c.l10 * y0) / c.l11;
  real y2 = (b.z - c.l20 * y0 - c.l21 * y1) / c.l22;
  return mk(y0, y1, y2);
}

// L^-T y (back substitution)
LG_HD V3 chol3_upper(const Chol& c, const V3& y) {
  real x2 = y.z / c.l22;
  real x1 = (y.y - c.l21 * x2) / c.l11;
  real x0 = (y.x - c.l10 * x1 - c.l20 * x2) / c.l00;
  return mk(x0, x1, x2);
}

LG_HD V3 chol3_solve(const Chol& c, const V3& b) { return chol3_upper(c, chol3_lower(c, b)); }

// ---------------------------------------------------------------------------
// per-finger dynamics (engine_v2._finger_dynamics)
// ---------------------------------------------------------------------------

struct PointData {
  V3 pos_w;
  V3 cols[3];       // world point-Jacobian columns, by joint
  V3 minv_cols[3];  // M^-1 J^T e_k for k = x, y, z
  real a[3][3];    // J M^-1 J^T
};

struct FingerData {
  real qd[3];  // free velocity after the unconstrained update
  Chol chol;   // of the finger's joint-space mass matrix
  PointData tip;
  PointData samples[LG_NUM_SAMPLES];
};

LG_HD V3 mount_rotate(const LgConsts& K, int f, const V3& v) {
  real c = K.mount_c[f], s = K.mount_s[f];
  return mk(c * v.x - s * v.y, s * v.x + c * v.y, v.z);
}

LG_HD void point_contact_data(const LgConsts& K, int f, const V3& p_local,
                              const V3 axes[3], const V3 joints[3],
                              const Chol& chol, PointData& out) {
  out.pos_w = add(mk(R(0.), R(0.), K.mount_z), mount_rotate(K, f, p_local));
  for (int i = 0; i < 3; ++i)
    out.cols[i] = mount_rotate(K, f, cross(axes[i], sub(p_local, joints[i])));
  for (int k = 0; k < 3; ++k)
    out.minv_cols[k] = chol3_solve(
        chol, mk(comp(out.cols[0], k), comp(out.cols[1], k), comp(out.cols[2], k)));
  for (int k = 0; k < 3; ++k)
    for (int mm = 0; mm < 3; ++mm)
      out.a[k][mm] = comp(out.cols[0], k) * comp(out.minv_cols[mm], 0) +
                     comp(out.cols[1], k) * comp(out.minv_cols[mm], 1) +
                     comp(out.cols[2], k) * comp(out.minv_cols[mm], 2);
}

// finger f's joint positions, velocities and torques in q, qd, tau
LG_HD void finger_dynamics(const LgConsts& K, int f, const real q[3], const real qd[3],
                           const real tau[3], const V3& g, const real lms[3],
                           const real jd[3], const real arm[3], bool with_samples,
                           FingerData& fd) {

  // ---- FK (finger-local frame)
  real c1 = lg_cos(q[0]), s1 = lg_sin(q[0]);
  real c2 = lg_cos(q[1]), s2 = lg_sin(q[1]);
  real c3 = lg_cos(q[2]), s3 = lg_sin(q[2]);
  M3 rots[3];
  rots[0] = rot_y(c1, s1);
  rots[1] = mul(rots[0], rot_x(c2, s2));
  rots[2] = mul(rots[1], rot_x(c3, s3));
  V3 joints[3];
  joints[0] = mk(R(0.), R(0.), R(0.));
  joints[1] = matvec(rots[0], mk(K.o2[0], K.o2[1], K.o2[2]));
  joints[2] = add(joints[1], matvec(rots[1], mk(K.o3[0], K.o3[1], K.o3[2])));
  V3 tip = add(joints[2], matvec(rots[2], mk(K.tip[0], K.tip[1], K.tip[2])));
  V3 axes[3];
  axes[0] = mk(R(0.), R(1.), R(0.));
  axes[1] = mk(rots[0].m[0][0], rots[0].m[1][0], rots[0].m[2][0]);
  axes[2] = mk(rots[1].m[0][0], rots[1].m[1][0], rots[1].m[2][0]);
  V3 coms[3];
  for (int l = 0; l < 3; ++l)
    coms[l] = add(joints[l], matvec(rots[l], mk(K.coms[l][0], K.coms[l][1], K.coms[l][2])));

  real masses[3];
  M3 i_w[3];
  for (int l = 0; l < 3; ++l) {
    masses[l] = K.base_masses[l] * lms[l];
    M3 scaled;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) scaled.m[i][j] = K.inertias[l][i][j] * lms[l];
    i_w[l] = mul(mul(rots[l], scaled), transpose(rots[l]));
  }

  // ---- mass matrix (link-Jacobian assembly)
  V3 jv[3][3];
  for (int l = 0; l < 3; ++l)
    for (int i = 0; i <= l; ++i) jv[l][i] = cross(axes[i], sub(coms[l], joints[i]));
  M3 m_e;
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      real acc = R(0.);
      for (int l = (i > j ? i : j); l < 3; ++l) {
        acc = acc + masses[l] * dot(jv[l][i], jv[l][j]);
        acc = acc + dot(axes[i], matvec(i_w[l], axes[j]));
      }
      m_e.m[i][j] = acc;
      m_e.m[j][i] = acc;
    }
  for (int i = 0; i < 3; ++i) m_e.m[i][i] = m_e.m[i][i] + arm[i];

  // ---- RNEA bias (qdd = 0, base acc = -g)
  V3 omega_prev = mk(R(0.), R(0.), R(0.)), alpha_prev = mk(R(0.), R(0.), R(0.));
  V3 a_joint_prev = mk(-g.x, -g.y, -g.z);
  V3 p_prev = joints[0];
  V3 omega[3], alpha[3], a_com[3];
  for (int i = 0; i < 3; ++i) {
    V3 d = sub(joints[i], p_prev);
    V3 a_joint = add(a_joint_prev,
                     add(cross(alpha_prev, d), cross(omega_prev, cross(omega_prev, d))));
    V3 w = add(omega_prev, scale(axes[i], qd[i]));
    V3 al = add(alpha_prev, cross(omega_prev, scale(axes[i], qd[i])));
    V3 rc = sub(coms[i], joints[i]);
    V3 ac = add(a_joint, add(cross(al, rc), cross(w, cross(w, rc))));
    omega[i] = w; alpha[i] = al; a_com[i] = ac;
    omega_prev = w; alpha_prev = al; a_joint_prev = a_joint; p_prev = joints[i];
  }
  V3 f_child = mk(R(0.), R(0.), R(0.)), n_child = mk(R(0.), R(0.), R(0.));
  real bias[3];
  for (int i = 2; i >= 0; --i) {
    V3 f_net = scale(a_com[i], masses[i]);
    V3 n_net = add(matvec(i_w[i], alpha[i]), cross(omega[i], matvec(i_w[i], omega[i])));
    V3 f_i = add(f_net, f_child);
    V3 n_i = add(add(n_net, n_child), cross(sub(coms[i], joints[i]), f_net));
    if (i < 2) n_i = add(n_i, cross(sub(joints[i + 1], joints[i]), f_child));
    bias[i] = dot(axes[i], n_i);
    f_child = f_i; n_child = n_i;
  }

  // ---- free-velocity update
  Chol chol = chol3_factor(m_e);
  V3 rhs = mk(tau[0] - bias[0] - jd[0] * qd[0], tau[1] - bias[1] - jd[1] * qd[1],
              tau[2] - bias[2] - jd[2] * qd[2]);
  V3 qdd = chol3_solve(chol, rhs);
  fd.qd[0] = qd[0] + K.h * qdd.x;
  fd.qd[1] = qd[1] + K.h * qdd.y;
  fd.qd[2] = qd[2] + K.h * qdd.z;
  fd.chol = chol;

  // ---- world-frame contact quantities
  point_contact_data(K, f, tip, axes, joints, chol, fd.tip);
  if (with_samples)
    for (int s = 0; s < LG_NUM_SAMPLES; ++s) {
      V3 p_s = add(joints[2], scale(sub(tip, joints[2]), K.sample_frac[s]));
      point_contact_data(K, f, p_s, axes, joints, chol, fd.samples[s]);
    }
}

LG_HD V3 point_vel(const V3 cols[3], const real qd[3]) {
  return mk(cols[0].x * qd[0] + cols[1].x * qd[1] + cols[2].x * qd[2],
            cols[0].y * qd[0] + cols[1].y * qd[1] + cols[2].y * qd[2],
            cols[0].z * qd[0] + cols[1].z * qd[1] + cols[2].z * qd[2]);
}

LG_HD void tangent_basis(const V3& n, V3& t1, V3& t2) {
  bool use_x = lg_fabs(n.x) < R(0.9);
  V3 a = mk(use_x ? R(1.) : R(0.), use_x ? R(0.) : R(1.), R(0.));
  t1 = cross(n, a);
  real inv = R(1.) / lg_sqrt(lg_fmax(dot(t1, t1), R(1e-18)));
  t1 = scale(t1, inv);
  t2 = cross(n, t1);
}

LG_HD void wall_gap(const real* P, real px, real py, real pz, real& gap, V3& n) {
  real rho = lg_sqrt(lg_fmax(px * px + py * py, R(1e-18)));
  real inv_rho = R(1.) / rho;
  real z_over = lg_fmax(pz - P[P_WALL_KNEE], R(0.));
  real s = z_over > R(0.) ? P[P_WALL_SLOPE] : R(0.);
  real inv_len = R(1.) / lg_sqrt(R(1.) + s * s);
  real r_eff = P[P_WALL_R] + P[P_WALL_SLOPE] * z_over;
  gap = (r_eff - rho) * inv_len;
  n = mk(-px * inv_rho * inv_len, -py * inv_rho * inv_len, s * inv_len);
}

LG_HD real restitution_target(const LgConsts& K, real depth, real v_n0, real restitution,
                               real bounce_threshold) {
  bool touching = depth - v_n0 * K.h > R(0.);
  return (v_n0 < -bounce_threshold && touching) ? -restitution * v_n0 : -(real)INFINITY;
}

LG_HD real contact_target(const LgConsts& K, real depth, real v_n0, real restitution,
                           real bounce_threshold, bool capped) {
  real pen_bias = K.baum_over_h * lg_fmax(depth - K.contact_slop, R(0.));
  if (capped) pen_bias = lg_fmin(pen_bias, K.finger_bias_cap);
  real bias = depth > R(0.) ? pen_bias : depth / K.h;
  return lg_fmax(bias, restitution_target(K, depth, v_n0, restitution, bounce_threshold));
}

// probe sphere at `center` vs the object: closest point, frame, signed distance
LG_HD void sphere_vs_object(bool sphere_obj, const V3& pos, const M3& rot,
                            const V3& half, const V3& center, V3& r, V3& n_w, V3& t1,
                            V3& t2, V3& point, real& sdist) {
  if (sphere_obj) {
    real radius_o = half.x;
    V3 delta = sub(center, pos);
    real d2 = dot(delta, delta);
    real dist = lg_sqrt(lg_fmax(d2, R(1e-18)));
    real inv_dist = R(1.) / dist;
    bool deg = d2 > R(1e-16);
    V3 dir_out = mk(deg ? delta.x * inv_dist : R(0.), deg ? delta.y * inv_dist : R(0.),
                    deg ? delta.z * inv_dist : R(1.));
    sdist = dist - radius_o;
    point = add(pos, scale(dir_out, radius_o));
    n_w = scale(dir_out, -R(1.));
    r = sub(point, pos);
    tangent_basis(n_w, t1, t2);
    return;
  }
  V3 local = matvec(transpose(rot), sub(center, pos));
  V3 clamped = mk(clipf_(local.x, -half.x, half.x), clipf_(local.y, -half.y, half.y),
                  clipf_(local.z, -half.z, half.z));
  V3 delta = sub(local, clamped);
  // the outside test compares the squared distance, never through sqrt
  real dist_sq = dot(delta, delta);
  bool outside = dist_sq > R(1e-16);
  real dist = lg_sqrt(lg_fmax(dist_sq, R(1e-18)));
  real inv_dist = R(1.) / dist;
  V3 n_out = scale(delta, inv_dist);
  V3 gaps = mk(half.x - lg_fabs(local.x), half.y - lg_fabs(local.y), half.z - lg_fabs(local.z));
  real min01 = lg_fmin(gaps.x, gaps.y);
  bool axis0 = gaps.x <= gaps.y;
  bool axis_is_2 = gaps.z < min01;
  V3 sgn = mk(signf_(local.x + R(1e-12)), signf_(local.y + R(1e-12)), signf_(local.z + R(1e-12)));
  V3 n_in = mk(axis_is_2 ? R(0.) : (axis0 ? sgn.x : R(0.)),
               axis_is_2 ? R(0.) : (axis0 ? R(0.) : sgn.y), axis_is_2 ? sgn.z : R(0.));
  real inside_dist = -(axis_is_2 ? gaps.z : lg_fmin(gaps.x, gaps.y));
  V3 n_local = outside ? n_out : n_in;
  sdist = outside ? dist : inside_dist;
  real gap_sel = axis_is_2 ? gaps.z : min01;
  V3 surf_local = outside ? clamped
                          : mk(local.x + n_in.x * gap_sel, local.y + n_in.y * gap_sel,
                               local.z + n_in.z * gap_sel);
  n_w = scale(matvec(rot, n_local), -R(1.));
  point = add(pos, matvec(rot, surf_local));
  r = sub(point, pos);
  tangent_basis(n_w, t1, t2);
}

// TGS velocity target for the remaining depth d at a mini-step whose
// remaining time h_rem = h - it * h_it enters as 1 / h_rem (one division per
// iteration, where the reference divides per row)
LG_HD real tgs_target(const LgConsts& K, real d, real rest, real inv_h_rem, bool capped) {
  real pen = K.tgs_over_h_it * lg_fmax(d - K.contact_slop, R(0.));
  if (capped) pen = lg_fmin(pen, K.finger_bias_cap);
  real bias = d > R(0.) ? pen : d * inv_h_rem;
  return lg_fmax(bias, rest);
}

// normal_step: lam <- max(lam + (target - u_n) / w_n, 0), 1/w_n stored;
// returns the change
LG_HD real normal_step(real u_n, real target, real iw, real& lam) {
  real new_lam = lg_fmax(lam + (target - u_n) * iw, R(0.));
  real d = new_lam - lam;
  lam = new_lam;
  return d;
}

LG_HD real friction_step(real u_t, real iw, real& lam_t, real mu_lam) {
  real new_lam = clipf_(lam_t - u_t * iw, -mu_lam, mu_lam);
  real d = new_lam - lam_t;
  lam_t = new_lam;
  return d;
}

// ---------------------------------------------------------------------------
// the cube at the start of a substep, as every role computes it
// ---------------------------------------------------------------------------

struct Cube {
  V3 pos;
  Quat quat;
  M3 rot;
  V3 v, w;          // free velocities
  real inv_mass;
  M3 inv_i_w;
  V3 sq;            // sqrt of the principal inverse inertias
  V3 half;
};

template <int ST>
LG_HD void cube_start(const LgConsts& K, const Env<ST>& S, const real* P, Cube& c) {
  const V3 g = mk(P[P_GRAV], P[P_GRAV + 1], P[P_GRAV + 2]);
  real lin_damp = lg_fmax(R(1.) - P[P_LIN_DAMP] * K.h, R(0.));
  real ang_damp = lg_fmax(R(1.) - P[P_ANG_DAMP] * K.h, R(0.));
  const int X = X_STATE;
  V3 v = mk(S[X + 25] * lin_damp, S[X + 26] * lin_damp, S[X + 27] * lin_damp);
  c.v = mk(v.x + K.h * g.x, v.y + K.h * g.y, v.z + K.h * g.z);
  c.w = mk(S[X + 28] * ang_damp, S[X + 29] * ang_damp, S[X + 30] * ang_damp);
  c.pos = mk(S[X + 18], S[X + 19], S[X + 20]);
  c.quat.x = S[X + 21]; c.quat.y = S[X + 22]; c.quat.z = S[X + 23]; c.quat.w = S[X + 24];
  c.rot = quat_to_m3(c.quat);
  c.inv_mass = R(1.) / P[P_CMASS];
  const real inv_i[3] = {R(1.) / P[P_INERTIA], R(1.) / P[P_INERTIA + 1], R(1.) / P[P_INERTIA + 2]};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c.inv_i_w.m[i][j] = c.rot.m[i][0] * inv_i[0] * c.rot.m[j][0] +
                          c.rot.m[i][1] * inv_i[1] * c.rot.m[j][1] +
                          c.rot.m[i][2] * inv_i[2] * c.rot.m[j][2];
  c.sq = mk(lg_sqrt(inv_i[0]), lg_sqrt(inv_i[1]), lg_sqrt(inv_i[2]));
  c.half = mk(P[P_HALF], P[P_HALF + 1], P[P_HALF + 2]);
}

LG_HD V3 cube_point_vel(const V3& v, const V3& w, const V3& r) { return add(v, cross(w, r)); }

LG_HD real k_cube_dir(const Cube& c, const V3& r, const V3& d) {
  V3 rxd = cross(r, d);
  return c.inv_mass + dot(rxd, matvec(c.inv_i_w, rxd));
}

LG_HD real k_spin(const Cube& c, const V3& n) {
  return lg_fmax(dot(n, matvec(c.inv_i_w, n)), R(1e-6));
}

// the cube's angular part of a row with angular Jacobian j: sqrt(I^-1) R^T j
LG_HD V3 ang_row(const Cube& c, const V3& j) {
  V3 b = matTvec(c.rot, j);
  return mk(c.sq.x * b.x, c.sq.y * b.y, c.sq.z * b.z);
}

template <int ST>
LG_HD void put3(const Env<ST>& S, int at, const V3& a) {
  S[at] = a.x; S[at + 1] = a.y; S[at + 2] = a.z;
}

// ---------------------------------------------------------------------------
// build, role 0: groups A (object points vs ground) and B (vs arena wall)
// ---------------------------------------------------------------------------

template <int ST>
LG_HD void build_cube_rows(const LgConsts& K, const Env<ST>& S, const real* P, const Cube& c) {
  const bool sphere_obj = K.object_shape == 1;
  const bool tgs = K.solver_type == 1;
  const real bounce = P[P_BOUNCE];
  const real radius_o = c.half.x;
  V3 a_points[8];
  int n_a, n_b = 0;
  V3 b_points[8], b_n[8];
  real b_depth[8];
  if (sphere_obj) {
    n_a = 1;
    a_points[0] = mk(c.pos.x, c.pos.y, c.pos.z - radius_o);
    if (K.enable_cube_wall) {
      real gap_c;
      V3 n_c;
      wall_gap(P, c.pos.x, c.pos.y, c.pos.z, gap_c, n_c);
      n_b = 1;
      b_points[0] = mk(c.pos.x - n_c.x * radius_o, c.pos.y - n_c.y * radius_o,
                       c.pos.z - n_c.z * radius_o);
      b_depth[0] = radius_o - gap_c;
      b_n[0] = n_c;
    }
  } else {
    n_a = 8;
    int ci = 0;
    for (int sx = -1; sx <= 1; sx += 2)
      for (int sy = -1; sy <= 1; sy += 2)
        for (int sz = -1; sz <= 1; sz += 2) {
          V3 local = mk((real)sx * c.half.x, (real)sy * c.half.y, (real)sz * c.half.z);
          a_points[ci] = add(c.pos, matvec(c.rot, local));
          ++ci;
        }
    if (K.enable_cube_wall) {
      n_b = 8;
      for (int i = 0; i < 8; ++i) {
        real gap;
        wall_gap(P, a_points[i].x, a_points[i].y, a_points[i].z, gap, b_n[i]);
        b_points[i] = a_points[i];
        b_depth[i] = -gap;
      }
    }
  }

  // A: directions n = +z, t1 = +y, t2 = -x (the reference's tangent basis)
  const V3 dirs[3] = {mk(R(0.), R(0.), R(1.)), mk(R(0.), R(1.), R(0.)),
                      mk(-R(1.), R(0.), R(0.))};
  for (int i = 0; i < n_a; ++i) {
    const int at = A_OFF + i * A_NF;
    V3 r = sub(a_points[i], c.pos);
    real depth = -a_points[i].z;
    real vn0 = cube_point_vel(c.v, c.w, r).z;
    real target = contact_target(K, depth, vn0, P[P_REST_CUBE_GROUND], bounce, false);
    real rest = restitution_target(K, depth, vn0, P[P_REST_CUBE_GROUND], bounce);
    for (int k = 0; k < 3; ++k) {
      put3(S, at + k * A_ROW, ang_row(c, cross(r, dirs[k])));
      S[at + k * A_ROW + 3] = R(1.) / k_cube_dir(c, r, dirs[k]);
    }
    S[at + A_TGT] = tgs ? rest : target;
    S[at + A_DEP] = depth;
    S[at + A_LN] = S[at + A_L1] = S[at + A_L2] = S[at + A_LT] = R(0.);
  }
  for (int i = 0; i < n_b; ++i) {
    const int at = B_OFF + i * B_NF;
    V3 r = sub(b_points[i], c.pos);
    V3 n = b_n[i], t1, t2;
    tangent_basis(n, t1, t2);
    V3 u = cube_point_vel(c.v, c.w, r);
    // a zero restitution, as the reference passes jnp.asarray(0.0)
    real target = contact_target(K, b_depth[i], dot(u, n), R(0.), bounce, false);
    real rest = restitution_target(K, b_depth[i], dot(u, n), R(0.), bounce);
    const V3 d3[3] = {n, t1, t2};
    for (int k = 0; k < 3; ++k) {
      put3(S, at + k * B_ROW, d3[k]);
      put3(S, at + k * B_ROW + 3, ang_row(c, cross(r, d3[k])));
      S[at + k * B_ROW + 6] = R(1.) / k_cube_dir(c, r, d3[k]);
    }
    if (K.enable_torsion) {
      put3(S, at + B_KT, ang_row(c, n));
      S[at + B_IWT] = R(1.) / k_spin(c, n);
    }
    S[at + B_TGT] = tgs ? rest : target;
    S[at + B_DEP] = b_depth[i];
    S[at + B_LN] = S[at + B_L1] = S[at + B_L2] = S[at + B_LT] = R(0.);
  }
}

// ---------------------------------------------------------------------------
// build, roles 1-3: one finger's dynamics and its groups C, F, D, E
// ---------------------------------------------------------------------------

// what a finger's role keeps in registers for its tip impulses
struct TipGeom {
  V3 cn, ct1, ct2, arm_c;  // C: frame, contact point - tip
  V3 arm_d;                // D: ground point - tip
  V3 en, et1, et2, arm_e;  // E: frame, wall point - tip
};

// the finger part of a row: sign * L^-1 J^T d
LG_HD V3 finger_row(const Chol& l, const V3 cols[3], const V3& d, real sign) {
  V3 j = chol3_lower(l, mk(dot(cols[0], d), dot(cols[1], d), dot(cols[2], d)));
  return scale(j, sign);
}

// the reference's J M^-1 J^T quadratic form d.(a d)
LG_HD real a_form(const real a[3][3], const V3& d) {
  M3 at;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) at.m[i][j] = a[i][j];
  return dot(d, matvec(at, d));
}

// one probe (tip or link sample) vs the object: a C or F record at `at`
template <int ST>
LG_HD void probe_rows(const LgConsts& K, const Env<ST>& S, const real* P, const Cube& c,
                      const PointData& pd, const Chol& l, const real qd[3], const V3& center,
                      real radius, real restitution, int at, V3& r, V3& n, V3& t1, V3& t2,
                      V3& point) {
  const bool tgs = K.solver_type == 1;
  real sdist;
  sphere_vs_object(K.object_shape == 1, c.pos, c.rot, c.half, center, r, n, t1, t2, point,
                   sdist);
  real depth = radius - sdist;
  V3 u = sub(cube_point_vel(c.v, c.w, r), point_vel(pd.cols, qd));
  real un = dot(u, n);
  real target = contact_target(K, depth, un, restitution, P[P_BOUNCE], false);
  real rest = restitution_target(K, depth, un, restitution, P[P_BOUNCE]);
  const V3 d3[3] = {n, t1, t2};
  for (int k = 0; k < 3; ++k) {
    put3(S, at + k * C_ROW, d3[k]);
    put3(S, at + k * C_ROW + 3, ang_row(c, cross(r, d3[k])));
    put3(S, at + k * C_ROW + 6, finger_row(l, pd.cols, d3[k], -R(1.)));
    S[at + k * C_ROW + 9] = R(1.) / (k_cube_dir(c, r, d3[k]) + a_form(pd.a, d3[k]));
  }
  // C and F share the row layout; their target, depth and lambdas follow
  const int tail = at + (at >= F_OFF ? F_TGT : C_TGT);
  S[tail] = tgs ? rest : target;
  S[tail + 1] = depth;
}

template <int ST>
LG_HD void build_finger_rows(const LgConsts& K, const Env<ST>& S, const real* P,
                             const real* tau, const Cube& c, int f, TipGeom& tg) {
  const bool tgs = K.solver_type == 1;
  const V3 g = mk(P[P_GRAV], P[P_GRAV + 1], P[P_GRAV + 2]);
  real lms[3], jd[3], arm[3], q[3], qd[3], tau3[3];
  for (int i = 0; i < 3; ++i) {
    lms[i] = P[P_LINK_MASS + i] / K.base_masses[i];
    jd[i] = P[P_JDAMP + i];
    arm[i] = P[P_ARM + i];
    q[i] = S[X_STATE + 3 * f + i];
    qd[i] = S[X_STATE + 9 + 3 * f + i];
    // selected, not indexed by f: tau stays in registers
    tau3[i] = f == 0 ? tau[i] : (f == 1 ? tau[3 + i] : tau[6 + i]);
  }
  FingerData fd;
  finger_dynamics(K, f, q, qd, tau3, g, lms, jd, arm, K.enable_link_cube != 0, fd);
  const Chol& l = fd.chol;

  // the sweep's normalised finger velocity yq = L^T qd and the factor
  const int xf = X_FINGER + 9 * f;
  S[xf] = l.l00 * fd.qd[0] + l.l10 * fd.qd[1] + l.l20 * fd.qd[2];
  S[xf + 1] = l.l11 * fd.qd[1] + l.l21 * fd.qd[2];
  S[xf + 2] = l.l22 * fd.qd[2];
  S[xf + 3] = l.l00; S[xf + 4] = l.l10; S[xf + 5] = l.l11;
  S[xf + 6] = l.l20; S[xf + 7] = l.l21; S[xf + 8] = l.l22;

  // ---- group C: the tip sphere vs the object
  const PointData& tp = fd.tip;
  const V3 center = add(tp.pos_w, mk(R(0.), R(0.), K.tip_off_z));
  {
    const int at = C_OFF + f * C_NF;
    V3 r, point;
    probe_rows(K, S, P, c, tp, l, fd.qd, center, P[P_TIP_RADIUS], P[P_REST_TIP_CUBE], at, r,
               tg.cn, tg.ct1, tg.ct2, point);
    tg.arm_c = sub(point, tp.pos_w);
    if (K.enable_torsion) {
      put3(S, at + C_KT, ang_row(c, tg.cn));
      S[at + C_IWT] = R(1.) / k_spin(c, tg.cn);
    }
    S[at + C_LN] = S[at + C_L1] = S[at + C_L2] = S[at + C_LT] = R(0.);
  }

  // ---- group F: the lower-link shaft samples vs the object (index f * S + s)
  if (K.enable_link_cube)
    for (int si = 0; si < LG_NUM_SAMPLES; ++si) {
      const int at = F_OFF + (f * LG_NUM_SAMPLES + si) * F_NF;
      const PointData& sp = fd.samples[si];
      V3 r, n, t1, t2, point;
      probe_rows(K, S, P, c, sp, l, fd.qd, sp.pos_w, K.sample_radius[si],
                 P[P_REST_LINK_CUBE], at, r, n, t1, t2, point);
      S[at + F_LN] = S[at + F_L1] = S[at + F_L2] = R(0.);
    }

  // ---- group D: the tip sphere vs the ground (rows z, x, y)
  if (K.enable_tip_ground) {
    const int at = D_OFF + f * D_NF;
    real depth = P[P_TIP_RADIUS] - center.z;
    real uz = point_vel(tp.cols, fd.qd).z;
    real target = contact_target(K, depth, uz, P[P_REST_TIP_GROUND], P[P_BOUNCE], true);
    real rest = restitution_target(K, depth, uz, P[P_REST_TIP_GROUND], P[P_BOUNCE]);
    // finger-only contact: J M^-1 J^T can be singular (floored at w_min)
    const real w3[3] = {lg_fmax(tp.a[2][2], K.w_min), lg_fmax(tp.a[0][0], K.w_min),
                        lg_fmax(tp.a[1][1], K.w_min)};
    const V3 d3[3] = {mk(R(0.), R(0.), R(1.)), mk(R(1.), R(0.), R(0.)),
                      mk(R(0.), R(1.), R(0.))};
    for (int k = 0; k < 3; ++k) {
      put3(S, at + k * D_ROW, finger_row(l, tp.cols, d3[k], R(1.)));
      S[at + k * D_ROW + 3] = R(1.) / w3[k];
    }
    S[at + D_TGT] = tgs ? rest : target;
    S[at + D_DEP] = depth;
    S[at + D_LN] = S[at + D_L1] = S[at + D_L2] = R(0.);
    tg.arm_d = sub(mk(center.x, center.y, center.z - P[P_TIP_RADIUS]), tp.pos_w);
  }

  // ---- group E: the tip sphere vs the arena wall (same record layout as D)
  if (K.enable_tip_wall) {
    const int at = E_OFF + f * D_NF;
    real gap;
    wall_gap(P, center.x, center.y, center.z, gap, tg.en);
    real depth = P[P_TIP_RADIUS] - gap;
    tangent_basis(tg.en, tg.et1, tg.et2);
    real un = dot(point_vel(tp.cols, fd.qd), tg.en);
    real target = contact_target(K, depth, un, P[P_REST_TIP_WALL], P[P_BOUNCE], true);
    real rest = restitution_target(K, depth, un, P[P_REST_TIP_WALL], P[P_BOUNCE]);
    const V3 d3[3] = {tg.en, tg.et1, tg.et2};
    for (int k = 0; k < 3; ++k) {
      put3(S, at + k * D_ROW, finger_row(l, tp.cols, d3[k], R(1.)));
      S[at + k * D_ROW + 3] = R(1.) / lg_fmax(a_form(tp.a, d3[k]), K.w_min);
    }
    S[at + D_TGT] = tgs ? rest : target;
    S[at + D_DEP] = depth;
    S[at + D_LN] = S[at + D_L1] = S[at + D_L2] = R(0.);
    tg.arm_e = sub(sub(center, scale(tg.en, P[P_TIP_RADIUS])), tp.pos_w);
  }
}

// ---------------------------------------------------------------------------
// sweep, role 0: the iterations over the stored rows, then the integration
// ---------------------------------------------------------------------------

LG_HD real dot3(const real* k, const real* x) { return k[0] * x[0] + k[1] * x[1] + k[2] * x[2]; }
LG_HD void axpy3(real a, const real* k, real* x) {
  x[0] = x[0] + a * k[0];
  x[1] = x[1] + a * k[1];
  x[2] = x[2] + a * k[2];
}

struct Vel {
  real v[3];      // cube linear velocity (world)
  real y[3];      // cube angular velocity, diag(sqrt(I)) R^T w
  real yq[3][3];  // finger joint velocities, L^T qd
};

// u of a cube-and-finger row (d, k_w, k_q at `r`) and its update
LG_HD real u_cf(const real* r, const Vel& s, int f) {
  return (dot3(r + 3, s.y) + dot3(r + 6, s.yq[f])) + dot3(r, s.v);
}
LG_HD void apply_cf(const real* r, real dl, real im, Vel& s, int f) {
  axpy3(dl * im, r, s.v);
  axpy3(dl, r + 3, s.y);
  axpy3(dl, r + 6, s.yq[f]);
}
LG_HD real u_c(const real* r, const Vel& s) { return dot3(r + 3, s.y) + dot3(r, s.v); }
LG_HD void apply_c(const real* r, real dl, real im, Vel& s) {
  axpy3(dl * im, r, s.v);
  axpy3(dl, r + 3, s.y);
}

LG_HD V3 world_w(const Cube& c, const real y[3]) {
  return matvec(c.rot, mk(c.sq.x * y[0], c.sq.y * y[1], c.sq.z * y[2]));
}

LG_HD Chol finger_chol(const real* x) {
  Chol l;
  l.l00 = x[3]; l.l10 = x[4]; l.l11 = x[5]; l.l20 = x[6]; l.l21 = x[7]; l.l22 = x[8];
  return l;
}

template <int ST>
LG_HD void sweep_and_integrate(const LgConsts& K, const Env<ST>& S, const real* P,
                               const Cube& c) {
  const bool sphere_obj = K.object_shape == 1;
  const bool tgs = K.solver_type == 1;
  const bool torsion = K.enable_torsion != 0;
  const int n_a = sphere_obj ? 1 : 8;
  const int n_b = K.enable_cube_wall ? n_a : 0;
  const int n_f = K.enable_link_cube ? 3 * LG_NUM_SAMPLES : 0;
  const int n_d = K.enable_tip_ground ? 3 : 0;
  const int n_e = K.enable_tip_wall ? 3 : 0;
  const real im = c.inv_mass;
  const real mu_cg = P[P_MU_CUBE_GROUND], mu_cw = P[P_MU_CUBE_WALL];
  const real mu_tc = P[P_MU_TIP_CUBE], mu_lc = P[P_MU_LINK_CUBE];
  const real mu_tg = P[P_MU_TIP_GROUND], mu_tw = P[P_MU_TIP_WALL];
  const real mu_tor_r = P[P_MU_TORSION] * P[P_TORSION_R];
  // group A's torsion row: w.z, with the reference's unclamped inv_i_w[2][2]
  const V3 kta3 = ang_row(c, mk(R(0.), R(0.), R(1.)));
  const real kta[3] = {kta3.x, kta3.y, kta3.z};
  const real iw_ta = R(1.) / c.inv_i_w.m[2][2];

  Vel s;
  s.v[0] = c.v.x; s.v[1] = c.v.y; s.v[2] = c.v.z;
  {
    // y solves R diag(sq) y = w: R from a quaternion a few ulps off unit
    // length is not exactly orthogonal, so invert it rather than transpose
    V3 b = matvec(inverse(c.rot), c.w);
    s.y[0] = b.x / c.sq.x; s.y[1] = b.y / c.sq.y; s.y[2] = b.z / c.sq.z;
  }
  Chol lf[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    for (int j = 0; j < 3; ++j) s.yq[f][j] = S[X_FINGER + 9 * f + j];
    real x[9];
    for (int j = 3; j < 9; ++j) x[j] = S[X_FINGER + 9 * f + j];
    lf[f] = finger_chol(x);
  }
  V3 p_pos = c.pos;
  Quat p_quat = c.quat;
  real p_q[9];
  for (int i = 0; i < 9; ++i) p_q[i] = S[X_STATE + i];

  for (int it = 0; it < K.solver_iterations; ++it) {
    // real, as the reference's traced loop index
    const real inv_h_rem = R(1.) / (K.h - (real)it * K.h_it);
    // ---- A. Each contact's record is loaded at its start (see the note)
    {
      real cur[A_NF];
      for (int i = 0; i < n_a; ++i) {
        const int at = A_OFF + i * A_NF;
        load_rec(S, at, cur);
        real ln = cur[A_LN], l1 = cur[A_L1], l2 = cur[A_L2], lt = cur[A_LT], dep = cur[A_DEP];
        real tgt = tgs ? tgs_target(K, dep, cur[A_TGT], inv_h_rem, false) : cur[A_TGT];
        real dl = normal_step(s.v[2] + dot3(cur, s.y), tgt, cur[3], ln);
        s.v[2] = s.v[2] + dl * im;
        axpy3(dl, cur, s.y);
        real mu_l = mu_cg * ln;
        if (tgs) dep = dep - (s.v[2] + dot3(cur, s.y)) * K.h_it;
        dl = friction_step(s.v[1] + dot3(cur + A_ROW, s.y), cur[A_ROW + 3], l1, mu_l);
        s.v[1] = s.v[1] + dl * im;
        axpy3(dl, cur + A_ROW, s.y);
        dl = friction_step(-s.v[0] + dot3(cur + 2 * A_ROW, s.y), cur[2 * A_ROW + 3], l2, mu_l);
        s.v[0] = s.v[0] - dl * im;
        axpy3(dl, cur + 2 * A_ROW, s.y);
        if (torsion) {
          dl = friction_step(dot3(kta, s.y), iw_ta, lt, mu_tor_r * ln);
          axpy3(dl, kta, s.y);
        }
        S[at + A_LN] = ln; S[at + A_L1] = l1; S[at + A_L2] = l2; S[at + A_LT] = lt;
        S[at + A_DEP] = dep;
      }
    }
    // ---- B
    if (n_b > 0) {
      real cur[B_NF];
      for (int i = 0; i < n_b; ++i) {
        const int at = B_OFF + i * B_NF;
        load_rec(S, at, cur);
        real ln = cur[B_LN], l1 = cur[B_L1], l2 = cur[B_L2], lt = cur[B_LT], dep = cur[B_DEP];
        real tgt = tgs ? tgs_target(K, dep, cur[B_TGT], inv_h_rem, false) : cur[B_TGT];
        real dl = normal_step(u_c(cur, s), tgt, cur[6], ln);
        apply_c(cur, dl, im, s);
        real mu_l = mu_cw * ln;
        if (tgs) dep = dep - u_c(cur, s) * K.h_it;
        dl = friction_step(u_c(cur + B_ROW, s), cur[B_ROW + 6], l1, mu_l);
        apply_c(cur + B_ROW, dl, im, s);
        dl = friction_step(u_c(cur + 2 * B_ROW, s), cur[2 * B_ROW + 6], l2, mu_l);
        apply_c(cur + 2 * B_ROW, dl, im, s);
        if (torsion) {
          dl = friction_step(dot3(cur + B_KT, s.y), cur[B_IWT], lt, mu_tor_r * ln);
          axpy3(dl, cur + B_KT, s.y);
        }
        S[at + B_LN] = ln; S[at + B_L1] = l1; S[at + B_L2] = l2; S[at + B_LT] = lt;
        S[at + B_DEP] = dep;
      }
    }
    // ---- C
    {
      real cur[C_NF];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int at = C_OFF + f * C_NF;
        load_rec(S, at, cur);
        real ln = cur[C_LN], l1 = cur[C_L1], l2 = cur[C_L2], lt = cur[C_LT], dep = cur[C_DEP];
        real tgt = tgs ? tgs_target(K, dep, cur[C_TGT], inv_h_rem, false) : cur[C_TGT];
        real dl = normal_step(u_cf(cur, s, f), tgt, cur[9], ln);
        apply_cf(cur, dl, im, s, f);
        if (tgs) dep = dep - u_cf(cur, s, f) * K.h_it;
        real mu_l = mu_tc * ln;
        dl = friction_step(u_cf(cur + C_ROW, s, f), cur[C_ROW + 9], l1, mu_l);
        apply_cf(cur + C_ROW, dl, im, s, f);
        dl = friction_step(u_cf(cur + 2 * C_ROW, s, f), cur[2 * C_ROW + 9], l2, mu_l);
        apply_cf(cur + 2 * C_ROW, dl, im, s, f);
        if (torsion) {
          dl = friction_step(dot3(cur + C_KT, s.y), cur[C_IWT], lt, mu_tor_r * ln);
          axpy3(dl, cur + C_KT, s.y);
        }
        S[at + C_LN] = ln; S[at + C_L1] = l1; S[at + C_L2] = l2; S[at + C_LT] = lt;
        S[at + C_DEP] = dep;
      }
    }
    // ---- F
    if (n_f > 0) {
      real cur[F_NF];
      // unrolled, so that the finger index is known when compiled and the
      // fingers' velocities stay in registers (n_f is 0 or 6)
#pragma unroll
      for (int idx = 0; idx < 3 * LG_NUM_SAMPLES; ++idx) {
        const int f = idx / LG_NUM_SAMPLES;
        const int at = F_OFF + idx * F_NF;
        load_rec(S, at, cur);
        real ln = cur[F_LN], l1 = cur[F_L1], l2 = cur[F_L2], dep = cur[F_DEP];
        real tgt = tgs ? tgs_target(K, dep, cur[F_TGT], inv_h_rem, false) : cur[F_TGT];
        real dl = normal_step(u_cf(cur, s, f), tgt, cur[9], ln);
        apply_cf(cur, dl, im, s, f);
        if (tgs) dep = dep - u_cf(cur, s, f) * K.h_it;
        real mu_l = mu_lc * ln;
        dl = friction_step(u_cf(cur + F_ROW, s, f), cur[F_ROW + 9], l1, mu_l);
        apply_cf(cur + F_ROW, dl, im, s, f);
        dl = friction_step(u_cf(cur + 2 * F_ROW, s, f), cur[2 * F_ROW + 9], l2, mu_l);
        apply_cf(cur + 2 * F_ROW, dl, im, s, f);
        S[at + F_LN] = ln; S[at + F_L1] = l1; S[at + F_L2] = l2; S[at + F_DEP] = dep;
      }
    }
    // ---- D, then E (finger-only rows: u = k_q.yq; n_d, n_e are 0 or 3)
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      const int n_g = grp == 0 ? n_d : n_e;
      const int off = grp == 0 ? D_OFF : E_OFF;
      const real mu = grp == 0 ? mu_tg : mu_tw;
      if (n_g == 0) continue;
      real cur[D_NF];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int at = off + f * D_NF;
        load_rec(S, at, cur);
        real ln = cur[D_LN], l1 = cur[D_L1], l2 = cur[D_L2], dep = cur[D_DEP];
        real tgt = tgs ? tgs_target(K, dep, cur[D_TGT], inv_h_rem, true) : cur[D_TGT];
        real dl = normal_step(dot3(cur, s.yq[f]), tgt, cur[3], ln);
        axpy3(dl, cur, s.yq[f]);
        real mu_l = mu * ln;
        if (tgs) dep = dep - dot3(cur, s.yq[f]) * K.h_it;
        dl = friction_step(dot3(cur + D_ROW, s.yq[f]), cur[D_ROW + 3], l1, mu_l);
        axpy3(dl, cur + D_ROW, s.yq[f]);
        dl = friction_step(dot3(cur + 2 * D_ROW, s.yq[f]), cur[2 * D_ROW + 3], l2, mu_l);
        axpy3(dl, cur + 2 * D_ROW, s.yq[f]);
        S[at + D_LN] = ln; S[at + D_L1] = l1; S[at + D_L2] = l2; S[at + D_DEP] = dep;
      }
    }

    if (tgs) {
      // mini-step pose integration; contact frames stay frozen at substep start
      p_pos = mk(p_pos.x + K.h_it * s.v[0], p_pos.y + K.h_it * s.v[1],
                 p_pos.z + K.h_it * s.v[2]);
      p_quat = quat_integrate(p_quat, world_w(c, s.y), K.half_h_it);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        V3 qdf = chol3_upper(lf[f], mk(s.yq[f][0], s.yq[f][1], s.yq[f][2]));
        p_q[3 * f] = p_q[3 * f] + K.h_it * qdf.x;
        p_q[3 * f + 1] = p_q[3 * f + 1] + K.h_it * qdf.y;
        p_q[3 * f + 2] = p_q[3 * f + 2] + K.h_it * qdf.z;
      }
    }
  }

  // ---- integrate positions + joint limits; the next substep's state
  const real vlim = P[P_VLIM];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    V3 qdf = chol3_upper(lf[f], mk(s.yq[f][0], s.yq[f][1], s.yq[f][2]));
    const real qds[3] = {qdf.x, qdf.y, qdf.z};
    for (int j = 0; j < 3; ++j) {
      const int gi = 3 * f + j;
      real qv = tgs ? p_q[gi] : S[X_STATE + gi] + K.h * qds[j];
      real qc = clipf_(qv, K.jlow[gi], K.jhigh[gi]);
      real qdv = qds[j];
      bool at_lower = (qv <= K.jlow[gi]) && (qdv < R(0.));
      bool at_upper = (qv >= K.jhigh[gi]) && (qdv > R(0.));
      qdv = (at_lower || at_upper) ? R(0.) : qdv;
      qdv = clipf_(qdv, -vlim, vlim);
      S[X_STATE + gi] = qc;
      S[X_STATE + 9 + gi] = qdv;
    }
  }
  V3 w = world_w(c, s.y);
  real w_norm = lg_sqrt(lg_fmax(dot(w, w), R(1e-18)));
  real w_scale = w_norm > K.max_cube_angvel ? K.max_cube_angvel / w_norm : R(1.);
  w = scale(w, w_scale);
  const V3 v = mk(s.v[0], s.v[1], s.v[2]);
  if (!tgs) {
    p_quat = quat_integrate(c.quat, w, K.half_h);
    p_pos = mk(c.pos.x + K.h * v.x, c.pos.y + K.h * v.y, c.pos.z + K.h * v.z);
  }
  put3(S, X_STATE + 18, p_pos);
  S[X_STATE + 21] = p_quat.x; S[X_STATE + 22] = p_quat.y;
  S[X_STATE + 23] = p_quat.z; S[X_STATE + 24] = p_quat.w;
  put3(S, X_STATE + 25, v);
  put3(S, X_STATE + 28, w);
}

// ---------------------------------------------------------------------------
// tip impulses, roles 1-3 (wrench sensing): force acc[0..2], torque acc[3..5]
// ---------------------------------------------------------------------------

template <int ST>
LG_HD void tip_impulse(const LgConsts& K, const Env<ST>& S, int f, const TipGeom& tg,
                       real acc[6]) {
  const int ac = C_OFF + f * C_NF;
  const V3 zv = mk(R(0.), R(0.), R(0.));
  V3 imp_c = scale(add(add(scale(tg.cn, S[ac + C_LN]), scale(tg.ct1, S[ac + C_L1])),
                       scale(tg.ct2, S[ac + C_L2])),
                   -R(1.));
  V3 imp = imp_c;
  V3 timp = cross(tg.arm_c, imp_c);
  if (K.enable_tip_ground) {
    const int ad = D_OFF + f * D_NF;
    V3 imp_d = mk(S[ad + D_L1], S[ad + D_L2], S[ad + D_LN]);
    imp = add(imp, imp_d);
    timp = add(timp, cross(tg.arm_d, imp_d));
  }
  if (K.enable_tip_wall) {
    const int ae = E_OFF + f * D_NF;
    V3 imp_e = add(add(scale(tg.en, S[ae + D_LN]), scale(tg.et1, S[ae + D_L1])),
                   scale(tg.et2, S[ae + D_L2]));
    imp = add(imp, imp_e);
    timp = add(timp, cross(tg.arm_e, imp_e));
  }
  imp = add(imp, zv);
  timp = add(timp, zv);
  acc[0] = acc[0] + imp.x; acc[1] = acc[1] + imp.y; acc[2] = acc[2] + imp.z;
  acc[3] = acc[3] + timp.x; acc[4] = acc[4] + timp.y; acc[5] = acc[5] + timp.z;
}

// ---------------------------------------------------------------------------
// the phases of one env's control step
// ---------------------------------------------------------------------------

template <int ST>
LG_HD void load_state(const Env<ST>& S, const real* __restrict__ state, int n, int env) {
  for (int i = 0; i < LG_STATE_ROWS; ++i) S[X_STATE + i] = state[i * n + env];
}

template <int ST>
LG_HD void store_state(const Env<ST>& S, real* __restrict__ out, int n, int env) {
  for (int i = 0; i < LG_STATE_ROWS; ++i) out[i * n + env] = S[X_STATE + i];
}

// role 0 builds the cube rows, role 1 + f finger f's
template <int ST>
LG_HD void build_phase(const LgConsts& K, const Env<ST>& S, const real* P, const real* tau,
                       int role, TipGeom& tg) {
  Cube c;
  cube_start(K, S, P, c);
  if (role == 0)
    build_cube_rows(K, S, P, c);
  else
    build_finger_rows(K, S, P, tau, c, role - 1, tg);
}

template <int ST>
LG_HD void sweep_phase(const LgConsts& K, const Env<ST>& S, const real* P) {
  Cube c;
  cube_start(K, S, P, c);
  sweep_and_integrate(K, S, P, c);
}

// ---------------------------------------------------------------------------
// fingertip kinematics: the env's observation path
// ---------------------------------------------------------------------------
//
// The second kernel of this file (built into the same library), fingertip_state_kernel, replaces no TPU
// kernel: the JAX package leaves engine_v2.fingertip_components_v2 to XLA,
// which fuses it. In plain PyTorch it is ~1,150 elementwise operations on
// (N,) columns, each a launch of its own, so the env step was bound by
// launches, not by its math. One thread per env computes all three fingers
// in registers: per finger ~380 operations (sin/cos, the rotation chain, the
// tip Jacobian's columns, the Shepperd quaternion with all four candidates).
// What bounds it is bytes: 18 rows read and 39 written, 228 B an env (1.9
// MB at 8192 envs, 0.56 us at 3.35 TB/s; the operations take 0.14 us at
// 67 TFLOP/s). Rows are [row][env], so a warp's loads and stores coalesce.
// Same formulas, in the same order, as the plain version; no fast math.

// rows of the output per finger: position 3, quaternion 4 (x, y, z, w),
// linear velocity 3, angular velocity 3
#define LG_TIP_ROWS 13
// envs (threads) per block: 8192 envs are 128 blocks, one per SM
#define LG_TIP_EPB 64

// engine_v2._quat_from_m3: Shepperd's four candidates, each square root's
// argument floored at 1e-12, one picked by the same selection, normalised
LG_HD void quat_from_m3(const M3& a, real o[4]) {
  const real (*m)[3] = a.m;
  const real trace = m[0][0] + m[1][1] + m[2][2];
  const real qw0 = lg_sqrt(lg_fmax(R(1.) + trace, R(1e-12))) * R(0.5);
  const real s0 = R(0.25) / qw0;
  const real c0[4] = {(m[2][1] - m[1][2]) * s0, (m[0][2] - m[2][0]) * s0,
                      (m[1][0] - m[0][1]) * s0, qw0};
  const real qx1 = lg_sqrt(lg_fmax(R(1.) + m[0][0] - m[1][1] - m[2][2], R(1e-12))) * R(0.5);
  const real s1 = R(0.25) / qx1;
  const real c1[4] = {qx1, (m[0][1] + m[1][0]) * s1, (m[0][2] + m[2][0]) * s1,
                      (m[2][1] - m[1][2]) * s1};
  const real qy2 = lg_sqrt(lg_fmax(R(1.) - m[0][0] + m[1][1] - m[2][2], R(1e-12))) * R(0.5);
  const real s2 = R(0.25) / qy2;
  const real c2[4] = {(m[0][1] + m[1][0]) * s2, qy2, (m[1][2] + m[2][1]) * s2,
                      (m[0][2] - m[2][0]) * s2};
  const real qz3 = lg_sqrt(lg_fmax(R(1.) - m[0][0] - m[1][1] + m[2][2], R(1e-12))) * R(0.5);
  const real s3 = R(0.25) / qz3;
  const real c3[4] = {(m[0][2] + m[2][0]) * s3, (m[1][2] + m[2][1]) * s3, qz3,
                      (m[1][0] - m[0][1]) * s3};
  const bool cond0 = trace > R(0.);
  const bool cond1 = (m[0][0] > m[1][1]) && (m[0][0] > m[2][2]);
  const bool cond2 = m[1][1] > m[2][2];
  real q[4];
  for (int i = 0; i < 4; ++i) q[i] = cond0 ? c0[i] : (cond1 ? c1[i] : (cond2 ? c2[i] : c3[i]));
  const real nrm = lg_sqrt(lg_fmax(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3],
                                   R(1e-12)));
  const real inv = R(1.) / nrm;
  for (int i = 0; i < 4; ++i) o[i] = q[i] * inv;
}

// engine_v2.fingertip_components_v2 for one env: joint positions q[9] and
// velocities qd[9] in, 3 x LG_TIP_ROWS rows out, finger by finger
LG_HD void fingertip_state(const LgConsts& K, const real q[9], const real qd[9],
                           real out[3 * LG_TIP_ROWS]) {
  for (int f = 0; f < 3; ++f) {
    const real* qf = q + 3 * f;
    const real* qdf = qd + 3 * f;
    real c1 = lg_cos(qf[0]), s1 = lg_sin(qf[0]);
    real c2 = lg_cos(qf[1]), s2 = lg_sin(qf[1]);
    real c3 = lg_cos(qf[2]), s3 = lg_sin(qf[2]);
    M3 r1 = rot_y(c1, s1);
    M3 r2 = mul(r1, rot_x(c2, s2));
    M3 r3 = mul(r2, rot_x(c3, s3));
    V3 p2 = matvec(r1, mk(K.o2[0], K.o2[1], K.o2[2]));
    V3 p3 = add(p2, matvec(r2, mk(K.o3[0], K.o3[1], K.o3[2])));
    V3 tip = add(p3, matvec(r3, mk(K.tip[0], K.tip[1], K.tip[2])));
    const V3 axes[3] = {mk(R(0.), R(1.), R(0.)), mk(r1.m[0][0], r1.m[1][0], r1.m[2][0]),
                        mk(r2.m[0][0], r2.m[1][0], r2.m[2][0])};
    const V3 joints[3] = {mk(R(0.), R(0.), R(0.)), p2, p3};
    V3 lin = mk(R(0.), R(0.), R(0.)), ang = mk(R(0.), R(0.), R(0.));
    for (int i = 0; i < 3; ++i) {
      V3 col = cross(axes[i], sub(tip, joints[i]));
      lin = add(lin, scale(col, qdf[i]));
      ang = add(ang, scale(axes[i], qdf[i]));
    }
    const real c = K.mount_c[f], s = K.mount_s[f];
    const M3 mount = {{{c, -s, R(0.)}, {s, c, R(0.)}, {R(0.), R(0.), R(1.)}}};
    real* o = out + f * LG_TIP_ROWS;
    const V3 tip_w = add(mk(R(0.), R(0.), K.mount_z), mount_rotate(K, f, tip));
    const V3 lin_w = mount_rotate(K, f, lin), ang_w = mount_rotate(K, f, ang);
    o[0] = tip_w.x; o[1] = tip_w.y; o[2] = tip_w.z;
    quat_from_m3(mul(mount, r3), o + 3);
    o[7] = lin_w.x; o[8] = lin_w.y; o[9] = lin_w.z;
    o[10] = ang_w.x; o[11] = ang_w.y; o[12] = ang_w.z;
  }
}

// env `env` of (9, n) joint rows q and qd to its column of the (39, n) out
LG_HD void fingertip_env(const LgConsts& K, const real* __restrict__ q,
                         const real* __restrict__ qd, real* __restrict__ out, int n, int env) {
  real qa[9], qda[9], o[3 * LG_TIP_ROWS];
  for (int i = 0; i < 9; ++i) {
    qa[i] = q[i * n + env];
    qda[i] = qd[i * n + env];
  }
  fingertip_state(K, qa, qda, o);
  for (int i = 0; i < 3 * LG_TIP_ROWS; ++i) out[i * n + env] = o[i];
}

#ifdef __CUDACC__

// LG_ROLES warps per block: role = threadIdx.x / LG_EPB, env in block =
// threadIdx.x % LG_EPB; every warp takes one role for all its envs.
__global__ void __launch_bounds__(LG_ROLES * LG_EPB)
physics_step_kernel(const LgConsts K, const real* __restrict__ state,
                    const real* __restrict__ params, const real* __restrict__ tau,
                    real* __restrict__ out, real* __restrict__ wrench, int n) {
  extern __shared__ real lg_smem[];
  const int role = threadIdx.x / LG_EPB;
  const int e = threadIdx.x % LG_EPB;
  const int env = blockIdx.x * LG_EPB + e;
  // the ragged edge: envs past n compute on a copy of the last env and store
  // nothing, so every thread reaches every barrier
  const bool active = env < n;
  const int src = active ? env : n - 1;
  const Env<LG_EPB> S{lg_smem + e};
  real P[LG_PARAM_ROWS], t[9], acc[6];
  for (int i = 0; i < LG_PARAM_ROWS; ++i) P[i] = params[i * n + src];
  for (int i = 0; i < 9; ++i) t[i] = tau[i * n + src];
  for (int i = 0; i < 6; ++i) acc[i] = R(0.);
  TipGeom tg;
  if (role == 0) load_state(S, state, n, src);
  __syncthreads();
  for (int k = 0; k < K.substeps; ++k) {
    build_phase(K, S, P, t, role, tg);
    __syncthreads();
    if (role == 0) sweep_phase(K, S, P);
    __syncthreads();
    if (role > 0) tip_impulse(K, S, role - 1, tg, acc);
  }
  if (!active) return;
  if (role == 0) {
    store_state(S, out, n, env);
  } else {
    const int f = role - 1;
    for (int i = 0; i < 3; ++i) {
      wrench[(3 * f + i) * n + env] = acc[i];
      wrench[(9 + 3 * f + i) * n + env] = acc[3 + i];
    }
  }
}

static const size_t lg_smem_bytes = (size_t)LG_EPB * LG_ENV_FLOATS * sizeof(real);

// The block's dynamic shared memory is above the 48 KB default: raise the
// cap, once per device (the attribute is the device context's). The first
// launch on a device raises it, so it must not fall inside a stream capture.
static const int lg_max_devices = 64;
static bool lg_smem_set[lg_max_devices] = {};
static cudaError_t lg_raise_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < lg_max_devices && lg_smem_set[dev])) return err;
  err = cudaFuncSetAttribute(
      physics_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lg_smem_bytes);
  if (err == cudaSuccess && dev < lg_max_devices) lg_smem_set[dev] = true;
  return err;
}

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int leibniz_physics_step(const real* state, const real* params,
                                    const real* tau, real* out, real* wrench, int n,
                                    const LgConsts* consts, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = lg_raise_smem();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + LG_EPB - 1) / LG_EPB;
  physics_step_kernel<<<blocks, LG_ROLES * LG_EPB, lg_smem_bytes, (cudaStream_t)stream>>>(
      *consts, state, params, tau, out, wrench, n);
  return (int)cudaGetLastError();
}

// Resident blocks per SM and dynamic shared memory per block of the launch
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int leibniz_physics_step_occupancy(int* blocks_per_sm, int* smem_bytes) {
  *smem_bytes = (int)lg_smem_bytes;
  cudaError_t err = lg_raise_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, physics_step_kernel,
                                                        LG_ROLES * LG_EPB, lg_smem_bytes);
  return (int)err;
}

// One thread per env; the ragged edge stores nothing.
__global__ void __launch_bounds__(LG_TIP_EPB)
fingertip_state_kernel(const LgConsts K, const real* __restrict__ q,
                       const real* __restrict__ qd, real* __restrict__ out, int n) {
  const int env = blockIdx.x * LG_TIP_EPB + threadIdx.x;
  if (env < n) fingertip_env(K, q, qd, out, n, env);
}

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int leibniz_fingertip_state(const real* q, const real* qd, real* out, int n,
                                       const LgConsts* consts, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + LG_TIP_EPB - 1) / LG_TIP_EPB;
  fingertip_state_kernel<<<blocks, LG_TIP_EPB, 0, (cudaStream_t)stream>>>(*consts, q, qd, out,
                                                                           n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

// The same phases on the host, one env after another, for tests of this
// source without a GPU.
extern "C" int leibniz_physics_step_host(const real* state, const real* params,
                                         const real* tau, real* out, real* wrench, int n,
                                         const LgConsts* consts) {
  const LgConsts& K = *consts;
  real store[LG_ENV_FLOATS];
  const Env<1> S{store};
  for (int env = 0; env < n; ++env) {
    real P[LG_PARAM_ROWS], t[9], acc[3][6];
    for (int i = 0; i < LG_PARAM_ROWS; ++i) P[i] = params[i * n + env];
    for (int i = 0; i < 9; ++i) t[i] = tau[i * n + env];
    for (int f = 0; f < 3; ++f)
      for (int i = 0; i < 6; ++i) acc[f][i] = R(0.);
    TipGeom tg[LG_ROLES];
    load_state(S, state, n, env);
    for (int k = 0; k < K.substeps; ++k) {
      for (int role = 0; role < LG_ROLES; ++role) build_phase(K, S, P, t, role, tg[role]);
      sweep_phase(K, S, P);
      for (int f = 0; f < 3; ++f) tip_impulse(K, S, f, tg[f + 1], acc[f]);
    }
    store_state(S, out, n, env);
    for (int f = 0; f < 3; ++f)
      for (int i = 0; i < 3; ++i) {
        wrench[(3 * f + i) * n + env] = acc[f][i];
        wrench[(9 + 3 * f + i) * n + env] = acc[f][3 + i];
      }
  }
  return 0;
}

extern "C" int leibniz_fingertip_state_host(const real* q, const real* qd, real* out, int n,
                                            const LgConsts* consts) {
  for (int env = 0; env < n; ++env) fingertip_env(*consts, q, qd, out, n, env);
  return 0;
}

extern "C" int leibniz_consts_size() { return (int)sizeof(LgConsts); }
