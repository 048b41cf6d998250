// TriFinger physics control step: one CUDA thread per env.
//
// Replaces the TPU kernel leibnizgym_tpu/ops/pallas_engine.py::_kernel
// (launched by physics_step_pallas), whose body is
// leibnizgym_tpu/ops/engine_v2.py::_substep_fields. The plain PyTorch version
// of the same step is leibnizgym_tpu_torch/ops/engine_v2.py; this file
// follows it formula by formula, in the same order of operations.
//
// What bounds it on an H100: latency and registers, not bytes. An env reads
// 31 + 40 + 9 floats and writes 31 + 18 (about 0.5 KB; 8192 envs move about
// 4 MB), while each control step runs on the order of 10^5 dependent scalar
// flops per env: FK, a 3x3 mass matrix and Cholesky per finger, up to 31
// contacts, and 4 x 8 sequential Gauss-Seidel sweeps. The sweep carries 21
// lambda groups (up to 104 multipliers) plus the frozen per-contact frames
// and Jacobians, far more than the 255 registers a thread may hold.
//
// What the design does about that:
//  - Component-major (C, N) layout at the boundary, so neighbouring threads
//    read neighbouring addresses; state and params are loaded once, all
//    substeps and solver iterations loop inside the kernel, results are
//    stored once. The ragged edge is `if (env >= n) return;`.
//  - Per-contact data lives in fixed-size per-thread arrays. What does not
//    fit in registers spills to local memory, which stays in L1/L2 (about
//    3.5 KB per env, under 30 MB at 8192 envs against a 50 MB L2). The
//    register count and spill bytes of this version are in PERF.md.
//  - Block size: 32 threads. At 8192 envs there are only 256 warps for 132
//    SMs, so larger blocks leave SMs idle (128-thread blocks give 64 blocks);
//    one-warp blocks spread the warps over every SM.
//  - SolverConfig's solver type, object shape and enable_* gates are runtime
//    flags in the constants struct: every thread takes the same branch.
//    Robot constants and solver factors come from the wrapper, so
//    leibnizgym_tpu/models/trifinger.py stays the one source of truth.
//
// Numerics: no fast math. nvcc contracts a*b+c into FMAs and the device
// sinf/cosf differ from the host's by an ulp, so results differ from the
// plain version in the last bits; the contact solve amplifies that (the
// cube's inverse inertia is ~1.8e4). The tolerances are stated where the
// kernel is compared with the plain version (chip_smoke.py,
// tests/test_torch_cuda.py); tests/test_torch_kernel_host.py holds a float64
// host build of this file to the plain version in float64.
//
// Build (route: nvcc into a shared library with a plain C entry point,
// loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The same file compiles as C++ for the host (g++ -x c++), where
// leibniz_physics_step_host runs the identical per-env function on the CPU.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LG_HD __host__ __device__ __forceinline__
#else
#define LG_HD static inline
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
LG_HD float lg_fmax(float a, float b) { return fmaxf(a, b); }
LG_HD double lg_fmax(double a, double b) { return fmax(a, b); }
LG_HD float lg_fmin(float a, float b) { return fminf(a, b); }
LG_HD double lg_fmin(double a, double b) { return fmin(a, b); }
LG_HD float lg_fabs(float x) { return fabsf(x); }
LG_HD double lg_fabs(double x) { return fabs(x); }
LG_HD float lg_sin(float x) { return sinf(x); }
LG_HD double lg_sin(double x) { return sin(x); }
LG_HD float lg_cos(float x) { return cosf(x); }
LG_HD double lg_cos(double x) { return cos(x); }

#define LG_STATE_ROWS 31
#define LG_PARAM_ROWS 40
#define LG_WRENCH_ROWS 18
#define LG_NUM_SAMPLES 2

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

LG_HD V3 chol3_solve(const Chol& c, const V3& b) {
  real y0 = b.x / c.l00;
  real y1 = (b.y - c.l10 * y0) / c.l11;
  real y2 = (b.z - c.l20 * y0 - c.l21 * y1) / c.l22;
  real x2 = y2 / c.l22;
  real x1 = (y1 - c.l21 * x2) / c.l11;
  real x0 = (y0 - c.l10 * x1 - c.l20 * x2) / c.l00;
  return mk(x0, x1, x2);
}

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

LG_HD void finger_dynamics(const LgConsts& K, int f, const real* q9, const real* qd9,
                           const real* tau9, const V3& g, const real lms[3],
                           const real jd[3], const real arm[3], bool with_samples,
                           FingerData& fd) {
  const real q[3] = {q9[3 * f], q9[3 * f + 1], q9[3 * f + 2]};
  const real qd[3] = {qd9[3 * f], qd9[3 * f + 1], qd9[3 * f + 2]};
  const real tau[3] = {tau9[3 * f], tau9[3 * f + 1], tau9[3 * f + 2]};

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

// qd += sign * M^-1 J^T p
LG_HD void apply_impulse(const V3 minv_cols[3], real qd[3], const V3& p, real sign) {
  for (int i = 0; i < 3; ++i)
    qd[i] = qd[i] + sign * (comp(minv_cols[0], i) * p.x + comp(minv_cols[1], i) * p.y +
                            comp(minv_cols[2], i) * p.z);
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

// ---------------------------------------------------------------------------
// contact records
// ---------------------------------------------------------------------------

struct CubeContact {  // groups A (ground) and B (wall)
  V3 r, n, t1, t2;
  real target, rest, depth, wn, wt1, wt2, ws;
  real ln, l1, l2, lt, d;
};

struct ProbeContact {  // groups C (tip vs cube) and F (link sample vs cube)
  V3 r, n, t1, t2, point;
  real target, rest, depth, wn, wt1, wt2, ws;
  real ln, l1, l2, lt, d;
};

struct FingerContact {  // groups D (tip vs ground) and E (tip vs wall)
  V3 n, t1, t2;
  real target, rest, depth, wn, wt1, wt2;
  real ln, l1, l2, d;
};

struct Body {
  real inv_mass;
  M3 inv_i_w;
};

LG_HD V3 cube_point_vel(const V3& v, const V3& w, const V3& r) { return add(v, cross(w, r)); }

LG_HD real k_cube_dir(const Body& b, const V3& r, const V3& d) {
  V3 rxd = cross(r, d);
  return b.inv_mass + dot(rxd, matvec(b.inv_i_w, rxd));
}

LG_HD void cube_apply(const Body& b, V3& v, V3& w, const V3& r, const V3& p) {
  v = mk(v.x + b.inv_mass * p.x, v.y + b.inv_mass * p.y, v.z + b.inv_mass * p.z);
  w = add(w, matvec(b.inv_i_w, cross(r, p)));
}

LG_HD void spin_apply(const Body& b, V3& w, const V3& n, real d_lam) {
  w = add(w, matvec(b.inv_i_w, scale(n, d_lam)));
}

LG_HD real k_spin(const Body& b, const V3& n) {
  return lg_fmax(dot(n, matvec(b.inv_i_w, n)), R(1e-6));
}

// normal_step: lam <- max(lam + (target - u_n) / w_n, 0); returns the change
LG_HD real normal_step(real u_n, real target, real w_n, real& lam) {
  real new_lam = lg_fmax(lam + (target - u_n) / w_n, R(0.));
  real d = new_lam - lam;
  lam = new_lam;
  return d;
}

LG_HD real friction_step(real u_t, real w_t, real& lam_t, real mu_lam) {
  real new_lam = clipf_(lam_t - u_t / w_t, -mu_lam, mu_lam);
  real d = new_lam - lam_t;
  lam_t = new_lam;
  return d;
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

// TGS velocity target for the remaining depth d at mini-step `it`
LG_HD real tgs_target(const LgConsts& K, real d, real rest, int it, bool capped) {
  real pen = K.tgs_over_h_it * lg_fmax(d - K.contact_slop, R(0.));
  if (capped) pen = lg_fmin(pen, K.finger_bias_cap);
  real h_rem = K.h - (real)it * K.h_it;  // real, as the reference's traced loop index
  real bias = d > R(0.) ? pen : d / h_rem;
  return lg_fmax(bias, rest);
}

struct PhysState {
  real q[9], qd[9];
  V3 pos;
  Quat quat;
  V3 v, w;
};

// ---------------------------------------------------------------------------
// one substep (engine_v2._substep_fields); adds this substep's tip impulses
// (force rows 0-8, torque rows 9-17) to imp_acc
// ---------------------------------------------------------------------------

LG_HD void substep(const LgConsts& K, PhysState& s, const real tau[9], const real* P,
                   real imp_acc[LG_WRENCH_ROWS]) {
  const bool sphere_obj = K.object_shape == 1;
  const bool tgs = K.solver_type == 1;
  const bool torsion = K.enable_torsion != 0;
  const V3 g = mk(P[P_GRAV], P[P_GRAV + 1], P[P_GRAV + 2]);
  real lms[3], jd[3], arm[3];
  for (int i = 0; i < 3; ++i) {
    lms[i] = P[P_LINK_MASS + i] / K.base_masses[i];
    jd[i] = P[P_JDAMP + i];
    arm[i] = P[P_ARM + i];
  }

  // ---- fingers
  FingerData fingers[3];
  real qds[3][3];
  for (int f = 0; f < 3; ++f) {
    finger_dynamics(K, f, s.q, s.qd, tau, g, lms, jd, arm, K.enable_link_cube != 0,
                    fingers[f]);
    for (int j = 0; j < 3; ++j) qds[f][j] = fingers[f].qd[j];
  }

  // ---- cube free velocities
  real lin_damp = lg_fmax(R(1.) - P[P_LIN_DAMP] * K.h, R(0.));
  real ang_damp = lg_fmax(R(1.) - P[P_ANG_DAMP] * K.h, R(0.));
  V3 v = mk(s.v.x * lin_damp, s.v.y * lin_damp, s.v.z * lin_damp);
  v = mk(v.x + K.h * g.x, v.y + K.h * g.y, v.z + K.h * g.z);
  V3 w = mk(s.w.x * ang_damp, s.w.y * ang_damp, s.w.z * ang_damp);

  // ---- cube body quantities
  const Quat quat = s.quat;
  const M3 rot = quat_to_m3(quat);
  const V3 pos = s.pos;
  Body body;
  body.inv_mass = R(1.) / P[P_CMASS];
  const real inv_i[3] = {R(1.) / P[P_INERTIA], R(1.) / P[P_INERTIA + 1], R(1.) / P[P_INERTIA + 2]};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      body.inv_i_w.m[i][j] = rot.m[i][0] * inv_i[0] * rot.m[j][0] +
                             rot.m[i][1] * inv_i[1] * rot.m[j][1] +
                             rot.m[i][2] * inv_i[2] * rot.m[j][2];
  const V3 half = mk(P[P_HALF], P[P_HALF + 1], P[P_HALF + 2]);
  const real radius_o = half.x;
  const real bounce = P[P_BOUNCE];

  // ---- object points: A vs ground, B vs wall
  V3 a_points[8];
  int n_a, n_b = 0;
  CubeContact A[8], B[8];
  V3 b_points[8];
  real b_depth[8];
  V3 b_n[8];
  if (sphere_obj) {
    n_a = 1;
    a_points[0] = mk(pos.x, pos.y, pos.z - radius_o);
    if (K.enable_cube_wall) {
      real gap_c;
      V3 n_c;
      wall_gap(P, pos.x, pos.y, pos.z, gap_c, n_c);
      n_b = 1;
      b_points[0] = mk(pos.x - n_c.x * radius_o, pos.y - n_c.y * radius_o,
                       pos.z - n_c.z * radius_o);
      b_depth[0] = radius_o - gap_c;
      b_n[0] = n_c;
    }
  } else {
    n_a = 8;
    int ci = 0;
    for (int sx = -1; sx <= 1; sx += 2)
      for (int sy = -1; sy <= 1; sy += 2)
        for (int sz = -1; sz <= 1; sz += 2) {
          V3 local = mk((real)sx * half.x, (real)sy * half.y, (real)sz * half.z);
          a_points[ci] = add(pos, matvec(rot, local));
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

  const V3 ez = mk(R(0.), R(0.), R(1.));
  const V3 a_t1 = mk(R(0.), R(1.), R(0.));
  const V3 a_t2 = mk(-R(1.), R(0.), R(0.));
  for (int i = 0; i < n_a; ++i) {
    CubeContact& ct = A[i];
    ct.r = sub(a_points[i], pos);
    ct.depth = -a_points[i].z;
    real vn0 = cube_point_vel(v, w, ct.r).z;
    ct.target = contact_target(K, ct.depth, vn0, P[P_REST_CUBE_GROUND], bounce, false);
    ct.rest = restitution_target(K, ct.depth, vn0, P[P_REST_CUBE_GROUND], bounce);
    ct.wn = k_cube_dir(body, ct.r, ez);
    ct.wt1 = k_cube_dir(body, ct.r, a_t1);
    ct.wt2 = k_cube_dir(body, ct.r, a_t2);
  }
  for (int i = 0; i < n_b; ++i) {
    CubeContact& ct = B[i];
    ct.r = sub(b_points[i], pos);
    ct.n = b_n[i];
    ct.depth = b_depth[i];
    tangent_basis(ct.n, ct.t1, ct.t2);
    V3 u = cube_point_vel(v, w, ct.r);
    ct.target = contact_target(K, ct.depth, dot(u, ct.n), R(0.), bounce, false);
    ct.rest = restitution_target(K, ct.depth, dot(u, ct.n), R(0.), bounce);
    ct.wn = k_cube_dir(body, ct.r, ct.n);
    ct.wt1 = k_cube_dir(body, ct.r, ct.t1);
    ct.wt2 = k_cube_dir(body, ct.r, ct.t2);
  }

  // ---- group C: tip spheres vs object
  ProbeContact C[3];
  V3 tip_center[3];
  for (int f = 0; f < 3; ++f) {
    ProbeContact& ct = C[f];
    const PointData& tp = fingers[f].tip;
    tip_center[f] = add(tp.pos_w, mk(R(0.), R(0.), K.tip_off_z));
    real sdist;
    sphere_vs_object(sphere_obj, pos, rot, half, tip_center[f], ct.r, ct.n, ct.t1,
                     ct.t2, ct.point, sdist);
    ct.depth = P[P_TIP_RADIUS] - sdist;
    V3 u = sub(cube_point_vel(v, w, ct.r), point_vel(tp.cols, qds[f]));
    real un = dot(u, ct.n);
    ct.target = contact_target(K, ct.depth, un, P[P_REST_TIP_CUBE], bounce, false);
    ct.rest = restitution_target(K, ct.depth, un, P[P_REST_TIP_CUBE], bounce);
    M3 at;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) at.m[i][j] = tp.a[i][j];
    ct.wn = k_cube_dir(body, ct.r, ct.n) + dot(ct.n, matvec(at, ct.n));
    ct.wt1 = k_cube_dir(body, ct.r, ct.t1) + dot(ct.t1, matvec(at, ct.t1));
    ct.wt2 = k_cube_dir(body, ct.r, ct.t2) + dot(ct.t2, matvec(at, ct.t2));
  }

  // ---- group F: lower-link shaft samples vs object (index f * S + s)
  const int n_f = K.enable_link_cube ? 3 * LG_NUM_SAMPLES : 0;
  ProbeContact F[3 * LG_NUM_SAMPLES];
  for (int idx = 0; idx < n_f; ++idx) {
    const int f = idx / LG_NUM_SAMPLES, si = idx % LG_NUM_SAMPLES;
    const PointData& sp = fingers[f].samples[si];
    ProbeContact& ct = F[idx];
    real sdist;
    sphere_vs_object(sphere_obj, pos, rot, half, sp.pos_w, ct.r, ct.n, ct.t1, ct.t2,
                     ct.point, sdist);
    ct.depth = K.sample_radius[si] - sdist;
    V3 u = sub(cube_point_vel(v, w, ct.r), point_vel(sp.cols, qds[f]));
    real un = dot(u, ct.n);
    ct.target = contact_target(K, ct.depth, un, P[P_REST_LINK_CUBE], bounce, false);
    ct.rest = restitution_target(K, ct.depth, un, P[P_REST_LINK_CUBE], bounce);
    M3 at;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) at.m[i][j] = sp.a[i][j];
    ct.wn = k_cube_dir(body, ct.r, ct.n) + dot(ct.n, matvec(at, ct.n));
    ct.wt1 = k_cube_dir(body, ct.r, ct.t1) + dot(ct.t1, matvec(at, ct.t1));
    ct.wt2 = k_cube_dir(body, ct.r, ct.t2) + dot(ct.t2, matvec(at, ct.t2));
  }

  // ---- group D: tip spheres vs ground
  const int n_d = K.enable_tip_ground ? 3 : 0;
  FingerContact D[3];
  for (int f = 0; f < n_d; ++f) {
    FingerContact& ct = D[f];
    const PointData& tp = fingers[f].tip;
    ct.depth = P[P_TIP_RADIUS] - tip_center[f].z;
    real uz = point_vel(tp.cols, qds[f]).z;
    ct.target = contact_target(K, ct.depth, uz, P[P_REST_TIP_GROUND], bounce, true);
    ct.rest = restitution_target(K, ct.depth, uz, P[P_REST_TIP_GROUND], bounce);
    // finger-only contact: J M^-1 J^T can be singular (floored at w_min)
    ct.wn = lg_fmax(tp.a[2][2], K.w_min);
    ct.wt1 = lg_fmax(tp.a[0][0], K.w_min);
    ct.wt2 = lg_fmax(tp.a[1][1], K.w_min);
  }

  // ---- group E: tip spheres vs arena wall
  const int n_e = K.enable_tip_wall ? 3 : 0;
  FingerContact E[3];
  for (int f = 0; f < n_e; ++f) {
    FingerContact& ct = E[f];
    const PointData& tp = fingers[f].tip;
    real gap;
    wall_gap(P, tip_center[f].x, tip_center[f].y, tip_center[f].z, gap, ct.n);
    ct.depth = P[P_TIP_RADIUS] - gap;
    tangent_basis(ct.n, ct.t1, ct.t2);
    real un = dot(point_vel(tp.cols, qds[f]), ct.n);
    ct.target = contact_target(K, ct.depth, un, P[P_REST_TIP_WALL], bounce, true);
    ct.rest = restitution_target(K, ct.depth, un, P[P_REST_TIP_WALL], bounce);
    M3 at;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) at.m[i][j] = tp.a[i][j];
    ct.wn = lg_fmax(dot(ct.n, matvec(at, ct.n)), K.w_min);
    ct.wt1 = lg_fmax(dot(ct.t1, matvec(at, ct.t1)), K.w_min);
    ct.wt2 = lg_fmax(dot(ct.t2, matvec(at, ct.t2)), K.w_min);
  }

  // ---- torsional friction spin masses
  const real a_ws = body.inv_i_w.m[2][2];
  if (torsion) {
    for (int i = 0; i < n_b; ++i) B[i].ws = k_spin(body, B[i].n);
    for (int f = 0; f < 3; ++f) C[f].ws = k_spin(body, C[f].n);
  }
  const real mu_tor_r = P[P_MU_TORSION] * P[P_TORSION_R];

  // ---- solver state: multipliers start at zero, TGS depths at the depths
  for (int i = 0; i < n_a; ++i) { A[i].ln = A[i].l1 = A[i].l2 = A[i].lt = R(0.); A[i].d = A[i].depth; }
  for (int i = 0; i < n_b; ++i) { B[i].ln = B[i].l1 = B[i].l2 = B[i].lt = R(0.); B[i].d = B[i].depth; }
  for (int i = 0; i < 3; ++i) { C[i].ln = C[i].l1 = C[i].l2 = C[i].lt = R(0.); C[i].d = C[i].depth; }
  for (int i = 0; i < n_f; ++i) { F[i].ln = F[i].l1 = F[i].l2 = F[i].lt = R(0.); F[i].d = F[i].depth; }
  for (int i = 0; i < n_d; ++i) { D[i].ln = D[i].l1 = D[i].l2 = R(0.); D[i].d = D[i].depth; }
  for (int i = 0; i < n_e; ++i) { E[i].ln = E[i].l1 = E[i].l2 = R(0.); E[i].d = E[i].depth; }
  V3 p_pos = pos;
  Quat p_quat = quat;
  real p_q[9];
  for (int i = 0; i < 9; ++i) p_q[i] = s.q[i];

  const real mu_cg = P[P_MU_CUBE_GROUND], mu_cw = P[P_MU_CUBE_WALL];
  const real mu_tc = P[P_MU_TIP_CUBE], mu_lc = P[P_MU_LINK_CUBE];
  const real mu_tg = P[P_MU_TIP_GROUND], mu_tw = P[P_MU_TIP_WALL];
  const V3 zv = mk(R(0.), R(0.), R(0.));

  for (int it = 0; it < K.solver_iterations; ++it) {
    for (int i = 0; i < n_a; ++i) {
      CubeContact& ct = A[i];
      V3 u = cube_point_vel(v, w, ct.r);
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, false) : ct.target;
      real d_lam = normal_step(u.z, tgt, ct.wn, ct.ln);
      cube_apply(body, v, w, ct.r, mk(R(0.), R(0.), d_lam));
      real mu_l = mu_cg * ct.ln;
      u = cube_point_vel(v, w, ct.r);
      if (tgs) ct.d = ct.d - u.z * K.h_it;
      d_lam = friction_step(u.y, ct.wt1, ct.l1, mu_l);
      cube_apply(body, v, w, ct.r, mk(R(0.), d_lam, R(0.)));
      u = cube_point_vel(v, w, ct.r);
      d_lam = friction_step(-u.x, ct.wt2, ct.l2, mu_l);
      cube_apply(body, v, w, ct.r, mk(-d_lam, R(0.), R(0.)));
      if (torsion) {
        d_lam = friction_step(w.z, a_ws, ct.lt, mu_tor_r * ct.ln);
        spin_apply(body, w, ez, d_lam);
      }
    }

    for (int i = 0; i < n_b; ++i) {
      CubeContact& ct = B[i];
      V3 u = cube_point_vel(v, w, ct.r);
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, false) : ct.target;
      real d_lam = normal_step(dot(u, ct.n), tgt, ct.wn, ct.ln);
      cube_apply(body, v, w, ct.r, scale(ct.n, d_lam));
      real mu_l = mu_cw * ct.ln;
      u = cube_point_vel(v, w, ct.r);
      if (tgs) ct.d = ct.d - dot(u, ct.n) * K.h_it;
      d_lam = friction_step(dot(u, ct.t1), ct.wt1, ct.l1, mu_l);
      cube_apply(body, v, w, ct.r, scale(ct.t1, d_lam));
      u = cube_point_vel(v, w, ct.r);
      d_lam = friction_step(dot(u, ct.t2), ct.wt2, ct.l2, mu_l);
      cube_apply(body, v, w, ct.r, scale(ct.t2, d_lam));
      if (torsion) {
        d_lam = friction_step(dot(w, ct.n), ct.ws, ct.lt, mu_tor_r * ct.ln);
        spin_apply(body, w, ct.n, d_lam);
      }
    }

    for (int f = 0; f < 3; ++f) {
      ProbeContact& ct = C[f];
      const PointData& tp = fingers[f].tip;
      V3 u = sub(cube_point_vel(v, w, ct.r), point_vel(tp.cols, qds[f]));
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, false) : ct.target;
      real d_lam = normal_step(dot(u, ct.n), tgt, ct.wn, ct.ln);
      V3 p = scale(ct.n, d_lam);
      cube_apply(body, v, w, ct.r, p);
      apply_impulse(tp.minv_cols, qds[f], p, -R(1.));
      if (tgs) {
        u = sub(cube_point_vel(v, w, ct.r), point_vel(tp.cols, qds[f]));
        ct.d = ct.d - dot(u, ct.n) * K.h_it;
      }
      real mu_l = mu_tc * ct.ln;
      for (int which = 0; which < 2; ++which) {
        const V3& t_vec = which == 0 ? ct.t1 : ct.t2;
        real w_t = which == 0 ? ct.wt1 : ct.wt2;
        real& lam = which == 0 ? ct.l1 : ct.l2;
        u = sub(cube_point_vel(v, w, ct.r), point_vel(tp.cols, qds[f]));
        d_lam = friction_step(dot(u, t_vec), w_t, lam, mu_l);
        p = scale(t_vec, d_lam);
        cube_apply(body, v, w, ct.r, p);
        apply_impulse(tp.minv_cols, qds[f], p, -R(1.));
      }
      if (torsion) {
        d_lam = friction_step(dot(w, ct.n), ct.ws, ct.lt, mu_tor_r * ct.ln);
        spin_apply(body, w, ct.n, d_lam);
      }
    }

    for (int idx = 0; idx < n_f; ++idx) {
      const int f = idx / LG_NUM_SAMPLES;
      ProbeContact& ct = F[idx];
      const PointData& sp = fingers[f].samples[idx % LG_NUM_SAMPLES];
      V3 u = sub(cube_point_vel(v, w, ct.r), point_vel(sp.cols, qds[f]));
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, false) : ct.target;
      real d_lam = normal_step(dot(u, ct.n), tgt, ct.wn, ct.ln);
      V3 p = scale(ct.n, d_lam);
      cube_apply(body, v, w, ct.r, p);
      apply_impulse(sp.minv_cols, qds[f], p, -R(1.));
      if (tgs) {
        u = sub(cube_point_vel(v, w, ct.r), point_vel(sp.cols, qds[f]));
        ct.d = ct.d - dot(u, ct.n) * K.h_it;
      }
      real mu_l = mu_lc * ct.ln;
      for (int which = 0; which < 2; ++which) {
        const V3& t_vec = which == 0 ? ct.t1 : ct.t2;
        real w_t = which == 0 ? ct.wt1 : ct.wt2;
        real& lam = which == 0 ? ct.l1 : ct.l2;
        u = sub(cube_point_vel(v, w, ct.r), point_vel(sp.cols, qds[f]));
        d_lam = friction_step(dot(u, t_vec), w_t, lam, mu_l);
        p = scale(t_vec, d_lam);
        cube_apply(body, v, w, ct.r, p);
        apply_impulse(sp.minv_cols, qds[f], p, -R(1.));
      }
    }

    for (int f = 0; f < n_d; ++f) {
      FingerContact& ct = D[f];
      const PointData& tp = fingers[f].tip;
      V3 u = point_vel(tp.cols, qds[f]);
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, true) : ct.target;
      real d_lam = normal_step(u.z, tgt, ct.wn, ct.ln);
      apply_impulse(tp.minv_cols, qds[f], mk(R(0.), R(0.), d_lam), R(1.));
      real mu_l = mu_tg * ct.ln;
      u = point_vel(tp.cols, qds[f]);
      if (tgs) ct.d = ct.d - u.z * K.h_it;
      d_lam = friction_step(u.x, ct.wt1, ct.l1, mu_l);
      apply_impulse(tp.minv_cols, qds[f], mk(d_lam, R(0.), R(0.)), R(1.));
      u = point_vel(tp.cols, qds[f]);
      d_lam = friction_step(u.y, ct.wt2, ct.l2, mu_l);
      apply_impulse(tp.minv_cols, qds[f], mk(R(0.), d_lam, R(0.)), R(1.));
    }

    for (int f = 0; f < n_e; ++f) {
      FingerContact& ct = E[f];
      const PointData& tp = fingers[f].tip;
      V3 u = point_vel(tp.cols, qds[f]);
      real tgt = tgs ? tgs_target(K, ct.d, ct.rest, it, true) : ct.target;
      real d_lam = normal_step(dot(u, ct.n), tgt, ct.wn, ct.ln);
      apply_impulse(tp.minv_cols, qds[f], scale(ct.n, d_lam), R(1.));
      if (tgs) {
        u = point_vel(tp.cols, qds[f]);
        ct.d = ct.d - dot(u, ct.n) * K.h_it;
      }
      real mu_l = mu_tw * ct.ln;
      for (int which = 0; which < 2; ++which) {
        const V3& t_vec = which == 0 ? ct.t1 : ct.t2;
        real w_t = which == 0 ? ct.wt1 : ct.wt2;
        real& lam = which == 0 ? ct.l1 : ct.l2;
        u = point_vel(tp.cols, qds[f]);
        d_lam = friction_step(dot(u, t_vec), w_t, lam, mu_l);
        apply_impulse(tp.minv_cols, qds[f], scale(t_vec, d_lam), R(1.));
      }
    }

    if (tgs) {
      // mini-step pose integration; contact frames stay frozen at substep start
      p_pos = mk(p_pos.x + K.h_it * v.x, p_pos.y + K.h_it * v.y, p_pos.z + K.h_it * v.z);
      p_quat = quat_integrate(p_quat, w, K.half_h_it);
      for (int f = 0; f < 3; ++f)
        for (int j = 0; j < 3; ++j) p_q[3 * f + j] = p_q[3 * f + j] + K.h_it * qds[f][j];
    }
  }

  // ---- fingertip contact impulses (wrench sensing)
  for (int f = 0; f < 3; ++f) {
    const ProbeContact& ct = C[f];
    const V3 tip_w = fingers[f].tip.pos_w;
    V3 imp_c = scale(add(add(scale(ct.n, ct.ln), scale(ct.t1, ct.l1)), scale(ct.t2, ct.l2)),
                     -R(1.));
    V3 center = tip_center[f];
    V3 imp = imp_c;
    V3 timp = cross(sub(ct.point, tip_w), imp_c);
    if (K.enable_tip_ground) {
      V3 imp_d = mk(D[f].l1, D[f].l2, D[f].ln);
      V3 arm_d = sub(mk(center.x, center.y, center.z - P[P_TIP_RADIUS]), tip_w);
      imp = add(imp, imp_d);
      timp = add(timp, cross(arm_d, imp_d));
    }
    if (K.enable_tip_wall) {
      const FingerContact& et = E[f];
      V3 imp_e = add(add(scale(et.n, et.ln), scale(et.t1, et.l1)), scale(et.t2, et.l2));
      V3 arm_e = sub(sub(center, scale(et.n, P[P_TIP_RADIUS])), tip_w);
      imp = add(imp, imp_e);
      timp = add(timp, cross(arm_e, imp_e));
    }
    imp = add(imp, zv);
    timp = add(timp, zv);
    imp_acc[3 * f] = imp_acc[3 * f] + imp.x;
    imp_acc[3 * f + 1] = imp_acc[3 * f + 1] + imp.y;
    imp_acc[3 * f + 2] = imp_acc[3 * f + 2] + imp.z;
    imp_acc[9 + 3 * f] = imp_acc[9 + 3 * f] + timp.x;
    imp_acc[9 + 3 * f + 1] = imp_acc[9 + 3 * f + 1] + timp.y;
    imp_acc[9 + 3 * f + 2] = imp_acc[9 + 3 * f + 2] + timp.z;
  }

  // ---- integrate positions + joint limits
  const real vlim = P[P_VLIM];
  for (int f = 0; f < 3; ++f)
    for (int j = 0; j < 3; ++j) {
      const int gi = 3 * f + j;
      real qv = tgs ? p_q[gi] : s.q[gi] + K.h * qds[f][j];
      real qc = clipf_(qv, K.jlow[gi], K.jhigh[gi]);
      real qdv = qds[f][j];
      bool at_lower = (qv <= K.jlow[gi]) && (qdv < R(0.));
      bool at_upper = (qv >= K.jhigh[gi]) && (qdv > R(0.));
      qdv = (at_lower || at_upper) ? R(0.) : qdv;
      qdv = clipf_(qdv, -vlim, vlim);
      s.q[gi] = qc;
      s.qd[gi] = qdv;
    }

  real w_norm = lg_sqrt(lg_fmax(dot(w, w), R(1e-18)));
  real w_scale = w_norm > K.max_cube_angvel ? K.max_cube_angvel / w_norm : R(1.);
  w = scale(w, w_scale);

  if (tgs) {
    s.pos = p_pos;
    s.quat = p_quat;
  } else {
    s.quat = quat_integrate(quat, w, K.half_h);
    s.pos = mk(pos.x + K.h * v.x, pos.y + K.h * v.y, pos.z + K.h * v.z);
  }
  s.v = v;
  s.w = w;
}

// one env through all substeps: load (C, N) columns, loop, store
LG_HD void step_env(const LgConsts& K, const real* __restrict__ state,
                    const real* __restrict__ params, const real* __restrict__ tau,
                    real* __restrict__ out, real* __restrict__ wrench, int n, int env) {
  PhysState s;
  real t[9], P[LG_PARAM_ROWS], acc[LG_WRENCH_ROWS];
  for (int i = 0; i < 9; ++i) s.q[i] = state[i * n + env];
  for (int i = 0; i < 9; ++i) s.qd[i] = state[(9 + i) * n + env];
  s.pos = mk(state[18 * n + env], state[19 * n + env], state[20 * n + env]);
  s.quat.x = state[21 * n + env];
  s.quat.y = state[22 * n + env];
  s.quat.z = state[23 * n + env];
  s.quat.w = state[24 * n + env];
  s.v = mk(state[25 * n + env], state[26 * n + env], state[27 * n + env]);
  s.w = mk(state[28 * n + env], state[29 * n + env], state[30 * n + env]);
  for (int i = 0; i < 9; ++i) t[i] = tau[i * n + env];
  for (int i = 0; i < LG_PARAM_ROWS; ++i) P[i] = params[i * n + env];
  for (int i = 0; i < LG_WRENCH_ROWS; ++i) acc[i] = R(0.);

  for (int k = 0; k < K.substeps; ++k) substep(K, s, t, P, acc);

  for (int i = 0; i < 9; ++i) out[i * n + env] = s.q[i];
  for (int i = 0; i < 9; ++i) out[(9 + i) * n + env] = s.qd[i];
  out[18 * n + env] = s.pos.x;
  out[19 * n + env] = s.pos.y;
  out[20 * n + env] = s.pos.z;
  out[21 * n + env] = s.quat.x;
  out[22 * n + env] = s.quat.y;
  out[23 * n + env] = s.quat.z;
  out[24 * n + env] = s.quat.w;
  out[25 * n + env] = s.v.x;
  out[26 * n + env] = s.v.y;
  out[27 * n + env] = s.v.z;
  out[28 * n + env] = s.w.x;
  out[29 * n + env] = s.w.y;
  out[30 * n + env] = s.w.z;
  for (int i = 0; i < LG_WRENCH_ROWS; ++i) wrench[i * n + env] = acc[i];
}

#ifdef __CUDACC__

__global__ void physics_step_kernel(const LgConsts K, const real* __restrict__ state,
                                    const real* __restrict__ params,
                                    const real* __restrict__ tau, real* __restrict__ out,
                                    real* __restrict__ wrench, int n) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  step_env(K, state, params, tau, out, wrench, n, env);
}

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int leibniz_physics_step(const real* state, const real* params,
                                    const real* tau, real* out, real* wrench, int n,
                                    const LgConsts* consts, int threads_per_block,
                                    void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + threads_per_block - 1) / threads_per_block;
  physics_step_kernel<<<blocks, threads_per_block, 0, (cudaStream_t)stream>>>(
      *consts, state, params, tau, out, wrench, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

// The same per-env function on the host, for tests of this source without a GPU.
extern "C" int leibniz_physics_step_host(const real* state, const real* params,
                                         const real* tau, real* out, real* wrench, int n,
                                         const LgConsts* consts) {
  for (int env = 0; env < n; ++env) step_env(*consts, state, params, tau, out, wrench, n, env);
  return 0;
}

extern "C" int leibniz_consts_size() { return (int)sizeof(LgConsts); }
