// GLS q-point physics shared by the fused sweeps of ns_gls_tpu_torch.
//
// The CUDA counterpart of ops/structured.py `_physics` / `_delta` (which
// mirror ops/navier_stokes.py `qpoint_fixed_point` / `qpoint_increment` and
// the reference's operator_ns.cc:949-1182 and 357-420): Galerkin + SUPG +
// PSPG + grad-div at one quadrature point, in the fixed-point, residual
// and Newton-increment flavors, and the stabilization parameters
// delta_1 / delta_2 (cell-wise with the viscous switch, or per q-point).
// Everything is float32 and lives in registers.
#pragma once

#ifndef GLS_HD
#define GLS_HD __device__ __forceinline__
#endif

enum GlsFlavor { GLS_FIXED = 0, GLS_INCREMENT = 1, GLS_RESIDUAL = 2 };

struct GlsScalars {
  float weight;  // primary BDF weight
  float stau;    // 1 / dt
  float nu;
  float c1;
  float c2;
};

// delta_1 / delta_2 from the cell's max |u*|^2 (viscous switch nu >= h).
GLS_HD void gls_delta_cell(const GlsScalars& sc, float h1, float usq_max,
                           float& d1, float& d2) {
  const float d1_adv = sc.c1 * rsqrtf(sc.stau * sc.stau + usq_max / (h1 * h1));
  const bool visc = sc.nu >= h1;
  d1 = visc ? sc.c1 * h1 * h1 : d1_adv;
  d2 = visc ? sc.c2 * h1 * h1 : sc.c2 * h1;
}

// delta_1 / delta_2 at one q-point from |u*|^2 there.
GLS_HD void gls_delta_q(const GlsScalars& sc, float hq, float usq,
                        float& d1, float& d2) {
  const float u2 = 1e-12f + usq;
  const float visc = 4.0f * sc.nu / (hq * hq);
  d1 = rsqrtf(sc.stau * sc.stau + 4.0f * u2 / (hq * hq) + 9.0f * (visc * visc));
  d2 = sqrtf(u2) * hq * 0.5f;
}

// 2D GLS physics at one q-point.
//   u[a], ug[a][x] = du_a/dx_x, p, pg[x]   : the function being applied
//   us[a], gus[a][b], gps[x]               : linearization point u*, grads
//   dto[a]                                  : history sum_i>=1 w_i u^(n-i)
//   has_dt_old                              : the history term is present
// out: vr[c] (value test-function weights), gr[c][x] (gradient weights).
GLS_HD void gls_physics_2d(int flavor, bool consider_dt, bool has_dt_old,
                           const GlsScalars& sc, const float u[2],
                           const float ug[2][2], float p, const float pg[2],
                           const float us[2], const float gus[2][2],
                           const float gps[2], const float dto[2], float d1,
                           float d2, float vr[3], float gr[3][2]) {
  const float w = sc.weight;
  const float nu = sc.nu;
  float udt[2] = {w * u[0], w * u[1]};
  const float div = ug[0][0] + ug[1][1];
  float res0[2];
  if (flavor != GLS_INCREMENT) {
    if (flavor == GLS_RESIDUAL && has_dt_old) {
      udt[0] += dto[0];
      udt[1] += dto[1];
    }
    float sgb[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) sgb[a] = ug[a][0] * us[0] + ug[a][1] * us[1];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      vr[a] = udt[a] + sgb[a];
      const float pspg = consider_dt ? udt[a] : 0.0f;
      res0[a] = d1 * (pspg + pg[a] + sgb[a]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        gr[a][x] = nu * (ug[a][x] + ug[x][a]) + res0[a] * us[x] +
                   ((a == x) ? (d2 * div - p) : 0.0f);
  } else {
    float sgu[2], ugs[2], sgs[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      sgu[a] = ug[a][0] * us[0] + ug[a][1] * us[1];
      ugs[a] = gus[a][0] * u[0] + gus[a][1] * u[1];
      sgs[a] = gus[a][0] * us[0] + gus[a][1] * us[1];
    }
    float res1[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      vr[a] = udt[a] + sgu[a] + ugs[a];
      const float pspg0 = consider_dt ? udt[a] : 0.0f;
      const float pspg1 = consider_dt ? (w * us[a] + dto[a]) : 0.0f;
      res0[a] = d1 * (pspg0 + pg[a] + sgu[a] + ugs[a]);
      res1[a] = d1 * (pspg1 + gps[a] + sgs[a]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        gr[a][x] = nu * (ug[a][x] + ug[x][a]) + res0[a] * us[x] +
                   res1[a] * u[x] + ((a == x) ? (d2 * div - p) : 0.0f);
  }
  vr[2] = div;
  gr[2][0] = res0[0];
  gr[2][1] = res0[1];
}
