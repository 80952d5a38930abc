// GLS q-point physics shared by the fused sweeps of ns_gls_tpu_torch.
//
// The CUDA counterpart of ops/structured.py `_physics` / `_delta` (which
// mirror ops/navier_stokes.py `qpoint_fixed_point` / `qpoint_increment` and
// the reference's operator_ns.cc:949-1182 and 357-420): Galerkin + SUPG +
// PSPG + grad-div at one quadrature point, in the fixed-point, residual
// and Newton-increment flavors, and the stabilization parameters
// delta_1 / delta_2 (cell-wise with the viscous switch, or per q-point).
// Everything is float32 and lives in registers; the physics is one
// template over the dimension (gls_physics<2> / <3>).
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

// GLS physics at one q-point in D = 2 or 3 dimensions.
//   u[a], ug[a][x] = du_a/dx_x, p, pg[x]   : the function being applied
//   us[a], gus[a][b], gps[x]               : linearization point u*, grads
//   dto[a]                                  : history sum_i>=1 w_i u^(n-i)
//   has_dt_old                              : the history term is present
// out: vr[c] (value test-function weights), gr[c][x] (gradient weights),
// c = 0..D (velocity components, then pressure).
template <int D>
GLS_HD void gls_physics(int flavor, bool consider_dt, bool has_dt_old,
                        const GlsScalars& sc, const float u[D],
                        const float ug[D][D], float p, const float pg[D],
                        const float us[D], const float gus[D][D],
                        const float gps[D], const float dto[D], float d1,
                        float d2, float vr[D + 1], float gr[D + 1][D]) {
  const float w = sc.weight;
  const float nu = sc.nu;
  float udt[D];
  float div = ug[0][0];
#pragma unroll
  for (int a = 0; a < D; ++a) udt[a] = w * u[a];
#pragma unroll
  for (int a = 1; a < D; ++a) div += ug[a][a];
  float res0[D];
  if (flavor != GLS_INCREMENT) {
    if (flavor == GLS_RESIDUAL && has_dt_old) {
#pragma unroll
      for (int a = 0; a < D; ++a) udt[a] += dto[a];
    }
    float sgb[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      sgb[a] = ug[a][0] * us[0];
#pragma unroll
      for (int b = 1; b < D; ++b) sgb[a] += ug[a][b] * us[b];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      vr[a] = udt[a] + sgb[a];
      const float pspg = consider_dt ? udt[a] : 0.0f;
      res0[a] = d1 * (pspg + pg[a] + sgb[a]);
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int x = 0; x < D; ++x)
        gr[a][x] = nu * (ug[a][x] + ug[x][a]) + res0[a] * us[x] +
                   ((a == x) ? (d2 * div - p) : 0.0f);
  } else {
    float sgu[D], ugs[D], sgs[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      sgu[a] = ug[a][0] * us[0];
      ugs[a] = gus[a][0] * u[0];
      sgs[a] = gus[a][0] * us[0];
#pragma unroll
      for (int b = 1; b < D; ++b) {
        sgu[a] += ug[a][b] * us[b];
        ugs[a] += gus[a][b] * u[b];
        sgs[a] += gus[a][b] * us[b];
      }
    }
    float res1[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      vr[a] = udt[a] + sgu[a] + ugs[a];
      const float pspg0 = consider_dt ? udt[a] : 0.0f;
      const float pspg1 = consider_dt ? (w * us[a] + dto[a]) : 0.0f;
      res0[a] = d1 * (pspg0 + pg[a] + sgu[a] + ugs[a]);
      res1[a] = d1 * (pspg1 + gps[a] + sgs[a]);
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int x = 0; x < D; ++x)
        gr[a][x] = nu * (ug[a][x] + ug[x][a]) + res0[a] * us[x] +
                   res1[a] * u[x] + ((a == x) ? (d2 * div - p) : 0.0f);
  }
  vr[D] = div;
#pragma unroll
  for (int x = 0; x < D; ++x) gr[D][x] = res0[x];
}
