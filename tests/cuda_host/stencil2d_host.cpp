// Host loops over the per-pixel functions of
// lagomorph_tpu_torch/csrc/stencil2d.cuh, compiled with g++ by
// tests/test_torch_host_kernels.py and held against the plain 2D ops.
// Fields are (N, 2, H, W) float32; a batch-1 m0 (Nm == 1) is shared by the
// subjects, and its gradient summed over them.
#include "stencil2d.cuh"

using namespace lagomorph::s2d;

extern "C" int host_adstar2d(const float* phi, const float* m0, float* out, float* mw, int N,
                             int Nm, int H, int W) {
  const long HW = (long)H * W, F = 2 * HW;
  bool ok = true;
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        const long q = n * F + (long)i * W + j;
        float o[2], w[2];
        ok &= adstar(phi + n * F, m0 + (Nm == 1 ? 0 : n * F), H, W, i, j, o, w);
        out[q] = o[0];
        out[q + HW] = o[1];
        mw[q] = w[0];
        mw[q + HW] = w[1];
      }
  return ok;
}

extern "C" int host_compose2d(const float* phi, const float* v, float s, float* out, int N,
                              int H, int W) {
  const long HW = (long)H * W, F = 2 * HW;
  bool ok = true;
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        const long q = n * F + (long)i * W + j;
        float o[2];
        ok &= compose(phi + n * F, v[q], v[q + HW], s, H, W, i, j, o);
        out[q] = o[0];
        out[q + HW] = o[1];
      }
  return ok;
}

extern "C" void host_compose2d_bwd(const float* phi, const float* v, float s, const float* g,
                                   float* d_phi, float* d_v, int N, int H, int W) {
  const long HW = (long)H * W, F = 2 * HW;
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        const long q = n * F + (long)i * W + j;
        float dp[2], dv[2];
        compose_bwd(phi + n * F, v + n * F, s, g + n * F, H, W, i, j, dp, dv);
        d_phi[q] = dp[0];
        d_phi[q + HW] = dp[1];
        d_v[q] = dv[0];
        d_v[q + HW] = dv[1];
      }
}

// d_mw: (N, 2, H, W) scratch
extern "C" void host_adstar2d_bwd(const float* phi, const float* m0, const float* g,
                                  const float* mw, float* d_mw, float* d_phi, float* d_m0,
                                  int N, int Nm, int H, int W) {
  const long HW = (long)H * W, F = 2 * HW;
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        const long q = n * F + (long)i * W + j;
        float d[2];
        adstar_bwd_dmw(phi + n * F, g[q], g[q + HW], H, W, i, j, d);
        d_mw[q] = d[0];
        d_mw[q + HW] = d[1];
      }
  for (int n = 0; n < N; ++n)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        const long q = n * F + (long)i * W + j;
        float d[2];
        adstar_bwd_dphi(phi + n * F, m0 + (Nm == 1 ? 0 : n * F), g + n * F, mw + n * F,
                        d_mw[q], d_mw[q + HW], H, W, i, j, d);
        d_phi[q] = d[0];
        d_phi[q + HW] = d[1];
      }
  for (int nm = 0; nm < Nm; ++nm)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        float acc[2] = {0.0f, 0.0f};
        for (int n = (Nm == 1 ? 0 : nm); n < (Nm == 1 ? N : nm + 1); ++n) {
          float d[2];
          warp_transpose(phi + n * F, 1.0f, d_mw + n * F, H, W, i, j, d);
          acc[0] = add(acc[0], d[0]);
          acc[1] = add(acc[1], d[1]);
        }
        const long q = nm * F + (long)i * W + j;
        d_m0[q] = acc[0];
        d_m0[q + HW] = acc[1];
      }
}
