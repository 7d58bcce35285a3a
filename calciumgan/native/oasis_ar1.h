// OASIS AR(1) spike deconvolution for one trace: the pool-adjacency
// machine of Friedrich et al. 2017, same spec as
// calciumgan/ops/oasis_ref.py, in float64.
//
// Shared by the host build (calciumgan_native.cc, g++) and the GPU build
// (oasis_cuda.cu, nvcc, one thread per trace). Both compile it without
// floating-point contraction (-ffp-contract=off / --fmad=false) and g**n is
// taken by repeated squaring, so the routine uses only IEEE +, -, * and /:
// the host and the card make every merge decision bit for bit alike.
//
// The caller supplies three small adaptors:
//   y(t)            -> double   fluorescence at frame t,
//   stack           -> CgPoolStack over scratch for T pools (no depth cap),
//   emit(t, c, s)              calcium and spike amplitude at frame t.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define CG_HD __host__ __device__ __forceinline__
#else
#define CG_HD inline
#endif

// g**n for n >= 0 by binary exponentiation (multiplications only).
CG_HD double cg_powi(double g, int64_t n) {
  double r = 1.0;
  double b = g;
  while (n > 0) {
    if (n & 1) r *= b;
    b *= b;
    n >>= 1;
  }
  return r;
}

// Pool stack: entry k of each array lives at index k * stride, so the GPU
// build can interleave all traces' stacks ([depth][trace]) and a warp's
// accesses at equal depth coalesce. The host build uses stride 1.
struct CgPoolStack {
  double* v;
  double* w;
  int32_t* len;
  int64_t stride;
  CG_HD double& V(int64_t k) const { return v[k * stride]; }
  CG_HD double& W(int64_t k) const { return w[k * stride]; }
  CG_HD int32_t& L(int64_t k) const { return len[k * stride]; }
};

template <class Src, class Sink>
CG_HD void cg_oasis_trace(const Src& y, int64_t T, double g, double lam,
                          double s_min, const CgPoolStack& st,
                          const Sink& emit) {
  if (T <= 0) return;
  // Pools 0..p-1 are in `st`; the top pool (vt, wt, lt) and a copy of pool
  // p-1 (pv, pw, with gl = g**pl and the merge threshold thr) stay in
  // registers, so a frame that merges nothing loads nothing from `st`.
  double vt = 0.0, wt = 0.0;
  int32_t lt = 0;
  double pv = 0.0, pw = 0.0, gl = 0.0, thr = 0.0;
  int32_t pl = 0;
  int64_t p = 0;
  for (int64_t t = 0; t < T; ++t) {
    if (t > 0) {
      st.V(p) = vt;
      st.W(p) = wt;
      st.L(p) = lt;
      ++p;
      pv = vt;
      pw = wt;
      pl = lt;
      gl = cg_powi(g, pl);
      thr = gl * (pv / pw) + s_min;
    }
    vt = (t == T - 1) ? y(t) - lam : y(t) - lam * (1.0 - g);
    wt = 1.0;
    lt = 1;
    // merge the top into its left neighbour while it violates the
    // minimum-spike constraint
    while (p > 0 && vt / wt < thr) {
      vt = pv + gl * vt;
      wt = pw + gl * gl * wt;
      lt = pl + lt;
      --p;
      if (p > 0) {
        pv = st.V(p - 1);
        pw = st.W(p - 1);
        pl = st.L(p - 1);
        gl = cg_powi(g, pl);
        thr = gl * (pv / pw) + s_min;
      }
    }
  }
  st.V(p) = vt;
  st.W(p) = wt;
  st.L(p) = lt;

  // c decays by g within a pool from max(v/w, 0); s[t] = c[t] - g c[t-1].
  // One flat loop over t, so every GPU lane writes frame t together.
  int64_t k = 0;
  int32_t left = 0;
  double dec = 0.0, prev = 0.0;
  for (int64_t t = 0; t < T; ++t) {
    if (left == 0) {
      const double h = st.V(k) / st.W(k);
      dec = h < 0.0 ? 0.0 : h;
      left = st.L(k);
      ++k;
    } else {
      dec *= g;
    }
    emit(t, dec, t == 0 ? 0.0 : dec - g * prev);
    prev = dec;
    --left;
  }
}
