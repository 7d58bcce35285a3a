"""Dichotomized Gaussian (DG) spike model, on device.

Re-design of ``/root/reference/dataset/dg/dichot_gauss.py`` and
``optim_dichot_gauss.py``:

- :class:`DichotGauss` samples correlated binary populations as ONE device
  computation (Cholesky + batched matmul + threshold) instead of a scipy
  ``rvs`` call per timebin (``dichot_gauss.py:170-174``),
- :class:`DGOptimise` fits the latent Gaussian: Φ⁻¹ means, time-varying /
  fixed covariance estimators, and `get_gauss_correlation` solving EVERY
  neuron pair's latent correlation simultaneously — a fixed-trip bisection
  under ``vmap`` (the reference runs a sequential tqdm loop with a scipy
  bivariate-CDF call per iteration — ``optim_dichot_gauss.py:181-190``),
- the bivariate normal CDF is evaluated with Gauss-Legendre quadrature of
  Φ₂(h, k, ρ) = Φ(h)Φ(k) + (1/2π)∫₀^ρ exp(-(h²-2rhk+k²)/(2(1-r²)))/√(1-r²) dr
  (Drezner & Wesolowsky's identity), fully vmappable,
- :class:`Higham` nearest-correlation-matrix projection (Higham 2002) stays
  on host in float64 — it runs once per fit on a small matrix and needs
  eigendecompositions at full precision.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import ndtri
from jax.scipy.stats import norm as jnorm


class WarningDG(UserWarning):
    pass


def heaviside(x, center: float = 0.0):
    """1 where x > center else 0 (``dichot_gauss.py:7-11``)."""
    x = jnp.asarray(x)
    return (x > center).astype(jnp.float32)


def cov_to_corr(cov: np.ndarray) -> np.ndarray:
    std = np.sqrt(np.diag(cov))
    return cov / (np.outer(std, std) + 1e-8)


def make_symmetric(M: np.ndarray) -> np.ndarray:
    if np.any(M != M.T):
        M = M.copy()
        tril = np.tril_indices(len(M), -1)
        M[tril] = M[tril[1], tril[0]].flatten()
    return M


# ---------------------------------------------------------------------------
# Higham nearest-correlation projection (host, float64)
# ---------------------------------------------------------------------------

class Higham:
    """Iterative alternating projection to the nearest correlation matrix
    (parity: ``dichot_gauss.py:35-100``)."""

    def __init__(self, maxiters: float = 1e5, tol: float = 1e-10):
        self.maxiters = maxiters
        self.tol = tol

    @staticmethod
    def projection_S(M):
        eigval, eigvec = np.linalg.eigh(M)
        eigval = np.maximum(eigval, 0.0)
        return (eigvec * eigval) @ eigvec.T

    @staticmethod
    def projection_U(M):
        out = M.copy()
        np.fill_diagonal(out, 1.0)
        return out

    @staticmethod
    def _relative_change(new: np.ndarray, old: np.ndarray) -> float:
        """max-row-sum (l_inf-induced) norm of the difference, relative to
        the new iterate."""
        return float(np.max(np.abs(new - old).sum(1))
                     / np.max(np.abs(new).sum(1)))

    def higham_correction(self, M: np.ndarray) -> np.ndarray:
        """Higham (2002): alternate projections onto the PSD cone and the
        unit-diagonal affine set, with a Dykstra correction term carried
        across iterations so the sequence converges to the nearest
        correlation matrix rather than just a feasible point. Stops when the
        PSD iterate, the unit-diagonal iterate, and their gap all move less
        than ``tol``."""
        psd = unit_diag = np.asarray(M, np.float64)
        correction = np.zeros_like(psd)
        for _ in range(int(self.maxiters)):
            shifted = unit_diag - correction
            new_psd = self.projection_S(shifted)
            correction = new_psd - shifted
            new_unit = self.projection_U(new_psd)
            done = max(
                self._relative_change(new_psd, psd),
                self._relative_change(new_unit, unit_diag),
                self._relative_change(new_unit, new_psd)) <= self.tol
            psd, unit_diag = new_psd, new_unit
            if done:
                break
        else:
            warnings.warn(
                f"Higham projection stopped at the {int(self.maxiters)}"
                f"-iteration cap before the change fell under {self.tol}.",
                WarningDG)
        # the unit-diagonal projection can re-introduce tiny negative
        # eigenvalues; clamp them and renormalise back to a correlation
        eigvals, eigvec = np.linalg.eigh(unit_diag)
        if eigvals.min() < 0:
            warnings.warn(
                "projected matrix has negative eigenvalues; clamping "
                "spectrum to reach positive definiteness.", WarningDG)
            eigvals = np.where(eigvals < 0, 1e-6, eigvals)
            unit_diag = (eigvec * eigvals) @ eigvec.T
            unit_diag = cov_to_corr(unit_diag)
            unit_diag = 0.5 * (unit_diag + unit_diag.T)
        return np.real(unit_diag)


def is_positive_definite(M: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(M)
        return True
    except np.linalg.LinAlgError:
        return False


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

class DichotGauss:
    """Binary population sampler: z ~ N(mean, corr) per timebin, thresholded
    at 0 (parity: ``dichot_gauss.py:103-179``). Output shape
    (timebins, repeats, neurons)."""

    def __init__(self, num_neur: int, mean=None, corr=None,
                 make_pd: bool = False, **kwargs):
        self.num_neur = num_neur
        self.make_pd = make_pd
        self.higham = Higham(**kwargs)
        if mean is None:
            mean = np.zeros((1, num_neur))
        if corr is None:
            corr = np.eye(num_neur)
            self.make_pd = False
        if self.make_pd:
            corr = self.do_higham_correction(make_symmetric(np.asarray(corr)))
        self.mean = np.asarray(mean, np.float64)
        self.corr = np.asarray(corr, np.float64)
        self._chol = np.linalg.cholesky(self.corr)

    def do_higham_correction(self, M: np.ndarray) -> np.ndarray:
        if not is_positive_definite(M):
            if not self.make_pd:
                warnings.warn(
                    "correlation matrix is not positive definite; construct "
                    "with make_pd=True to project it onto the nearest "
                    "correlation matrix.", WarningDG)
                raise NotImplementedError
            warnings.warn("correlation matrix is not positive definite; "
                          "applying the Higham projection.", WarningDG)
            M = self.higham.higham_correction(M)
        return M

    def sample(self, key=None, mean=None, corr=None,
               repeats: int = 1) -> jnp.ndarray:
        """One batched device computation: (repeats, timebins, N) standard
        normals -> correlate via Cholesky -> + mean -> threshold ->
        transpose to (timebins, repeats, neurons)."""
        mean = self.mean if mean is None else np.asarray(mean)
        if corr is not None:
            corr = self.do_higham_correction(np.asarray(corr))
            chol = np.linalg.cholesky(corr)
        else:
            chol = self._chol
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        timebins = mean.shape[0]
        eps = jax.random.normal(
            key, (repeats, timebins, self.num_neur), jnp.float32)
        z = jnp.matmul(eps, jnp.asarray(chol.T, jnp.float32),
                       precision=lax.Precision.HIGHEST)
        z = z + jnp.asarray(mean, jnp.float32)[None]
        return heaviside(jnp.transpose(z, (1, 0, 2)))


# ---------------------------------------------------------------------------
# bivariate normal CDF (Gauss-Legendre quadrature, vmappable)
# ---------------------------------------------------------------------------

_GL_ORDER = 64
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_GL_ORDER)


@jax.jit
def bivar_gauss_cdf(h: jnp.ndarray, k: jnp.ndarray,
                    rho: jnp.ndarray) -> jnp.ndarray:
    """Φ₂(h, k; ρ) for standard bivariate normals, broadcast over inputs."""
    h, k, rho = jnp.broadcast_arrays(jnp.asarray(h, jnp.float64),
                                     jnp.asarray(k, jnp.float64),
                                     jnp.asarray(rho, jnp.float64))
    # integrate r from 0 to rho
    nodes = jnp.asarray(_GL_NODES)          # on [-1, 1]
    weights = jnp.asarray(_GL_WEIGHTS)
    r = 0.5 * rho[..., None] * (nodes + 1.0)
    scale = 0.5 * rho[..., None]
    one_m_r2 = 1.0 - r * r
    integrand = jnp.exp(
        -(h[..., None] ** 2 - 2.0 * r * h[..., None] * k[..., None]
          + k[..., None] ** 2) / (2.0 * one_m_r2)) / jnp.sqrt(one_m_r2)
    integral = jnp.sum(weights * integrand * scale, axis=-1)
    return (jnorm.cdf(h) * jnorm.cdf(k)
            + integral / (2.0 * jnp.pi)).astype(jnp.float64)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("maxiters",))
def _solve_pair_correlations(gauss_means: jnp.ndarray,
                             data_means: jnp.ndarray,
                             data_covar: jnp.ndarray,
                             maxiters: int = 60,
                             tol: float = 1e-10) -> jnp.ndarray:
    """Latent correlation for every neuron pair at once.

    For each pair (i, j): root of
        f(ρ) = mean_t Φ₂(μ_i(t), μ_j(t); ρ) - r_i r_j - Σ_ij
    by bisection on [-0.99999, 0.99999] with the reference's edge-case
    semantics (``optim_dichot_gauss.py:47-96``): |f(λ0)| < tol -> λ0,
    |f(λ1)| < tol -> λ1, f(λ0) f(λ1) > tol -> 0. Pairs with
    |Σ_ij| <= 1e-10 get 0 (``:181-186``). Runs as one vmapped fixed-trip
    ``fori_loop`` over the P = N(N-1)/2 pairs.
    """
    N = gauss_means.shape[-1]
    iu, ju = jnp.tril_indices(N, -1)

    mu_i = gauss_means[..., iu].T      # (P, timebins)
    mu_j = gauss_means[..., ju].T
    r_ij = data_means[iu] * data_means[ju]
    cov_ij = data_covar[iu, ju]

    def f(rho):                        # rho: (P,)
        cdf = bivar_gauss_cdf(mu_i, mu_j, rho[:, None]).mean(-1)
        return cdf - r_ij - cov_ij

    lo0 = jnp.full(cov_ij.shape, -0.99999, jnp.float64)
    hi0 = jnp.full(cov_ij.shape, 0.99999, jnp.float64)
    f0, f1 = f(lo0), f(hi0)

    def body(_, state):
        lo, hi, root, fr = state
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        hi = jnp.where(fm > 0, mid, hi)
        lo = jnp.where(fm < 0, mid, lo)
        # track the latest midpoint until |f| <= tol (reference keeps
        # iterating but result converges; fixed trips are jit-friendly)
        done = jnp.abs(fr) <= tol
        root = jnp.where(done, root, mid)
        fr = jnp.where(done, fr, fm)
        return lo, hi, root, fr

    # seed with the first midpoint's bracket already applied — seeding
    # (lo0, hi0, mid0, f(mid0)) would make the first loop trip recompute
    # f at the same midpoint, wasting one full quadrature sweep
    mid0 = 0.5 * (lo0 + hi0)
    fm0 = f(mid0)
    state = (jnp.where(fm0 < 0, mid0, lo0), jnp.where(fm0 > 0, mid0, hi0),
             mid0, fm0)
    _, _, root, _ = lax.fori_loop(0, maxiters, body, state)

    root = jnp.where(jnp.abs(f0) < tol, lo0, root)
    root = jnp.where(jnp.abs(f1) < tol, hi0, root)
    root = jnp.where(f0 * f1 > tol, 0.0, root)
    root = jnp.where(jnp.abs(cov_ij) <= 1e-10, 0.0, root)

    corr = jnp.eye(N, dtype=jnp.float64)
    corr = corr.at[iu, ju].set(root)
    corr = corr.at[ju, iu].set(root)
    return corr


class DGOptimise:
    """Fit DG parameters to binary data of shape (timebins, trials, neurons)
    (parity: ``optim_dichot_gauss.py:100-194``)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float64)
        self.timebins, self.trials, self.num_neur = data.shape
        self.data = data

    @property
    def gauss_mean(self) -> np.ndarray:
        """Φ⁻¹ of per-(timebin, neuron) firing probability, clamped away
        from {0, 1} (``optim_dichot_gauss.py:109-126``)."""
        mean = self.data.mean(1)
        if np.any(mean < 0) or np.any(mean > 1):
            raise ValueError("Mean should have value between 0 and 1.")
        mean = np.where(mean == 0.0, mean + 1e-4, mean)
        mean = np.where(mean == 1.0, mean - 1e-4, mean)
        with jax.enable_x64(True):
            return np.asarray(jax.device_get(ndtri(mean)))

    @property
    def data_tvar_covariance(self) -> np.ndarray:
        """Across-neuron covariance for time-varying rates
        (``optim_dichot_gauss.py:128-144``)."""
        data = self.data
        data_norm = data - data.mean(0)                 # (T, R, N)
        # per-trial (N, N) covariance over time, averaged across trials
        tot = np.einsum("tri,trj->rij", data_norm, data_norm)
        return tot.mean(0) / self.timebins

    @property
    def data_tfix_covariance(self) -> np.ndarray:
        """Across-neuron covariance for fixed rates
        (``optim_dichot_gauss.py:146-154``)."""
        data_norm = (self.data - self.data.mean(1, keepdims=True)).reshape(
            -1, self.num_neur)
        return data_norm.T @ data_norm / (self.timebins * self.trials)

    def get_gauss_correlation(self, set_attr: bool = True,
                              **kwargs) -> np.ndarray:
        data_mean = self.data.mean(1).mean(0)
        gauss_mean = np.atleast_2d(self.gauss_mean)
        data_covar = (self.data_tvar_covariance if self.timebins > 1
                      else self.data_tfix_covariance)
        # the bisection needs f64 to honour the reference's 1e-10 tolerance
        with jax.enable_x64(True):
            corr = np.asarray(jax.device_get(_solve_pair_correlations(
                jnp.asarray(gauss_mean), jnp.asarray(data_mean),
                jnp.asarray(data_covar), **kwargs)))
        if set_attr:
            self.gauss_corr = corr
        return corr
