"""Dichotomized Gaussian subsystem vs scipy/numpy oracles."""

import numpy as np
import pytest
import scipy.stats as st

import jax

from calciumgan.ops import dg


# ---------------------------------------------------------------------------
# bivariate CDF + bisection vs scipy oracle
# ---------------------------------------------------------------------------

def _scipy_bivar_cdf(h, k, rho):
    cov = np.array([[1.0, rho], [rho, 1.0]])
    return st.multivariate_normal(mean=[0.0, 0.0], cov=cov).cdf([h, k])


@pytest.mark.parametrize("h,k,rho", [
    (0.0, 0.0, 0.5), (0.3, -0.7, 0.2), (-1.2, 0.4, 0.9),
    (1.0, 1.0, -0.6), (0.5, 0.5, 0.0), (-0.3, -0.3, -0.95),
])
def test_bivar_gauss_cdf_matches_scipy(h, k, rho):
    with jax.enable_x64(True):
        ours = float(dg.bivar_gauss_cdf(h, k, rho))
    assert ours == pytest.approx(_scipy_bivar_cdf(h, k, rho), abs=1e-8)


def _reference_bisection(data_means, gauss_means, data_covar,
                         maxiters=1000, tol=1e-10):
    """The reference's sequential find_root_bisection
    (optim_dichot_gauss.py:47-96) with the scipy CDF."""
    def eqn(dm, gm, dc, rho):
        vals = np.array(gm).T
        cdf = np.mean([_scipy_bivar_cdf(v[0], v[1], rho)
                       for v in np.atleast_2d(vals)])
        return cdf - np.prod(dm) - dc

    lo, hi = -0.99999, 0.99999
    f0 = eqn(data_means, gauss_means, data_covar, lo)
    f1 = eqn(data_means, gauss_means, data_covar, hi)
    if abs(f0) < tol:
        return lo
    if abs(f1) < tol:
        return hi
    if f0 * f1 > tol:
        return 0.0
    f, it, result = np.inf, 0, None
    while abs(f) > tol and it < maxiters:
        result = (lo + hi) / 2
        f = eqn(data_means, gauss_means, data_covar, result)
        if f > 0:
            hi = result
        elif f < 0:
            lo = result
        it += 1
    return result


def test_pair_correlation_matches_reference_bisection(rng):
    """Fit a 3-neuron DG to sampled binary data; every pairwise latent
    correlation must match the reference's sequential bisection."""
    spikes = (rng.uniform(size=(1, 5000, 3)) <
              np.array([0.2, 0.5, 0.35])).astype(np.float64)
    opt = dg.DGOptimise(spikes)
    corr = opt.get_gauss_correlation()

    gauss_mean = opt.gauss_mean
    data_mean = spikes.mean(1).mean(0)
    data_covar = opt.data_tfix_covariance
    for i in range(3):
        for j in range(i):
            expected = _reference_bisection(
                [data_mean[i], data_mean[j]],
                [gauss_mean[..., i], gauss_mean[..., j]],
                data_covar[i, j])
            assert corr[i, j] == pytest.approx(expected, abs=1e-6), (i, j)
    np.testing.assert_allclose(np.diag(corr), 1.0)
    np.testing.assert_allclose(corr, corr.T)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def test_gauss_mean_is_ppf(rng):
    spikes = (rng.uniform(size=(4, 300, 2)) < 0.3).astype(np.float64)
    opt = dg.DGOptimise(spikes)
    expected = st.norm.ppf(np.clip(spikes.mean(1), 1e-4, 1 - 1e-4))
    np.testing.assert_allclose(opt.gauss_mean, expected, atol=1e-9)


def test_tfix_covariance_matches_reference_formula(rng):
    spikes = (rng.uniform(size=(1, 400, 3)) < 0.4).astype(np.float64)
    opt = dg.DGOptimise(spikes)
    T, R, N = spikes.shape
    data_norm = (spikes - spikes.mean(1)).reshape(-1, N)
    expected = data_norm.T @ data_norm / (T * R)
    np.testing.assert_allclose(opt.data_tfix_covariance, expected, atol=1e-12)


def test_tvar_covariance_matches_reference_formula(rng):
    spikes = (rng.uniform(size=(50, 8, 3)) < 0.4).astype(np.float64)
    opt = dg.DGOptimise(spikes)
    T, R, N = spikes.shape
    data_norm = (spikes - spikes.mean(0)).reshape(T, -1)
    tot = data_norm.T.dot(data_norm).reshape(R, N, R, N)
    inds = range(R)
    expected = tot[inds, :, inds, :].mean(0) / T
    np.testing.assert_allclose(opt.data_tvar_covariance, expected, atol=1e-10)


# ---------------------------------------------------------------------------
# Higham projection
# ---------------------------------------------------------------------------

def test_higham_makes_psd_correlation(rng):
    A = rng.normal(size=(6, 6))
    M = (A + A.T) / 2
    np.fill_diagonal(M, 1.0)
    M[0, 1] = M[1, 0] = 5.0       # definitely not PSD
    out = dg.Higham().higham_correction(M)
    eigvals = np.linalg.eigvalsh(out)
    assert eigvals.min() >= -1e-8
    np.testing.assert_allclose(np.diag(out), 1.0, atol=1e-6)


def test_higham_identity_on_psd():
    M = np.array([[1.0, 0.3], [0.3, 1.0]])
    out = dg.Higham().higham_correction(M)
    np.testing.assert_allclose(out, M, atol=1e-8)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_sampler_moments():
    mean = np.array([[0.5, -0.5]])
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])
    sampler = dg.DichotGauss(2, mean=mean, corr=corr)
    out = np.asarray(sampler.sample(jax.random.PRNGKey(0), repeats=200_000))
    assert out.shape == (1, 200_000, 2)
    # P(spike) = Phi(mean)
    np.testing.assert_allclose(out.mean(1)[0], st.norm.cdf(mean[0]),
                               atol=5e-3)
    # joint firing probability = Phi2(mean_i, mean_j; rho)
    joint = (out[0, :, 0] * out[0, :, 1]).mean()
    expected = _scipy_bivar_cdf(mean[0, 0], mean[0, 1], 0.4)
    assert joint == pytest.approx(expected, abs=5e-3)


def test_sampler_higham_on_non_pd_corr():
    corr = np.array([[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]])
    with pytest.warns(dg.WarningDG):
        sampler = dg.DichotGauss(3, corr=corr, make_pd=True)
    out = np.asarray(sampler.sample(jax.random.PRNGKey(1), repeats=100))
    assert out.shape == (1, 100, 3)


def test_fit_roundtrip():
    """Sample from a known DG, refit, recover mean & correlation."""
    mean = np.array([[0.3, -0.2, 0.1]])
    corr = np.eye(3)
    corr[0, 1] = corr[1, 0] = 0.35
    corr[1, 2] = corr[2, 1] = -0.25
    sampler = dg.DichotGauss(3, mean=mean, corr=corr)
    spikes = np.asarray(sampler.sample(jax.random.PRNGKey(42),
                                       repeats=200_000), np.float64)
    opt = dg.DGOptimise(spikes)
    np.testing.assert_allclose(opt.gauss_mean[0], mean[0], atol=2e-2)
    fit = opt.get_gauss_correlation()
    np.testing.assert_allclose(fit, corr, atol=3e-2)
