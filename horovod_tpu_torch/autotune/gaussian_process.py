"""Gaussian-process regression for the autotuner: the port of
``horovod_tpu/autotune/gaussian_process.py``, numpy as there.

Role parity: ``horovod/common/optim/gaussian_process.cc/.h`` — GP with an
RBF kernel fit to (parameter vector → score) samples, used only by the
Bayesian-optimization autotuner.  The reference fits kernel
hyperparameters by L-BFGS maximum marginal likelihood
(``gaussian_process.cc:44+``); at the autotuner's sample counts (tens)
a dense grid over the length-scale maximizes the same objective exactly
as well, with numpy Cholesky and no optimizer dependency — pass
``length_scale=None`` (the default) to select it per ``fit()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Log-spaced candidate length-scales for marginal-likelihood selection,
# spanning "every sample is independent" (0.05 on the unit cube) to
# "the surface is one slow trend" (2.0).
_LS_GRID = np.geomspace(0.05, 2.0, 24)


class GaussianProcess:
    """GP posterior over f: [0,1]^d -> R with RBF kernel.

    ``length_scale=None`` selects the length-scale by maximizing the log
    marginal likelihood over ``_LS_GRID`` at each ``fit()``; a float
    pins it (the pre-r5 fixed-hyperparameter behavior).
    """

    def __init__(self, length_scale: Optional[float] = None,
                 signal_variance: float = 1.0,
                 noise_variance: float = 1e-4):
        if length_scale is not None and length_scale <= 0:
            raise ValueError(f"length_scale must be positive or None "
                             f"(auto-fit), got {length_scale}")
        self._fit_length_scale = length_scale is None
        self.length_scale = 0.25 if length_scale is None else length_scale
        self.signal_variance = signal_variance
        self.noise_variance = noise_variance
        self._x: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # squared exponential: k(x,x') = s² exp(-‖x-x'‖² / (2ℓ²))
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_variance * np.exp(-0.5 * d2 /
                                             (self.length_scale ** 2))

    def _factor(self, x: np.ndarray, yn: np.ndarray):
        """Cholesky + weights for the current hyperparameters."""
        k = self._kernel(x, x) + self.noise_variance * np.eye(len(x))
        chol = np.linalg.cholesky(k)
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, yn))
        return chol, alpha

    def _log_marginal_likelihood(self, chol, alpha, yn) -> float:
        # lml = -1/2 yᵀα − Σ log L_ii − n/2 log 2π   (GPML eq. 2.30)
        return float(-0.5 * yn @ alpha
                     - np.log(np.diag(chol)).sum()
                     - 0.5 * len(yn) * np.log(2 * np.pi))

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).ravel()
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        if self._fit_length_scale and len(x) >= 3:
            # Type-II MLE over the grid — the reference's L-BFGS fit
            # (gaussian_process.cc:44+) on a 1-D hyperparameter space,
            # solved by dense evaluation instead of a line search.  A
            # non-PD kernel at an extreme candidate is skipped, not fatal.
            best, best_lml = self.length_scale, -np.inf
            for ls in _LS_GRID:
                self.length_scale = float(ls)
                try:
                    chol, alpha = self._factor(x, yn)
                except np.linalg.LinAlgError:
                    continue
                lml = self._log_marginal_likelihood(chol, alpha, yn)
                if lml > best_lml:
                    best, best_lml = float(ls), lml
            self.length_scale = best
        self._chol, self._alpha = self._factor(x, yn)
        self._x = x

    @property
    def y_std(self) -> float:
        """Scale of the standardized targets (1.0 before the first fit)."""
        return self._y_std

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at x (de-standardized)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return (np.full(len(x), self._y_mean),
                    np.full(len(x), np.sqrt(self.signal_variance)))
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(self.signal_variance - (v ** 2).sum(0), 1e-12, None)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)
