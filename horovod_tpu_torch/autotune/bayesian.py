"""Bayesian optimization with expected-improvement acquisition: the port
of ``horovod_tpu/autotune/bayesian.py``, numpy as there (the same
``RandomState`` draws, so the same scores give the same candidates).

Role parity: ``horovod/common/optim/bayesian_optimization.cc/.h`` —
propose the next parameter vector maximizing expected improvement under
the GP posterior.  The reference maximizes EI with L-BFGS restarts; the
search space here is a low-dimensional unit cube, so a deterministic
quasi-random candidate sweep is equally effective and simpler.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from horovod_tpu_torch.autotune.gaussian_process import GaussianProcess


def _normal_cdf(z: np.ndarray) -> np.ndarray:
    from math import sqrt

    try:
        from scipy.special import erf  # pragma: no cover
    except Exception:
        erf = np.vectorize(__import__("math").erf)
    return 0.5 * (1.0 + erf(z / sqrt(2.0)))


def _normal_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


class BayesianOptimization:
    """Maximizes an expensive black-box f over [0,1]^dim."""

    def __init__(self, dim: int, xi: float = 0.01, seed: int = 0,
                 n_candidates: int = 512):
        self.dim = dim
        self.xi = xi  # exploration bonus (parity: bayesian_optimization.h)
        self._rng = np.random.RandomState(seed)
        self._n_candidates = n_candidates
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []
        self.gp = GaussianProcess()

    def add_sample(self, x: np.ndarray, y: float) -> None:
        self._xs.append(np.asarray(x, np.float64).ravel())
        self._ys.append(float(y))
        self.gp.fit(np.stack(self._xs), np.asarray(self._ys))

    def best(self) -> Optional[np.ndarray]:
        if not self._ys:
            return None
        return self._xs[int(np.argmax(self._ys))]

    def expected_improvement(self, x: np.ndarray) -> np.ndarray:
        mean, std = self.gp.predict(x)
        best = max(self._ys) if self._ys else 0.0
        # Work on the GP's standardized scale so the xi exploration bonus
        # is meaningful regardless of the raw score units (bytes/sec is
        # ~1e8; raw xi=0.01 would be vacuous).
        y_std = self.gp.y_std
        imp = (mean - best) / y_std - self.xi
        sd = std / y_std
        z = imp / sd
        return imp * _normal_cdf(z) + sd * _normal_pdf(z)

    def next_sample(self) -> np.ndarray:
        """Candidate with the highest EI (random sweep + past-best jitter)."""
        if not self._ys:
            return self._rng.uniform(size=self.dim)
        cands = self._rng.uniform(size=(self._n_candidates, self.dim))
        # densify around the incumbent — EI is often maximized nearby
        best = self.best()
        local = np.clip(
            best + self._rng.normal(scale=0.1,
                                    size=(self._n_candidates // 4, self.dim)),
            0.0, 1.0)
        cands = np.concatenate([cands, local])
        ei = self.expected_improvement(cands)
        return cands[int(np.argmax(ei))]
