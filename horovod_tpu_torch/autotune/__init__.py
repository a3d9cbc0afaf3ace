"""Runtime autotuning of the eager engine's knobs: the port of
``horovod_tpu/autotune``.

Role parity: ``horovod/common/parameter_manager.cc/.h`` (tunable knobs,
warmup/sampling schedule, rank-0-tunes-and-broadcasts) +
``horovod/common/optim/bayesian_optimization.cc`` and
``gaussian_process.cc`` (GP regression with expected-improvement
acquisition).  Scored the same way: bytes processed per unit time.
"""

from horovod_tpu_torch.autotune.gaussian_process import GaussianProcess  # noqa
from horovod_tpu_torch.autotune.bayesian import BayesianOptimization  # noqa
from horovod_tpu_torch.autotune.parameter_manager import (  # noqa
    ParameterManager,
    TunedParams,
)
