"""PyTorch and CUDA port of ``inplacedhmc_tpu``: lockstep multinomial NUTS
with windowed warmup, for an NVIDIA H100.

The JAX package stays the reference; this package imports none of it.  Its
entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  CUDA kernels written by hand for Hopper, built by ``nvcc`` on
first use, carry the main paths: the fused logistic-regression potential
(``csrc/logistic_vg.cu``), the whole NUTS transition with a diagonal or
dense metric for each tile physics (``csrc/tree_kernel.cuh`` with the
Gaussian's, eight schools', the funnel's, the dense Gaussian's and logistic
regression's value and gradient: ``csrc/tree_gaussian.cu``,
``csrc/tree_eight_schools.cu``, ``csrc/tree_funnel.cu``,
``csrc/tree_dense_gaussian.cu``, ``csrc/tree_logistic.cu``, the last
reached by ``use_pallas="tree"``) and the fused Gaussian leapfrog step
(``csrc/leapfrog_gaussian.cu``).
"""

from .config import (DualAveraging, FindLocalOptimum, FixedStepsize,
                     InitialStepsizeSearch, NUTS, StepsizeCollapseError,
                     TuningNUTS, default_warmup_stages)
from .core.hamiltonian import (batched_logdensity_and_grad, evaluate,
                               joint_logdensity)
from .core.metric import (DenseMetric, DiagMetric, dense_metric, diag_metric,
                          identity_metric)
from .core.state import (EvalPoint, PhasePoint, Termination, TreeStats,
                         WarmupState)
from .models.base import Model
from .nuts.tree import nuts_transition
from .sample import MCMCResult, NUTSKernel, mcmc_with_warmup, sample

__all__ = [
    "NUTS", "DualAveraging", "FixedStepsize", "InitialStepsizeSearch",
    "TuningNUTS", "FindLocalOptimum", "StepsizeCollapseError",
    "default_warmup_stages",
    "DiagMetric", "DenseMetric", "diag_metric", "dense_metric",
    "identity_metric",
    "EvalPoint", "PhasePoint", "Termination", "TreeStats", "WarmupState",
    "batched_logdensity_and_grad", "evaluate", "joint_logdensity",
    "nuts_transition", "Model", "MCMCResult", "NUTSKernel",
    "mcmc_with_warmup", "sample",
]
