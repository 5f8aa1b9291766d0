"""PyTorch and CUDA port of ``inplacedhmc_tpu``: lockstep multinomial NUTS
with windowed warmup, for an NVIDIA H100.

The JAX package stays the reference; this package imports none of it.  Its
entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  The fused logistic-regression potential runs through a CUDA kernel
written by hand for Hopper (``csrc/logistic_vg.cu``), built by ``nvcc`` on
first use.
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
