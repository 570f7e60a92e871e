"""physicsbasedbayesianinference_tpu — accelerator ensemble-HMC inference.

A from-scratch JAX rebuild of the capabilities of
Anton-Le/PhysicsBasedBayesianInference (physics-flavoured ensemble HMC for
probabilistic models): jitted XLA sampling scans, a fused Pallas (Triton)
HMC transition for the GPU, walker-axis
sharding over device meshes, a native probabilistic-model DSL, symplectic
integrators, adaptation, tempering/SMC, and N-body physics targets.
"""

from . import (
    adaptation,
    checkpoint,
    chees,
    config,
    constants,
    diagnostics,
    ensemble,
    hmc,
    models,
    native,
    nuts,
    ops,
    parallel,
    physics,
    smc,
    tempering,
    utils,
)
from .constants import NATURAL, SI, Constants, solar_system_units
from .ensemble import (
    EnsembleState,
    kinetic_energy,
    new_ensemble,
    sample_momenta,
    sample_positions,
)
from .hmc import (HMCInfo, HMCKernel, HMCState, build_dense_hmc_kernel,
                  build_fused_hmc_kernel, build_hmc_kernel, run_hmc)
from .nuts import NUTSInfo, NUTSKernel, build_nuts_kernel, run_nuts
from .smc import SMCResult, run_smc
from .chees import ChEESRunResult, run_chees_hmc
from .tempering import PTResult, run_parallel_tempering

__version__ = "0.1.0"

__all__ = [
    "adaptation",
    "constants",
    "ensemble",
    "hmc",
    "Constants",
    "NATURAL",
    "SI",
    "solar_system_units",
    "EnsembleState",
    "new_ensemble",
    "sample_positions",
    "sample_momenta",
    "kinetic_energy",
    "HMCState",
    "HMCInfo",
    "HMCKernel",
    "build_dense_hmc_kernel",
    "build_fused_hmc_kernel",
    "build_hmc_kernel",
    "run_hmc",
    "smc",
    "SMCResult",
    "run_smc",
    "tempering",
    "chees",
    "ChEESRunResult",
    "run_chees_hmc",
    "PTResult",
    "run_parallel_tempering",
    "nuts",
    "NUTSInfo",
    "NUTSKernel",
    "build_nuts_kernel",
    "run_nuts",
    "checkpoint",
    "config",
    "diagnostics",
    "models",
    "native",
    "ops",
    "parallel",
    "physics",
    "utils",
]
