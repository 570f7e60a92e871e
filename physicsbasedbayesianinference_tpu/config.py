"""Run configuration: one dataclass, JSON round-trip.

The reference hard-codes every run parameter as module constants in
scripts (reference test_integrator_benchmarks_harmonic.py:25-37,
test_HMC.py:110-117) and has two ad-hoc data formats (model-data JSON,
samples/NumpyroExamples/ data.json files; N-body text, MiscFunctions.py:8-43).
SURVEY.md §5 calls for a single config (model ref, walkers, steps,
adaptation, temperature, mesh) + CLI driver filling the empty main.py.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    """Everything needed to reproduce a sampling run."""

    # model: "builtin:<potential>" (ops.potentials.builtin_potentials),
    # "example:<model>" (models.examples.EXAMPLE_MODELS, with data_path),
    # or "numpyro:<module>:<fn>" (requires numpyro installed)
    model: str = "builtin:std_normal_2d"
    data_path: Optional[str] = None
    # non-centering for example:/native-DSL models — "" (off), "auto"
    # (rewrite latent loc-scale sites that depend on other latents), or
    # a comma-separated site list (models/core.reparam). numpyro: models
    # must use numpyro's own reparam handlers (setting this raises).
    reparam: str = ""

    sampler: str = "hmc"            # hmc | nuts | smc | pt | chees
    kernel: str = "auto"            # auto | fused | xla — transition engine
    metric: str = "diag"            # diag | dense — hmc mass-matrix form
    #                                 (auto = xla; fused = Triton, GPU)
    num_walkers: int = 1024
    num_warmup: int = 500
    num_samples: int = 500
    num_steps: int = 16             # hmc leapfrog steps / smc mutation len
    max_depth: int = 8              # nuts
    init_step_size: float = 0.1
    target_accept: float = 0.8
    adapt_mass: bool = True
    temperature: float = 1.0        # physical T (k_B from constants)
    constants: str = "natural"      # natural | si
    seed: int = 0
    collect: str = "samples"        # samples | moments | none | stream
    thin: int = 1

    # smc extras
    smc_beta0: float = 0.0
    smc_max_stages: int = 50

    # parallel-tempering extras
    pt_replicas: int = 8
    pt_beta_min: float = 0.05

    # execution
    sharded: bool = False            # place walkers over all local devices
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0        # 0 = only final
    output_path: Optional[str] = None  # .npz samples/summary dump
    log_every: int = 100

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    @classmethod
    def from_file(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_json(f.read())
