"""Sharding over ranks on torch.distributed (port of `kzg_tpu/parallel/`):
the four-step distributed NTT (all_to_all), the sharded Pippenger MSM
(all_gather join) and the sharded commit + witness, batched and
evaluation-form steps. One process a rank, NCCL between cards and gloo
between CPU processes (`runtime.py`)."""

from .ntt import ShardedDomain, four_step_dif, four_step_dit
from .msm import make_sharded_msm, pad_msm_inputs
from .pipeline import (
    make_commit_witness_step,
    make_batched_witness_step,
    make_eval_form_step,
)
from .runtime import initialize_distributed, make_mesh

__all__ = [
    "ShardedDomain",
    "four_step_dif",
    "four_step_dit",
    "make_sharded_msm",
    "pad_msm_inputs",
    "make_commit_witness_step",
    "make_batched_witness_step",
    "make_eval_form_step",
    "initialize_distributed",
    "make_mesh",
]
