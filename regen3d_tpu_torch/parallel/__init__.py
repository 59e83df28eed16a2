"""The port's parallel layer (counterpart of regen3d_tpu/parallel/).

* :mod:`.mesh`: a ('dp', 'tp') ``torch.distributed`` device mesh and the
  JAX package's partition rules, placed on a model's parameters;
* :mod:`.tp`: the tensor-parallel projections and their collectives;
* :mod:`.train`: the DiT's training step, on one device and over dp × tp,
  and the distillation trainers' optimizer;
* :mod:`.fleet`: many scenes over the ranks, phase by phase;
* :mod:`.dryrun`: the four multi-rank programs, each against its unsharded
  run.

One card runs every program at world size 1, which computes the unsharded
function; several ranks need a process group started by the caller
(``torch.distributed.init_process_group``, or ``torchrun``).
"""

from regen3d_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    partition_spec_for,
    shard_params,
)
