"""Data, tensor and sequence parallelism over torch.distributed (port of
s3prl_tpu/parallel): `mesh` (the rank mesh and its layouts),
`distributed` (the process group), `collectives` (the port's explicit
collectives), `dryrun` (the multichip dry run)."""

from .mesh import (make_mesh, replicate, sequence_sharded_extraction, shard_batch,
                   shard_params)
