"""Multi-rank execution on ``torch.distributed``: process-group meshes, the
row-sharded distributed Cholesky, solves and append, ``LargeScaleGP``, and
the sharded exact steps. Counterpart of ``friedrich_tpu/parallel/``."""

from .large_scale import LargeScaleGP
from .mesh import (
    make_chain_mesh,
    make_matrix_mesh,
    matrix_sharding,
    replicated,
    row_sharding,
)
from .sharded import (
    make_sharded_build_and_factor,
    make_sharded_predict,
    make_sharded_train_step,
    shard_state,
)

__all__ = [
    "LargeScaleGP",
    "make_chain_mesh",
    "make_matrix_mesh",
    "matrix_sharding",
    "replicated",
    "row_sharding",
    "make_sharded_build_and_factor",
    "make_sharded_predict",
    "make_sharded_train_step",
    "shard_state",
]
