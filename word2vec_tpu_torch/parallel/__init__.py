"""Data-parallel training in one process: the replica mesh, the replica
sync (mean and delta) and ShardedTrainer (port of word2vec_tpu/parallel/
at tp = sp = 1; see mesh.py and trainer.py). The tests run dp = 2 and 4
replicas on the CPU; chip_smoke.py runs two replicas on one card."""

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, make_mesh
from .trainer import (
    Replicas,
    ShardedTrainer,
    make_delta_sync,
    make_sync,
    replicate_params,
    unreplicate_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "Replicas",
    "ShardedTrainer",
    "make_delta_sync",
    "make_mesh",
    "make_sync",
    "replicate_params",
    "unreplicate_params",
]
