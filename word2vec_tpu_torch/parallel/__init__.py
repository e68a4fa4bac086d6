"""Data-, sequence- and tensor-parallel training in one process: the
(dp, sp, tp) mesh, the replica sync (mean and delta) and ShardedTrainer
(port of word2vec_tpu/parallel/ in one process; see mesh.py, trainer.py
and ops/shards.py). The tests run meshes up to (2, 2, 2) and tp 4 on the
CPU; chip_smoke.py runs them with every shard on one card."""

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, make_mesh
from .trainer import (
    Replicas,
    ShardedTrainer,
    concat_shards,
    make_delta_sync,
    make_sync,
    replicate_params,
    split_params,
    unreplicate_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "Replicas",
    "ShardedTrainer",
    "concat_shards",
    "make_delta_sync",
    "make_mesh",
    "make_sync",
    "replicate_params",
    "split_params",
    "unreplicate_params",
]
