"""Data-, sequence- and tensor-parallel training: the (dp, sp, tp) mesh,
the replica sync (mean and delta) and ShardedTrainer, in one process or,
on the data axis, across several on torch.distributed (port of
word2vec_tpu/parallel/; see mesh.py, trainer.py, multihost.py and
ops/shards.py). The tests run meshes up to (2, 2, 2) and tp 4 on the CPU,
and two and three gloo processes (an elastic fleet re-forming through
ShardedTrainer's remesh counterpart, an exec: resilience/elastic.py, with
its store hosted by coordservice.py); chip_smoke.py runs them with every
shard on one card, and two and three processes sharing it."""

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, make_mesh
from .multihost import (
    DistConfig,
    generation_env,
    global_agree_max,
    global_agree_min,
    global_agree_sum,
    global_heartbeat,
    hybrid_axes,
    initialize_from_env,
    make_global_mesh,
    process_count,
    process_index,
)
from .trainer import (
    Replicas,
    ShardedTrainer,
    assemble_local_replica,
    concat_shards,
    make_delta_sync,
    make_sync,
    replicate_params,
    split_params,
    unreplicate_params,
)

__all__ = [
    "DATA_AXIS",
    "DistConfig",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "Replicas",
    "ShardedTrainer",
    "assemble_local_replica",
    "concat_shards",
    "generation_env",
    "global_agree_max",
    "global_agree_min",
    "global_agree_sum",
    "global_heartbeat",
    "hybrid_axes",
    "initialize_from_env",
    "make_global_mesh",
    "make_delta_sync",
    "make_mesh",
    "make_sync",
    "process_count",
    "process_index",
    "replicate_params",
    "split_params",
    "unreplicate_params",
]
