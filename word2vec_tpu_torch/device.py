"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
`device=` they take "cuda", and they raise when no CUDA device exists
rather than carrying on with the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu' (which runs the plain PyTorch "
            "versions of the kernels)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for a `with` block (a no-op on
    the CPU): kernels, graph captures and new streams then land on it."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def torch_dtype(name: str) -> torch.dtype:
    """config.dtype / config.compute_dtype -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(
            f"dtype {name!r} is not supported by the port (float32, bfloat16)"
        )
    return table[name]


_U64 = 0xFFFF_FFFF_FFFF_FFFF


def generator(device: torch.device, seed: Optional[int]) -> torch.Generator:
    """A torch.Generator on `device`, seeded."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _U64)
    return g


def _splitmix64(x: int) -> int:
    x = (x + 0x9E37_79B9_7F4A_7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58_476D_1CE4_E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D0_49BB_1331_11EB) & _U64
    return x ^ (x >> 31)


def step_seed(run_seed: int, step: int) -> int:
    """The seed of optimizer step `step`'s draws: a fixed mix of
    (run_seed ^ 0x5EED, step), the port's counterpart of
    fold_in(key(run_seed ^ 0x5EED), step) (word2vec_tpu/train.py:683-686,
    749). The draws of a step, all of its micro sub-steps included, are a
    pure function of (run seed, step), so a run resumed at any step
    continues the trajectory, and chunked, per-step and graph-replayed
    dispatch draw the same numbers."""
    base = _splitmix64((int(run_seed) ^ 0x5EED) & _U64)
    return _splitmix64(base ^ (int(step) & _U64))


def replica_seed(seed: int, replica: int) -> int:
    """The seed of data-parallel replica `replica`'s draws within the step
    seeded `seed` (step_seed): the port's counterpart of
    fold_in(key, axis_index("data")) (word2vec_tpu/ops/train_step.py:
    394-395), which the JAX step applies only when dp > 1, so a
    one-replica run keeps the draws of step_seed exactly."""
    return _splitmix64((int(seed) ^ _splitmix64(0xD47A ^ int(replica))) & _U64)


def seq_seed(seed: int, shard: int) -> int:
    """The seed of sequence shard `shard`'s draws within the step seeded
    `seed` (after replica_seed when dp > 1): the port's counterpart of
    fold_in(key, axis_index("seq")) (word2vec_tpu/ops/band_step.py:
    248-249), which the JAX step applies after the data fold and only
    when sp > 1. Every tensor-parallel shard of a replica uses the
    replica's draws (JAX folds no model index)."""
    return _splitmix64((int(seed) ^ _splitmix64(0x5E9 ^ int(shard))) & _U64)


def seed_step(
    gen: torch.Generator, run_seed: int, step: int,
    replica: Optional[int] = None, seq: Optional[int] = None,
) -> None:
    """Re-seed `gen` for step `step`'s draws (data replica `replica`'s,
    when given: parallel/trainer.py's replicas at dp > 1; then sequence
    shard `seq`'s, when given: at sp > 1). Under CUDA graph replay the
    generator is registered with the graph, so the replayed kernels read
    this seed (and offset 0) from the graph's seed holders."""
    seed = step_seed(run_seed, step)
    if replica is not None:
        seed = replica_seed(seed, replica)
    if seq is not None:
        seed = seq_seed(seed, seq)
    gen.manual_seed(seed)
