"""The (data, seq, model) mesh of one-process parallel training.

Port of word2vec_tpu/parallel/mesh.py. The JAX package lays its devices
out as a (dp, sp, tp) jax.sharding.Mesh, the model axis innermost; here a
Mesh is the same grid as a flat device list: coordinate (d, s, t) is
devices[(d*sp + s)*tp + t], with the same axis names and the same shape
check.

  data  — replica d trains its own row block of every global step;
  seq   — sequence shard s trains the column slice [s*Lloc, (s+1)*Lloc)
          of those rows, with W halo tokens on each side (ops/shards.py);
          replica-wise it behaves like the data axis and shares its sync;
  model — tensor-parallel shard t holds the dim slice [t*d/tp, (t+1)*d/tp)
          of every table; the step sums its partial logits over the
          shards (ops/shards.lockstep).

A replica of parallel/trainer.py is one (d, s) coordinate, index r =
d*sp + s; its tp shards are devices[r*tp:(r+1)*tp].

The default devices are the visible cards, each once; on the CPU, [cpu]
* (dp*sp*tp). A caller may name one card several times: the replicas and
shards then take turns on it, which is how a one-card machine runs a
(2, 2, 2) mesh (the counterpart of the JAX tests' virtual CPU devices).

Across several processes (parallel/multihost.make_global_mesh) a Mesh is
one process's part of the global grid: `devices` are its own local_dp *
sp * tp devices, `procs` the process count and `process` its index. Only
the data axis spans processes, data-major, so process p holds the global
replicas [p * local_replicas, (p + 1) * local_replicas); `dp` and
`replicas` are the global widths, `shard_devices` takes a local replica.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A (dp, sp, tp) grid; coordinate (d, s, t) on devices[(d*sp + s)*tp + t]
    (a device may repeat)."""

    devices: Tuple[torch.device, ...]
    sp: int = 1
    tp: int = 1
    #: the process count of the global grid and this process's index in it
    procs: int = 1
    process: int = 0

    @property
    def local_dp(self) -> int:
        """The data coordinates this process holds."""
        return len(self.devices) // (self.sp * self.tp)

    @property
    def dp(self) -> int:
        return self.local_dp * self.procs

    @property
    def shape(self) -> Dict[str, int]:
        """Axis widths by name, as jax.sharding.Mesh.shape gives them."""
        return {DATA_AXIS: self.dp, SEQ_AXIS: self.sp, MODEL_AXIS: self.tp}

    @property
    def replicas(self) -> int:
        """The (data, seq) coordinates: dp * sp."""
        return self.dp * self.sp

    @property
    def local_replicas(self) -> int:
        """The (data, seq) coordinates this process holds."""
        return self.local_dp * self.sp

    @property
    def replica_offset(self) -> int:
        """The global index of this process's first replica."""
        return self.process * self.local_replicas

    def shard_devices(self, replica: int) -> Tuple[torch.device, ...]:
        """The devices of (local) replica r's tp shards, shard order."""
        return self.devices[replica * self.tp:(replica + 1) * self.tp]

    @property
    def cards(self) -> List[torch.device]:
        """The distinct devices of the mesh, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(
    dp: int,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A (dp, sp, tp) mesh over the first dp*sp*tp of `devices`.

    With devices=None the platform is `device`'s (the card unless the
    caller asks for the CPU): every visible card once, or [cpu] * (dp*sp*tp)."""
    for name, n in (("dp", dp), ("tp", tp), ("sp", sp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    need = dp * sp * tp
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = [dev] * need
        else:
            devices = [
                torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ]
    devices = [resolve_device(d) for d in devices]
    if need > len(devices):
        raise ValueError(
            f"mesh ({dp}x{sp}x{tp}) needs {need} devices, have {len(devices)}"
        )
    devices = [
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d
        for d in devices[:need]
    ]
    return Mesh(tuple(devices), sp=sp, tp=tp)
