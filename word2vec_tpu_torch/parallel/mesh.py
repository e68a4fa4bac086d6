"""The replica mesh of one-process data-parallel training.

Port of word2vec_tpu/parallel/mesh.py at tp = sp = 1. The JAX package lays
its devices out as a (data, seq, model) jax.sharding.Mesh; here a Mesh is
the list of devices the data-parallel replicas train on, replica r on
devices[r], with the same axis names and the same shape check. Each
replica holds a full copy of the tables and trains its own row block of
every global step; parallel/trainer.py averages the replicas every
dp_sync_every optimizer steps.

The default devices are the visible cards, each once (one replica a
card); on the CPU, [cpu] * dp. A caller may name one card several times:
the replicas then take turns on it, which is how a one-card machine runs
dp = 2 (the counterpart of the JAX tests' virtual CPU devices).

Not in this slice (ROADMAP A8b): the model (tensor-parallel) and seq
(sequence-parallel) axes, whose steps exchange partial logits and halo
tokens inside the step; tp > 1 or sp > 1 raises NotImplementedError.
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
    """dp replicas, replica r on devices[r] (a device may repeat)."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis widths by name, as jax.sharding.Mesh.shape gives them."""
        return {DATA_AXIS: len(self.devices), SEQ_AXIS: 1, MODEL_AXIS: 1}

    @property
    def cards(self) -> List[torch.device]:
        """The distinct devices of the mesh, in replica order."""
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
    """A (dp, 1, 1) mesh over the first dp of `devices`.

    With devices=None the platform is `device`'s (the card unless the
    caller asks for the CPU): every visible card once, or [cpu] * dp."""
    if tp != 1 or sp != 1:
        raise NotImplementedError(
            f"mesh ({dp}x{sp}x{tp}): only data parallelism is in this slice "
            "of the PyTorch port; tensor (tp) and sequence (sp) parallelism "
            "are ROADMAP A8b"
        )
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
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
    return Mesh(tuple(devices))
