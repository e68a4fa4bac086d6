"""Supervised auto-recovery from divergence.

The port's counterpart of word2vec_tpu/resilience/supervisor.py. The
divergence tripwire (obs/health.HealthMonitor) turns "train on NaN params
until the epoch ends" into a structured DivergenceError; the supervisor
closes the loop:

    try train -> DivergenceError -> roll back to the last GOOD checkpoint
    (io/checkpoint's backup chain + integrity validation + a finite-params
    check, so a checkpoint that itself captured NaN tables is rejected and
    quarantined) -> optionally rescale alpha and advance the shuffle seed
    (a divergence is often batch-order and learning-rate conditioned) ->
    retry, up to `max_retries` times -> re-raise.

The trainer instance is REUSED across retries, and so are its captured
CUDA graphs: the seed and alpha are inputs of every replay (the step's
generator is re-seeded from device.step_seed(seed, step) before each
replay, the alphas are copied into the graph's static buffer per
dispatch, and the batcher and the resident row order read config.seed at
each train() call), so a recovery costs a checkpoint load and one copy
into the trainer's persistent buffers — train(state=...) copies the
rolled-back tables into the tensors the graphs were captured against — and
no new capture. Every recovery is recorded (`Supervisor.recoveries`, also
attached to the final TrainReport.recoveries, logged as an
"auto_recover" event and put on the flight timeline).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..obs.health import DivergenceError


def validate_finite_params(state, config=None, vocab=None) -> None:
    """load_checkpoint validator: every table must be all-finite. A
    checkpoint taken after the params went NaN is not a rollback target —
    treating it as corrupt sends the loader down the backup chain. Runs on
    the loader's CPU tensors."""
    from ..io.checkpoint import CheckpointError

    for k, v in state.params.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise CheckpointError(
                f"non-finite values in checkpointed table {k!r} "
                "(captured after divergence)"
            )


class Supervisor:
    """Retry `trainer.train` across DivergenceErrors with rollback.

    Parameters:
      trainer         a train.Trainer
      checkpoint_dir  where the run's checkpoints land; None means every
                      recovery restarts from a fresh init (still bounded)
      max_retries     recoveries before the DivergenceError propagates
      alpha_scale     multiplied into config.init_alpha per recovery
                      (1.0 = keep the schedule; 0.5 halves it each time)
      reseed          advance config.seed per recovery so the retry sees a
                      different batch order and draw streams
    """

    def __init__(
        self,
        trainer,
        checkpoint_dir: Optional[str] = None,
        max_retries: int = 1,
        alpha_scale: float = 0.5,
        reseed: bool = True,
        log_fn=None,
    ):
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        if not (0.0 < alpha_scale <= 1.0):
            raise ValueError(
                f"alpha_scale must be in (0, 1], got {alpha_scale}"
            )
        self.trainer = trainer
        self.checkpoint_dir = checkpoint_dir
        self.max_retries = int(max_retries)
        self.alpha_scale = float(alpha_scale)
        self.reseed = bool(reseed)
        self.log_fn = log_fn
        #: one record per recovery ("auto_recover" events)
        self.recoveries: List[Dict] = []

    def run(self, state=None, **train_kwargs):
        """trainer.train with supervised retries; same return contract.
        The final report carries `recoveries` when any recovery happened."""
        attempt = 0
        while True:
            try:
                out_state, report = self.trainer.train(state=state, **train_kwargs)
                if self.recoveries:
                    report.recoveries = list(self.recoveries)
                return out_state, report
            except DivergenceError as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                state = self._recover(e, attempt)

    # ------------------------------------------------------------ recovery
    def _recover(self, err: DivergenceError, attempt: int):
        from ..io.checkpoint import CheckpointError, load_checkpoint

        state = None
        rolled_back_to: Optional[str] = None
        if self.checkpoint_dir:
            try:
                state, _ck_cfg, _ck_vocab = load_checkpoint(
                    self.checkpoint_dir, validate=validate_finite_params
                )
                rolled_back_to = f"step {state.step}"
            except CheckpointError:
                state = None
        if state is None:
            # no checkpoint landed before the divergence (or none survived
            # validation): restart from init — with the seed bump below the
            # re-init is a genuinely different draw, not a replay
            rolled_back_to = "fresh init"

        # Rescale alpha / advance the shuffle seed on the live trainer: both
        # are inputs of each dispatch, so no runner is rebuilt and no graph
        # is captured again
        cfg = self.trainer.config
        new_fields = {}
        if self.alpha_scale != 1.0:
            new_fields["init_alpha"] = cfg.init_alpha * self.alpha_scale
        if self.reseed:
            new_fields["seed"] = cfg.seed + 1
        if new_fields:
            self.trainer.config = dataclasses.replace(cfg, **new_fields)

        if state is None:
            state = self.trainer.init_state()

        rec = {
            "event": "auto_recover",
            "attempt": attempt,
            "max_retries": self.max_retries,
            "failed_step": err.step,
            "streak": err.streak,
            "rolled_back_to": rolled_back_to,
            "resume_step": state.step,
            "init_alpha": self.trainer.config.init_alpha,
            "seed": self.trainer.config.seed,
        }
        self.recoveries.append(rec)
        if self.log_fn:
            self.log_fn(dict(rec))
        fl = getattr(self.trainer, "flight", None)
        if fl is not None:
            # the recovery lands on the flight timeline too: a later dump
            # shows the run healed (and how) without the JSONL file
            fl.log_record(rec)
        return state
