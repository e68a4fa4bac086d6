"""Resilience: the failures a run actually has, in one process or more.

  shutdown.py   — preemption-safe cooperative stop (SIGTERM/SIGINT ->
                  checkpoint at the next dispatch boundary -> exit
                  EXIT_PREEMPTED), the SIGUSR1 flight dump and the SIGUSR2
                  device dump (a bounded profiler window + the memory
                  ledger).
  supervisor.py — auto-recovery from divergence: roll back to the
                  last-good checkpoint into the trainer's captured
                  buffers, rescale alpha, advance the seed, retry.
  faults.py     — the declarative FaultPlan the chaos tests and
                  `--faults` inject.
  watchdog.py   — the step-deadline watchdog (stack dump + wedged phase +
                  EXIT_STALLED), bounded_call, the peer-failure classifier
                  and PeerAgreement (the multi-process stop vote with a
                  liveness heartbeat, and the elastic grow and policy
                  columns).
  elastic.py    — elastic training: the rendezvous (ElasticServer), the
                  shrink / grow / election / policy-shrink rounds, the
                  generation snapshot and the in-place exec
                  (ElasticController).
  policy.py     — the signal-driven elastic policy (ElasticPolicy,
                  parse_policy).

Submodules are imported lazily: io/checkpoint.py consults `faults` for
its injection point, and an eager `from .supervisor import ...` here would
close an import cycle through io/checkpoint -> resilience.faults.
"""

from __future__ import annotations

__all__ = [
    "ElasticController",
    "ElasticError",
    "ElasticPolicy",
    "ElasticServer",
    "Fault",
    "FaultPlan",
    "GrowRequested",
    "PolicyError",
    "PolicyShrinkRequested",
    "PeerAgreement",
    "ShutdownHandler",
    "StepWatchdog",
    "Supervisor",
    "SyncTimeout",
    "EXIT_PREEMPTED",
    "EXIT_STALLED",
]

_LAZY = {
    "ElasticController": (
        "word2vec_tpu_torch.resilience.elastic", "ElasticController"
    ),
    "ElasticError": ("word2vec_tpu_torch.resilience.elastic", "ElasticError"),
    "ElasticServer": ("word2vec_tpu_torch.resilience.elastic", "ElasticServer"),
    "GrowRequested": ("word2vec_tpu_torch.resilience.elastic", "GrowRequested"),
    "PolicyShrinkRequested": (
        "word2vec_tpu_torch.resilience.elastic", "PolicyShrinkRequested"
    ),
    "ElasticPolicy": ("word2vec_tpu_torch.resilience.policy", "ElasticPolicy"),
    "PolicyError": ("word2vec_tpu_torch.resilience.policy", "PolicyError"),
    "Fault": ("word2vec_tpu_torch.resilience.faults", "Fault"),
    "FaultPlan": ("word2vec_tpu_torch.resilience.faults", "FaultPlan"),
    "ShutdownHandler": (
        "word2vec_tpu_torch.resilience.shutdown", "ShutdownHandler"
    ),
    "EXIT_PREEMPTED": (
        "word2vec_tpu_torch.resilience.shutdown", "EXIT_PREEMPTED"
    ),
    "Supervisor": ("word2vec_tpu_torch.resilience.supervisor", "Supervisor"),
    "StepWatchdog": ("word2vec_tpu_torch.resilience.watchdog", "StepWatchdog"),
    "PeerAgreement": ("word2vec_tpu_torch.resilience.watchdog", "PeerAgreement"),
    "SyncTimeout": ("word2vec_tpu_torch.resilience.watchdog", "SyncTimeout"),
    "EXIT_STALLED": ("word2vec_tpu_torch.resilience.watchdog", "EXIT_STALLED"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
