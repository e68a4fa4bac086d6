"""Training loop (single device).

Port of the single-device path of word2vec_tpu/train.py (Trainer
construction, init_state, alpha_at and the per-step loop): epochs over a
shuffled corpus with the linear alpha decay of Word2Vec.cpp:379-380,

    alpha = max(min_alpha, init_alpha * (1 - words_done / (iters * total_words)))

refreshed every step. The host fills [B, L] batches in a prefetch thread;
each step draws its randomness from a torch.Generator on the device and
runs the band step of the config's route (ops/band_step.py: 'xla',
'pallas_oa' and 'pallas' on split tables, 'xla', 'pallas_oa' and
'pallas_fused' on the unified slab), which updates the tables in place. The loop reads the device only at log points and at the end.

Not in this slice: the chunked / device-resident dispatch (the step runs
one launch sequence per batch whatever `chunk_steps` says; the trajectory
is the same), checkpoints, and the obs / resilience / planner hooks.
Configs that need them raise NotImplementedError.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from .config import Word2VecConfig
from .data.batcher import BatchIterator, PackedCorpus, prefetch
from .data.vocab import Vocab
from .device import DeviceLike, generator, resolve_device
from .models.params import Params, init_params
from .ops.band_step import BandStep, check_route
from .ops.tables import DeviceTables


@dataclass
class TrainState:
    params: Params
    step: int = 0
    words_done: int = 0
    epoch: int = 0


@dataclass
class TrainReport:
    words_per_sec: float
    total_words: int
    steps: int
    wall_time: float
    final_loss: float
    loss_history: List[float] = field(default_factory=list)


def _check_slice(config: Word2VecConfig) -> None:
    check_route(config)
    unported = [
        (config.autotune != "off", "autotune (tune/)"),
        (config.corpus_mode != "resident", "corpus_mode='streaming' (stream/)"),
        (config.resident == "on", "resident='on' (ops/resident.py)"),
        (config.quality_probe_every > 0, "quality_probe_every (obs/quality.py)"),
        (config.health_metrics, "health_metrics (obs/health.py)"),
        (config.divergence_budget > 0, "divergence_budget (obs/health.py)"),
        (config.elastic != "off", "elastic (resilience/elastic.py)"),
    ]
    names = [name for cond, name in unported if cond]
    if names:
        raise NotImplementedError(
            "not in this slice of the PyTorch port: " + ", ".join(names)
        )


class Trainer:
    """End-to-end single-device trainer; device defaults to "cuda"."""

    def __init__(
        self,
        config: Word2VecConfig,
        vocab: Vocab,
        corpus: PackedCorpus,
        log_fn: Optional[Callable[[Dict], None]] = None,
        device: DeviceLike = None,
    ):
        _check_slice(config)
        self.config = config
        self.vocab = vocab
        self.corpus = corpus
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.tables = DeviceTables.build(vocab, config, self.device)
        self.total_words = corpus.num_tokens
        self.step_fn = BandStep(config, self.tables)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = self.config.seed if seed is None else seed
        gen = generator(self.device, seed)
        return TrainState(
            params=init_params(self.config, len(self.vocab), gen)
        )

    def alpha_at(self, words_done: int) -> float:
        cfg = self.config
        frac = words_done / max(1, cfg.iters * self.total_words)
        return max(cfg.min_alpha, cfg.init_alpha * (1.0 - frac))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(
        self,
        state: Optional[TrainState] = None,
        log_every: int = 50,
        max_steps: int = 0,
    ) -> tuple:
        """Run the epochs (or stop after `max_steps` optimizer steps when
        it is > 0). Returns (state, TrainReport)."""
        cfg = self.config
        state = state or self.init_state()
        batcher = BatchIterator(
            self.corpus, cfg.batch_rows, cfg.max_sentence_len, seed=cfg.seed
        )
        # the root of the device draw streams (cf. train.py:683-685)
        gen = generator(self.device, cfg.seed ^ 0x5EED)
        k = cfg.micro_steps
        loss_hist: List[float] = []
        last = None
        self._sync()
        t0 = time.perf_counter()
        done = False
        for epoch in range(state.epoch, cfg.iters):
            state.epoch = epoch
            for tokens_np, words in prefetch(batcher.epoch(epoch)):
                tokens = torch.from_numpy(tokens_np).to(
                    self.device, non_blocking=True
                )
                alpha = self.alpha_at(state.words_done)
                # micro_steps: k sequential optimizer sub-steps over row
                # blocks of the batch (ops/train_step.py micro wrapper)
                last = None
                for sub in tokens.chunk(k, dim=0):
                    m = self.step_fn(state.params, sub, gen, alpha)
                    last = m if last is None else {
                        key: last[key] + m[key] for key in m
                    }
                state.step += 1
                state.words_done += words
                if log_every and state.step % log_every == 0:
                    loss = float(last["loss_sum"]) / max(1.0, float(last["pairs"]))
                    loss_hist.append(loss)
                    if self.log_fn is not None:
                        dt = time.perf_counter() - t0
                        self.log_fn({
                            "step": state.step,
                            "epoch": epoch,
                            "alpha": alpha,
                            "loss": loss,
                            "words_per_sec": state.words_done / max(dt, 1e-9),
                        })
                if max_steps and state.step >= max_steps:
                    done = True
                    break
            if done:
                break
            state.epoch = epoch + 1
        self._sync()
        wall = time.perf_counter() - t0
        final_loss = float("nan")
        if last is not None:
            final_loss = float(last["loss_sum"]) / max(1.0, float(last["pairs"]))
        report = TrainReport(
            words_per_sec=state.words_done / max(wall, 1e-9),
            total_words=state.words_done,
            steps=state.step,
            wall_time=wall,
            final_loss=final_loss,
            loss_history=loss_hist,
        )
        return state, report
