"""Mid-epoch resume in the port's Trainer continues the trajectory (CPU).

The JAX trainer resumes a state bitwise: the epoch is re-entered at its
first undone batch (_resume_skip, word2vec_tpu/train.py:453-468) and
each step draws from fold_in(base_key, state.step) (:683-686, :749), so
the draws depend on the step index alone (tests/test_resident.py:100-139
pins it). The port's counterparts: Trainer._resume_skip and
device.step_seed, the seed of step s a pure function of (run seed, s).

Pins, BITWISE: train(max_steps=k) then train(state=...) equals one
uninterrupted run, on every route, per-step, chunked and resident, on the
same trainer and on a fresh one; a state grabbed by checkpoint_cb in the
middle of an epoch resumes to the uninterrupted params; a state on an
epoch boundary rolls into the next epoch. train(state=...) copies the
caller's params in and never trains them in place, and the params it
returns stay the caller's. A state whose step counter does not fit this
geometry restarts its epoch with a warning and a log record.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp_
from word2vec_tpu_torch import Trainer
from word2vec_tpu_torch.device import seed_step, step_seed

torch.set_num_threads(1)

MODES = {
    "per_step": dict(chunk_steps=1),
    "chunked": dict(chunk_steps=4, resident="off"),
    "resident": dict(chunk_steps=4, resident="on"),
}


def _trainer(cfg):
    vocab, corpus = tp_.small_corpus()
    return Trainer(cfg, vocab, corpus, device="cpu")


def _clone(state):
    return type(state)(
        params={k: v.clone() for k, v in state.params.items()},
        step=state.step, words_done=state.words_done, epoch=state.epoch,
    )


def test_step_seed_is_a_pure_function_of_seed_and_step():
    seeds = [step_seed(11, s) for s in range(2000)]
    assert seeds == [step_seed(11, s) for s in range(2000)]
    assert len(set(seeds)) == 2000
    assert step_seed(11, 5) != step_seed(12, 5)
    assert all(0 <= x < 2**64 for x in seeds)
    g = torch.Generator()
    draws = []
    for _ in range(2):
        seed_step(g, 11, 7)
        draws.append(torch.rand(5, generator=g))
    assert torch.equal(*draws)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_mid_epoch_resume_matches_uninterrupted(route, mode):
    cfg = tp_.trainer_cfg(route, iters=2, **MODES[mode])
    full, _ = _trainer(cfg).train(log_every=0)
    tr = _trainer(cfg)
    spe = -(-tr.corpus.num_rows // cfg.batch_rows)
    k = 7  # mid-epoch, inside a chunk of 4
    assert k < spe
    part, rep = tr.train(log_every=0, max_steps=k)
    assert (part.step, part.epoch, rep.steps) == (k, 0, k)
    mid = _clone(part)
    same, _ = tr.train(state=part, log_every=0)          # the same trainer
    fresh, _ = _trainer(cfg).train(state=mid, log_every=0)  # a fresh one
    for got in (same, fresh):
        assert (got.step, got.words_done, got.epoch) == (
            full.step, full.words_done, full.epoch)
        tp_.assert_params_bitwise(got.params, full.params)


@pytest.mark.parametrize("mode", ["per_step", "resident"])
@pytest.mark.parametrize("name", list(tp_.STEP_ROUTES))
def test_step_routes_resume_matches_uninterrupted(name, mode):
    """The hs and pair steps resumed mid-epoch in a fresh trainer end on
    the uninterrupted params."""
    cfg = tp_.trainer_cfg(**tp_.STEP_ROUTES[name], **MODES[mode])
    full, _ = _trainer(cfg).train(log_every=0)
    part, _ = _trainer(cfg).train(log_every=0, max_steps=7)
    got, _ = _trainer(cfg).train(state=part, log_every=0)
    assert (got.step, got.words_done) == (full.step, full.words_done)
    tp_.assert_params_bitwise(got.params, full.params)


def test_checkpoint_cb_state_resumes_to_the_uninterrupted_params():
    """tests/test_resident.py:100-139 in the port: checkpoint mid-epoch on
    the resident path, resume in a new trainer, land on the same params."""
    cfg = tp_.trainer_cfg(iters=2, chunk_steps=4, resident="on",
                          subsample_threshold=0.0, word_dim=8)
    full, _ = _trainer(cfg).train(log_every=0)
    saved = {}

    def grab(state):
        if not saved and state.epoch == 0 and state.step >= 8:
            saved["state"] = _clone(state)

    _trainer(cfg).train(log_every=0, checkpoint_cb=grab, checkpoint_every=8)
    assert "state" in saved and 0 < saved["state"].step < full.step
    resumed, _ = _trainer(cfg).train(state=saved["state"], log_every=0)
    assert resumed.step == full.step
    tp_.assert_params_bitwise(resumed.params, full.params)


@pytest.mark.parametrize("chunk", [1, 4])
def test_checkpoint_cb_cadence(chunk):
    steps = []
    tr = _trainer(tp_.trainer_cfg(chunk_steps=chunk, resident="off"))
    state, _ = tr.train(log_every=0, checkpoint_cb=lambda s: steps.append(s.step),
                        checkpoint_every=5)
    if chunk == 1:
        assert steps == list(range(5, state.step + 1, 5))
    else:  # once per chunk boundary that crosses a multiple of 5
        assert steps and all(s % 4 == 0 or s == state.step for s in steps)
        assert len(steps) == len({s // 5 for s in steps})


def test_resume_on_the_epoch_boundary_rolls_into_the_next_epoch():
    cfg = tp_.trainer_cfg(iters=2)
    full, _ = _trainer(cfg).train(log_every=0)
    tr = _trainer(cfg)
    spe = -(-tr.corpus.num_rows // cfg.batch_rows)
    part, _ = tr.train(log_every=0, max_steps=spe)
    part.epoch = 0  # a checkpoint taken before the epoch counter advanced
    got, _ = _trainer(cfg).train(state=part, log_every=0)
    tp_.assert_params_bitwise(got.params, full.params)


def test_train_copies_the_callers_params_and_returns_its_own():
    cfg = tp_.trainer_cfg()
    tr = _trainer(cfg)
    state = tr.init_state()
    given = {k: v.clone() for k, v in state.params.items()}
    held = state.params
    out, _ = tr.train(state=state, log_every=0, max_steps=3)
    for k in given:
        assert torch.equal(held[k], given[k])  # not trained in place
    first = {k: v.clone() for k, v in out.params.items()}
    tr.train(state=_clone(out), log_every=0, max_steps=6)
    tp_.assert_params_bitwise(out.params, first)  # not aliased to the trainer


def test_out_of_range_step_counter_restarts_the_epoch_loudly():
    logs = []
    cfg = tp_.trainer_cfg()
    vocab, corpus = tp_.small_corpus()
    tr = Trainer(cfg, vocab, corpus, log_fn=logs.append, device="cpu")
    state = tr.init_state()
    state.step = 10_000  # from another batch geometry
    with pytest.warns(UserWarning, match="out of range"):
        tr.train(state=state, log_every=0, max_steps=10_002)
    assert tr.resume_fallback == "epoch_restart"
    assert [r["event"] for r in logs] == ["resume_fallback"]
    assert logs[0]["derived_skip"] == 10_000
