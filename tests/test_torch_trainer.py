"""The port trainer's hooks beyond the step (CPU):

  * the three construction-time config hazard warnings fire with the JAX
    package's text on the same configs;
  * the always-on nonfinite_loss metric counts as the JAX package's
    obs/health.instrument_step does, per micro sub-step, when a NaN is
    planted in a table (the chunk runners of both packages on the same
    tokens and draws), and the divergence tripwire aborts at its budget;
  * a stop_check that stops at step s stops the run at s (per-step and
    chunked dispatch, report.interrupted == "preempted"), and a real
    SIGTERM through ShutdownHandler stops it at the next boundary.
"""

import signal
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu import Trainer as JTrainer  # noqa: E402
from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops.train_step import make_chunk_runner as j_chunk  # noqa: E402
from word2vec_tpu.utils.synthetic import zipf_vocab as j_zipf_vocab  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import PackedCorpus, Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.obs.health import DivergenceError  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner  # noqa: E402
from word2vec_tpu_torch.resilience.shutdown import ShutdownHandler  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

torch.set_num_threads(1)


def _messages(make):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        make()
    return [str(w.message) for w in rec if issubclass(w.category, UserWarning)]


HAZARDS = {
    # (a) ~12 tokens a word per optimizer block, (b) 3 steps an epoch
    "block-heavy+few-steps": (dict(batch_rows=8), 10, 400, 2),
    # (c) the degenerate domain under an explicit band kernel, (b)
    "degenerate-band": (dict(batch_rows=4, kernel="band", iters=30), 40, 2000, 2),
    # a config that triggers none of them
    "clean": (dict(batch_rows=1), 400, 4000, 0),
    # (c)'s domain under kernel='auto': the trainer selects 'pair' and the
    # degeneracy warning stays silent; (b)
    "degenerate-auto": (dict(batch_rows=4, iters=30), 40, 2000, 1),
}


@pytest.mark.parametrize("case", list(HAZARDS))
def test_hazard_warnings_match_jax_text(case):
    over, vocab_size, tokens, n_warnings = HAZARDS[case]
    kw = dict(model="sg", train_method="ns", negative=3, word_dim=8,
              window=2, min_count=1, max_sentence_len=16, **over)
    tv = zipf_vocab(vocab_size, 10 * tokens)
    jv = j_zipf_vocab(vocab_size, 10 * tokens)
    ids = zipf_corpus_ids(tv, tokens, seed=2, sentence_len=16)
    got = _messages(lambda: Trainer(Word2VecConfig(**kw), tv,
                                    PackedCorpus.pack(ids, 16), device="cpu"))
    want = _messages(lambda: JTrainer(JConfig(**kw), jv, JCorpus.pack(ids, 16)))
    assert got == want and len(got) == n_warnings
    if case == "degenerate-band":
        assert any("shared negative pool" in m for m in got)


def test_nonfinite_loss_counts_as_jax_instrument_step(monkeypatch):
    """A NaN row in the input table: every step whose batch touches it
    (or the rows it has poisoned since) counts one per micro sub-step,
    exactly as the JAX step's instrumented metrics do."""
    kw = tp_.kw(micro_steps=2)
    jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
    jt, tt = tp_.tables()
    jp = j_init(jcfg, tp_.V, jax.random.key(1))
    toks = np.stack([np.roll(tp_.tokens(), i, axis=0) for i in range(4)])
    bad = int(toks[0, 0, 0])
    jp = {k: (v.at[bad].set(jnp.nan) if k == "emb_in" else v)
          for k, v in jp.items()}
    tparams = tp_.torch_params(jp, tcfg)
    alphas = np.float32([0.03, 0.028, 0.026, 0.024])
    base_key = jax.random.key(7)
    _, jm = jax.jit(j_chunk(jcfg, jt))(
        jp, jnp.asarray(toks), base_key, 0, jnp.asarray(alphas))
    runner = make_chunk_runner(tcfg, tt)
    # sub-step i of a step draws from fold_in(step key, i) over B/2 rows
    # (the JAX micro wrapper)
    monkeypatch.setattr(tp_, "B", tp_.B // 2)
    runner.draws_hook = lambda step, sub: tp_.jax_draws(
        runner.step,
        jax.random.fold_in(jax.random.fold_in(base_key, step), sub), jt)
    tm = runner(tparams, torch.from_numpy(toks), 0, 0, alphas)
    want = np.asarray(jm["nonfinite_loss"])
    np.testing.assert_array_equal(tm["nonfinite_loss"].numpy(), want)
    assert want[0] >= 1 and want.max() <= 2


def _small(**over):
    vocab, corpus = tp_.small_corpus(3000)
    return Trainer(tp_.trainer_cfg(**over), vocab, corpus, device="cpu")


@pytest.mark.parametrize("chunk", [1, 3])
def test_divergence_budget_aborts_and_counts(chunk):
    tr = _small(chunk_steps=chunk, divergence_budget=0)
    state = tr.init_state()
    state.params = {k: torch.full_like(v, float("nan")) for k, v in state.params.items()}
    _, rep = tr.train(state=state, log_every=0, max_steps=6)
    assert rep.health["nonfinite_loss_steps"] == rep.health["observations"] == 6
    tr = _small(chunk_steps=chunk, divergence_budget=3)
    state = tr.init_state()
    state.params = {k: torch.full_like(v, float("nan")) for k, v in state.params.items()}
    with pytest.raises(DivergenceError) as e:
        tr.train(state=state, log_every=0)
    assert e.value.step == 3 and e.value.streak == 3 and e.value.first_step == 1
    _, rep = _small(chunk_steps=chunk).train(log_every=0, max_steps=6)
    assert rep.health["nonfinite_loss_steps"] == 0


@pytest.mark.parametrize("chunk,stop_at", [(1, 5), (3, 6)])
def test_stop_check_stops_at_the_step(chunk, stop_at):
    tr = _small(chunk_steps=chunk, iters=2)
    tr.stop_check = lambda step: step >= stop_at
    state, rep = tr.train(log_every=0)
    assert state.step == rep.steps == stop_at
    assert rep.interrupted == "preempted" and state.epoch == 0
    full = _small(chunk_steps=chunk, iters=2)
    whole, rep = full.train(log_every=0)
    assert rep.interrupted is None and whole.step > stop_at
    # the stopped state resumes onto the uninterrupted trajectory
    rest, _ = _small(chunk_steps=chunk, iters=2).train(state=state, log_every=0)
    tp_.assert_params_bitwise(rest.params, whole.params)


def test_sigterm_requests_a_cooperative_stop():
    tr = _small(chunk_steps=1, iters=2)
    handler = ShutdownHandler().install()
    try:
        tr.install_shutdown(handler)

        def ckpt(state):
            if state.step == 2:
                signal.raise_signal(signal.SIGTERM)

        state, rep = tr.train(log_every=0, checkpoint_cb=ckpt, checkpoint_every=1)
    finally:
        handler.uninstall()
    assert handler.requested and handler.signum == signal.SIGTERM
    assert state.step == 2 and rep.interrupted == "preempted"


def test_hs_tail_drops_reach_the_log_and_warn():
    """Two-tier hs with a tail bound that overflows: every log record of
    the hs route carries hs_tail_dropped (the JAX record's key), the
    other routes' records do not, and two consecutive dropping
    observations warn once with the JAX trainer's fix."""
    vocab, corpus = tp_.small_corpus()
    logs = []
    cfg = tp_.trainer_cfg(**tp_.STEP_ROUTES["hs-cbow-2tier-overflow"])
    tr = Trainer(cfg, vocab, corpus, log_fn=logs.append, device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tr.train(log_every=2)
    steps = [r for r in logs if "step" in r]
    assert steps and all(r["hs_tail_dropped"] >= 0 for r in steps)
    assert sum(r["hs_tail_dropped"] for r in steps) > 0
    msgs = [str(w.message) for w in rec if "hs tail compaction" in str(w.message)]
    assert len(msgs) == 1 and "hs_tail_slots" in msgs[0]
    logs.clear()
    Trainer(tp_.trainer_cfg(**tp_.STEP_ROUTES["pair-ns"]), vocab, corpus,
            log_fn=logs.append, device="cpu").train(log_every=2, max_steps=4)
    assert logs and not any("hs_tail_dropped" in r for r in logs)
