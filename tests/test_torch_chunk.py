"""The port's chunked dispatch (ops/train_step.make_chunk_runner,
ops/graphs.py) against the JAX package's make_chunk_runner and against
the port's own per-step driver (CPU).

Pins:
  * the chunk runner matches JAX make_chunk_runner on the same [S, B, L]
    tokens, alphas and base key, the port fed the JAX step's draws of
    fold_in(base_key, step0 + i) through the runner's draws_hook, split,
    unified and fused_tables; tolerance torch_parity.assert_params_close
    (f32 tables within atol 1e-6: the contractions sum in another order);
  * within the port, BITWISE: a chunked Trainer run (chunk_steps 5 and
    auto) equals the per-step run, sg and cbow with micro_steps=2, on every
    route; fused_tables equals the unfused run;
  * an all-PAD batch changes no parameter value and counts no pair on any
    route (its zero terms turn a -0.0 cell into +0.0, as the JAX step's
    .at[].add of +0.0 does), and the runner skips a padded chunk's pad
    steps, so a padded chunk equals its real steps BITWISE, -0.0 included;
  * alpha as a 0-d float32 tensor (what a captured step reads) gives the
    step of alpha as a float, BITWISE, on every route.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops.train_step import make_chunk_runner as j_chunk  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.models.params import FUSED_KEY  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.graphs import METRICS  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner  # noqa: E402

torch.set_num_threads(1)

S, STEP0 = 3, 5


def _chunk_tokens(n_real):
    """[S, B, L]: n_real batches (torch_parity.tokens and row-rolled
    copies of it), then all-PAD batches."""
    base = tp_.tokens()
    toks = np.full((S,) + base.shape, -1, np.int32)
    for i in range(n_real):
        toks[i] = np.roll(base, i, axis=0)
    return toks


JAX_CASES = {
    "xla-split": dict(),
    "xla-split-cbow-mean": dict(model="cbow", scatter_mean=True),
    "xla-unified": dict(table_layout="unified"),
    "xla-fused_tables": dict(fused_tables=True),
    "pallas_oa-fused_tables": dict(band_backend="pallas_oa", fused_tables=True),
    "pallas-split": dict(band_backend="pallas"),
    "pallas_fused-unified": dict(band_backend="pallas_fused",
                                 table_layout="unified"),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_chunk_runner_matches_jax_chunk_runner(case):
    kw = tp_.kw(**JAX_CASES[case])
    jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
    jt, tt = tp_.tables()
    jp = j_init(jcfg, tp_.V, jax.random.key(1))
    tp = tp_.torch_params(jp, tcfg)
    toks = _chunk_tokens(2)  # a padded chunk: two real steps, one pad
    alphas = np.float32([0.03, 0.027, 0.024])
    base_key = jax.random.key(7)

    jp, jm = jax.jit(j_chunk(jcfg, jt))(
        jp, jnp.asarray(toks), base_key, STEP0, jnp.asarray(alphas)
    )
    runner = make_chunk_runner(tcfg, tt)
    runner.draws_hook = lambda step, sub: tp_.jax_draws(
        runner.step, jax.random.fold_in(base_key, step), jt
    )
    tm = runner(tp, torch.from_numpy(toks), 0, STEP0, alphas, steps=2)
    tp_.assert_params_close(tp, jp, kw)
    assert sorted(tp) == sorted(jp)  # fused_tables: the public layout stays
    for i in range(S):
        tp_.assert_metrics_close({k: tm[k][i] for k in jm},
                                 {k: jm[k][i] for k in jm})
        assert float(tm["hs_tail_dropped"][i]) == 0.0  # no hs tail here
    assert float(jm["pairs"][2]) == 0.0 and float(tm["pairs"][2]) == 0.0


def _run(cfg, **train_kw):
    vocab, corpus = tp_.small_corpus()
    state, report = Trainer(cfg, vocab, corpus, device="cpu").train(
        log_every=3, **train_kw)
    return state, report


@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_chunked_matches_per_step_bitwise(route, model):
    """chunk_steps=5 (the epoch's last chunk padded) and the per-step path,
    micro_steps=2: the same params, steps, words, loss history."""
    one, r1 = _run(tp_.trainer_cfg(route, model=model, micro_steps=2))
    five, r5 = _run(tp_.trainer_cfg(route, model=model, micro_steps=2,
                                    chunk_steps=5, resident="off"))
    assert one.step == five.step > 5 and one.step % 5 != 0
    assert one.words_done == five.words_done == r1.total_words
    tp_.assert_params_bitwise(one.params, five.params)
    assert r1.loss_history and np.isfinite(r1.loss_history).all()
    assert np.isfinite(r5.final_loss)


@pytest.mark.parametrize("name", list(tp_.STEP_ROUTES))
def test_step_routes_chunked_match_per_step_bitwise(name):
    """The hs and pair steps through the chunk runner: chunk_steps=5 (the
    last chunk padded) equals the per-step path, params and loss."""
    over = tp_.STEP_ROUTES[name]
    one, r1 = _run(tp_.trainer_cfg(**over))
    five, r5 = _run(tp_.trainer_cfg(chunk_steps=5, resident="off", **over))
    assert one.step == five.step > 5 and one.step % 5 != 0
    tp_.assert_params_bitwise(one.params, five.params)
    assert sorted(one.params) == sorted(five.params)
    assert np.isfinite(r1.final_loss) and r1.loss_history
    assert r1.loss_history[-1] == r5.loss_history[-1]


@pytest.mark.parametrize("over", [dict(chunk_steps=0, iters=2),
                                  dict(chunk_steps=4, fused_tables=True),
                                  dict(chunk_steps=4, fused_tables=True,
                                       band_backend="pallas_oa")],
                         ids=["auto-2-epochs", "fused_tables", "fused_tables-pallas_oa"])
def test_chunk_variants_match_per_step_bitwise(over):
    per = dict(iters=over.get("iters", 1), band_backend=over.get("band_backend", "xla"))
    ref, _ = _run(tp_.trainer_cfg(**per))
    got, rep = _run(tp_.trainer_cfg(resident="off", **{**over, **per}))
    tp_.assert_params_bitwise(ref.params, got.params)
    assert FUSED_KEY not in got.params


def test_chunk_log_cadence_matches_per_step():
    """log_every boundaries: one history entry per dispatch that crosses
    one, so the per-step path (S=1) logs every log_every steps."""
    logs = []
    vocab, corpus = tp_.small_corpus()
    cfg = tp_.trainer_cfg()
    state, rep = Trainer(cfg, vocab, corpus, log_fn=logs.append,
                         device="cpu").train(log_every=4)
    assert [r["step"] for r in logs] == list(range(4, state.step + 1, 4))
    assert len(rep.loss_history) == len(logs)
    assert all(np.isfinite(r["loss"]) and r["alpha"] > 0 for r in logs)
    assert logs[-1]["progress"] <= 1.0


def _route_params(route, dtype, seed=0):
    """Split or unified params with -0.0 cells on row 0 and row 3."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.normal(0, 0.1, (tp_.V, 2, tp_.D)).astype(np.float32))
    t = t.to(dtype)
    t[0, :, ::2] = -0.0
    t[3, :, 1::3] = -0.0
    if route[1] == "unified":
        return {FUSED_KEY: t.contiguous()}
    return {"emb_in": t[:, 0].contiguous(), "emb_out_ns": t[:, 1].contiguous()}


def _route_kw(route, **over):
    return tp_.kw(band_backend=route[0], table_layout=route[1], **over)


@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_pad_batches_are_noops(route, model):
    _, tt = tp_.tables()
    cfg = Word2VecConfig(**_route_kw(route, model=model, scatter_mean=True))
    # the step on an all-PAD batch: no value moves, no pair counts
    params = _route_params(route, torch.float32)
    before = {k: v.clone() for k, v in params.items()}
    dead = torch.full((tp_.B, tp_.L), -1, dtype=torch.int32)
    m = BandStep(cfg, tt)(params, dead, torch.Generator().manual_seed(2), 0.03)
    for k in params:
        assert torch.equal(params[k], before[k]), k
    assert float(m["pairs"]) == 0.0 and float(m["loss_sum"]) == 0.0
    # a padded chunk: bitwise its real step, the -0.0 cells included
    runner = make_chunk_runner(cfg, tt)
    chunk = _route_params(route, torch.float32)
    tm = runner(chunk, _chunk_tokens(1), 4, 0, np.float32([0.03, 0.03, 0.03]),
                steps=1)
    one = _route_params(route, torch.float32)
    make_chunk_runner(cfg, tt)(one, _chunk_tokens(1)[:1], 4, 0, np.float32([0.03]))
    tp_.assert_params_bitwise(chunk, one)
    assert float(tm["pairs"][0]) > 0 and float(tm["pairs"][1:].sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_alpha_tensor_matches_alpha_float(route, dtype):
    _, tt = tp_.tables()
    cfg = Word2VecConfig(**_route_kw(route, dtype=dtype, model="cbow",
                                     stochastic_rounding=dtype == "bfloat16",
                                     scatter_mean=True))
    step = BandStep(cfg, tt)
    toks = torch.from_numpy(tp_.tokens())
    draws = step.draw(torch.Generator().manual_seed(5), toks)
    alpha = float(np.float32(0.0271))
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    a, b = _route_params(route, td), _route_params(route, td)
    ma = step.apply(a, toks, draws, alpha)
    mb = step.apply(b, toks, draws, torch.tensor(alpha, dtype=torch.float32))
    tp_.assert_params_bitwise(a, b)
    for k in METRICS:
        assert torch.equal(ma[k], mb[k]), k
