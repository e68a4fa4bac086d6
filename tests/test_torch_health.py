"""The port's health counters (obs/health.instrument_step, config.
health_metrics) against the JAX package's instrument_step (CPU).

Pins, on the same JAX-initialized params, tokens and JAX-made draws
(tests/torch_parity.py):
  * one and three steps of every band ns route (xla split and unified,
    pallas_oa, pallas, pallas_fused), the positional hs step and the pair
    step, f32 and bf16 tables: the same metrics keys; nonfinite_params and
    alpha_sum exact; grad_sq and every update_sq_<table> within 1e-5
    relative;
  * the counters see a non-finite cell left by an EARLIER step: the
    whole table is counted at every step, as in JAX;
  * within the port, BITWISE: the health rows of a chunked dispatch (the
    streaming runner, unfused and on the fused [V, 2, d] slab) equal the
    per-step runner's;
  * with health_metrics off the step is the router's own object and the
    graph's rows are ops/graphs.METRICS exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.obs.health import instrument_step as j_instrument  # noqa: E402
from word2vec_tpu.ops.band_step import make_band_train_step as j_band  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.obs.health import (  # noqa: E402
    HealthStep, health_names, instrument_step,
)
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.graphs import METRICS, StepGraph  # noqa: E402
from word2vec_tpu_torch.ops.steps import make_step  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner  # noqa: E402

torch.set_num_threads(1)

BAND = {
    "xla-split": dict(),
    "xla-unified": dict(table_layout="unified"),
    "pallas_oa": dict(band_backend="pallas_oa"),
    "pallas": dict(band_backend="pallas"),
    "pallas_fused": dict(band_backend="pallas_fused", table_layout="unified"),
}
STEPS = {"hs": dict(), "pair-ns": dict(kernel="pair", train_method="ns",
                                       negative=3)}
DTYPES = ["float32", "bfloat16"]
HEALTH = ("alpha_sum", "grad_sq", "nonfinite_params")

_JAX = {}


def _jax_band(kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        jcfg = JConfig(**kw)
        jt, tt = tp_.tables()
        base = j_band(jcfg, jt, fused=jcfg.table_layout == "unified")
        _JAX[key] = (jcfg, jt, tt, jax.jit(j_instrument(base, jcfg)))
    return _JAX[key]


def _assert_health_close(tm, jm):
    jkeys = {k for k in jm if k in HEALTH or k.startswith("update_sq_")}
    tkeys = {k for k in tm if k in HEALTH or k.startswith("update_sq_")}
    assert tkeys == jkeys and "update_sq_emb_in" in tkeys
    assert float(tm["nonfinite_params"]) == float(jm["nonfinite_params"])
    assert float(tm["alpha_sum"]) == float(jm["alpha_sum"])
    assert float(jm["grad_sq"]) > 0.0  # a table moved
    for k in sorted(jkeys - {"nonfinite_params", "alpha_sum"}):
        # a table that did not move (emb_in at step 1: the ns output table
        # starts at zero) must read exactly 0 in both packages
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=0, err_msg=k)


def _band_run(kw, steps, poison=False):
    jcfg, jt, tt, jfn = _jax_band(kw)
    tcfg = Word2VecConfig(**kw)
    jp = j_init(jcfg, tp_.V, jax.random.key(1))
    tparams = tp_.torch_params(jp, tcfg)
    toks = tp_.tokens()
    step = instrument_step(BandStep(tcfg, tt), tcfg)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.03 - 0.002 * i
        jp, jm = jfn(jp, jnp.asarray(toks), key, jnp.float32(alpha))
        tm = step.apply(tparams, torch.from_numpy(toks),
                        tp_.jax_draws(step, key, jt), alpha)
        if poison and i == 0:
            # a cell of a row no later step touches goes non-finite
            jp = {k: v.at[(tp_.V - 1,) + (0,) * (v.ndim - 1)].set(jnp.inf)
                  for k, v in jp.items()}
            for v in tparams.values():
                v[(tp_.V - 1,) + (0,) * (v.ndim - 1)] = float("inf")
    return jm, tm


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", list(BAND))
def test_band_health_matches_jax(route, dtype, steps):
    kw = tp_.kw(health_metrics=True, dtype=dtype, **BAND[route])
    jm, tm = _band_run(kw, steps)
    _assert_health_close(tm, jm)
    assert float(tm["nonfinite_params"]) == 0.0
    tp_.assert_metrics_close(tm, jm)


def _hs_run(kw, steps):
    """tests/torch_parity.hs_run with both steps instrumented: the JAX
    hs / pair step under its instrument_step (as make_train_step applies
    it), the port's router step (which instruments itself under
    health_metrics)."""
    from word2vec_tpu.ops.hs_step import make_hs_train_step
    from word2vec_tpu.ops.tables import DeviceTables as JTables
    from word2vec_tpu.ops.train_step import make_pair_train_step
    from word2vec_tpu_torch.ops.tables import DeviceTables as TTables

    key_ = ("health",) + tuple(sorted(kw.items()))
    if key_ not in _JAX:
        jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
        jv, tv = tp_.hs_vocabs()
        jt = JTables.build(jv, jcfg)
        tt = TTables.build(tv, tcfg, torch.device("cpu"))
        make = (make_pair_train_step if jcfg.resolved_kernel == "pair"
                else make_hs_train_step)
        _JAX[key_] = (jcfg, tcfg, jt, tt,
                      jax.jit(j_instrument(make(jcfg, jt), jcfg)))
    jcfg, tcfg, jt, tt, jfn = _JAX[key_]
    jp = j_init(jcfg, tp_.HV, jax.random.key(1))
    if "emb_out_hs" in jp:
        jp["emb_out_hs"] = (0.1 * jax.random.normal(
            jax.random.key(3), jp["emb_out_hs"].shape)).astype(jp["emb_out_hs"].dtype)
    tparams = tp_.torch_params(jp, tcfg)
    toks = tp_.hs_tokens()
    step = make_step(tcfg, tt)
    assert isinstance(step, HealthStep)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.05 - 0.01 * i
        jp, jm = jfn(jp, jnp.asarray(toks), key, jnp.float32(alpha))
        tm = step.apply(tparams, torch.from_numpy(toks),
                        tp_.any_draws(step.base, key, jt, *toks.shape), alpha)
    return jm, tm


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", list(STEPS))
def test_hs_and_pair_health_match_jax(route, dtype, steps):
    kw = tp_.hs_kw(health_metrics=True, dtype=dtype, **STEPS[route])
    jm, tm = _hs_run(kw, steps)
    _assert_health_close(tm, jm)


def test_nonfinite_cell_of_an_earlier_step_still_counts():
    kw = tp_.kw(health_metrics=True)
    jm, tm = _band_run(kw, 2, poison=True)
    # the poisoned cells, and what step 2 spread them to
    assert float(jm["nonfinite_params"]) >= 2.0
    assert float(tm["nonfinite_params"]) == float(jm["nonfinite_params"])
    for k in jm:
        if k.startswith("update_sq_") or k == "grad_sq":
            assert np.isfinite(float(tm[k])) == np.isfinite(float(jm[k])), k


def _runner_rows(cfg, tt, params, toks, alphas, S):
    """The metrics rows of len(alphas) steps dispatched S at a time."""
    runner = make_chunk_runner(cfg, tt, graphed=False,
                               fused=cfg.fused_tables and S > 1)
    rows = []
    for c in range(0, len(alphas), S):
        m = runner(params, torch.from_numpy(toks[c:c + S]), 5, 10 + c,
                   alphas[c:c + S])
        rows.append(torch.stack([m[k] for k in m]).clone())
        names = tuple(m)
    return names, torch.cat(rows, dim=1)


@pytest.mark.parametrize("fused", [False, True])
def test_chunked_health_rows_equal_per_step_bitwise(fused):
    kw = tp_.kw(health_metrics=True, micro_steps=2, fused_tables=fused)
    cfg = Word2VecConfig(**kw)
    jcfg = JConfig(**kw)
    _, tt = tp_.tables()
    base = tp_.tokens()
    toks = np.stack([np.roll(base, i, axis=0) for i in range(6)])
    alphas = np.float32([0.03, 0.029, 0.028, 0.027, 0.026, 0.025])
    start = tp_.torch_params(j_init(jcfg, tp_.V, jax.random.key(1)), cfg)
    a = {k: v.clone() for k, v in start.items()}
    b = {k: v.clone() for k, v in start.items()}
    names1, one = _runner_rows(cfg, tt, a, toks, alphas, 1)
    names3, three = _runner_rows(cfg, tt, b, toks, alphas, 3)
    assert names1 == names3 and set(health_names(a)) <= set(names1)
    assert torch.equal(one.view(torch.int32), three.view(torch.int32))
    tp_.assert_params_bitwise(a, b)
    assert float(one[names1.index("grad_sq")].min()) > 0.0


def test_health_off_keeps_the_step_and_its_rows():
    _, tt = tp_.tables()
    off = Word2VecConfig(**tp_.kw())
    on = Word2VecConfig(**tp_.kw(health_metrics=True))
    assert isinstance(make_step(off, tt), BandStep)
    assert isinstance(make_step(on, tt), HealthStep)
    params = tp_.torch_params(j_init(JConfig(**tp_.kw()), tp_.V,
                                     jax.random.key(1)), off)
    g = StepGraph(make_step(off, tt), params, lambda s: None, 2, graphed=False)
    assert g.names == METRICS and g.out.shape == (len(METRICS), 2)
    g = StepGraph(make_step(on, tt), params, lambda s: None, 2, graphed=False)
    assert g.names == METRICS + health_names(params)
    assert health_names(params) == HEALTH + ("update_sq_emb_in",
                                             "update_sq_emb_out_ns")
