"""Shared harness of the step parity tests (tests/test_torch_*.py): one
config through the JAX package's band step and the port's BandStep on the
same params, tokens and draws.

The JAX side is `make_band_train_step(cfg, tables, fused=unified)`, its
Pallas kernels run through the interpreter on the CPU. Its draws are
reproduced with the same jax.random calls it makes (ops/band_step.py:
257-268 and 612-619, the alias draw of ops/train_step.py:41-49, the SR
streams of _sr_streams) and handed to the port's `BandStep.apply` as
`Draws`, so both packages see the same randomness.

`jax_grid_cast` removes one reference artefact for the bf16+SR cases: XLA's
CPU exp2 is not exact at integer arguments (ROADMAP Queue C1), so the JAX
step's SR grid sits slightly off a power of two while torch.exp2 is exact;
the tests hand the port the reference's grid.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from word2vec_tpu.config import Word2VecConfig as JConfig
from word2vec_tpu.data.negative import build_alias_table
from word2vec_tpu.models.params import init_params as j_init
from word2vec_tpu.ops.band_step import make_band_train_step as j_step
from word2vec_tpu.ops.tables import DeviceTables as JTables
from word2vec_tpu.ops.train_step import _sr_streams

from word2vec_tpu_torch import Word2VecConfig
from word2vec_tpu_torch.models.params import params_from_numpy
from word2vec_tpu_torch.ops.band_step import BandStep, Draws
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables

V, D, B, L = 60, 16, 6, 40


def kw(**over):
    """Step config kwargs at the small test shape (split tables, 'xla')."""
    base = dict(
        model="sg", train_method="ns", negative=3, word_dim=D, window=3,
        min_count=1, compute_dtype="float32", shared_negatives=8,
        max_sentence_len=L, band_chunk=10,
    )
    base.update(over)
    return base


def tables():
    rng = np.random.default_rng(2)
    counts = np.arange(2 * V, V, -1).astype(np.float64)
    at = build_alias_table(counts ** 0.75 / np.sum(counts ** 0.75))
    keep = rng.uniform(0.4, 1.0, size=V).astype(np.float32)  # subsampling on
    j = JTables(jnp.asarray(keep), jnp.asarray(at.accept),
                jnp.asarray(at.alias), None, None, None)
    t = TTables(torch.from_numpy(keep), torch.from_numpy(at.accept),
                torch.from_numpy(at.alias))
    return j, t


def tokens():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, V, size=(B, L)).astype(np.int32)
    toks[2, 30:] = -1
    return toks


def jax_draws(step: BandStep, key, jt) -> Draws:
    """The JAX step's draws for `key`, as the port's Draws."""
    cfg = step.config
    W, KP = cfg.window, cfg.shared_negatives
    k_sub, k_win, k_neg = jax.random.split(key, 3)
    u_sub = jax.random.uniform(k_sub, (B, L))
    w_eff = W - jax.random.randint(k_win, (B, L), 0, W, dtype=jnp.int32)
    shape = (B, KP) if cfg.negative_scope == "row" else (KP,)
    k_bucket, k_coin = jax.random.split(k_neg)
    j = jax.random.randint(k_bucket, shape, 0, V, dtype=jnp.int32)
    u = jax.random.uniform(k_coin, shape)
    negs = jnp.where(u < jt.alias_accept[j], j, jt.alias_idx[j])
    sr = None
    if cfg.stochastic_rounding:
        k_sr = _sr_streams(key, True)
        sr = tuple(
            torch.from_numpy(np.array(jax.random.uniform(k_sr(i), (n, D))))
            for i, n in enumerate(step.sr_rows(B, L))
        )
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Draws(t(u_sub), t(w_eff), t(negs).to(torch.int32), sr)


def jax_grid_cast(vals, dtype, u=None, dest=None):
    """The port's _cast_update with the SR grid ulp(dest) taken from
    jnp.exp2, as the JAX step computes it on the CPU."""
    if u is None or dtype != torch.bfloat16:
        return vals.to(dtype)
    w = jnp.asarray(np.abs(dest.float().numpy()))
    ulp = torch.from_numpy(np.array(
        jnp.exp2(jnp.floor(jnp.log2(jnp.maximum(w, 1e-7))) - 7.0)
    ))
    q = vals.float() / ulp
    qf = torch.floor(q)
    return ((qf + (u < q - qf).float()) * ulp).to(torch.bfloat16)


# compiled JAX steps by config: the three-step cases reuse the one-step
# cases' compilations when the file runs on one worker
_JAX_STEPS = {}


def jax_step(cfg_kw):
    key = tuple(sorted(cfg_kw.items()))
    if key not in _JAX_STEPS:
        jcfg = JConfig(**cfg_kw)
        jt, tt = tables()
        fused = jcfg.table_layout == "unified"
        _JAX_STEPS[key] = (jcfg, jt, tt, jax.jit(j_step(jcfg, jt, fused=fused)))
    return _JAX_STEPS[key]


def torch_params(jp, cfg):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg, "cpu")


def run(cfg_kw, steps):
    """`steps` steps of both packages from the same JAX-initialized params.
    Returns (jax params, jax metrics, port params, port metrics)."""
    jcfg, jt, tt, jfn = jax_step(cfg_kw)
    tcfg = Word2VecConfig(**cfg_kw)
    jp = j_init(jcfg, V, jax.random.key(1))
    tp = torch_params(jp, tcfg)
    start = {k: v.clone() for k, v in tp.items()}
    toks = tokens()
    tfn = BandStep(tcfg, tt)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.03 - 0.002 * i
        jp, jm = jfn(jp, jnp.asarray(toks), key, jnp.float32(alpha))
        tm = tfn.apply(tp, torch.from_numpy(toks), jax_draws(tfn, key, jt), alpha)
    assert any(not torch.equal(tp[k], start[k]) for k in tp)  # tables moved
    return jp, jm, tp, tm


def assert_bf16_tables_close(got, ref, name=""):
    """cbow's bf16 tables: every cell equal, except at most 0.5% of the
    cells (and at least 2 allowed) that may sit one bf16 ulp apart. The
    port's band_sv contraction sums its terms in another order than XLA's
    dot (the last f32 bit of some cbow projections differs), and such a bit
    can flip the bf16 rounding of an update that lands near a rounding
    boundary; with a zero-initialized table the SR grid is 2^-31 and a flip
    is likelier (ROADMAP Queue C3)."""
    diff = got != ref
    n = int(diff.sum())
    assert n <= max(2, int(0.005 * got.size)), (name, n, got.size)
    if n:
        mag = np.maximum(np.abs(got[diff]), np.abs(ref[diff]))
        ulp = np.exp2(np.floor(np.log2(mag)) - 7.0)
        assert np.all(np.abs(got[diff] - ref[diff]) <= ulp), name


def assert_params_close(tp, jp, cfg_kw):
    """f32 tables within atol 1e-6; bf16 tables exact for sg and per
    assert_bf16_tables_close for cbow."""
    assert sorted(tp) == sorted(jp)
    for k in tp:
        got = tp[k].float().numpy()
        ref = np.asarray(jp[k], np.float32)
        if cfg_kw.get("dtype", "float32") == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=k)
        elif cfg_kw.get("model", "sg") == "sg":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            assert_bf16_tables_close(got, ref, k)


def assert_metrics_close(tm, jm):
    np.testing.assert_allclose(float(tm["pairs"]), float(jm["pairs"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    assert float(tm["clip_engaged"]) == float(jm["clip_engaged"])
