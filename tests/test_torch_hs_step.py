"""The port's positional hierarchical-softmax step (ops/hs_step.HsStep)
against the JAX package's make_hs_train_step (CPU).

Both packages build their Huffman tables from the same vocabulary counts
(torch_parity.hs_vocabs) and run two steps from the same JAX-initialized
params on the same tokens, the JAX step's draws fed to the port
(torch_parity.any_draws). Tolerances:
  * f32 tables, f32 compute: params within atol 1e-6
    (torch_parity.assert_params_close; the contractions sum in another
    order than XLA's dots, the scatters add in the same order);
  * bf16 tables: bitwise for sg, torch_parity.assert_bf16_tables_close for
    cbow, with the reference's SR grid (torch_parity.jax_grid_cast,
    ROADMAP C1);
  * pairs, clip_engaged and hs_tail_dropped exact; loss_sum within rtol
    1e-5 (torch_parity.assert_metrics_close).
Cases: one and two tiers x sg and cbow, the band chunked and dense,
scatter_mean and the row clip, cbow's slab_scatter branch, bf16 tables
+- SR with bf16 and f32 compute, and a forced tail overflow (a small
hs_tail_slots) that drops updates. resolve_tail_slots equals the JAX
function on every bound it can take.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.ops.hs_step import resolve_tail_slots as j_slots  # noqa: E402
from word2vec_tpu.ops.tables import DeviceTables as JTables  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.ops import hs_step as ths  # noqa: E402
from word2vec_tpu_torch.ops import train_step as tts  # noqa: E402
from word2vec_tpu_torch.ops.hs_step import HsStep, resolve_tail_slots  # noqa: E402
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables  # noqa: E402

torch.set_num_threads(1)

CASES = {
    "sg-1tier": dict(),
    "cbow-1tier": dict(model="cbow"),
    "sg-2tier": dict(hs_dense_top=8),
    "cbow-2tier": dict(model="cbow", hs_dense_top=8),
    "sg-2tier-chunked-mean-clip": dict(hs_dense_top=8, band_chunk=8,
                                       scatter_mean=True, clip_row_update=0.05),
    "sg-1tier-mean-clip": dict(scatter_mean=True, clip_row_update=0.05),
    "cbow-slab_scatter-mean-clip": dict(model="cbow", band_chunk=8, slab_scatter=True,
                                        scatter_mean=True, clip_row_update=0.05),
    "cbow-2tier-sum-window1": dict(model="cbow", hs_dense_top=8, cbow_mean=False,
                                   window=1),
    "sg-2tier-overflow": dict(hs_dense_top=8, hs_tail_slots=5),
    "cbow-2tier-overflow-mean": dict(model="cbow", hs_dense_top=8, hs_tail_slots=3,
                                     scatter_mean=True),
    "sg-bf16": dict(dtype="bfloat16", compute_dtype="bfloat16"),
    "sg-2tier-bf16-sr": dict(dtype="bfloat16", hs_dense_top=8,
                             stochastic_rounding=True),
    "cbow-2tier-bf16-sr": dict(dtype="bfloat16", model="cbow", hs_dense_top=8,
                               stochastic_rounding=True, compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hs_step_matches_jax(case, monkeypatch):
    monkeypatch.setattr(tts, "_cast_update", tp_.jax_grid_cast)
    monkeypatch.setattr(ths, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.hs_kw(**CASES[case])
    jp, jm, tp, tm = tp_.hs_run(kw)
    tp_.assert_params_close(tp, jp, kw)
    tp_.assert_metrics_close(tm, jm)
    assert float(tm["hs_tail_dropped"]) == float(jm["hs_tail_dropped"])
    if case.endswith("overflow") or case.endswith("overflow-mean"):
        assert float(jm["hs_tail_dropped"]) > 0
    assert float(tm["nonfinite_loss"]) == 0.0


@pytest.mark.parametrize("over,L", [
    (dict(hs_dense_top=8), tp_.HL),               # auto: mean + 6 sigma + Ct
    (dict(hs_dense_top=8), 2),                     # auto, tiny L
    (dict(hs_dense_top=8, hs_tail_slots=0), tp_.HL),
    (dict(hs_dense_top=8, hs_tail_slots=5), tp_.HL),
    (dict(hs_dense_top=8, hs_tail_slots=10_000), tp_.HL),
    (dict(hs_dense_top=40, model="cbow"), tp_.HL),
])
def test_resolve_tail_slots_matches_jax(over, L):
    kw = tp_.hs_kw(**over)
    jv, tv = tp_.hs_vocabs()
    jt = JTables.build(jv, JConfig(**kw))
    tt = TTables.build(tv, Word2VecConfig(**kw), torch.device("cpu"))
    Ct = tt.hs_tail_codes.shape[1]
    for slots in (0, Ct, L * Ct, (L + 6) * Ct):
        assert resolve_tail_slots(Word2VecConfig(**kw), tt, L, slots) == j_slots(
            JConfig(**kw), jt, L, slots)


def test_hs_tables_match_jax():
    kw = tp_.hs_kw(hs_dense_top=8)
    jv, tv = tp_.hs_vocabs()
    jt = JTables.build(jv, JConfig(**kw))
    tt = TTables.build(tv, Word2VecConfig(**kw), torch.device("cpu"))
    for name in ("keep_probs", "hs_codes", "hs_points", "hs_len", "hs_msig",
                 "hs_tail_codes", "hs_tail_points", "hs_tail_len"):
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("hs_tail_mean", "hs_tail_var", "hs_dense_coverage"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.alias_accept is None and jt.alias_accept is None


def test_pad_batch_is_a_noop_and_refusals():
    """An all-PAD batch moves no value and counts no pair (two tiers,
    scatter_mean); the step refuses ns configs and the unified slab."""
    kw = tp_.hs_kw(hs_dense_top=8, scatter_mean=True, model="cbow")
    _, tv = tp_.hs_vocabs()
    cfg = Word2VecConfig(**kw)
    step = HsStep(cfg, TTables.build(tv, cfg, torch.device("cpu")))
    g = torch.Generator().manual_seed(3)
    params = {"emb_in": torch.randn(tp_.HV, tp_.HD, generator=g),
              "emb_out_hs": torch.randn(tp_.HV - 1, tp_.HD, generator=g)}
    before = {k: v.clone() for k, v in params.items()}
    dead = torch.full((tp_.HB, tp_.HL), -1, dtype=torch.int32)
    m = step(params, dead, torch.Generator().manual_seed(2), 0.03)
    tp_.assert_params_bitwise(params, before)
    assert float(m["pairs"]) == 0.0 and float(m["loss_sum"]) == 0.0
    with pytest.raises(ValueError, match="hierarchical softmax only"):
        HsStep(Word2VecConfig(**tp_.kw()), tp_.tables()[1])
