"""The port's utils/profiling.py against the JAX package's (CPU): the
analytic step-work counters (step_geometry, step_flops, step_hbm_bytes)
equal, exactly, on the flagship config and the hs / pair / pallas routes;
lap_stats equal on the same laps; StepTimer laps on CPU tensors; the
annotate / trace context managers."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.utils import profiling as jprof  # noqa: E402

from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.utils import profiling as tprof  # noqa: E402

FLAGSHIP = dict(model="sg", train_method="ns", negative=5, word_dim=300,
                window=5, batch_rows=256, max_sentence_len=192,
                shared_negatives=64, min_count=5)
CONFIGS = {
    "flagship-xla": dict(FLAGSHIP),
    "flagship-pallas_fused": dict(FLAGSHIP, band_backend="pallas_fused",
                                  table_layout="unified", band_chunk=64),
    "flagship-pallas": dict(FLAGSHIP, band_backend="pallas", band_chunk=64),
    "flagship-pallas_oa-bf16": dict(FLAGSHIP, band_backend="pallas_oa",
                                    band_chunk=64, dtype="bfloat16"),
    "flagship-slab-batch": dict(FLAGSHIP, slab_scatter=True,
                                negative_scope="batch"),
    "hs-sg": dict(FLAGSHIP, train_method="hs", negative=0),
    "hs-cbow-2tier": dict(FLAGSHIP, train_method="hs", negative=0,
                          model="cbow", hs_dense_top=64),
    "pair-ns": dict(FLAGSHIP, kernel="pair"),
    "pair-hs": dict(FLAGSHIP, kernel="pair", train_method="hs", negative=0),
    "short-rows-dense": dict(FLAGSHIP, max_sentence_len=16),
}
VOCAB = 71000


@pytest.mark.parametrize("case", list(CONFIGS))
def test_step_counters_equal_jax(case):
    kw = CONFIGS[case]
    j, t = JConfig(**kw), Word2VecConfig(**kw)
    assert tprof.step_geometry(t, VOCAB) == jprof.step_geometry(j, VOCAB)
    assert tprof.step_flops(t, VOCAB) == jprof.step_flops(j, VOCAB)
    assert tprof.step_hbm_bytes(t, VOCAB) == jprof.step_hbm_bytes(j, VOCAB)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 10, 101])
def test_lap_stats_equal_jax(n):
    laps = list(np.random.default_rng(n).exponential(0.01, size=n))
    assert tprof.lap_stats(laps) == jprof.lap_stats(laps)


def test_step_timer_and_annotations(tmp_path):
    t = tprof.StepTimer(warmup=1)
    x = torch.zeros(3)
    for _ in range(5):
        t.lap({"out": x + 1})
    st = t.stats()
    assert st["laps"] == 3 and st["min_ms"] >= 0.0
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("w2v_region"):
            (x * 2).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace_profile.json") > 0
