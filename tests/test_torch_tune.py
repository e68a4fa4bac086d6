"""The port's planner (word2vec_tpu_torch/tune/) against the JAX package's
(word2vec_tpu/tune/), on the CPU.

Exact: plan keys, fingerprints, kernel routes, candidate grids (the port's
"gpu" grid against JAX's "tpu" grid, with no departure; CPU against CPU),
predict() on the CPU with the JAX module's anchors patched into the port
module, cost_calibrate / apply_calibration / attribution_rows on one
estimate and summary (perturbed anchors included), and cache files
written by either package and read by the other. Port-only: probe then
cached returns the same plan; a cached miss probes and persists; a
Trainer on a cached or a probed plan trains BITWISE equal to a Trainer
built on config.apply_plan(plan); plan_shapes / plan_constraints as
JAX's; a streaming config keys with "+stream"; no TPU row or seed.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu.config import TunePlan as JPlan  # noqa: E402
from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.tune import cache as jcache  # noqa: E402
from word2vec_tpu.tune import cost_model as jcm  # noqa: E402
from word2vec_tpu.tune import planner as jplanner  # noqa: E402

from word2vec_tpu_torch import PackedCorpus, Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.ops.launch import core_smem_bytes  # noqa: E402
from word2vec_tpu_torch.tune import cache as tcache  # noqa: E402
from word2vec_tpu_torch.tune import cost_model as tcm  # noqa: E402
from word2vec_tpu_torch.tune import planner as tplanner  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

torch.set_num_threads(1)

FLAGSHIP = dict(model="sg", train_method="ns", negative=5, word_dim=300,
                window=5, batch_rows=256, max_sentence_len=192,
                shared_negatives=64, min_count=5)
CONFIGS = {
    "flagship-ns": dict(FLAGSHIP),
    "flagship-ns-unified-fused": dict(FLAGSHIP, band_backend="pallas_fused",
                                      table_layout="unified"),
    "flagship-ns-batch-bf16": dict(FLAGSHIP, negative_scope="batch",
                                   shared_negatives=256, dtype="bfloat16",
                                   stochastic_rounding=True),
    "flagship-hs": dict(FLAGSHIP, train_method="hs", negative=0),
    "flagship-pair": dict(FLAGSHIP, kernel="pair"),
    "tiny": dict(model="sg", train_method="ns", negative=3, word_dim=16,
                 window=2, batch_rows=8, max_sentence_len=32, min_count=1,
                 chunk_steps=0),
}
VOCAB = 71000
ANCHOR_NAMES = ("LAYOUT_COPY_INEFFICIENCY", "SCATTER_SEC_PER_ROW",
                "PROGRAM_GAP_MS", "DMA_SEC_PER_ROW")


def both(case, **over):
    kw = dict(CONFIGS[case], **over)
    return JConfig(**kw), Word2VecConfig(**kw)


def _plans(grid):
    return [p.to_json() for p in grid]


@pytest.fixture
def jax_anchors(monkeypatch):
    """The port module with the JAX module's four anchors, read at run time."""
    for name in ANCHOR_NAMES:
        monkeypatch.setattr(tcm, name, getattr(jcm, name))


# ------------------------------------------------------ keys and grids
@pytest.mark.parametrize("case", list(CONFIGS))
def test_fingerprint_and_route_equal_jax(case):
    j, t = both(case)
    assert tplanner.config_fingerprint(t) == jplanner.config_fingerprint(j)
    assert tplanner.kernel_route(t) == jplanner.kernel_route(j)


@pytest.mark.parametrize("args", [
    ("NVIDIA H100 80GB HBM3", "gpu", "band-ns", 71290, 300, "unified", 64,
     "pallas_fused"),
    ("cpu", "cpu", "band-hs", 60, 16, "split", 64, "xla"),
    ("", "cpu", "pair", 99, 8, "split", 8, "xla"),
    ("NVIDIA H100 80GB HBM3", "gpu", "band-ns", 1_234_567, 200, "split", 16,
     "pallas_oa"),
])
def test_plan_key_equal_jax(args):
    assert tcache.plan_key(*args) == jcache.plan_key(*args)
    assert tcache.SCHEMA == jcache.SCHEMA


@pytest.mark.parametrize("case", ["flagship-ns", "flagship-ns-unified-fused",
                                  "flagship-ns-batch-bf16", "flagship-hs",
                                  "flagship-pair", "tiny"])
@pytest.mark.parametrize("platforms", [("gpu", "tpu"), ("cpu", "cpu")])
def test_candidate_grid_equal_jax(case, platforms):
    j, t = both(case)
    vocab = 60 if case == "tiny" else VOCAB
    ours = _plans(tplanner.candidate_grid(t, vocab, {"platform": platforms[0]}))
    theirs = _plans(jplanner.candidate_grid(j, vocab, {"platform": platforms[1]}))
    assert ours == theirs


def test_card_grid_record_equals_jax():
    """chip_smoke.py phase 12 (a) holds the card's flagship grid to
    JAX_FLAGSHIP_GRID: the size of the JAX package's TPU grid of the same
    config and its KP-256 batch-scope pallas plans, the card's grid equal
    to it plan by plan, and PROBE_WIDE's plan among them."""
    import chip_smoke as cs

    cfg = cs.flagship_cfg("xla", "split")
    names = {f.name for f in dataclasses.fields(JConfig)}
    jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})
    theirs = jplanner.candidate_grid(jcfg, cs.V, {"platform": "tpu"})
    ours = tplanner.candidate_grid(cfg, cs.V, {"platform": "gpu"})
    assert _plans(ours) == _plans(theirs)
    backend, layout, rows, chunk, kp, scope = cs.PROBE_WIDE
    wide = [p for p in theirs if p.band_backend == backend
            and p.negative_scope == scope and p.shared_negatives == kp]
    assert (len(theirs), len(wide)) == cs.JAX_FLAGSHIP_GRID
    assert cs.grid_cfg(*cs.PROBE_WIDE).current_plan() in ours


def test_band_core_shared_memory_pins_the_refusal():
    """The band cores' shared memory a block (the host copy of the
    libraries' sizes) pins that no chunk JAX takes is refused: past one
    center piece (CORE_S_PIECE) it no longer grows with S, past one piece
    of the negative pool and of the width with KP or d, and past one slot
    piece (a center piece's S + 2W slots over CORE_K_PIECE) with W; no
    (L <= 2048, W < L/2, S in {auto, 2W, L - 1}) at any KP and d up to 1024
    exceeds a block, for both kernels and both compute types; and no
    band-core plan of the card's grid at L 348 and L 1000 (the flagship, d
    200, and W 100) exceeds a block."""
    from word2vec_tpu_torch.ops.banded import resolve_chunk
    from word2vec_tpu_torch.ops.launch import (
        CORE_D_PIECE, CORE_K_PIECE, CORE_KP_PIECE, CORE_S_PIECE, SMEM_PER_BLOCK,
        core_pieced)

    # the flagship tile budgets the two kernels' source notes document, a
    # chunk past one center piece, and the pieced tensor-core body's room
    assert core_smem_bytes("fused_grad_core", 118, 128, 64, 300, 5, True) == 177_448
    assert core_smem_bytes("band_core", 118, 128, 64, 300, 5, True) == 177_408
    for kernel in ("fused_grad_core", "band_core"):
        assert core_smem_bytes(kernel, 500, 510, 64, 300, 5, True) == 225_152
        assert core_smem_bytes(kernel, 998, 1996, 1024, 1024, 499, True) == 225_152
    kernels = ("fused_grad_core", "band_core")
    # past one slot piece the size stops growing with W
    for kernel in kernels:
        for bf16 in (True, False):
            for S in (1, 64, 118, CORE_S_PIECE, 500):
                first = next(W for W in range(1, 2048)
                             if min(S, CORE_S_PIECE) + 2 * W > CORE_K_PIECE)
                assert core_pieced(S, first)
                piece = core_smem_bytes(kernel, S, S + 2 * first, CORE_KP_PIECE,
                                        CORE_D_PIECE, first, bf16)
                for W in range(first, 1100):
                    assert core_smem_bytes(kernel, S, S + 2 * W, CORE_KP_PIECE,
                                           CORE_D_PIECE, W, bf16) == piece
    # every chunk JAX takes at L <= 2048: the distinct (S, W) sizes (past one
    # slot piece W no longer enters), each at the pool and width sizes that
    # cross a piece, and at every d up to 1024 for the widest chunks
    keys = set()
    for L in range(2, 2049):
        for W in range(1, (L + 1) // 2):
            for S in {resolve_chunk(L, W, 0), 2 * W, L - 1}:
                if 2 * W <= S < L:
                    Sc = min(S, CORE_S_PIECE)
                    keys.add((Sc, S > CORE_S_PIECE,
                              W if Sc + 2 * W <= CORE_K_PIECE else None))
    assert len(keys) > 1000
    kps = (1, 16, 17, 63, 64, 65, 100, 256, 1024)
    ds = (1, 7, 16, 17, 300, 304, 305, 512, 1000, 1024)
    for Sc, longer, W in keys:
        S = CORE_S_PIECE + 1 if longer else Sc
        W = W if W is not None else max(1, (CORE_K_PIECE - Sc) // 2 + 1)
        for kernel in kernels:
            for bf16 in (True, False):
                for kp in kps:
                    for d in ds:
                        assert core_smem_bytes(kernel, S, S + 2 * W, kp, d, W,
                                               bf16) <= SMEM_PER_BLOCK, (
                            kernel, bf16, S, W, kp, d)
    for kernel in kernels:
        for bf16 in (True, False):
            for S, W in ((118, 5), (CORE_S_PIECE, 1), (1000, 499), (2047, 1023)):
                for d in range(1, 1025):
                    assert core_smem_bytes(kernel, S, S + 2 * W, 1024, d, W,
                                           bf16) <= SMEM_PER_BLOCK
    # the card's grid at the reference's sentence length (L 1000) and at
    # L 348 (its L/2 chunk is 174), at W 100 too: every pallas /
    # pallas_fused plan fits
    kernel_of = {"pallas": "band_core", "pallas_fused": "fused_grad_core"}
    chunks = set()
    for L, d, W in ((348, 300, 5), (1000, 300, 5), (1000, 200, 5), (1000, 300, 100)):
        _, t = both("flagship-ns", max_sentence_len=L, word_dim=d, window=W)
        plans = [p for p in tplanner.candidate_grid(t, VOCAB, {"platform": "gpu"})
                 if p.band_backend in kernel_of]
        assert plans
        for p in plans:
            S = resolve_chunk(L, t.window, p.band_chunk)
            chunks.add((S, W))
            for bf16 in (True, False):
                assert core_smem_bytes(kernel_of[p.band_backend], S, S + 2 * t.window,
                                       p.shared_negatives, d, t.window,
                                       bf16) <= SMEM_PER_BLOCK, (L, d, p)
    assert {(174, 5), (333, 5), (500, 5), (200, 100)} <= chunks


# ------------------------------------------------------- the cost model
PREDICT_CASES = {
    "xla": dict(FLAGSHIP),
    "pallas_oa": dict(FLAGSHIP, band_backend="pallas_oa"),
    "pallas": dict(FLAGSHIP, band_backend="pallas"),
    "pallas_fused": dict(FLAGSHIP, band_backend="pallas_fused",
                         table_layout="unified"),
    "unified-kp16": dict(FLAGSHIP, table_layout="unified", shared_negatives=16),
    "hs": CONFIGS["flagship-hs"],
    "pair": CONFIGS["flagship-pair"],
}


@pytest.mark.parametrize("case", list(PREDICT_CASES))
@pytest.mark.parametrize("chunk_cap", [None, 1, 96])
def test_predict_equal_jax_on_cpu(case, chunk_cap, jax_anchors):
    kw = PREDICT_CASES[case]
    j, t = JConfig(**kw), Word2VecConfig(**kw)
    assert tcm.predict(t, VOCAB, "", "cpu", chunk_cap).to_json() == (
        jcm.predict(j, VOCAB, "", "cpu", chunk_cap).to_json())
    assert tcm.predicted_words_per_sec(t, VOCAB) == (
        jcm.predicted_words_per_sec(j, VOCAB))
    assert tcm.geometry(t, VOCAB) == jcm.geometry(j, VOCAB)


def _summary(ms_dispatch, ms_wait, ms_batch=0.05):
    return {"steps": 36, "spans": {
        "dispatch": {"ms_per_step": ms_dispatch},
        "device_wait": {"ms_per_step": ms_wait},
        "batcher_wait": {"ms_per_step": ms_batch},
    }}


@pytest.mark.parametrize("case", ["pallas_fused", "xla", "unified-kp16"])
@pytest.mark.parametrize("measure", ["none", "exact", "scatter+2x", "half"])
@pytest.mark.parametrize("perturb", [None, 3.0, 1 / 3])
def test_calibration_equal_jax(case, measure, perturb, jax_anchors):
    """cost_calibrate, apply_calibration and attribution_rows on one
    estimate and one trace summary, with JAX's perturbed-anchor
    counterfactuals."""
    est_j = jcm.predict(JConfig(**PREDICT_CASES[case]), VOCAB, "TPU v5 lite", "tpu")
    est_t = tcm.CostEstimate(**dataclasses.asdict(est_j))
    dev = est_j.step_ms + est_j.dispatch_ms
    measured = {"none": None, "exact": dev,
                "scatter+2x": dev + 2 * est_j.scatter_ms, "half": dev / 2}[measure]
    anchors = None if perturb is None else {
        name: getattr(jcm, const) * perturb
        for name, (const, _, _) in jcm.ANCHORS.items()}
    cal_j = jcm.cost_calibrate(est_j, measured, anchors)
    cal_t = tcm.cost_calibrate(est_t, measured, anchors)
    assert cal_t == cal_j
    summary = _summary(dev * 0.25, dev * 0.75 if measured else 0.0)
    rows_j = jcm.attribution_rows(est_j, summary)
    assert tcm.attribution_rows(est_t, summary) == rows_j
    assert tcm.apply_calibration(rows_j, cal_j) == jcm.apply_calibration(rows_j, cal_j)
    assert tcm.measured_device_ms(summary) == jcm.measured_device_ms(summary)
    assert tcm.ANCHORS == jcm.ANCHORS
    assert (tcm.DRIFT_FACTOR, tcm.CALIBRATE_MIN_SHARE) == (
        jcm.DRIFT_FACTOR, jcm.CALIBRATE_MIN_SHARE)


def test_no_tpu_row_or_seed(monkeypatch):
    assert list(tcm.DEVICE_SPECS) == ["NVIDIA H100"]
    assert tcm.DEVICE_SPECS["NVIDIA H100"][:2] == (989e12, 3.35e12)
    assert tcm.device_spec("NVIDIA A100-SXM4-80GB", "gpu") == (
        tcm.DEVICE_SPECS["NVIDIA H100"])
    assert tcm.device_spec("cpu", "cpu") == tcm.CPU_SPEC == jcm.CPU_SPEC
    with open(tcache._SEED_PATH) as f:
        seeds = json.load(f)
    assert seeds["schema"] == tcache.SCHEMA and seeds["grid_notes"]
    text = json.dumps(seeds["plans"])
    assert "TPU" not in text and "tpu" not in text
    # the port's plans do not mix with the JAX package's by default
    monkeypatch.delenv("W2V_PLAN_CACHE", raising=False)
    assert tcache.default_cache_path().endswith(
        "/.cache/word2vec_tpu_torch/plan_cache.json")
    assert tcache.default_cache_path() != jcache.default_cache_path()
    monkeypatch.setenv("W2V_PLAN_CACHE", "/x/plans.json")
    assert tcache.default_cache_path() == jcache.default_cache_path() == "/x/plans.json"


# ------------------------------------------------------------ the cache
ENTRY = {
    "plan": JPlan(batch_rows=128, band_chunk=96, chunk_cap=96, prefetch_depth=1,
                  shared_negatives=16, negative_scope="row",
                  band_backend="pallas_fused", table_layout="unified",
                  table_dtype="float32", stochastic_rounding=False).to_json(),
    "predicted": {"total_ms": 1.5},
    "measured_words_per_sec": 12345.6,
    "device_kind": "NVIDIA H100 80GB HBM3",
    "platform": "gpu",
}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_read_across_packages(tmp_path, writer):
    j, t = both("flagship-ns-unified-fused")
    fp_j, fp_t = jplanner.config_fingerprint(j), tplanner.config_fingerprint(t)
    assert fp_j == fp_t
    key = tcache.plan_key("NVIDIA H100 80GB HBM3", "gpu", "band-ns", VOCAB, 300,
                          "unified", 64, "pallas_fused")
    path = str(tmp_path / "plans.json")
    store, read = (jcache, tcache) if writer == "jax" else (tcache, jcache)
    store.store(key, dict(ENTRY, fingerprint=fp_t), path)
    got = read.lookup(key, fp_j, path)
    assert got is not None and got["plan"] == ENTRY["plan"]
    assert read.lookup(key, dict(fp_j, window=7), path) is None  # invalidation
    assert read.lookup(key + "+stream", fp_j, path) is None


# ------------------------------------------------ probes and the trainer
@pytest.fixture(scope="module")
def tiny_problem():
    cfg = Word2VecConfig(**CONFIGS["tiny"])
    vocab = zipf_vocab(60, 6000)
    corpus = PackedCorpus.pack(zipf_corpus_ids(vocab, 16000, seed=3), 32)
    return cfg, vocab, corpus


def _resolve(cfg, vocab, corpus, mode, cache, **kw):
    kw = dict(dict(max_probes=2, probe_steps=1, probe_dispatches=1), **kw)
    return tplanner.resolve_plan(cfg, vocab, corpus=corpus, mode=mode,
                                 cache_path=cache, device="cpu", **kw)


def test_probe_then_cached_reproduces_the_winner(tmp_path, tiny_problem):
    cfg, vocab, corpus = tiny_problem
    cache = str(tmp_path / "plans.json")
    probed = _resolve(cfg, vocab, corpus, "probe", cache)
    assert probed.source == "probe" and len(probed.probes) == 2
    assert all("error" not in p for p in probed.probes)
    assert all(set(p) >= {"measured_step_ms", "probe_words_per_sec",
                          "score_words_per_sec", "launches",
                          "predicted_total_ms"} for p in probed.probes)
    # the plain versions run on the CPU: no kernel launches
    assert all(not any(p["launches"].values()) for p in probed.probes)
    cached = _resolve(cfg, vocab, corpus, "cached", cache)
    assert cached.source == "cache" and cached.probes == []
    assert cached.plan == probed.plan
    assert json.dumps(cached.plan.to_json()) == json.dumps(probed.plan.to_json())
    assert cached.key == probed.key == "cpu|cpu|band-ns|V60|d16|split|kp64|xla"


def test_cached_miss_probes_and_persists(tmp_path, tiny_problem):
    cfg, vocab, corpus = tiny_problem
    cache = str(tmp_path / "plans.json")
    miss = _resolve(cfg, vocab, corpus, "cached", cache)
    assert miss.source == "probe" and miss.probes
    entry = tcache.lookup(miss.key, tplanner.config_fingerprint(cfg), cache)
    assert entry is not None and entry["plan"] == miss.plan.to_json()
    assert entry["device_kind"] == "cpu" and entry["platform"] == "cpu"


def test_refused_plan_is_an_error_record(tiny_problem):
    cfg, vocab, corpus = tiny_problem
    bad = dataclasses.replace(cfg.current_plan(), band_backend="pallas_fused",
                              table_layout="split")
    rec = tplanner.probe_plan(cfg, bad, vocab, corpus, device="cpu")
    assert rec["error"].startswith("ValueError") and rec["score_words_per_sec"] == 0.0


def test_probe_failure_that_is_not_a_refusal_propagates(tiny_problem, monkeypatch):
    """A kernel that fails to build or launch must fail the search, never
    turn into an error record that another route's probe outscores."""
    from word2vec_tpu_torch.ops import graphs

    cfg, vocab, corpus = tiny_problem

    def broken(self, *a, **k):
        raise RuntimeError("fused_grad_core launch: invalid argument")

    monkeypatch.setattr(graphs.ChunkRunner, "__call__", broken)
    with pytest.raises(RuntimeError, match="launch"):
        tplanner.probe_plan(cfg, cfg.current_plan(), vocab, corpus, device="cpu")


def _train(trainer):
    """The trained params' bits (bf16 tables viewed as int16: the search
    may pick the bf16 + SR candidate)."""
    state, _ = trainer.train(log_every=0)
    return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            .numpy().copy() for k, v in state.params.items()}


def _bitwise(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("mode", ["cached", "probe"])
def test_trainer_on_a_resolved_plan_trains_bitwise_equal(tmp_path, tiny_problem, mode):
    cfg, vocab, corpus = tiny_problem
    cache = str(tmp_path / "plans.json")
    if mode == "cached":
        _resolve(cfg, vocab, corpus, "probe", cache, max_probes=4)
    asked = dataclasses.replace(cfg, autotune=mode, plan_cache=cache)
    tuned = Trainer(asked, vocab, corpus, device="cpu")
    res = tuned.plan_resolution
    assert res.source == ("cache" if mode == "cached" else "probe")
    assert tuned.config == asked.apply_plan(res.plan)
    assert tuned.config.autotune == "off"
    ref = Trainer(asked.apply_plan(res.plan), vocab, corpus, device="cpu")
    assert ref.plan_resolution is None
    assert _bitwise(_train(tuned), _train(ref))


def test_plan_shapes_and_constraints_as_jax(tiny_problem):
    from word2vec_tpu.data.batcher import PackedCorpus as JCorpus
    from word2vec_tpu.train import Trainer as JTrainer
    from word2vec_tpu.utils.synthetic import zipf_corpus_ids as jids
    from word2vec_tpu.utils.synthetic import zipf_vocab as jvocab

    cfg, vocab, corpus = tiny_problem
    jv = jvocab(60, 6000)
    jc = JCorpus.pack(jids(jv, 16000, seed=3), 32)
    for over in ({}, {"chunk_steps": 1}, {"band_chunk": 10, "batch_rows": 16}):
        t = Trainer(dataclasses.replace(cfg, **over), vocab, corpus, device="cpu")
        j = JTrainer(JConfig(**dict(CONFIGS["tiny"], **over)), jv, jc)
        assert t.plan_shapes() == j.plan_shapes()
        assert t.plan_constraints() == j.plan_constraints()


def test_streaming_config_keys_with_stream(tmp_path, tiny_problem):
    cfg, vocab, corpus = tiny_problem
    stream = dataclasses.replace(cfg, corpus_mode="streaming")
    res = _resolve(stream, vocab, corpus, "probe", str(tmp_path / "p.json"))
    assert res.key == "cpu|cpu|band-ns|V60|d16|split|kp64|xla+stream"
    assert tcache.lookup(res.key, tplanner.config_fingerprint(stream),
                         str(tmp_path / "p.json")) is not None
    # the trainer of a streaming run resolves under the same key
    tr = Trainer(dataclasses.replace(stream, autotune="cached",
                                     plan_cache=str(tmp_path / "p.json")),
                 vocab, corpus, device="cpu")
    assert tr.plan_resolution.source == "cache"
    assert tr.plan_resolution.key == res.key
    assert tr.plan_constraints()["corpus_mode"] == "streaming"
