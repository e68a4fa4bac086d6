"""The port's query engine (word2vec_tpu_torch/serve/query.py) and eval/
against the JAX package's, on the same matrix, made from a seed:
identical ids and tie order (duplicated rows make exact ties that straddle
the top-k cut), scores within 1e-6 on an f32 table and 1e-3 on a bf16
table; the score planes within the same tolerances; a batch above
MAX_BATCH_BUCKET; and evaluate_pairs, evaluate_analogies (3CosAdd and
3CosMul) and nearest_neighbors giving the JAX package's results. The port
engine runs on device="cpu" here; chip_smoke.py holds the card engine
against the CPU one."""

import numpy as np
import pytest

from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.eval import analogy as j_analogy
from word2vec_tpu.eval import neighbors as j_neighbors
from word2vec_tpu.eval import similarity as j_similarity
from word2vec_tpu.serve import query as jq

from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.eval import analogy as t_analogy
from word2vec_tpu_torch.eval import neighbors as t_neighbors
from word2vec_tpu_torch.eval import similarity as t_similarity
from word2vec_tpu_torch.eval.__main__ import main as eval_main
from word2vec_tpu_torch.io.embeddings import save_word2vec
from word2vec_tpu_torch.serve import query as tq

V, D = 64, 12
TOL = {"float32": 1e-6, "bfloat16": 1e-3}
DTYPES = list(TOL)


@pytest.fixture(autouse=True)
def _fresh_cache():
    jq.clear_engine_cache()
    tq.clear_engine_cache()
    yield
    jq.clear_engine_cache()
    tq.clear_engine_cache()


@pytest.fixture(scope="module")
def case():
    """[V, D] matrix with two groups of duplicated rows (exact ties: rows
    5..14 are one vector, rows 40..45 another, scaled so the unit rows
    tie bitwise) and both packages' vocabularies."""
    rng = np.random.default_rng(7)
    W = rng.normal(size=(V, D)).astype(np.float32)
    W[5:15] = W[5]
    W[40:46] = W[40] * 2.0
    counts = {f"w{i}": 1000 - i for i in range(V)}
    return W, Vocab.from_counter(counts, 1), JVocab.from_counter(counts, 1)


def _engines(case, dtype, **kw):
    W, tv, jv = case
    return (tq.QueryEngine(W, tv, table_dtype=dtype, device="cpu", **kw),
            jq.QueryEngine(W, jv, table_dtype=dtype, **kw))


def _same_ranked(got, want, tol):
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 8, 20, V])
def test_neighbors_batch_matches_jax(case, dtype, k):
    te, je = _engines(case, dtype)
    words = ["w0", "w5", "w9", "w14", "w40", "w33", "w63"]
    for got, want in zip(te.neighbors_batch(words, k=k),
                         je.neighbors_batch(words, k=k)):
        _same_ranked(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_straddling_the_cut_take_the_lower_ids(case, dtype):
    te, je = _engines(case, dtype)
    # w6's nearest rows are its nine duplicates; a top-4 cuts the tie group
    got = te.neighbor_id_sets(np.array([6, 41]), k=4)
    want = je.neighbor_id_sets(np.array([6, 41]), k=4)
    np.testing.assert_array_equal(got[0], [5, 7, 8, 9])
    np.testing.assert_array_equal(got[1], [40, 42, 43, 44])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_neighbor_id_sets_and_analogies_match_jax(case, dtype):
    te, je = _engines(case, dtype)
    ids = np.arange(0, V, 3)
    for g, w in zip(te.neighbor_id_sets(ids, k=10), je.neighbor_id_sets(ids, k=10)):
        np.testing.assert_array_equal(g, w)
    triples = [("w1", "w2", "w3"), ("w5", "w40", "w20"), ("w6", "w7", "w8"),
               ("w63", "w0", "w41")]
    for k in (1, 5, 12):
        for got, want in zip(te.analogy_batch(triples, k=k),
                             je.analogy_batch(triples, k=k)):
            _same_ranked(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_planes_and_cosines_match_jax(case, dtype):
    te, je = _engines(case, dtype)
    tol = TOL[dtype]
    pairs = [("w0", "w1"), ("w5", "w6"), ("w2", "w2"), ("w40", "w63")]
    np.testing.assert_allclose(te.similarity_batch(pairs),
                               je.similarity_batch(pairs), rtol=0, atol=tol)
    i, j = np.arange(0, 30), np.arange(30, 60)
    np.testing.assert_allclose(te.pair_cosines(i, j), je.pair_cosines(i, j),
                               rtol=0, atol=tol)
    a, b, c = np.arange(0, 9), np.arange(9, 18), np.arange(18, 27)
    tp = te.analogy_planes(a, b, c)
    assert tp.shape == (9, V) and tp.dtype == np.float32 and tp.flags.writeable
    np.testing.assert_allclose(tp, je.analogy_planes(a, b, c), rtol=0, atol=tol)
    np.testing.assert_allclose(te.cosine_planes(a), je.cosine_planes(a),
                               rtol=0, atol=tol)


def _in_near_tie(scores, i, tol=1e-6):
    """Position i of a ranked score list sits in a run of scores closer
    than `tol`: candidates f32 arithmetic cannot order reliably."""
    return any(abs(scores[i] - scores[j]) < tol
               for j in (i - 1, i + 1) if 0 <= j < len(scores))


def test_batch_above_the_bucket_cap_is_split(case):
    """1,061 random analogy rows, split at MAX_BATCH_BUCKET. Ids are
    identical except inside a near-tie of the JAX engine's own f32 scores
    (closer than 1e-6, e.g. 0.6281362 vs 0.62813616 against the tie group
    of rows 5..14): the port's f64-accumulated scores order such
    candidates by their exact values, the JAX engine by its rounding."""
    te, je = _engines(case, "float32")
    rng = np.random.default_rng(3)
    B = te.MAX_BATCH_BUCKET + 37
    ids = rng.integers(0, V, size=(B, 3)).astype(np.int32)
    w = np.tile(np.float32([[-1.0, 1.0, 1.0]]), (B, 1))
    got, want = te.batch_topk(ids, w, 5), je.batch_topk(ids, w, 5)
    assert len(got) == len(want) == B
    swapped = 0
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
        diff = np.flatnonzero(gt != wt)
        assert all(_in_near_tie(wv, i) for i in diff), (gt, gv, wt, wv)
        swapped += bool(len(diff))
    assert swapped <= 2


def test_a_nan_row_matches_jax(case):
    """A diverged row (NaN) scores NaN against every query: both engines
    leave it out of every answer (the host filter keeps finite scores),
    and the query of that word itself comes back empty."""
    W, tv, jv = case
    W = W.copy()
    W[20] = np.nan
    te = tq.QueryEngine(W, tv, device="cpu")
    je = jq.QueryEngine(W, jv)
    for word in ("w0", "w6", "w20"):
        _same_ranked(te.neighbors_batch([word], k=5)[0],
                     je.neighbors_batch([word], k=5)[0], 1e-6)
    assert te.neighbors_batch(["w20"], k=5)[0] == []


def test_restrict_swap_and_the_engine_cache(case):
    W, tv, _ = case
    te = tq.QueryEngine(W, tv, restrict=20, device="cpu")
    assert te.V == 20
    with pytest.raises(KeyError, match="'w30' not in vocabulary"):
        te.neighbors_batch(["w30"])
    assert te.swap_table(W) == 1 and te.V == V
    with pytest.raises(ValueError, match="SHRINK"):
        te.swap_table(W[:10])
    e1 = tq.get_engine(W, tv, device="cpu")
    assert tq.get_engine(W, tv, device="cpu") is e1
    assert tq.get_engine(W.copy(), tv, device="cpu") is not e1
    with pytest.raises(ValueError, match="table_dtype"):
        tq.QueryEngine(W, tv, table_dtype="int8", device="cpu")


# ------------------------------------------------------------------- eval
def _questions(tmp_path):
    p = tmp_path / "q.txt"
    p.write_text(
        ": one\nw1 w2 w3 w4\nw5 w40 w20 w21\nw6 w7 w8 w9\n"
        ": two\nw63 w0 w41 w42\nw1 w2 w3 zzz\nw10 w11 w12 w10\n"
    )
    return str(p)


@pytest.mark.parametrize("method", ["3cosadd", "3cosmul"])
def test_evaluate_analogies_matches_jax(case, tmp_path, method):
    W, tv, jv = case
    path = _questions(tmp_path)
    got = t_analogy.evaluate_analogies(W, tv, path, method=method, device="cpu")
    want = j_analogy.evaluate_analogies(W, jv, path, method=method)
    assert (got.correct, got.total, got.skipped_oov, got.skipped_degenerate) == (
        want.correct, want.total, want.skipped_oov, want.skipped_degenerate)
    assert got.by_section == want.by_section
    assert got.accuracy == want.accuracy
    assert got.mean_gold_rank == pytest.approx(want.mean_gold_rank, abs=1e-9)


def test_evaluate_pairs_and_neighbors_match_jax(case, tmp_path):
    W, tv, jv = case
    rng = np.random.default_rng(4)
    pairs = [(f"w{a}", f"w{b}", float(s)) for a, b, s in zip(
        rng.integers(0, V, 25), rng.integers(0, V, 25), rng.uniform(0, 10, 25))]
    pairs.append(("w1", "nope", 3.0))
    got = t_similarity.evaluate_pairs(W, tv, pairs, device="cpu")
    want = j_similarity.evaluate_pairs(W, jv, pairs)
    assert (got.pairs_used, got.pairs_total) == (want.pairs_used, want.pairs_total)
    assert got.spearman == pytest.approx(want.spearman, abs=1e-12)
    assert got.pearson == pytest.approx(want.pearson, abs=1e-6)
    for word in ("w0", "w6", "w41"):
        _same_ranked(t_neighbors.nearest_neighbors(W, tv, word, k=7, device="cpu"),
                     j_neighbors.nearest_neighbors(W, jv, word, k=7), 1e-6)
    _same_ranked(t_neighbors.analogy_query(W, tv, "w1", "w2", "w3", device="cpu"),
                 j_neighbors.analogy_query(W, jv, "w1", "w2", "w3"), 1e-6)


def test_eval_cli(case, tmp_path, capsys):
    W, tv, _ = case
    vec = str(tmp_path / "v.bin")
    save_word2vec(vec, tv, W, binary=True)
    assert eval_main(["--backend", "cpu", "--binary", "neighbors", vec,
                      "w6", "-k", "3"]) == 0
    out = capsys.readouterr().out.split()
    assert out[0::2] == ["w5", "w7", "w8"]
    assert eval_main(["--backend", "cpu", "--binary", "analogies", vec,
                      _questions(tmp_path)]) == 0
    res = capsys.readouterr().out
    assert "\"total\": 4" in res and "\"skipped_degenerate\": 1" in res
    assert eval_main(["--backend", "cpu", "--binary", "neighbors", vec,
                      "zzz"]) == 1
