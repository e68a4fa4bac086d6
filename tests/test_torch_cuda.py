"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels of word2vec_tpu_torch/csrc/*.cu have no interpret mode, so
these tests run only where torch.cuda.is_available() (and nvcc) are;
elsewhere they skip with that reason. On the H100 run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py holds the same kernels against the same plain versions at
the flagship shapes.

Tolerances: the slab scatter, the overlap-add and the ordered row sum are
BITWISE (each adds the same terms in the same order as its plain
version), also on the adversarial id sets of tests/run_sets.py; the run
list is exact; the scatter, the row sum and a whole step repeat bitwise
from run to run; fused_grad_core and band_core with f32 compute within
max|err| <= 1e-5 * max|plain| per output (sums in another order, FMA
contraction), n_ctx / ctx_w exact; with bf16 compute (their tensor-core
bodies) at chip_smoke.ODD_SHAPES within chip_smoke.TOL (2e-2: a gradient
weight on a bf16 rounding boundary may round one ulp apart), masks exact,
and two calls bitwise equal.
"""

import numpy as np
import pytest
import torch

from word2vec_tpu_torch.ops import banded
from word2vec_tpu_torch.ops import fused_step as fs
from word2vec_tpu_torch.ops import launch
from word2vec_tpu_torch.ops import band_core as bc
from word2vec_tpu_torch.ops import overlap as ov
from word2vec_tpu_torch.ops import runs as rl
from word2vec_tpu_torch.ops import train_step as ts

from chip_smoke import (
    CORE_NAMES, CORE_ORDER, GRAD_NAMES, GRAD_ORDER, ODD_SHAPES, TOL,
    small_core_inputs, small_grad_inputs,
)
from run_sets import ROW_SUM_SETS, SCATTER_SETS, id_set

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

V, D, B, L, W, S, KP, K = 300, 64, 6, 40, 3, 10, 8, 3
NVR = 2000  # table rows of the adversarial id sets


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grad_inputs(dev, table_dtype):
    rng = np.random.default_rng(11)
    C, _ = banded._geom(L, W, S)
    tokens = torch.from_numpy(rng.integers(0, V, size=(B, L)).astype(np.int32))
    tokens[2, 30:] = -1
    tok = torch.where(tokens >= 0, tokens, 0)
    pad = C * S - L
    keep = torch.from_numpy(rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = torch.from_numpy(rng.integers(1, W + 1, size=(B, L)))
    P = torch.nn.functional.pad
    cpu = dict(
        emb=torch.from_numpy(rng.normal(0, 0.5, size=(V, 2, D)).astype(np.float32)
                             ).to(table_dtype),
        tok_c=P(tok, (0, pad)).reshape(B, C, S),
        tok_k=banded.slab_token_ids(tokens, W, S),
        keep_c=P(keep.float(), (0, pad)).reshape(B, C, S),
        w_c=P(w_eff.float(), (0, pad)).reshape(B, C, S),
        negs=torch.from_numpy(rng.integers(0, V, size=(B, KP)).astype(np.int32)),
    )
    return {k: v.contiguous().to(dev) for k, v in cpu.items()}


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_kernel_matches_plain(cuda, model, table_dtype):
    inp = _grad_inputs(cuda, table_dtype)
    args = [inp[k] for k in ("emb", "tok_c", "tok_k", "keep_c", "w_c", "negs")]
    kw = dict(W=W, K=K, L=L, cdt=torch.float32, is_cbow=model == "cbow")
    before = launch.LAUNCHES["fused_grad_core"]
    got = fs.fused_grad_core(*args, 0.03, **kw)
    ref = fs.fused_grad_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["fused_grad_core"] == before + 1
    for name, g, r in zip(("d_ctr", "d_ctx", "n_ctx", "ctx_w", "d_neg",
                           "w_neg_sum", "losses"), got, ref):
        err = float((g - r).abs().max())
        if name in ("n_ctx", "ctx_w"):
            assert err == 0.0, name
        else:
            assert err <= 1e-5 * float(r.abs().max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_scatter_kernel_bitwise_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    n = 5000
    idx = torch.from_numpy(np.sort(rng.integers(0, 80, size=n)).astype(np.int32))
    idx[:5] = -1
    emb = torch.from_numpy(rng.normal(size=(80, 2, 40)).astype(np.float32)).to(dtype)
    vals = torch.from_numpy(rng.normal(size=(n, 2, 40)).astype(np.float32)).to(dtype)
    pvals = vals[:700, 1].contiguous()
    pidx = torch.sort(idx[:700].abs()).values.contiguous()
    got = fs.fused_slab_scatter(emb.clone().to(cuda), idx.to(cuda), vals.to(cuda))
    got = fs.fused_slab_scatter(got, pidx.to(cuda), pvals.to(cuda), plane=1)
    ref = fs.fused_slab_scatter_plain(emb.clone(), idx, vals)
    ref = fs.fused_slab_scatter_plain(ref, pidx, pvals, plane=1)
    assert torch.equal(got.cpu(), ref)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("name", sorted(set(SCATTER_SETS) | set(ROW_SUM_SETS)))
def test_find_runs_kernel_matches_plain(cuda, name):
    idx = torch.from_numpy(id_set(name, np.random.default_rng(5), nv=NVR, scale=4))
    before = launch.LAUNCHES["find_runs"]
    got = rl.find_runs(idx.to(cuda))
    torch.cuda.synchronize()
    assert launch.LAUNCHES["find_runs"] == before + 1
    n = idx.numel()
    want = rl.find_runs_plain(idx)
    for g, w in zip(rl.unpack_runs(got.cpu(), n), rl.unpack_runs(want, n)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("plane", [None, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", SCATTER_SETS)
def test_slab_scatter_kernel_adversarial_sets(cuda, name, dtype, plane):
    """Flagship width (d = 300: the doubled-width unified call and the
    plane-1 tail), every edge of the work split; bitwise vs plain and
    across two runs."""
    rng = np.random.default_rng(6)
    idx = id_set(name, rng, nv=NVR, scale=4)
    n, d = idx.size, 300
    emb = torch.from_numpy(rng.normal(size=(NVR, 2, d)).astype(np.float32)).to(dtype)
    emb[::3] = -0.0
    shape = (n, 2, d) if plane is None else (n, d)
    v = rng.normal(size=shape).astype(np.float32)
    v.reshape(n, -1)[::5] = 0.0
    vals = torch.from_numpy(v).to(dtype)
    ref = fs.fused_slab_scatter_plain(emb.clone(), torch.from_numpy(idx), vals, plane)
    outs = []
    for _ in range(2):
        got = fs.fused_slab_scatter(emb.clone().to(cuda), torch.from_numpy(idx).to(cuda),
                                    vals.to(cuda), plane)
        torch.cuda.synchronize()
        outs.append(got.cpu())
    assert not torch.equal(ref, emb)
    for got in outs:
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 7), (torch.float32, 6),
                                     (torch.bfloat16, 6), (torch.bfloat16, 7)])
@pytest.mark.parametrize("name", ["long_edges", "trainer"])
def test_slab_scatter_kernel_narrow_vectors(cuda, name, dtype, d):
    """Widths that allow 2- and 1-value vectors only (fs.scatter_vector),
    whole rows and the plane-1 tail; bitwise vs plain."""
    rng = np.random.default_rng(8)
    idx = torch.from_numpy(id_set(name, rng, nv=NVR))
    n = idx.numel()
    emb = torch.from_numpy(rng.normal(size=(NVR, 2, d)).astype(np.float32)).to(dtype)
    vals = torch.from_numpy(rng.normal(size=(n, 2, d)).astype(np.float32)).to(dtype)
    pv = vals[:, 1].contiguous()
    ref = fs.fused_slab_scatter_plain(emb.clone(), idx, vals)
    ref = fs.fused_slab_scatter_plain(ref, idx, pv, plane=1)
    got = fs.fused_slab_scatter(emb.clone().to(cuda), idx.to(cuda), vals.to(cuda))
    got = fs.fused_slab_scatter(got, idx.to(cuda), pv.to(cuda), plane=1)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(ref))


@pytest.mark.parametrize("name", ROW_SUM_SETS)
def test_ordered_row_sum_kernel_adversarial_sets(cuda, name):
    rng = np.random.default_rng(7)
    idx = id_set(name, rng, nv=NVR, scale=4)
    idx = idx[idx >= 0]  # the plain version indexes every id
    vals = (rng.random(idx.size) * 10.0 ** rng.uniform(-4, 4, size=idx.size))
    vals = vals.astype(np.float32)
    vals[::7] = 0.0
    start = torch.from_numpy(rng.normal(size=NVR).astype(np.float32))
    start[::3] = -0.0
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    ref = ts.ordered_row_sum_plain(NVR, t_idx, t_vals, start.clone())
    for _ in range(2):
        got = ts.ordered_row_sum(NVR, t_idx.to(cuda), t_vals.to(cuda),
                                 start.clone().to(cuda), presorted=True)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got.cpu()), _bits(ref))


def test_overlap_kernel_bitwise_matches_plain(cuda):
    rng = np.random.default_rng(2)
    for (b, c, w, s, d) in [(5, 3, 3, 10, 64), (2, 2, 5, 118, 30)]:
        y = torch.from_numpy(
            rng.normal(size=(b, c, s + 2 * w, d)).astype(np.float32)).to(cuda)
        before = launch.LAUNCHES["overlap_add_slabs"]
        got = ov.overlap_add_slabs(y, w, s)
        ref = ov.overlap_add_slabs_plain(y, w, s)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["overlap_add_slabs"] == before + 1
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _core_inputs(dev, scope, table_dtype):
    rng = np.random.default_rng(12)
    C, P = banded._geom(L, W, S)
    tokens = torch.from_numpy(rng.integers(0, V, size=(B, L)).astype(np.int32))
    tokens[2, 30:] = -1
    tok = torch.where(tokens >= 0, tokens, 0).long()
    pad = C * S - L
    keep = torch.from_numpy(rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = torch.from_numpy(rng.integers(1, W + 1, size=(B, L)))
    tab = torch.from_numpy(rng.normal(0, 0.5, size=(2, V, D)).astype(np.float32))
    tab = tab.to(table_dtype)
    nb = B if scope == "row" else 1
    negs = torch.from_numpy(rng.integers(0, V, size=(nb, KP)).astype(np.int32))
    P2 = torch.nn.functional.pad
    cpu = dict(
        a=banded._pad_rows(tab[0][tok], C * S).reshape(B, C, S, D),
        bk=banded._slabs(banded._pad_ctx(tab[1][tok], W, P), C, S, 2 * W),
        en=tab[1][negs.long()],
        tok_c=P2(tokens, (0, pad), value=-1).reshape(B, C, S),
        tok_k=banded.slab_token_ids(tokens, W, S),
        keep_c=P2(keep.float(), (0, pad)).reshape(B, C, S),
        w_c=P2(w_eff.float(), (0, pad)).reshape(B, C, S),
        negs=negs,
    )
    return [cpu[k].contiguous().to(dev) for k in
            ("a", "bk", "en", "tok_c", "tok_k", "keep_c", "w_c", "negs")]


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_band_core_kernel_matches_plain(cuda, model, scope, table_dtype):
    args = _core_inputs(cuda, scope, table_dtype)
    kw = dict(W=W, K=K, cdt=torch.float32, is_cbow=model == "cbow")
    before = launch.LAUNCHES["band_core"]
    got = bc.band_core(*args, 0.03, **kw)
    ref = bc.band_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["band_core"] == before + 1
    for name, g, r in zip(("d_h", "d_ctx", "d_neg", "n_ctx", "ctx_w",
                           "w_neg_sum", "losses"), got, ref):
        assert g.shape == r.shape, name
        err = float((g - r).abs().max())
        if name in ("n_ctx", "ctx_w"):
            assert err == 0.0, name
        else:
            assert err <= 1e-5 * float(r.abs().max()), (name, err)


def test_ordered_row_sum_kernel_bitwise_and_repeatable(cuda):
    rng = np.random.default_rng(4)
    n, nv = 20000, 300
    p = 1.0 / np.arange(1, nv + 1)
    idx = torch.from_numpy(np.sort(rng.choice(nv, size=n, p=p / p.sum()))
                           .astype(np.int32))
    vals = torch.from_numpy(
        (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 4, size=n)).astype(np.float32))
    i2 = torch.from_numpy(rng.integers(0, nv, size=3000).astype(np.int32))
    v2 = torch.from_numpy(rng.normal(size=3000).astype(np.float32))
    ref = ts.ordered_row_sum(nv, i2, v2, ts.ordered_row_sum(nv, idx, vals,
                                                            presorted=True))
    runs = []
    for _ in range(2):
        before = launch.LAUNCHES["ordered_row_sum"]
        got = ts.ordered_row_sum(nv, idx.to(cuda), vals.to(cuda), presorted=True)
        got = ts.ordered_row_sum(nv, i2.to(cuda), v2.to(cuda), got)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["ordered_row_sum"] == before + 2
        runs.append(got.cpu())
    for got in runs:
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _small_corpus():
    from word2vec_tpu_torch import PackedCorpus, Vocab

    rng = np.random.default_rng(1)
    sents = [[f"w{j}" for j in rng.integers(0, 50, size=30)] for _ in range(64)]
    vocab = Vocab.build(sents, min_count=1)
    return vocab, PackedCorpus.pack(vocab.encode_corpus(sents), 30)


# launches per step of each route's kernels, at clip_row_update=1.0 (on)
# and scatter_mean=False (the defaults): the clip budget adds three ordered
# row sums (one for the in table, two for the out table's positive and
# negative contributions); one run list per distinct sorted id array (the
# token-order sides share one; pallas scatters its context side from slab
# space, a third array)
ROUTE_LAUNCHES = {
    ("pallas_fused", "unified"): dict(fused_grad_core=1, fused_slab_scatter=2,
                                      find_runs=2),
    ("xla", "split"): dict(fused_slab_scatter=3, find_runs=2),
    ("xla", "unified"): dict(fused_slab_scatter=2, find_runs=2),
    ("pallas_oa", "split"): dict(overlap_add_slabs=1, fused_slab_scatter=3,
                                 find_runs=2),
    ("pallas", "split"): dict(band_core=1, fused_slab_scatter=3, find_runs=3),
}


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_trainer_launches_each_kernel_per_step(cuda, route):
    from word2vec_tpu_torch import Trainer, Word2VecConfig

    backend, layout = route
    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                         max_sentence_len=30, band_chunk=10, shared_negatives=8,
                         table_layout=layout, band_backend=backend)
    tr = Trainer(cfg, vocab, corpus)
    want = {k: 0 for k in launch.LAUNCHES}
    want["ordered_row_sum"] = 3
    want.update(ROUTE_LAUNCHES[route])
    # the first run captures the step as a CUDA graph: one eager warm-up
    # step on clones of the params, then a replay per step
    launch.reset_launch_counts()
    state, report = tr.train(log_every=2)
    assert launch.LAUNCHES == {k: v * (report.steps + 1) for k, v in want.items()}
    launch.reset_launch_counts()
    state, report = tr.train(log_every=2)
    assert launch.LAUNCHES == {k: v * report.steps for k, v in want.items()}
    assert np.all(np.isfinite(report.loss_history))


def test_step_repeats_bitwise_on_the_card(cuda):
    """Two runs of one default-route step from the same params and draws:
    bitwise-equal tables (no atomics anywhere in the update)."""
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.tables import DeviceTables

    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                         max_sentence_len=30, band_chunk=10, shared_negatives=8,
                         clip_row_update=1e-4, scatter_mean=True)
    step = BandStep(cfg, DeviceTables.build(vocab, cfg, cuda))
    tokens = torch.from_numpy(corpus.flat[:8 * 30].reshape(8, 30)).to(cuda)
    draws = step.draw(torch.Generator(device=cuda).manual_seed(3), tokens)
    out = []
    for _ in range(2):
        params = init_params(cfg, len(vocab), torch.Generator(device=cuda).manual_seed(1))
        m = step.apply(params, tokens, draws, 0.05)
        torch.cuda.synchronize()
        out.append((params, m))
    assert float(out[0][1]["clip_engaged"]) > 0
    for k in out[0][0]:
        assert torch.equal(out[0][0][k].view(torch.int32), out[1][0][k].view(torch.int32))


def _hold(names, got, ref, tol):
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        err = float((g.double() - r.double()).abs().max())
        if name in ("n_ctx", "ctx_w"):
            assert err == 0.0, name
        else:
            limit = 1e-4 if name == "losses" else tol
            assert err <= limit * float(r.abs().max()), (name, err)


@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(ODD_SHAPES))
def test_grad_core_tensor_cores_match_plain(cuda, shape, model, table):
    d, kp, w, s, l, b = ODD_SHAPES[shape]
    inp = small_grad_inputs(V=80, d=d, B=b, L=l, W=w, S=s, KP=kp, table=table)
    args = [inp[k].to(cuda) for k in GRAD_ORDER]
    kw = dict(W=w, K=K, L=l, cdt=torch.bfloat16, is_cbow=model == "cbow")
    rec = torch.zeros((b, len(launch.CORE_PHASES)), dtype=torch.int64, device=cuda)
    got = fs.fused_grad_core(*args, 0.03, phase_cycles=rec, **kw)
    again = fs.fused_grad_core(*args, 0.03, **kw)
    ref = fs.fused_grad_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    _hold(GRAD_NAMES, got, ref, TOL[torch.bfloat16])
    for g, a in zip(got, again):
        assert torch.equal(_bits(g), _bits(a))
    assert bool((rec >= 0).all()) and bool((rec.sum(1) > 0).all())


@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(ODD_SHAPES))
def test_band_core_tensor_cores_match_plain(cuda, shape, model, scope):
    d, kp, w, s, l, b = ODD_SHAPES[shape]
    table = torch.bfloat16 if shape.startswith("d64") else torch.float32
    inp = small_core_inputs(V=80, d=d, B=b, L=l, W=w, S=s, KP=kp, table=table,
                            scope=scope, model=model)
    args = [inp[k].to(cuda) for k in CORE_ORDER]
    kw = dict(W=w, K=K, cdt=torch.bfloat16, is_cbow=model == "cbow")
    rec = torch.zeros((b, len(launch.CORE_PHASES)), dtype=torch.int64, device=cuda)
    got = bc.band_core(*args, 0.03, phase_cycles=rec, **kw)
    again = bc.band_core(*args, 0.03, **kw)
    ref = bc.band_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    _hold(CORE_NAMES, got, ref, TOL[torch.bfloat16])
    for g, a in zip(got, again):
        assert torch.equal(_bits(g), _bits(a))
    assert bool((got[1][args[4] < 0] == 0).all())
    assert bool((rec >= 0).all()) and bool((rec.sum(1) > 0).all())


# ------------------------------------------------- graphed dispatch (A4)
def _graph_trainer(cuda, route, graphs=True, **over):
    from word2vec_tpu_torch import Trainer, Word2VecConfig

    backend, layout = route
    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                         max_sentence_len=30, band_chunk=10, shared_negatives=8,
                         table_layout=layout, band_backend=backend, iters=2, **over)
    tr = Trainer(cfg, vocab, corpus, device=cuda)
    tr.graphs = graphs
    return tr


def _same(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_graph_replay_matches_eager(cuda, route):
    """Every step replayed as a CUDA graph (per-step, chunked streaming,
    chunked resident, a mid-epoch resume) against the eager per-step run of
    the same seed: bitwise-equal params."""
    ref, _ = _graph_trainer(cuda, route, graphs=False).train(log_every=0)
    g = _graph_trainer(cuda, route)
    part, _ = g.train(log_every=0, max_steps=5)
    assert g.capture_s > 0 and g._runners  # captured, not eager
    resumed, _ = g.train(state=part, log_every=0)
    assert _same(resumed.params, ref.params)
    whole, _ = g.train(log_every=0)
    assert _same(whole.params, ref.params)
    for over in (dict(chunk_steps=3, resident="off"), dict(chunk_steps=3, resident="on")):
        state, rep = _graph_trainer(cuda, route, **over).train(log_every=0)
        assert state.step == ref.step and _same(state.params, ref.params), over


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_graph_replays_count_their_launches(cuda, route):
    """A capture launches nothing and each replay adds the capture's
    counts: a graphed run launches each kernel as often per step as an
    eager one (the counts chip_smoke.expected_launches holds)."""
    want = {k: 0 for k in launch.LAUNCHES}
    want["ordered_row_sum"] = 3
    want.update(ROUTE_LAUNCHES[route])
    for over in (dict(), dict(chunk_steps=3, resident="off"),
                 dict(chunk_steps=3, resident="on")):
        tr = _graph_trainer(cuda, route, **over)
        tr.train(log_every=0, max_steps=2)  # warm-up and capture
        launch.reset_launch_counts()
        state, rep = tr.train(log_every=0)
        torch.cuda.synchronize()
        assert launch.LAUNCHES == {k: v * rep.steps for k, v in want.items()}, over


def test_step_graph_reads_each_alpha_and_seed(cuda):
    """One StepGraph of three slots: each replay reads its slot's alpha and
    the seed set before it, as the eager step does."""
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.graphs import StepGraph
    from word2vec_tpu_torch.ops.tables import DeviceTables

    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                         max_sentence_len=30, band_chunk=10, shared_negatives=8,
                         micro_steps=2)
    step = BandStep(cfg, DeviceTables.build(vocab, cfg, cuda))
    toks = torch.from_numpy(corpus.flat[:3 * 8 * 30].reshape(3, 8, 30)).to(cuda)
    out = []
    for graphed in (False, True):
        params = init_params(cfg, len(vocab), torch.Generator(device=cuda).manual_seed(1))
        g = StepGraph(step, params, lambda s: toks.index_select(0, s).reshape(8, 30),
                      3, graphed=graphed)
        assert (g.graph is not None) == graphed
        m = g.dispatch(np.float32([0.05, 0.01, 0.03]), 7, 100)
        torch.cuda.synchronize()
        out.append((params, {k: v.clone() for k, v in m.items()}))
    assert _same(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_health_rows_in_the_graph_match_eager(cuda, route):
    """health_metrics on: the captured step's health rows (per-step and
    chunked resident) equal the eager run's bitwise, and the port's
    kernels launch as often per step as with health off."""
    want = {k: 0 for k in launch.LAUNCHES}
    want["ordered_row_sum"] = 3
    want.update(ROUTE_LAUNCHES[route])
    logs = {}
    for name, graphs, over in (("eager", False, dict()), ("graph", True, dict()),
                               ("resident", True, dict(chunk_steps=3,
                                                       resident="on"))):
        tr = _graph_trainer(cuda, route, graphs=graphs, health_metrics=True,
                            **over)
        rec = []
        tr.flight.note_counters = lambda step, c, rec=rec: rec.append((step, c))
        launch.reset_launch_counts()
        state, rep = tr.train(log_every=0)
        torch.cuda.synchronize()
        if graphs and not over:
            assert launch.LAUNCHES == {k: v * (rep.steps + 1)
                                       for k, v in want.items()}
        logs[name] = (state, rep, rec)
    for step, c in logs["eager"][2]:
        assert c["nonfinite_params"] == 0 and c["grad_norm"] > 0
    assert logs["graph"][2] == logs["eager"][2]
    assert _same(logs["resident"][0].params, logs["eager"][0].params)
    he, hr = logs["eager"][1].health, logs["resident"][1].health
    assert he["observations"] == hr["observations"] == logs["eager"][1].steps
    np.testing.assert_allclose(hr["grad_norm_cumulative"],
                               he["grad_norm_cumulative"], rtol=1e-12)


def test_capture_beside_a_querying_thread(cuda):
    """A thread answering neighbor queries on the card runs on while the
    trainer captures its step (the first dispatch, and again after a
    vocabulary growth dropped the graphs): no query fails, nothing of the
    thread's work lands in a graph, and the params equal the same run's
    without the thread, bitwise."""
    import threading

    from word2vec_tpu_torch import Trainer, Word2VecConfig
    from word2vec_tpu_torch.serve.query import QueryEngine

    def run(with_queries):
        vocab, corpus = _small_corpus()
        cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                             max_sentence_len=30, band_chunk=10,
                             shared_negatives=8, table_layout="unified",
                             band_backend="pallas_fused", chunk_steps=3,
                             corpus_mode="streaming", vocab_reserve=4)
        tr = Trainer(cfg, vocab, corpus, device=cuda)
        W = torch.randn(len(vocab), 32, generator=torch.Generator().manual_seed(0))
        eng = QueryEngine(W.numpy(), vocab, device=cuda)
        stop, served, errors = threading.Event(), [0], []

        def client():
            while not stop.is_set():
                try:
                    assert len(eng.neighbors_batch(vocab.words[:16], k=5)) == 16
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — the assertion target
                    errors.append(e)

        q = threading.Thread(target=client, daemon=True)
        if with_queries:
            q.start()
        try:
            state, _ = tr.train(log_every=0)
            vocab.admit([("zz_new", 50)])
            tr.refresh_vocab_tables()
            state, _ = tr.train(state=state, log_every=0)
            torch.cuda.synchronize()
        finally:
            stop.set()
            if with_queries:
                q.join(timeout=30)
        assert not errors, errors[:1]
        assert not with_queries or (served[0] > 0 and not q.is_alive())
        return state.params

    assert _same(run(True), run(False))
