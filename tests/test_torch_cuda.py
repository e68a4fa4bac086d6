"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels of word2vec_tpu_torch/csrc/*.cu have no interpret mode, so
these tests run only where torch.cuda.is_available() (and nvcc) are;
elsewhere they skip with that reason. On the H100 run them with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py holds the same kernels against the same plain versions at
the flagship shapes. The data-parallel cases hold the replica sync on the
card bitwise against the CPU sync, and a dp = 2 run of two replicas on one
card (each its own captured graphs) bitwise against the eager run.

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


# ------------------------------------------------- the planner (A10d)
def _plan_cfg(route, **over):
    from word2vec_tpu_torch import Word2VecConfig

    backend, layout = route
    return Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                          max_sentence_len=30, band_chunk=10, shared_negatives=8,
                          table_layout=layout, band_backend=backend, **over)


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_probe_plan_counts_its_launches(cuda, route):
    """probe_plan on the card: a graphed ChunkRunner whose capture runs one
    eager warm-up step, then 1 + probe_dispatches dispatches of
    probe_steps replays; its record counts exactly those launches and
    carries no error."""
    from word2vec_tpu_torch.tune import planner

    vocab, corpus = _small_corpus()
    cfg = _plan_cfg(route)
    before = dict(launch.LAUNCHES)
    rec = planner.probe_plan(cfg, cfg.current_plan(), vocab, corpus,
                             probe_steps=2, probe_dispatches=2, device=cuda)
    planner.free_probe_residue(cuda)
    assert "error" not in rec and rec["measured_step_ms"] > 0
    per = {k: 0 for k in launch.LAUNCHES}
    per["ordered_row_sum"] = 3
    per.update(ROUTE_LAUNCHES[route])
    steps = 1 + (1 + 2) * 2
    assert rec["launches"] == {k: v * steps for k, v in per.items()}
    assert {k: launch.LAUNCHES[k] - before[k] for k in launch.LAUNCHES} == (
        rec["launches"])


def test_probe_search_leaves_no_device_memory(cuda, tmp_path):
    """resolve_plan on the card probes graphed candidates of the kernel
    routes and returns the device memory it found: no graph, pool, table
    or param of a probe survives the search; a trainer on the winner then
    trains."""
    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.tune import planner

    vocab, corpus = _small_corpus()
    cfg = _plan_cfg(("pallas_fused", "unified"), chunk_steps=2)
    planner.free_probe_residue(cuda)
    before = torch.cuda.memory_allocated(cuda)
    res = planner.resolve_plan(cfg, vocab, corpus=corpus, mode="probe",
                               cache_path=str(tmp_path / "plans.json"),
                               device=cuda)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == before
    assert res.probes and all("error" not in p for p in res.probes)
    assert res.key.startswith(torch.cuda.get_device_name(cuda) + "|gpu|band-ns|")
    tr = Trainer(cfg.apply_plan(res.plan), vocab, corpus, device=cuda)
    state, rep = tr.train(log_every=0)
    assert rep.steps > 0 and np.isfinite(rep.final_loss)


def test_band_core_refuses_a_shape_over_shared_memory(cuda):
    """band_core at batch scope and KP 256 with d 300 needs more shared
    memory a block than the card has: refused before any launch, the
    host copy of the size equal to the library's."""
    from word2vec_tpu_torch import _build

    get = _build.library("band_core").w2v_band_core_smem_bytes
    for kp in (64, 256):
        assert launch.core_smem_bytes("band_core", 118, 128, kp, 300, 5, True) == (
            get(118, 128, kp, 300, 5, 1))
    inp = small_core_inputs(V=200, d=300, B=2, L=192, W=5, S=118, KP=256,
                            table=torch.float32, scope="batch", model="sg")
    args = [inp[k].to(cuda) for k in CORE_ORDER]
    before = dict(launch.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        bc.band_core(*args, 0.03, W=5, K=3, cdt=torch.bfloat16, is_cbow=False)
    assert launch.LAUNCHES == before


# ------------------------------------------- data parallelism (A8a)
@pytest.mark.parametrize("mode", ["mean", "delta"])
def test_replica_sync_on_the_card_matches_cpu(cuda, mode):
    """Two replicas on one card, synced there, bitwise equal to the same
    sync on the CPU on copies of them; the sync writes in place."""
    from word2vec_tpu_torch.parallel import make_delta_sync, make_mesh, make_sync

    rng = np.random.default_rng(3)
    base = rng.normal(size=(500, 2, 64)).astype(np.float32)
    reps = [base + rng.normal(scale=1e-2, size=base.shape).astype(np.float32)
            for _ in range(2)]
    dev_mesh, cpu_mesh = make_mesh(2, devices=[cuda, cuda]), make_mesh(2, device="cpu")
    on_card = [{"emb": torch.from_numpy(r).to(cuda)} for r in reps]
    on_cpu = [{"emb": torch.from_numpy(r.copy())} for r in reps]
    ptrs = [p["emb"].data_ptr() for p in on_card]
    if mode == "mean":
        make_sync(dev_mesh)(on_card)
        make_sync(cpu_mesh)(on_cpu)
    else:
        make_delta_sync(dev_mesh)(on_card, {"emb": torch.from_numpy(base).to(cuda)})
        make_delta_sync(cpu_mesh)(on_cpu, {"emb": torch.from_numpy(base.copy())})
    torch.cuda.synchronize()
    assert [p["emb"].data_ptr() for p in on_card] == ptrs
    for r in range(2):
        assert torch.equal(_bits(on_card[r]["emb"].cpu()), _bits(on_cpu[r]["emb"]))
        assert torch.equal(on_card[r]["emb"], on_card[0]["emb"])


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_dp2_graphed_run_matches_eager(cuda, route):
    """ShardedTrainer(dp=2) with both replicas on one card: each replica's
    steps replayed as its own CUDA graph, chunked and resident, bitwise
    equal to the eager per-step run, with each replica's kernels launched
    once a step."""
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh

    backend, layout = route
    vocab, corpus = _small_corpus()

    def trainer(graphs=True, **over):
        cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=4,
                             max_sentence_len=30, band_chunk=10, shared_negatives=8,
                             table_layout=layout, band_backend=backend, iters=2,
                             dp_sync_every=2, **over)
        tr = ShardedTrainer(cfg, vocab, corpus, mesh=make_mesh(2, devices=[cuda, cuda]))
        tr.graphs = graphs
        return tr

    eager = trainer(graphs=False)
    ref, _ = eager.train(log_every=0)
    want = {k: 0 for k in launch.LAUNCHES}
    want["ordered_row_sum"] = 3
    want.update(ROUTE_LAUNCHES[route])
    for over in (dict(), dict(chunk_steps=2, resident="off"),
                 dict(chunk_steps=2, resident="on")):
        tr = trainer(**over)
        tr.train(log_every=0, max_steps=2)  # warm-up and capture
        launch.reset_launch_counts()
        state, rep = tr.train(log_every=0)
        torch.cuda.synchronize()
        assert launch.LAUNCHES == {k: 2 * v * rep.steps for k, v in want.items()}, over
        assert state.step == ref.step
        assert _same(state.params, ref.params), over
        for r in range(2):
            assert _same(tr._replicas[r], eager._replicas[r]), over


@pytest.mark.parametrize("first", ["cuda", "cpu"])
def test_dp2_replicas_on_two_devices(cuda, first):
    """Replicas on two devices, the card and the CPU (a one-card machine's
    stand-in for a second card): each device gets its own frequency
    tables, resident corpus and epoch order, the card's replica its own
    capture pool and stream when the card is not the trainer's first
    device, the metrics are gathered across devices and the sync is staged
    through replica 0's device. Without a sync each replica trains bitwise
    as the same replica of a mesh on its device alone, and only the card's
    replica launches kernels; with syncs (mean and delta) every sync is
    bitwise the same sync on the CPU on copies of the replicas, and the
    replicas end bitwise equal."""
    from word2vec_tpu_torch import TrainState, Word2VecConfig
    from word2vec_tpu_torch.parallel import (
        ShardedTrainer, make_delta_sync, make_mesh, make_sync,
    )

    cpu = torch.device("cpu")
    devs = [cuda, cpu] if first == "cuda" else [cpu, cuda]
    vocab, corpus = _small_corpus()
    route = ("pallas_fused", "unified")

    def trainer(devices, **over):
        cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=4,
                             max_sentence_len=30, band_chunk=10, shared_negatives=8,
                             table_layout=route[1], band_backend=route[0], iters=2,
                             **over)
        return ShardedTrainer(cfg, vocab, corpus, mesh=make_mesh(2, devices=devices))

    want = {k: 0 for k in launch.LAUNCHES}
    want["ordered_row_sum"] = 3
    want.update(ROUTE_LAUNCHES[route])
    # one initial table for every mesh (an init draws from the generator
    # of the trainer's first device, and the card's differs from the CPU's)
    init = trainer([cpu, cpu]).init_state().params
    for over in (dict(chunk_steps=1), dict(chunk_steps=2, resident="on")):
        runs = {}
        for name, devices in (("mixed", devs), ("cuda", [cuda, cuda]), ("cpu", [cpu, cpu])):
            tr = trainer(devices, dp_sync_every=0, **over)
            tr._finalize = lambda s: None  # no sync: the replicas apart
            _, rep = tr.train(TrainState(params=init), log_every=2)
            runs[name] = (tr, rep)
        mixed, rep = runs["mixed"]
        assert rep.total_words == runs["cpu"][1].total_words, over
        assert rep.loss_history and np.isfinite(rep.loss_history).all(), over
        if over.get("resident"):
            assert rep.resident["resolved"] == "resident", over
        for r, dev in enumerate(devs):
            alone = runs[dev.type][0]._replicas[r]
            assert {v.device.type for v in mixed._replicas[r].values()} == {dev.type}
            assert _same({k: v.cpu() for k, v in mixed._replicas[r].items()},
                         {k: v.cpu() for k, v in alone.items()}), (over, r)
        launch.reset_launch_counts()
        _, rep = mixed.train(log_every=0, max_steps=4)  # captured: replays only
        torch.cuda.synchronize()
        assert launch.LAUNCHES == {k: v * rep.steps for k, v in want.items()}, over

    for mode in ("mean", "delta"):
        tr = trainer(devs, dp_sync_every=2, sync_mode=mode, chunk_steps=2)
        on_cpu = (make_delta_sync if mode == "delta" else make_sync)(
            make_mesh(2, device="cpu"))
        inner, seen = tr.sync_fn, []

        def checked(params, *base, inner=inner, on_cpu=on_cpu, seen=seen):
            # copies: .cpu() of the CPU replica would be its own buffer
            host = [{k: v.to("cpu", copy=True) for k, v in p.items()} for p in params]
            hbase = [{k: v.to("cpu", copy=True) for k, v in b.items()} for b in base]
            out = inner(params, *base)
            ref = on_cpu(host, *hbase)
            for r, p in enumerate(out):
                assert _same({k: v.cpu() for k, v in p.items()}, ref[r]), (mode, r)
            seen.append(1)
            return out

        tr.sync_fn = checked
        state, rep = tr.train(log_every=2)
        assert len(seen) >= 2, mode
        assert rep.loss_history and np.isfinite(rep.loss_history).all(), mode
        a, b = ({k: v.cpu() for k, v in p.items()} for p in tr._replicas)
        assert _same(a, b) and _same(a, {k: v.cpu() for k, v in state.params.items()}), mode


# ------------------------------------------- tensor and sequence parallel
@pytest.mark.parametrize("tp", [2, 4])
def test_psum_on_the_card_is_the_cpu_sum(cuda, tp):
    """ops/shards.shard_sum on the card (the psum of the model axis) is
    bitwise the CPU shard-order sum of copies of the same partials."""
    from word2vec_tpu_torch.ops.shards import shard_sum

    g = torch.Generator(device=cuda).manual_seed(tp)
    parts = [torch.randn((64, 197), generator=g, device=cuda)
             * 10.0 ** torch.randint(-6, 6, (64, 1), generator=g, device=cuda)
             for _ in range(tp)]
    got = shard_sum(parts, cuda)
    want = shard_sum([p.cpu() for p in parts], torch.device("cpu"))
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("width", [150, 75])
@pytest.mark.parametrize("layout", ["split", "unified"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_at_the_tp_shard_widths(cuda, width, layout, dtype):
    """The slab scatter at a tp shard's width of the flagship d = 300 (tp 2
    and 4: the vector load drops to 2 and 1 values), whole rows and the
    unified slab's plane-1 tail, bitwise its plain version."""
    rng = np.random.default_rng(width)
    p = 1.0 / np.arange(1, NVR + 1)
    ids = np.sort(rng.choice(NVR, size=6000, p=p / p.sum())).astype(np.int32)
    idx = torch.from_numpy(ids).to(cuda)
    shape = (NVR, 2, width) if layout == "unified" else (NVR, width)
    table = (0.1 * torch.randn(shape, device=cuda)).to(dtype)
    vals = (1e-2 * torch.randn((ids.size,) + shape[1:], device=cuda)).to(dtype)
    got = fs.fused_slab_scatter(table.clone(), idx, vals)
    want = fs.fused_slab_scatter_plain(table.clone(), idx, vals)
    assert torch.equal(_bits(got), _bits(want))
    if layout == "unified":
        tail = (1e-2 * torch.randn((ids.size, width), device=cuda)).to(dtype)
        got = fs.fused_slab_scatter(table.clone(), idx, tail, plane=1)
        want = fs.fused_slab_scatter_plain(table.clone(), idx, tail, plane=1)
        assert torch.equal(_bits(got), _bits(want))


def _tp_trainer(devices, mesh, **over):
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh

    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=4,
                         max_sentence_len=30, shared_negatives=8, iters=2,
                         dp_sync_every=2, **over)
    dp, sp, tp = mesh
    return ShardedTrainer(cfg, vocab, corpus,
                          mesh=make_mesh(dp, tp=tp, sp=sp, devices=devices))


def test_tp2_sp2_graphed_run_matches_eager(cuda):
    """ShardedTrainer at sp 2 x tp 2 on one card: each replica's two
    shards, their psums included, replayed as one CUDA graph, per-step and
    chunked resident, bitwise equal to the eager per-step run, with each
    shard's kernels launched once a step."""
    eager = _tp_trainer([cuda] * 4, (1, 2, 2), chunk_steps=1)
    eager.graphs = False
    ref, _ = eager.train(log_every=0)
    for over in (dict(chunk_steps=1), dict(chunk_steps=2, resident="on")):
        tr = _tp_trainer([cuda] * 4, (1, 2, 2), **over)
        assert not tr.split_shards
        st, rep = tr.train(log_every=2)
        assert _same(st.params, ref.params), over
        assert rep.loss_history and np.isfinite(rep.loss_history).all(), over
        launch.reset_launch_counts()
        _, rep = tr.train(log_every=0, max_steps=4)  # captured: replays only
        torch.cuda.synchronize()
        want = {k: 0 for k in launch.LAUNCHES}
        want.update(ordered_row_sum=3, **ROUTE_LAUNCHES[("xla", "split")])
        assert launch.LAUNCHES == {k: v * 4 * rep.steps for k, v in want.items()}, over


@pytest.mark.parametrize("first", ["cuda", "cpu"])
def test_tp2_replica_on_a_card_and_the_cpu(cuda, first):
    """A tp-2 replica whose shards sit on the card and the CPU (a one-card
    machine's stand-in for two cards) runs eagerly (StepGraph.split): the
    tokens, draws and partial logits cross the devices, every psum is
    bitwise the CPU shard-order sum of its partials, only the card's shard
    launches kernels (once a step), and the tables stay within the JAX tp
    test's 5e-5 of the same run with both shards on its first device,
    whose generator draws the replica's draws (the shards' partial logits
    come from two devices' matrix products, which add in other orders, so
    the runs are not bitwise)."""
    from word2vec_tpu_torch import TrainState
    from word2vec_tpu_torch.ops import shards

    cpu = torch.device("cpu")
    devs = [cuda, cpu] if first == "cuda" else [cpu, cuda]
    init = _tp_trainer([cpu, cpu], (1, 1, 2)).init_state().params
    one = _tp_trainer([devs[0]] * 2, (1, 1, 2), chunk_steps=1)
    one.graphs = False
    ref, _ = one.train(TrainState(params=init), log_every=0, max_steps=6)
    mixed = _tp_trainer(devs, (1, 1, 2), chunk_steps=1)
    assert mixed.split_shards
    real, sums = shards.shard_sum, []

    def checked(parts, home):
        out = real(parts, home)
        want = real([p.to("cpu", copy=True) for p in parts], cpu)
        sums.append(torch.equal(_bits(out.cpu()), _bits(want)))
        return out

    shards.shard_sum = checked
    try:
        launch.reset_launch_counts()
        st, rep = mixed.train(TrainState(params=init), log_every=2, max_steps=6)
        torch.cuda.synchronize()
    finally:
        shards.shard_sum = real
    assert sums and all(sums)
    assert rep.loss_history and np.isfinite(rep.loss_history).all()
    want = {k: 0 for k in launch.LAUNCHES}
    want.update(ordered_row_sum=3, **ROUTE_LAUNCHES[("xla", "split")])
    assert launch.LAUNCHES == {k: v * rep.steps for k, v in want.items()}
    for i, s in enumerate(mixed._replicas[0]):
        assert {v.device.type for v in s.values()} == {devs[i].type}
    for k in ref.params:
        err = float((st.params[k].cpu() - ref.params[k].cpu()).abs().max())
        assert err <= 5e-5, (k, err)


# ------------------------------------------------------- several processes
def _card_sync_fleet(cuda, tmp_path, devices):
    """Two spawned ranks (tests/torch_mp_worker.py, card_sync mode) syncing
    tables on the card; each global replica held bitwise against the
    one-process sync of the same tables on the card."""
    import torch_mp_worker as W
    from word2vec_tpu_torch.parallel import make_delta_sync, make_mesh, make_sync

    rcs, res, arrs, logs = W.launch(tmp_path, {"mode": "card_sync", "devices": devices},
                                    timeout=120.0)
    assert rcs == [0, 0], logs
    for reps in (2, 4):
        base, tabs = W.tables(reps)
        mesh = make_mesh(reps, devices=[cuda] * reps)
        for mode in ("mean", "delta"):
            mine = [{"t": torch.from_numpy(tabs[r].copy()).to(cuda)} for r in range(reps)]
            if mode == "mean":
                make_sync(mesh)(mine)
            else:
                make_delta_sync(mesh)(mine, {"t": torch.from_numpy(base.copy()).to(cuda)})
            local = reps // 2
            for g in range(reps):
                fleet = torch.from_numpy(arrs[g // local][f"{mode}{reps}_{g}"])
                assert torch.equal(_bits(fleet), _bits(mine[g]["t"].cpu())), (mode, reps, g)
    return [r["topology"] for r in res]


def test_two_ranks_on_one_card_sync_bitwise_over_gloo(cuda, tmp_path):
    """Both ranks on card 0: the table backend is gloo, staged through
    host memory, recorded with why; every sync is the one-process sync."""
    topo = _card_sync_fleet(cuda, tmp_path, "shared")
    for r, t in enumerate(topo):
        assert t["table_backend"] == "gloo" and t["staged"] is True, t
        assert t["process_index"] == r and "share a card" in t["reason"]
        assert len({row["card"] for row in t["ranks"]}) == 1


def test_two_ranks_on_two_cards_sync_bitwise_over_nccl(cuda, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (one rank on each)")
    topo = _card_sync_fleet(cuda, tmp_path, "own")
    for t in topo:
        assert t["table_backend"] == "nccl" and t["staged"] is False, t
        assert len({row["card"] for row in t["ranks"]}) == 2


@pytest.mark.parametrize("layout", ["split", "unified"])
def test_assemble_local_replica_of_a_tp2_replica(cuda, layout):
    """A tp-2 replica's shards on the card concatenate back to the table,
    in new tensors on the card."""
    from word2vec_tpu_torch.parallel import (
        assemble_local_replica, make_mesh, replicate_params,
    )

    shape = (300, 64) if layout == "split" else (300, 2, 64)
    table = torch.from_numpy(np.random.default_rng(4).normal(size=shape).astype(np.float32))
    reps = replicate_params({"t": table.to(cuda)}, make_mesh(2, tp=2, devices=[cuda] * 4))
    got = assemble_local_replica(reps)["t"]
    assert got.is_cuda and torch.equal(_bits(got.cpu()), _bits(table))
    assert all(got.data_ptr() != s["t"].data_ptr() for s in reps[0])


@pytest.mark.parametrize("layout", ["split", "unified"])
def test_remesh_dp3_2_3_on_one_card(cuda, layout, tmp_path):
    """ShardedTrainer.remesh on the card: dp 3 -> 2 -> 3, every replica on
    the one card, each leg continued from a checkpoint of the last:
    every parameter bitwise a fresh trainer of the new shape resumed from
    the same checkpoint, and no captured graph of an old mesh left behind
    (the card memory the trainer holds back to its level once the old
    trainer and the fresh ones are gone)."""
    import dataclasses

    from word2vec_tpu_torch import TrainState, Word2VecConfig
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh
    from word2vec_tpu_torch.tune.planner import free_probe_residue

    vocab, corpus = _small_corpus()
    backend = "pallas_fused" if layout == "unified" else "xla"
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=4,
                         max_sentence_len=30, band_chunk=10, shared_negatives=8,
                         table_layout=layout, band_backend=backend, iters=1,
                         dp_sync_every=2, chunk_steps=2, resident="off")

    def mesh(dp):
        return make_mesh(dp, devices=[cuda] * dp)

    def held():
        free_probe_residue(cuda)  # unreferenced blocks and cuBLAS workspaces
        return torch.cuda.memory_allocated(cuda)

    base = held()
    tr = ShardedTrainer(cfg, vocab, corpus, mesh=mesh(3))
    state, _ = tr.train(log_every=0)
    at_dp3 = held()  # three replicas and their captured graphs
    for leg, dp in enumerate((2, 3), start=2):
        ck = str(tmp_path / f"ck{leg}")
        save_checkpoint(ck, TrainState(params=tr.export_params(state), step=state.step,
                                       words_done=state.words_done, epoch=state.epoch),
                        tr.config, vocab)
        tr.config = dataclasses.replace(cfg, iters=leg)
        tr.remesh(mesh=mesh(dp), state=state, checkpoint_dir=ck)
        assert tr.dp == dp and len(tr._replicas) == dp and not tr._runners
        state, _ = tr.train(state=state, log_every=0)
        fresh = ShardedTrainer(tr.config, vocab, corpus, mesh=mesh(dp))
        s2, _, _ = load_checkpoint(ck)
        fresh.import_params(s2.params, s2)
        s2, _ = fresh.train(state=s2, log_every=0)
        assert s2.step == state.step
        assert _same(tr.export_params(state), fresh.export_params(s2))
        del fresh, s2
    # back at dp 3: what the first dp-3 run held, no graph of dp 2 left
    assert held() == at_dp3
    del tr, state
    assert held() == base
