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
and two calls bitwise equal; past one piece of the negative pool or of the
width (KP 256 at batch scope, d 1000) likewise, in both compute types.
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
# negative contributions) and, on the gathered update tail, three squared
# norm passes; the tail's scatters are the gathered instantiation; one run
# list per distinct sorted id array (the token-order sides share one;
# pallas scatters its context side from slab space, a third array)
ROUTE_LAUNCHES = {
    ("pallas_fused", "unified"): dict(fused_grad_core=1, gathered_slab_scatter=2,
                                      find_runs=2, row_sq_norms=3),
    ("xla", "split"): dict(gathered_slab_scatter=3, find_runs=2, row_sq_norms=3),
    ("xla", "unified"): dict(gathered_slab_scatter=2, find_runs=2, row_sq_norms=3),
    ("pallas_oa", "split"): dict(overlap_add_slabs=1, gathered_slab_scatter=3,
                                 find_runs=2, row_sq_norms=3),
    ("pallas", "split"): dict(band_core=1, gathered_slab_scatter=3, find_runs=3,
                              row_sq_norms=3),
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


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(300, 256, 5, "batch", 0, 192), (1000, 64, 10, "row", 0, 192),
                                   (512, 128, 5, "row", 160, 192),
                                   (304, 64, 5, "batch", 173, 192),
                                   (300, 64, 5, "row", 174, 348),
                                   (300, 64, 5, "batch", 333, 1000),
                                   (300, 64, 5, "row", 500, 1000),
                                   (1000, 256, 5, "batch", 500, 1000)],
                         ids=["d300-kp256-batch", "d1000-kp64-w10", "d512-kp128-s160",
                              "d304-kp64-s173", "d300-kp64-s174-l348",
                              "d300-kp64-s333-l1000", "d300-kp64-s500-l1000",
                              "d1000-kp256-s500-l1000"])
def test_band_cores_take_wide_pools_and_rows(cuda, shape, cdt):
    """KP 256 at batch scope with d 300, d 1000 at KP 64, and explicit
    chunks past one center piece of 128 (S 160 with two width and two
    negative pieces: the logits' blocks in two rounds a warp; S 173 and 174,
    the last of which a block refused before the chunk was walked in center
    pieces; S 333 and 500 at L 1000, the C word2vec's sentence length, S 333
    leaving a one-center last chunk; S 500 at d 1000 and KP 256, the chunk,
    the pool and the width all in pieces): both band cores hold their plain
    versions (phase 3's tolerances, two calls bitwise equal); the host copy
    of each core's shared memory equals the library's, and it is the same
    past one piece of the pool, the width, the chunk and the slots."""
    _hold_wide_cores(cuda, shape, cdt)


def test_f32_band_cores_carry_a_halo_slot_across_three_pieces(cuda):
    """f32 compute at W 70 and S 300 (pieces of 128, 128 and 44 centers):
    2W = 140 exceeds a center piece, so the context sum of one slab slot
    is handed from the first piece through the middle one to the last
    (the f32 bodies' reach past one piece, band_tiles.cuh); both band cores
    hold their plain versions as above."""
    _hold_wide_cores(cuda, (128, 64, 70, "row", 300, 600), torch.float32)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(300, 64, 95, "row", 0, 192),
                                   (300, 64, 499, "batch", 0, 1000)],
                         ids=["w95-l192", "w499-l1000"])
def test_band_cores_take_every_window(cuda, shape, cdt):
    """Windows past one slot piece (csrc/band_tiles.cuh kKc): W 95 at the
    flagship's L 192 (S 190, two center pieces of two slot
    pieces) and W 499 at L 1000 (S 998, the widest window JAX takes there:
    eight center pieces of seven or eight slot pieces, a slot shared by
    all eight):
    both band cores hold their plain versions as above, their shared
    memory that of one slot piece."""
    _hold_wide_cores(cuda, shape, cdt)


def _hold_wide_cores(cuda, shape, cdt):
    from word2vec_tpu_torch import _build

    d, kp, w, scope, chunk, L_ = shape
    S = banded.resolve_chunk(L_, w, chunk)
    bf = int(cdt == torch.bfloat16)
    for kernel, lib, fn in (("fused_grad_core", "fused_step", "w2v_grad_core_smem_bytes"),
                            ("band_core", "band_core", "w2v_band_core_smem_bytes")):
        get = getattr(_build.library(lib), fn)
        host = launch.core_smem_bytes(kernel, S, S + 2 * w, kp, d, w, bool(bf))
        assert host == get(S, S + 2 * w, kp, d, w, bf)
        assert host == launch.core_smem_bytes(
            kernel, S, S + 2 * w, launch.CORE_KP_PIECE, launch.CORE_D_PIECE, w, bool(bf))
        if S > launch.CORE_S_PIECE:  # the same at every longer chunk
            S1 = launch.CORE_S_PIECE + 1
            assert host == launch.core_smem_bytes(kernel, S1, S1 + 2 * w, kp, d, w, bool(bf))
        # past one slot piece (bf16 compute: a pieced chunk), the same at
        # every wider window
        Kc = launch.CORE_K_PIECE
        if (launch.core_pieced(S, w) if bf
                else min(S, launch.CORE_S_PIECE) + 2 * w > Kc):
            assert host == launch.core_smem_bytes(kernel, S, S + 2 * Kc, kp, d, Kc,
                                                  bool(bf))
    inp = small_grad_inputs(V=200, d=d, B=2, L=L_, W=w, S=S, KP=kp,
                            table=torch.float32)
    args = [inp[k].to(cuda) for k in GRAD_ORDER]
    kw = dict(W=w, K=K, L=L_, cdt=cdt, is_cbow=False)
    got = fs.fused_grad_core(*args, 0.03, **kw)
    again = fs.fused_grad_core(*args, 0.03, **kw)
    ref = fs.fused_grad_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    _hold(GRAD_NAMES, got, ref, TOL[cdt])
    assert all(torch.equal(_bits(g), _bits(a)) for g, a in zip(got, again))
    inp = small_core_inputs(V=200, d=d, B=2, L=L_, W=w, S=S, KP=kp,
                            table=torch.float32, scope=scope, model="sg")
    args = [inp[k].to(cuda) for k in CORE_ORDER]
    kw = dict(W=w, K=K, cdt=cdt, is_cbow=False)
    before = launch.LAUNCHES["band_core"]
    got = bc.band_core(*args, 0.03, **kw)
    again = bc.band_core(*args, 0.03, **kw)
    ref = bc.band_core_plain(*args, 0.03, **kw)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["band_core"] == before + 2
    _hold(CORE_NAMES, got, ref, TOL[cdt])
    assert all(torch.equal(_bits(g), _bits(a)) for g, a in zip(got, again))


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


# ------------------------------------------------ the gathered update tail
def _flagship_tail_inputs(dev, seed=0):
    """The sgns flagship's tail operands: Zipf ids of 256 rows of 192 tokens
    sorted stably (long runs on the hot ids), the fused grad core's padded
    [256, 236, 300] f32 outputs as the two planes' sources, 16,384 negative
    rows, per-id clip scales with some rows under 1."""
    from chip_smoke import zipf_p

    rng = np.random.default_rng(seed)
    Vf, Bf, Lf, CS, d, n_neg = 71_000, 256, 192, 236, 300, 256 * 64
    p = zipf_p()
    flat = torch.from_numpy(rng.choice(Vf, size=Bf * Lf, p=p).astype(np.int32))
    order = torch.argsort(flat, stable=True)
    idx = flat[order].contiguous()
    rows = (order + (order // Lf) * (CS - Lf)).to(torch.int32)
    src = [torch.from_numpy(rng.normal(0, 0.05, size=(Bf * CS, d)).astype(np.float32))
           for _ in range(2)]
    negs = torch.from_numpy(rng.choice(Vf, size=n_neg, p=p).astype(np.int32))
    order_n = torch.argsort(negs, stable=True)
    neg_idx = negs[order_n].contiguous()
    neg_src = torch.from_numpy(rng.normal(0, 0.05, size=(n_neg, d)).astype(np.float32))
    scale = torch.from_numpy(np.where(rng.random(Vf) < 0.3,
                                      rng.uniform(0.01, 1.0, Vf), 1.0).astype(np.float32))
    emb = torch.from_numpy(rng.normal(0, 0.1, size=(Vf, 2, d)).astype(np.float32))
    t = lambda x: x.to(dev)  # noqa: E731
    return dict(idx=t(idx), rows=t(rows), src=[t(x) for x in src], neg_idx=t(neg_idx),
                neg_rows=t(order_n.to(torch.int32)), neg_src=t(neg_src),
                scale=t(scale), scale2=t(scale.flip(0).contiguous()), emb=emb)


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathered_scatter_bitwise_the_sorted_sequence(cuda, dtype, scaled):
    """At the flagship's shapes the gathered scatter, reading the padded
    grad-core rows through the sort order and scaling at the add, equals
    today's sequence bitwise: gather -> multiply -> cast -> stack ->
    fused_slab_scatter (the contiguous kernel), both planes in one call,
    then plane 1 alone for the negatives; and two runs agree."""
    x = _flagship_tail_inputs(cuda)
    emb = x["emb"].to(dtype).to(cuda)
    sc, sc2 = (x["scale"], x["scale2"]) if scaled else (None, None)
    ref = emb.clone()
    vals = torch.stack([(s[x["rows"].long()] * c[x["idx"].long()][:, None]
                         if c is not None else s[x["rows"].long()]).to(dtype)
                        for s, c in zip(x["src"], (sc, sc2))], dim=1).contiguous()
    fs.fused_slab_scatter(ref, x["idx"], vals)
    nv = x["neg_src"][x["neg_rows"].long()]
    if sc2 is not None:
        nv = nv * sc2[x["neg_idx"].long()][:, None]
    fs.fused_slab_scatter(ref, x["neg_idx"], nv.to(dtype).contiguous(), plane=1)
    outs = []
    for _ in range(2):
        got = emb.clone()
        before = launch.LAUNCHES["gathered_slab_scatter"]
        fs.gathered_slab_scatter(got, x["idx"], tuple(x["src"]), x["rows"], (sc, sc2))
        fs.gathered_slab_scatter(got, x["neg_idx"], (x["neg_src"],), x["neg_rows"],
                                 (sc2,), plane=1)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["gathered_slab_scatter"] == before + 2
        outs.append(got)
    assert not torch.equal(ref, emb)
    for got in outs:
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 300), (torch.bfloat16, 300),
                                     (torch.float32, 6), (torch.bfloat16, 7)])
@pytest.mark.parametrize("name", ["long_edges", "trainer"])
def test_gathered_scatter_split_tables_and_narrow_vectors(cuda, name, dtype, d):
    """A [V, d] table (the split layout's scatters) at the flagship width
    and at widths that allow 2- and 1-value vectors, on the work split's
    edge cases: bitwise the plain version."""
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(id_set(name, rng, nv=NVR))
    n = idx.numel()
    emb = torch.from_numpy(rng.normal(size=(NVR, d)).astype(np.float32)).to(dtype)
    src = torch.from_numpy(rng.normal(size=(2 * n + 5, d)).astype(np.float32))
    rows = torch.from_numpy(rng.permutation(2 * n + 5)[:n].astype(np.int32))
    scale = torch.from_numpy(rng.uniform(0.1, 1.0, NVR).astype(np.float32))
    ref = fs.gathered_slab_scatter_plain(emb.clone(), idx, (src,), rows, (scale,))
    got = fs.gathered_slab_scatter(emb.clone().to(cuda), idx.to(cuda), (src.to(cuda),),
                                   rows.to(cuda), (scale.to(cuda),))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(ref))


@pytest.mark.parametrize("shape", [(256, 236, 192, 300), (1, 16384, 16384, 300),
                                   (8, 40, 30, 7), (3, 10, 10, 150)],
                         ids=["padded", "negatives", "narrow", "tp2"])
def test_row_sq_norms_kernel_matches_plain(cuda, shape):
    """The squared norms of the live rows, read in place (the padded rows
    never: they hold NaN here), within float32 rounding of
    torch.sum(v * v, -1), and bitwise from run to run."""
    G, R, live, d = shape
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.normal(0, 0.05, size=(G, R, d)).astype(np.float32))
    src[:, live:] = float("nan")
    want = fs.row_sq_norms_plain(src, live)
    before = launch.LAUNCHES["row_sq_norms"]
    got = [fs.row_sq_norms(src.to(cuda), live) for _ in range(2)]
    torch.cuda.synchronize()
    assert launch.LAUNCHES["row_sq_norms"] == before + 2
    assert got[0].shape == (G * live,) and torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0].cpu(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize(
    "over,gathered",
    [(dict(), True), (dict(scatter_mean=True), False),
     (dict(dtype="bfloat16", stochastic_rounding=True), False),
     (dict(clip_row_update=1e-4), True)],
    ids=["default", "scatter_mean", "bf16-sr", "clip-engaged"],
)
@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES), ids="-".join)
def test_band_tail_route_and_counter_on_the_card(cuda, route, over, gathered, monkeypatch):
    """The band step's update tail on the card: the gathered one unless SR
    or scatter_mean keeps the sorted one, read from the flight recorder's
    `band_tail` counter (one a dispatch, 1 on every gathered step); the
    gathered run equals the sorted tail's run (the sorted tail forced on
    the card) bitwise where no row's clip engages, and within float32
    rounding of the clip's norms where it does."""
    from word2vec_tpu_torch.ops import band_step as bs

    runs = {}
    for name in ("rule", "sorted"):
        if name == "sorted":
            monkeypatch.setattr(bs, "gathered_tail", lambda config, sr, device: False)
        tr = _graph_trainer(cuda, route, chunk_steps=3, resident="on", **over)
        state, rep = tr.train(log_every=0)
        torch.cuda.synchronize()
        tails = [e["args"] for e in tr.flight.ring.events() if e["name"] == "band_tail"]
        assert tails and sum(t["steps"] for t in tails) == rep.steps
        runs[name] = (state, [t["gathered"] for t in tails])
    assert set(runs["rule"][1]) == {1.0 if gathered else 0.0}
    assert set(runs["sorted"][1]) == {0.0}
    a, b = runs["rule"][0].params, runs["sorted"][0].params
    if "clip_row_update" not in over:
        assert _same(a, b)
    else:
        for k in a:
            torch.testing.assert_close(a[k].float(), b[k].float(), rtol=0, atol=1e-6)


def test_band_tail_counter_absent_on_hs(cuda):
    """The hs step updates through scatter_update: no band_tail counter."""
    from word2vec_tpu_torch import Trainer, Word2VecConfig

    vocab, corpus = _small_corpus()
    cfg = Word2VecConfig(word_dim=32, window=3, min_count=1, batch_rows=8,
                         max_sentence_len=30, train_method="hs", negative=0,
                         band_backend="xla", table_layout="split")
    tr = Trainer(cfg, vocab, corpus, device=cuda)
    tr.train(log_every=0)
    assert not [e for e in tr.flight.ring.events() if e["name"] == "band_tail"]
