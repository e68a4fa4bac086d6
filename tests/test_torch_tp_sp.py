"""The port's tensor and sequence parallelism in one process
(word2vec_tpu_torch/parallel/, ops/shards.py) against the JAX package's
make_sharded_step / make_sync on the same (dp, sp, tp) mesh (CPU, the JAX
side on the 8 virtual CPU devices of conftest.py), each case the
counterpart of a case of tests/test_parallel.py.

Pins:
  * the shard-order sum (ops/shards.shard_sum) is BITWISE XLA's CPU psum
    over the model axis at tp = 2 and 4, and halo_exchange is EXACTLY
    JAX's _halo_exchange at sp = 2 and 4;
  * one step at tp = 2 and 4 for sg/cbow x ns/hs, and at dp 2 x tp 2,
    matches JAX's sharded step fed the same draws (every tp shard of a
    replica draws alike; JAX folds dp, then sp): tables within atol 1e-6,
    metrics (health counters included) within rtol 1e-5, counts exact;
  * sp = 2 on the band and pair steps: the same against JAX, and the sum
    of the shards' deltas equals the single-device step (the JAX test's
    1e-4); the sp sync (mean and delta) is bitwise JAX's over the same
    replicas;
  * the mesh's device order, the trainer's refusals with the JAX
    messages, the planner's constraints and shapes.
The trainers are in tests/test_torch_tp_sp_trainer.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from word2vec_tpu.compat import shard_map  # noqa: E402
from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.negative import build_alias_table  # noqa: E402
from word2vec_tpu.data.vocab import Vocab as JVocab  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops.band_step import _halo_exchange as j_halo  # noqa: E402
from word2vec_tpu.ops.tables import DeviceTables as JTables  # noqa: E402
from word2vec_tpu.ops.train_step import make_train_step as j_train_step  # noqa: E402
from word2vec_tpu.parallel import make_mesh as j_mesh  # noqa: E402
from word2vec_tpu.parallel import make_sharded_step as j_sharded_step  # noqa: E402
from word2vec_tpu.parallel import make_sync as j_sync  # noqa: E402
from word2vec_tpu.parallel import replicate_params as j_replicate  # noqa: E402
from word2vec_tpu.parallel.trainer import make_delta_sync as j_delta  # noqa: E402

import torch  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data.vocab import Vocab as TVocab  # noqa: E402
from word2vec_tpu_torch.models.params import params_from_numpy  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.shards import (  # noqa: E402
    center_zone, halo_exchange, lockstep, shard_sum, solo,
)
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner  # noqa: E402
from word2vec_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, make_delta_sync, make_mesh, make_sync, replicate_params,
    unreplicate_params,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

V, D = 50, 16
ALPHA = 0.02
CPU = torch.device("cpu")


def _u32(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ----------------------------------------------------- the psum, the halo
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_sum_is_xla_psum_bitwise(tp):
    """ops/shards.shard_sum vs jax.lax.psum over the model axis of a
    (1, 1, tp) mesh on the same partials (some equal across shards, some
    of mixed magnitude, where the order of the adds shows)."""
    rng = np.random.default_rng(tp)
    parts = rng.normal(size=(tp, 64, 7)).astype(np.float32)
    parts[:, :8] = parts[0, :8]  # equal operands
    parts[:, 8:16] *= np.float32(10.0) ** rng.integers(-6, 6, size=(tp, 8, 1))
    mesh = j_mesh(dp=1, tp=tp)
    want = jax.jit(shard_map(
        lambda x: jax.lax.psum(x, "model"), mesh=mesh,
        in_specs=P("model"), out_specs=P("model"),
    ))(jnp.asarray(parts.reshape(tp * 64, 7)))
    want = np.asarray(want).reshape(tp, 64, 7)[0]
    got = shard_sum([torch.from_numpy(p) for p in parts], CPU)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    # lockstep hands every shard that sum, and solo a body its own operand
    def body(x):
        y = yield x
        return y

    outs = lockstep([body(torch.from_numpy(p)) for p in parts], CPU)
    for o in outs:
        np.testing.assert_array_equal(_u32(o.numpy()), _u32(want))
    one = torch.from_numpy(parts[1])
    assert solo(body(one)) is one
    # the metrics contract psum(v, model) / tp (parallel/trainer.py:160-168)
    # on a metric every shard holds alike: ((v + v) + v) + v may round
    v = rng.uniform(1, 1e4, size=(16,)).astype(np.float32)
    want = jax.jit(shard_map(
        lambda x: jax.lax.psum(x, "model") / tp, mesh=mesh,
        in_specs=P("model"), out_specs=P("model"),
    ))(jnp.asarray(np.tile(v, tp)))
    got = shard_sum([torch.from_numpy(v)] * tp, CPU) / tp
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(np.asarray(want)[:16]))


@pytest.mark.parametrize("sp", [2, 4])
def test_halo_exchange_is_jax_exactly(sp):
    """halo_exchange(rows, s, sp, W) == JAX's _halo_exchange of shard s's
    slice over the seq axis (its ppermutes), -1 outer halos included; a
    slice shorter than the window is refused with JAX's reason."""
    W, L = 3, 24
    rng = np.random.default_rng(sp)
    toks = rng.integers(0, V, size=(4, L)).astype(np.int32)
    toks[1, 17:] = -1
    mesh = j_mesh(dp=1, tp=1, sp=sp)
    want = jax.jit(shard_map(
        lambda t: j_halo(t, W, "seq"), mesh=mesh,
        in_specs=P(None, "seq"), out_specs=P(None, "seq"),
    ))(jnp.asarray(toks))
    lh = L // sp + 2 * W
    want = np.asarray(want).reshape(4, sp, lh)
    for s in range(sp):
        got = halo_exchange(torch.from_numpy(toks), s, sp, W)
        np.testing.assert_array_equal(got.numpy(), want[:, s])
        zone = center_zone(lh, W, CPU).numpy()
        assert zone.sum() == L // sp and not zone[:W].any() and not zone[-W:].any()
    with pytest.raises(ValueError, match="per-shard slice length 2 < window 3"):
        halo_exchange(torch.from_numpy(toks[:, :8]), 0, 4, W)


# ------------------------------------------------------------ the steps
def _vocabs():
    counts = np.array([100 - i for i in range(V)], np.int64)
    words = [f"w{i}" for i in range(V)]
    return JVocab(words, counts.copy()), TVocab(words, counts.copy())


def _cfg(**over):
    """tests/test_parallel.py setup(): V 50, d 16, window 3, no subsample."""
    kw = dict(model="sg", train_method="ns", negative=3, word_dim=D, window=3,
              min_count=1, subsample_threshold=0)
    kw.update(over)
    return kw


_SETUP = {}


def _setup(kw):
    """(jax cfg, port cfg, jax tables, port tables) of a config, cached."""
    key = tuple(sorted(kw.items()))
    if key not in _SETUP:
        jv, tv = _vocabs()
        jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
        _SETUP[key] = (jcfg, tcfg, JTables.build(jv, jcfg),
                       TTables.build(tv, tcfg, CPU))
    return _SETUP[key]


def replica_key(key, d, s, dp, sp):
    """The key of replica (d, s) inside JAX's sharded step: fold dp, then sp."""
    if dp > 1:
        key = jax.random.fold_in(key, d)
    if sp > 1:
        key = jax.random.fold_in(key, s)
    return key


def port_step(tcfg, tt, jt, params, tokens, key, dp=1, sp=1, tp=1, alpha=ALPHA):
    """One global step of the port on [dp*B, L] tokens: one runner a
    (data, seq) replica, as ShardedTrainer builds them, each fed the JAX
    step's draws of its replica. Returns (replicas, metrics {name: [R]});
    the runners stay as port_step.runners."""
    B = tokens.shape[0] // dp
    W = tcfg.window
    ms = []
    port_step.runners = []
    for r in range(dp * sp):
        d, s = divmod(r, sp)
        runner = make_chunk_runner(tcfg, tt, tp=tp, sp=sp)
        port_step.runners.append(runner)
        runner.replica, runner.stride, runner.block = r, dp, d
        runner.fold = (d if dp > 1 else None, s if sp > 1 else None)
        rows = torch.from_numpy(tokens[d * B:(d + 1) * B])
        if sp > 1:
            rows = halo_exchange(rows, s, sp, W).contiguous()
        k = replica_key(key, d, s, dp, sp)
        runner.draws_hook = lambda step, sub, rr, k=k, shp=tuple(rows.shape): tp_.any_draws(
            runner.step, k, jt, *shp)
        m = runner(params[r], rows[None], 3, 5, np.float32([alpha]))
        ms.append({n: float(v[0]) for n, v in m.items()})
    return params, {n: np.float32([m[n] for m in ms]) for n in ms[0]}


def _replica_sum(vals):
    acc = np.float32(vals[0])
    for v in vals[1:]:
        acc = np.float32(acc + np.float32(v))
    return acc


def assert_metrics_match(tm, jm):
    """The replica sums of the port's metrics against JAX's psum'd ones:
    counts exact, loss_sum within the JAX test's rtol 1e-4 (tests/
    test_parallel.py:70: a sum of B*L*KP float32 terms, which XLA and
    torch add in other orders), the rest within rtol 1e-5."""
    assert set(jm) <= set(tm)
    for k in jm:
        got, want = _replica_sum(tm[k]), float(jm[k])
        if k in ("pairs", "clip_engaged", "nonfinite_loss", "nonfinite_params"):
            assert got == want, (k, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4 if k == "loss_sum" else 1e-5,
                                       err_msg=k)


def _jax_replicas(jout, r):
    return {k: np.asarray(v[r]) for k, v in jout.items()}


_JSTEPS = {}


def _jax_sharded(kw, dp, sp, tp, tables_fn=None):
    key = (tuple(sorted(kw.items())), dp, sp, tp, tables_fn is not None)
    if key not in _JSTEPS:
        jcfg, tcfg, jt, tt = _setup(kw)
        if tables_fn is not None:
            jt, tt = tables_fn()
        mesh = j_mesh(dp=dp, tp=tp, sp=sp)
        _JSTEPS[key] = (jcfg, tcfg, jt, tt, mesh,
                        j_sharded_step(jcfg, jt, mesh))
    return _JSTEPS[key]


def _compare_step(kw, dp, sp, tp, tokens, tables_fn=None):
    jcfg, tcfg, jt, tt, mesh, jfn = _jax_sharded(kw, dp, sp, tp, tables_fn)
    params = j_init(jcfg, V, jax.random.key(7))
    if "emb_out_hs" in params:  # nonzero, so the first step moves it
        params["emb_out_hs"] = 0.1 * jax.random.normal(
            jax.random.key(3), params["emb_out_hs"].shape)
    key = jax.random.key(42)
    jout, jm = jfn(j_replicate(params, mesh), jnp.asarray(tokens), key,
                   jnp.float32(ALPHA))
    host = params_from_numpy({k: np.asarray(v) for k, v in params.items()}, tcfg, "cpu")
    tmesh = make_mesh(dp, tp=tp, sp=sp, device="cpu")
    reps, tm = port_step(tcfg, tt, jt, replicate_params(host, tmesh), tokens, key,
                         dp=dp, sp=sp, tp=tp)
    for r in range(dp * sp):
        got = unreplicate_params([reps[r]])
        tp_.assert_params_close(got, _jax_replicas(jout, r), kw)
    assert_metrics_match(tm, jm)
    return params, host, reps, jout, tm, jm


def _tokens(rows=8, L=24, seed=0, lo=0):
    return np.random.default_rng(seed).integers(lo, V, size=(rows, L)).astype(np.int32)


@pytest.mark.parametrize("tm", ["ns", "hs"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_step_matches_jax(tp, model, tm):
    """tests/test_parallel.py:51: a tp step (each shard [V, d/tp], its
    logits summed over the shards) against JAX's sharded step of the same
    mesh and draws, the health counters and the row clip on, so every
    psum site of the route is crossed."""
    kw = _cfg(model=model, train_method=tm, negative=3 if tm == "ns" else 0,
              health_metrics=True, clip_row_update=0.05)
    _, _, reps, *_ = _compare_step(kw, 1, 1, tp, _tokens())
    shards = reps[0]
    assert len(shards) == tp
    for s in shards:
        for v in s.values():
            assert v.shape[-1] == D // tp and v.is_contiguous()


@pytest.mark.parametrize("over,gathered", [
    (dict(), True),
    (dict(table_layout="unified"), True),
    (dict(scatter_mean=True), False),
], ids=["split", "unified", "scatter_mean"])
def test_tensor_parallel_band_tail_matches_jax(over, gathered, monkeypatch):
    """tp 2 with the gathered update tail allowed on the CPU (the card's
    rule): the shards' squared norms still meet at the row clip's psum
    sites before the root, the step takes the tail the rule says (the
    trainer's band_tail counter reads the runner's step) and matches JAX's
    sharded step, the clip engaged."""
    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.ops import band_step

    rule = band_step.gathered_tail
    monkeypatch.setattr(band_step, "gathered_tail", lambda config, sr, device: rule(
        config, sr, torch.device("cuda")))
    kw = _cfg(clip_row_update=0.0001, **over)
    *_, tm, jm = _compare_step(kw, 1, 1, 2, _tokens())
    assert Trainer._band_tail(port_step.runners) is gathered
    assert float(jm["clip_engaged"]) > 0


def test_dp_times_tp_step_matches_jax():
    """tests/test_parallel.py:112 at dp 2 x tp 2, the unified slab and
    the scatter_mean counts, against JAX's step; then the mean sync of the
    JAX step's replicas is bitwise JAX's, shard by shard."""
    kw = _cfg(table_layout="unified", scatter_mean=True, health_metrics=True)
    *_, jout, _, _ = _compare_step(kw, 2, 1, 2, _tokens())
    jcfg, tcfg, _, _, mesh, _ = _jax_sharded(kw, 2, 1, 2)
    tmesh = make_mesh(2, tp=2, device="cpu")
    reps = [replicate_params(params_from_numpy(_jax_replicas(jout, r), tcfg, "cpu"),
                             make_mesh(1, tp=2, device="cpu"))[0] for r in range(2)]
    out = make_sync(tmesh)(reps)
    want = j_sync(mesh)(jout)
    for r in range(2):
        got = unreplicate_params([out[r]])
        for k in want:
            np.testing.assert_array_equal(_u32(got[k].numpy()), _u32(want[k][r]))


@pytest.mark.parametrize("route", ["band", "hs"])
def test_sequence_parallel_step_matches_jax(route):
    """sp = 2 (the haloed slices, center ownership, the seq fold of the
    draws) against JAX's sharded step at sp 2 and at dp 2 x sp 2 x tp 2."""
    over = {} if route == "band" else dict(train_method="hs", negative=0)
    kw = _cfg(max_sentence_len=24, health_metrics=True, **over)
    _compare_step(kw, 1, 2, 1, _tokens(4))
    if route == "band":
        _compare_step(kw, 2, 2, 2, _tokens(8, seed=1))


def _degenerate_tables():
    """keep-prob 1 everywhere, every negative draw word 0 (tests/
    test_parallel.py:158-169), in both packages."""
    keep = np.ones(V, np.float32)
    p = np.zeros(V)
    p[0] = 1.0
    at = build_alias_table(p)
    jt = JTables(jnp.asarray(keep), jnp.asarray(at.accept), jnp.asarray(at.alias),
                 None, None, None)
    tt = TTables(torch.from_numpy(keep), torch.from_numpy(at.accept),
                 torch.from_numpy(at.alias))
    return jt, tt


CONSERVE_KW = dict(model="sg", train_method="ns", negative=2, word_dim=D, window=1,
                   min_count=1, subsample_threshold=0.0, compute_dtype="float32",
                   shared_negatives=4, max_sentence_len=24)


@pytest.mark.parametrize("kernel", ["band", "pair"])
def test_sequence_parallel_conserves_the_single_device_update(kernel):
    """tests/test_parallel.py:173 and :284: window 1, no subsample and
    degenerate negatives pin the draws, so the SUM of the sp = 2 shards'
    deltas equals the single-device step's (1e-4), the pairs are equal,
    and each shard matches JAX's sp step (atol 1e-6)."""
    kw = dict(CONSERVE_KW, kernel=kernel)
    tokens = _tokens(4, seed=8 if kernel == "band" else 9, lo=1)
    params, host, reps, jout, tm, _ = _compare_step(
        kw, 1, 2, 1, tokens, tables_fn=_degenerate_tables)
    jcfg, tcfg, jt, tt, *_ = _jax_sharded(kw, 1, 2, 1, _degenerate_tables)
    single = {k: v.clone() for k, v in host.items()}
    runner = make_chunk_runner(tcfg, tt)
    key = jax.random.key(42)
    runner.draws_hook = lambda step, sub: tp_.any_draws(runner.step, key, jt, *tokens.shape)
    m1 = runner(single, torch.from_numpy(tokens[None]), 3, 5, np.float32([ALPHA]))
    for k in host:
        delta = (reps[0][k] - host[k]) + (reps[1][k] - host[k])
        np.testing.assert_allclose(delta.numpy(), (single[k] - host[k]).numpy(),
                                   atol=1e-4, err_msg=k)
    assert _replica_sum(tm["pairs"]) == float(m1["pairs"][0])
    np.testing.assert_allclose(_replica_sum(tm["loss_sum"]), float(m1["loss_sum"][0]),
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["mean", "delta"])
def test_sp_sync_applies_mean_of_shard_deltas(mode):
    """tests/test_parallel.py:213: the port's sync over the sp = 2
    replicas of JAX's sp step is bitwise JAX's sync of them, and applies
    1/sp of the single-device delta."""
    kw = CONSERVE_KW
    tokens = _tokens(4, seed=8, lo=1)
    params, host, reps, jout, _, _ = _compare_step(
        kw, 1, 2, 1, tokens, tables_fn=_degenerate_tables)
    jcfg, tcfg, jt, tt, mesh, _ = _jax_sharded(kw, 1, 2, 1, _degenerate_tables)
    ref_new, _ = jax.jit(j_train_step(jcfg, jt))(
        params, jnp.asarray(tokens), jax.random.key(42), jnp.float32(ALPHA))
    tmesh = make_mesh(1, sp=2, device="cpu")
    mine = [params_from_numpy(_jax_replicas(jout, r), tcfg, "cpu") for r in range(2)]
    if mode == "mean":
        want = j_sync(mesh)(jout)
        out = make_sync(tmesh)(mine)
    else:
        want = j_delta(mesh)(jout, j_replicate(params, mesh))
        out = make_delta_sync(tmesh)(mine, {k: v.clone() for k, v in host.items()})
    for k in host:
        for r in range(2):
            np.testing.assert_array_equal(_u32(out[r][k].numpy()), _u32(want[k][r]))
        ref_delta = np.asarray(ref_new[k]) - np.asarray(params[k])
        applied = out[0][k].numpy() - host[k].numpy()
        np.testing.assert_allclose(applied, ref_delta / 2,
                                   atol=1e-4 if mode == "mean" else 2e-2, err_msg=k)


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_sync_over_the_replica_axes_is_jax_bitwise(dp, sp):
    """make_sync / make_delta_sync over dp*sp replicas of tp = 2 shards
    (drifted tables) vs JAX's pmean over (data, seq), bitwise."""
    rng = np.random.default_rng(dp * 10 + sp)
    R = dp * sp
    base = rng.normal(size=(40, 8)).astype(np.float32)
    reps = base[None] + rng.normal(scale=1e-2, size=(R, 40, 8)).astype(np.float32)
    reps[:, :3] *= 1e3
    jm = j_mesh(dp=dp, tp=2, sp=sp)
    tm = make_mesh(dp, tp=2, sp=sp, device="cpu")
    for mode in ("mean", "delta"):
        jparams = {"emb_in": jnp.asarray(reps)}
        mine = [replicate_params({"emb_in": torch.from_numpy(reps[r].copy())},
                                 make_mesh(1, tp=2, device="cpu"))[0] for r in range(R)]
        if mode == "mean":
            want = j_sync(jm)(jparams)
            got = make_sync(tm)(mine)
        else:
            want = j_delta(jm)(jparams, j_replicate({"emb_in": base}, jm))
            tbase = replicate_params({"emb_in": torch.from_numpy(base.copy())},
                                     make_mesh(1, tp=2, device="cpu"))[0]
            got = make_delta_sync(tm)(mine, tbase)
        w = np.asarray(want["emb_in"])
        for r in range(R):
            full = unreplicate_params([got[r]])["emb_in"].numpy()
            np.testing.assert_array_equal(_u32(full), _u32(w[r]))


# ---------------------------------------------------- mesh and refusals
def test_mesh_order_and_shape():
    """(d, s, t) on devices[(d*sp + s)*tp + t], the model axis innermost
    (word2vec_tpu/parallel/mesh.py:36-61); the JAX shape message."""
    devs = [f"cpu:{i}" for i in range(8)]
    m = make_mesh(2, tp=2, sp=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "seq": 2, "model": 2} and m.replicas == 4
    jm = j_mesh(dp=2, tp=2, sp=2)
    assert dict(jm.shape) == m.shape
    grid = np.arange(8).reshape(2, 2, 2)
    for d in range(2):
        for s in range(2):
            r = d * 2 + s
            assert [r * 2 + t for t in range(2)] == list(grid[d, s])
    del devs
    with pytest.raises(ValueError, match=r"mesh \(2x2x3\) needs 12 devices, have 8"):
        make_mesh(2, tp=3, sp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"mesh \(2x2x3\) needs 12 devices, have 8"):
        j_mesh(dp=2, tp=3, sp=2)


def test_trainer_refusals_carry_the_jax_messages():
    """tests/test_parallel.py:147 and :338, and JAX's _reject_pallas
    under the model and seq axes (parallel/trainer.py:121-138)."""
    vocab = TVocab([f"w{i}" for i in range(10)], np.full(10, 5, np.int64))
    from word2vec_tpu_torch import PackedCorpus

    corpus = PackedCorpus.pack([np.arange(10, dtype=np.int32)], 16)
    mk = lambda **kw: Word2VecConfig(**dict(dict(negative=2, word_dim=8, min_count=1,  # noqa: E731
                                                 max_sentence_len=16), **kw))
    with pytest.raises(ValueError, match="word_dim 10 not divisible by tp=4"):
        ShardedTrainer(mk(word_dim=10), vocab, corpus, tp=4, device="cpu")
    with pytest.raises(ValueError, match="max_sentence_len 15 not divisible by sp=2"):
        ShardedTrainer(mk(max_sentence_len=15), vocab, corpus, sp=2, device="cpu")
    with pytest.raises(ValueError, match="shorter than window"):
        ShardedTrainer(mk(max_sentence_len=8, window=3), vocab, corpus, sp=4,
                       device="cpu")
    with pytest.raises(ValueError, match="scatter_mean"):
        ShardedTrainer(mk(scatter_mean=True), vocab, corpus, sp=2, device="cpu")
    for backend, layout in (("pallas", "split"), ("pallas_oa", "split"),
                            ("pallas_fused", "unified")):
        for axes in (dict(tp=2), dict(sp=2)):
            with pytest.raises(ValueError, match=(
                    rf"band_backend='{backend}' is single-chip only.*"
                    r"Use band_backend='xla' for sharded training")):
                ShardedTrainer(mk(band_backend=backend, table_layout=layout,
                                  band_chunk=8, window=2), vocab, corpus,
                               device="cpu", **axes)
    # at tp = sp = 1 every route still trains under dp (ROADMAP C10)
    ShardedTrainer(mk(band_backend="pallas", band_chunk=8, window=2), vocab, corpus,
                   dp=2, device="cpu")
    with pytest.raises(ValueError, match=r"\(tp, sp\) = \(2, 1\) mesh"):
        BandStep(mk(band_backend="pallas_oa", band_chunk=8, window=2),
                 TTables.build(vocab, mk(), CPU), tp=2)


def test_planner_constraints_shapes_and_grid():
    """plan_constraints / plan_shapes equal the JAX trainer's under the
    model and seq axes (parallel/trainer.py:912-940), and the planner's
    grid under allow_pallas False drops the kernel routes, as JAX's does."""
    from word2vec_tpu.parallel import ShardedTrainer as JSharded
    from word2vec_tpu.tune.planner import candidate_grid as j_grid
    from word2vec_tpu_torch.tune.planner import candidate_grid

    vocab, corpus = tp_.small_corpus(2350)
    cfg = tp_.trainer_cfg(chunk_steps=8, dp_sync_every=6)
    tr = ShardedTrainer(cfg, vocab, corpus, dp=2, tp=2, sp=2, device="cpu")
    jv = JVocab(list(vocab.words), vocab.counts.copy())
    from word2vec_tpu.data.batcher import PackedCorpus as JCorpus

    jc = JCorpus(corpus.flat.copy(), corpus.row_starts.copy(), corpus.row_lens.copy())
    jkw = {k: getattr(cfg, k) for k in (
        "model", "train_method", "negative", "word_dim", "window", "min_count",
        "subsample_threshold", "iters", "batch_rows", "max_sentence_len",
        "band_chunk", "shared_negatives", "seed", "chunk_steps", "dp_sync_every")}
    jtr = JSharded(JConfig(**jkw), jv, jc, dp=2, tp=2, sp=2)
    c, jc_ = tr.plan_constraints(), jtr.plan_constraints()
    assert {k: c[k] for k in jc_} == jc_ and c["allow_pallas"] is False
    sh, jsh = tr.plan_shapes(), jtr.plan_shapes()
    for k in ("dp", "sp", "tp", "rows_per_dispatch", "cols_per_shard", "dim_per_shard",
              "chunk_len"):
        assert sh[k] == jsh[k], k
    assert (sh["cols_per_shard"], sh["dim_per_shard"]) == (12, 8)
    grid = candidate_grid(tr.config, len(vocab), dict(c, platform="gpu"))
    assert {p.band_backend for p in grid} == {"xla"}
    jgrid = j_grid(jtr.config, len(vocab), dict(jc_, platform="tpu"))
    assert {p.band_backend for p in jgrid} == {"xla"}
    one = ShardedTrainer(cfg, vocab, corpus, dp=2, device="cpu").plan_constraints()
    assert one["allow_pallas"] is True
