"""The port's resilience (word2vec_tpu_torch/resilience/supervisor.py,
io/checkpoint.py's validate= / quarantine= and its ckpt_oserror injection
point, the trainer's fault hook, the CLI's --auto-recover / --faults)
against the JAX package, on the CPU.

Pins:
  * the loader's cases of tests/test_resilience.py::TestCheckpointDurability
    — a truncated state.npz, a silent bit flip, a checkpoint without a
    manifest, a missing dir, a NaN checkpoint under the finite-params
    validator, quarantine on and off — give the same step, the same
    quarantine and the same error in both packages on copies of one
    directory; the save's ckpt_oserror retries land (or surface) alike;
  * the three supervisor tests of tests/test_resilience.py on the port's
    Trainer (per-step and chunk_steps=4) beside the JAX Trainer: the same
    auto_recover records, finite tables;
  * a recovery rolls back into the trainer's buffers: the same runners and
    step graphs, no new one made;
  * the CLI: --auto-recover gives the JAX CLI's manifest recoveries; a bad
    --faults spec exits 1 with the JAX message; sigterm@k exits 75 and the
    resume ends bitwise equal to the uninterrupted run.
"""

import contextlib
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from word2vec_tpu.cli import main as jmain  # noqa: E402
from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.io import checkpoint as jck  # noqa: E402
from word2vec_tpu.obs.health import DivergenceError as JDivergence  # noqa: E402
from word2vec_tpu.resilience import faults as jfaults  # noqa: E402
from word2vec_tpu.resilience.supervisor import (  # noqa: E402
    Supervisor as JSupervisor,
    validate_finite_params as j_finite,
)
from word2vec_tpu.train import Trainer as JTrainer, TrainState as JState  # noqa: E402
from word2vec_tpu.utils.synthetic import (  # noqa: E402
    zipf_corpus_ids as j_ids, zipf_vocab as j_vocab,
)

from word2vec_tpu_torch import Word2VecConfig, resilience  # noqa: E402
from word2vec_tpu_torch.cli import main as tmain  # noqa: E402
from word2vec_tpu_torch.data.batcher import PackedCorpus  # noqa: E402
from word2vec_tpu_torch.io import checkpoint as tck  # noqa: E402
from word2vec_tpu_torch.obs.health import DivergenceError  # noqa: E402
from word2vec_tpu_torch.ops import graphs, resident  # noqa: E402
from word2vec_tpu_torch.resilience import faults as tfaults  # noqa: E402
from word2vec_tpu_torch.resilience.shutdown import EXIT_PREEMPTED  # noqa: E402
from word2vec_tpu_torch.resilience.supervisor import (  # noqa: E402
    Supervisor, validate_finite_params,
)
from word2vec_tpu_torch.train import Trainer, TrainState  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

#: tests/test_resilience.py's _setup: a 40-word Zipf vocabulary, 3,000
#: tokens packed at L=16, B=4 (47 steps an epoch)
CFG = dict(model="sg", train_method="ns", negative=3, word_dim=16, window=2,
           batch_rows=4, max_sentence_len=16, min_count=1, seed=9)


def _both(**kw):
    """(port trainer, JAX trainer) on the same config and corpus."""
    kw.setdefault("iters", 3)
    tv = zipf_vocab(40, 4000)
    jv = j_vocab(40, 4000)
    tc = PackedCorpus.pack(zipf_corpus_ids(tv, 3000, seed=5), 16)
    jc = JCorpus.pack(j_ids(jv, 3000, seed=5), 16)
    t = Trainer(Word2VecConfig(**CFG, **kw), tv, tc, device="cpu")
    j = JTrainer(JConfig(**CFG, **kw), jv, jc)
    return t, j


def _finite(params):
    return all(bool(torch.isfinite(v.float()).all()) for v in params.values())


# ---------------------------------------------------- checkpoint durability
def _tables(seed=0, nan=False):
    r = np.random.default_rng(seed)
    out = {k: r.normal(size=(40, 16)).astype(np.float32)
           for k in ("emb_in", "emb_out_ns")}
    if nan:
        out["emb_in"][3, 5] = np.nan
    return out


def _save_pair(root, steps, nan_last=False, keep=1):
    """The same checkpoint chain written by the port's saver into
    root/t/ck and copied to root/j/ck for the JAX loader."""
    cfg = Word2VecConfig(**CFG, iters=3)
    ck = os.path.join(root, "t", "ck")
    for i, step in enumerate(steps):
        nan = nan_last and i == len(steps) - 1
        params = {k: torch.from_numpy(v) for k, v in _tables(i, nan).items()}
        tck.save_checkpoint(ck, TrainState(params, step=step), cfg, keep=keep)
    shutil.copytree(os.path.join(root, "t"), os.path.join(root, "j"))
    return ck, os.path.join(root, "j", "ck")


def _truncate(ck):
    with open(os.path.join(ck, "state.npz"), "r+b") as f:
        f.truncate(64)


def _bitflip(ck):
    p = os.path.join(ck, "config.json")
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))


def _no_manifest(ck):
    os.remove(os.path.join(ck, "integrity.json"))


#: (steps saved, NaN in the last, damage, load kwargs (port, JAX))
LOAD_CASES = {
    "truncated_npz_falls_back_to_old": ([1, 2], False, _truncate, {}),
    "silent_bitflip_no_backup": ([3], False, _bitflip, {}),
    "legacy_without_manifest": ([5], False, _no_manifest, {}),
    "nan_rejected_by_validator": ([1, 2], True, None, {"validate": True}),
    "nan_loads_without_validator": ([1, 2], True, None, {}),
    "no_quarantine_keeps_the_dir": ([1, 2], True, None,
                                    {"validate": True, "quarantine": False}),
    "no_fallback": ([1, 2], False, _truncate, {"fallback": False}),
    "missing_dir": ([1], False, shutil.rmtree, {}),
}


def _load(mod, ck, validate=False, **kw):
    """(step, the dirs left, the error) of one load."""
    if validate:
        kw["validate"] = validate_finite_params if mod is tck else j_finite
    try:
        with _quiet():
            st, _, _ = mod.load_checkpoint(ck, **kw)
        out = ("loaded", st.step)
    except mod.CheckpointError as e:
        out = ("error", str(e).replace(os.path.dirname(ck), "ROOT"))
    return out, sorted(os.listdir(os.path.dirname(ck)))


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_cases_match_jax_loader(tmp_path, case):
    steps, nan_last, damage, kw = LOAD_CASES[case]
    tdir, jdir = _save_pair(str(tmp_path), steps, nan_last)
    if damage is not None:
        damage(tdir)
        damage(jdir)
    t_out = _load(tck, tdir, **kw)
    j_out = _load(jck, jdir, **kw)
    assert t_out == j_out
    expected = {
        "truncated_npz_falls_back_to_old": ("loaded", 1),
        "silent_bitflip_no_backup": ("error",),
        "legacy_without_manifest": ("loaded", 5),
        "nan_rejected_by_validator": ("loaded", 1),
        "nan_loads_without_validator": ("loaded", 2),
        "no_quarantine_keeps_the_dir": ("loaded", 1),
        "no_fallback": ("error",),
        "missing_dir": ("error",),
    }[case]
    assert t_out[0][:len(expected)] == expected
    quarantined = any(n.startswith("ck.corrupt") for n in t_out[1])
    assert quarantined == (case in ("truncated_npz_falls_back_to_old",
                                    "silent_bitflip_no_backup",
                                    "nan_rejected_by_validator",
                                    "no_fallback"))


def _step(state, step):
    return type(state)(state.params, step=step)


@pytest.mark.parametrize("times, lands", [(2, True), (10, False)])
def test_ckpt_oserror_retries_like_jax(tmp_path, times, lands):
    """The save's injection point: fewer failures than retries land the
    checkpoint with a retry warning, more surface the OSError; the
    landed checkpoint is never touched by a failed save."""
    tcfg, jcfg = Word2VecConfig(**CFG), JConfig(**CFG)
    tab = _tables()
    outcomes = []
    for mod, fmod, cfg, state in (
        (tck, tfaults, tcfg,
         TrainState({k: torch.from_numpy(v) for k, v in tab.items()}, step=4)),
        (jck, jfaults, jcfg,
         JState({k: jnp.asarray(v) for k, v in tab.items()}, step=4)),
    ):
        ck = str(tmp_path / mod.__name__.split(".")[0] / "ck")
        mod.save_checkpoint(ck, _step(state, 1), cfg, backoff=0.001)
        prev = fmod.activate(fmod.FaultPlan([fmod.Fault("ckpt_oserror", times=times)]))
        try:
            with pytest.warns(UserWarning, match="retry"):
                if lands:
                    mod.save_checkpoint(ck, state, cfg, backoff=0.001)
                else:
                    with pytest.raises(OSError, match="injected"):
                        mod.save_checkpoint(ck, state, cfg, backoff=0.001)
            log = fmod.active().log
        finally:
            fmod.activate(prev)
        outcomes.append((mod.load_checkpoint(ck)[0].step, len(log)))
    assert outcomes[0] == outcomes[1] == ((4, 2) if lands else (1, 4))


# ---------------------------------------------------- supervised recovery
def _records(recs):
    return [dict(r) for r in recs]


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_supervisor_recovers_like_jax(tmp_path, chunk_steps):
    """tests/test_resilience.py::test_supervisor_recovers_from_injected_nan
    on both trainers: the same auto_recover record, finite tables, the
    rescaled alpha and the advanced seed on the live trainer."""
    t, j = _both(divergence_budget=3, chunk_steps=chunk_steps)
    recs, states = [], []
    for tr, fmod, mod, sup_cls in ((t, tfaults, tck, Supervisor),
                                   (j, jfaults, jck, JSupervisor)):
        ck = str(tmp_path / type(tr).__module__.split(".")[0] / "ck")
        tr.fault_plan = fmod.FaultPlan.parse("nan@12")

        def cb(s, tr=tr, ck=ck, mod=mod):
            mod.save_checkpoint(ck, s, tr.config, tr.vocab, keep=2)

        sup = sup_cls(tr, checkpoint_dir=ck, max_retries=2, alpha_scale=0.5)
        with _quiet():
            st, rep = sup.run(log_every=0, checkpoint_cb=cb, checkpoint_every=4)
        assert len(rep.recoveries) == 1 and np.isfinite(rep.final_loss)
        assert tr.config.init_alpha == pytest.approx(0.025 * 0.5)
        assert tr.config.seed == CFG["seed"] + 1
        recs.append(_records(rep.recoveries))
        states.append(st)
    assert recs[0] == recs[1]
    rec = recs[0][0]
    assert rec["rolled_back_to"].startswith("step")
    assert rec["resume_step"] < rec["failed_step"]
    assert _finite(states[0].params)


def test_supervisor_gives_up_like_jax(tmp_path):
    t, j = _both(divergence_budget=2)
    recs = []
    for tr, fmod, err in ((t, tfaults, DivergenceError), (j, jfaults, JDivergence)):
        tr.fault_plan = fmod.FaultPlan([fmod.Fault("nan", step=4, times=100)])
        sup = (Supervisor if tr is t else JSupervisor)(
            tr, checkpoint_dir=str(tmp_path / "none"), max_retries=2)
        with _quiet(), pytest.raises(err):
            sup.run(log_every=0)
        recs.append(_records(sup.recoveries))
    assert len(recs[0]) == 2 and recs[0] == recs[1]


def test_supervisor_without_checkpoint_restarts_fresh_like_jax():
    t, j = _both(divergence_budget=2, iters=1)
    recs, states = [], []
    for tr, fmod in ((t, tfaults), (j, jfaults)):
        tr.fault_plan = fmod.FaultPlan.parse("nan@3")
        sup = (Supervisor if tr is t else JSupervisor)(
            tr, checkpoint_dir=None, max_retries=1)
        with _quiet():
            st, rep = sup.run(log_every=0)
        assert np.isfinite(rep.final_loss)
        recs.append(_records(rep.recoveries))
        states.append(st)
    assert recs[0] == recs[1]
    assert recs[0][0]["rolled_back_to"] == "fresh init"
    assert recs[0][0]["resume_step"] == 0
    assert _finite(states[0].params)


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_recovery_reuses_the_runners_and_graphs(tmp_path, monkeypatch,
                                                chunk_steps):
    """The rollback lands in the trainer's persistent buffers: the same
    runner objects, the same step graphs over the same tensors, and no
    step graph made after the first dispatch."""
    made = []

    class Counted(graphs.StepGraph):
        def __init__(self, *a, **k):
            made.append(self)
            super().__init__(*a, **k)

    monkeypatch.setattr(graphs, "StepGraph", Counted)
    monkeypatch.setattr(resident, "StepGraph", Counted)
    t, _ = _both(divergence_budget=3, chunk_steps=chunk_steps)
    ck = str(tmp_path / "ck")
    t.fault_plan = tfaults.FaultPlan.parse("nan@12")
    seen = {}

    class Watch(Supervisor):
        def _recover(self, err, attempt):
            seen["runners"] = dict(t._runners)
            seen["buffers"] = {k: v.data_ptr() for k, v in t._params.items()}
            seen["made"] = len(made)
            return super()._recover(err, attempt)

    sup = Watch(t, checkpoint_dir=ck, max_retries=2)
    with _quiet():
        st, rep = sup.run(
            log_every=0, checkpoint_every=4,
            checkpoint_cb=lambda s: tck.save_checkpoint(ck, s, t.config, keep=2),
        )
    assert rep.recoveries and seen["made"] == len(made) == 1
    assert t._runners.keys() == seen["runners"].keys()
    assert all(t._runners[k] is r for k, r in seen["runners"].items())
    assert {k: v.data_ptr() for k, v in t._params.items()} == seen["buffers"]
    assert _finite(st.params)


def test_lazy_names_point_at_the_port():
    from word2vec_tpu_torch.resilience import watchdog

    assert resilience.Supervisor is Supervisor
    assert resilience.StepWatchdog is watchdog.StepWatchdog
    assert resilience.EXIT_STALLED == watchdog.EXIT_STALLED == 76


# ------------------------------------------------------------- CLI chaos
@pytest.fixture
def corpus_file(tmp_path):
    rng = np.random.default_rng(0)
    toks = []
    for _ in range(400):
        toks += ["x", str(rng.choice(["a", "b"])), "y",
                 "p", str(rng.choice(["c", "d"])), "q"]
    p = tmp_path / "corpus.txt"
    p.write_text(" ".join(toks))
    return str(p)


def _common(corpus_file):
    return ["-train", corpus_file, "-size", "8", "-negative", "2",
            "-min-count", "1", "--backend", "cpu", "--batch-rows", "4",
            "--max-sentence-len", "32", "--quiet"]


def test_cli_auto_recover_manifest_matches_jax(tmp_path, corpus_file):
    mans = {}
    for pkg, main in (("t", tmain), ("j", jmain)):
        mdir = str(tmp_path / (pkg + "m"))
        with _quiet():
            rc = main(_common(corpus_file) + [
                "-output", str(tmp_path / (pkg + "v.txt")), "-iter", "2",
                "--seed", "3", "--checkpoint-dir", str(tmp_path / (pkg + "ck")),
                "--checkpoint-every", "4", "--divergence-budget", "3",
                "--auto-recover", "2", "--faults", "nan@12",
                "--metrics-dir", mdir,
            ])
        assert rc == 0
        mans[pkg] = json.load(open(os.path.join(mdir, "manifest.json")))
    assert mans["t"]["shutdown"] == mans["j"]["shutdown"] == "clean"
    assert len(mans["t"]["recoveries"]) == 1
    assert mans["t"]["recoveries"] == mans["j"]["recoveries"]
    from word2vec_tpu_torch.io.embeddings import load_word2vec

    _, M = load_word2vec(str(tmp_path / "tv.txt"))
    assert np.all(np.isfinite(M))


def test_cli_bad_faults_spec_like_jax(corpus_file, capsys):
    errs = []
    for main in (tmain, jmain):
        assert main(_common(corpus_file) + ["--faults", "bogus@2"]) == 1
        errs.append(capsys.readouterr().err)
    assert "bad --faults spec" in errs[0] and errs[0] == errs[1]


def test_cli_sigterm_preempt_then_resume_bitwise(tmp_path, corpus_file):
    common = _common(corpus_file)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    ck, mdir = str(tmp_path / "ck"), str(tmp_path / "m")
    with _quiet():
        assert tmain(common + ["-output", a, "-iter", "3", "--seed", "3"]) == 0
        rc = tmain(common + [
            "-output", b, "-iter", "3", "--seed", "3", "--checkpoint-dir", ck,
            "--checkpoint-every", "5", "--faults", "sigterm@20",
            "--metrics-dir", mdir,
        ])
        assert rc == EXIT_PREEMPTED
        assert not os.path.exists(b)
        man = json.load(open(os.path.join(mdir, "manifest.json")))
        assert man["shutdown"] == "preempted"
        assert tmain(common + ["-output", b, "--resume", ck]) == 0
    assert open(a).read() == open(b).read()
