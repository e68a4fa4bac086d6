"""The port's CLI under data parallelism (--dp, --dp-sync-every,
--sync-mode) on --backend cpu, after tests/test_cli.py:106-132 at tp = 1:

  * --dp 2 trains, checkpoints the synced, unreplicated [V, d] tables and
    exports vectors; the manifest and the mesh record say mesh_size 2;
  * a single-device run resumes a --dp 2 checkpoint and a --dp 2 run
    resumes a single-device one; a --dp 2 checkpoint of the JAX CLI
    resumes in the port and a port --dp 2 checkpoint in the JAX CLI;
  * a --dp 2 run cut by a stop on a sync boundary (exit 75) and resumed
    ends BITWISE on the uninterrupted run, mean and delta sync;
  * the flags' defaults, types and choices are the JAX CLI's.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu_torch.cli import build_parser, main as cli  # noqa: E402
from word2vec_tpu_torch.io import checkpoint as ck  # noqa: E402
from word2vec_tpu_torch.resilience import shutdown  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs 2 (virtual) devices"
)


@pytest.fixture(scope="module")
def zipf_file(tmp_path_factory):
    rng = np.random.default_rng(1)
    p = 1.0 / np.arange(1, 121)
    p /= p.sum()
    toks = rng.choice([f"w{i}" for i in range(120)], 12000, p=p)
    path = tmp_path_factory.mktemp("corpus") / "zipf.txt"
    path.write_text(" ".join(toks))
    return str(path)


def _common(zipf_file, *extra):
    return ["-train", zipf_file, "-output", "", "-size", "16", "-window", "2",
            "-negative", "3", "-iter", "2", "-min-count", "1",
            "-subsample", "0", "--backend", "cpu", "--batch-rows", "4",
            "--max-sentence-len", "64", "--quiet", *extra]


def _state(path):
    state, cfg, _ = ck.load_checkpoint(path, fallback=False)
    return state, cfg


def test_dp2_trains_checkpoints_and_exports(tmp_path, zipf_file):
    out, ckd, mdir = (str(tmp_path / n) for n in ("vec.txt", "ck", "m"))
    args = _common(zipf_file, "--dp", "2", "--dp-sync-every", "8",
                   "--chunk-steps", "3", "--checkpoint-dir", ckd,
                   "--metrics-dir", mdir, "--quality-probe-every", "0")
    args[args.index("-output") + 1] = out
    assert cli(args) == 0
    state, cfg = _state(ckd)
    assert cfg.dp_sync_every == 8 and cfg.sync_mode == "mean"
    for v in state.params.values():
        assert v.dim() == 2 and bool(torch.isfinite(v).all())
    with open(out) as f:
        n, d = map(int, f.readline().split())
    assert (n, d) == (state.params["emb_in"].shape[0], 16)
    with open(os.path.join(mdir, "manifest.json")) as f:
        assert json.load(f)["mesh_size"] == 2
    with open(os.path.join(mdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert any(r.get("event") == "mesh" and r["mesh_size"] == 2 for r in recs)


def _mid(path):
    """The last periodic checkpoint of a --checkpoint-every run (.old)."""
    state, cfg = _state(path + ".old")
    assert 0 < state.step and cfg.iters == 2
    return path + ".old", state


def test_checkpoints_move_between_dp_and_single_device(tmp_path, zipf_file):
    """Each run's mid-run checkpoint (2-D tables) resumes in the other
    geometry; the step counter is in the trainer's unit (global steps at
    dp 2: ceil(batches / 2) an epoch), so a resume across geometries
    restarts its epoch, as in the JAX trainer."""
    dp_ck, one_ck = str(tmp_path / "dp"), str(tmp_path / "one")
    every = ["--checkpoint-every", "5"]
    assert cli(_common(zipf_file, "--dp", "2", "--checkpoint-dir", dp_ck, *every)) == 0
    assert cli(_common(zipf_file, "--checkpoint-dir", one_ck, *every)) == 0
    s_dp, _ = _state(dp_ck)
    s_one, _ = _state(one_ck)
    batches = s_one.step // 2  # a single-device epoch, two epochs run
    assert s_dp.step == 2 * -(-batches // 2)
    for src, extra in ((dp_ck, ()), (one_ck, ("--dp", "2"))):
        mid, before = _mid(src)
        assert all(v.dim() == 2 for v in before.params.values())
        again = str(tmp_path / f"again_{os.path.basename(src)}")
        assert cli(_common(zipf_file, "--resume", mid, "--checkpoint-dir", again,
                           *extra)) == 0
        after, _ = _state(again)
        assert after.epoch == 2 and after.step > before.step
        assert all(v.dim() == 2 for v in after.params.values())


def test_jax_and_port_dp2_checkpoints_resume_in_each_other(tmp_path, zipf_file):
    """tests/test_cli.py:106-132 at tp = 1, across the packages: a mid-run
    checkpoint of each package's --dp 2 run resumes in the other."""
    from word2vec_tpu.cli import main as jcli
    from word2vec_tpu.io.checkpoint import load_checkpoint as jload

    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    every = ["--dp", "2", "--checkpoint-every", "5"]
    assert jcli(_common(zipf_file, "--checkpoint-dir", jck, *every)) == 0
    assert cli(_common(zipf_file, "--checkpoint-dir", tck, *every)) == 0
    (jmid, js), (tmid, ts) = _mid(jck), _mid(tck)
    assert js.step == ts.step and js.epoch == ts.epoch
    end = _state(tck)[0].step
    port_from_jax, jax_from_port = str(tmp_path / "p"), str(tmp_path / "j")
    assert cli(_common(zipf_file, "--dp", "2", "--resume", jmid,
                       "--checkpoint-dir", port_from_jax)) == 0
    assert jcli(_common(zipf_file, "--dp", "2", "--resume", tmid,
                        "--checkpoint-dir", jax_from_port)) == 0
    a = _state(port_from_jax)[0]
    b, _, _ = jload(jax_from_port)
    assert a.step == b.step == end and a.epoch == b.epoch == 2
    assert np.asarray(b.params["emb_in"]).ndim == 2 and a.params["emb_in"].dim() == 2


@pytest.mark.parametrize("mode,chunk", [("mean", "1"), ("delta", "4")])
def test_cut_dp2_run_resumes_bitwise(tmp_path, zipf_file, monkeypatch, mode, chunk):
    common = _common(zipf_file, "--dp", "2", "--dp-sync-every", "4",
                     "--sync-mode", mode, "--chunk-steps", chunk)
    full = str(tmp_path / "full")
    assert cli(common + ["--checkpoint-dir", full]) == 0
    cut_at = 8  # a sync boundary and a chunk boundary, mid-epoch
    monkeypatch.setattr(shutdown.ShutdownHandler, "make_stop_check",
                        lambda self: lambda step: step >= cut_at)
    cut = str(tmp_path / "cut")
    assert cli(common + ["--checkpoint-dir", cut]) == shutdown.EXIT_PREEMPTED
    mid, _ = _state(cut)
    assert mid.step == cut_at and mid.epoch == 0
    monkeypatch.undo()
    assert cli(common + ["--checkpoint-dir", cut, "--resume", cut]) == 0
    (a, _), (b, _) = _state(full), _state(cut)
    assert (a.step, a.words_done, a.epoch) == (b.step, b.words_done, b.epoch)
    for k in a.params:
        assert torch.equal(a.params[k].view(torch.int32), b.params[k].view(torch.int32)), k


def test_dp_flags_match_the_jax_cli():
    from word2vec_tpu.cli import build_parser as jparser

    mine, theirs = build_parser(), jparser()
    for flag in ("--dp", "--dp-sync-every", "--sync-mode"):
        a = next(x for x in mine._actions if flag in x.option_strings)
        b = next(x for x in theirs._actions if flag in x.option_strings)
        assert (a.default, a.type, a.choices) == (b.default, b.type, b.choices), flag


def test_dp_on_the_card_refuses_more_replicas_than_cards(zipf_file, capsys):
    """--backend gpu places one replica a visible card: without a card it
    raises as every entry point does; with n cards --dp n+1 is refused
    with the mesh's message (exit 1)."""
    n = torch.cuda.device_count()
    args = _common(zipf_file, "--dp", str(n + 1))
    args[args.index("--backend") + 1] = "gpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(args)
        return
    assert cli(args) == 1
    assert f"mesh ({n + 1}x1x1) needs {n + 1} devices, have {n}" in capsys.readouterr().err
