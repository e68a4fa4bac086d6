"""The port CLI's planner flags (--autotune, --plan-cache) on --backend cpu,
against the JAX CLI's behavior: the `autotune (...)` line in the JAX
CLI's format, the plan-applied config in the checkpoint and the manifest,
the manifest's cost_calibrate block with the JAX CLI's keys, and a JAX
checkpoint whose config has autotune set resuming through both CLIs with
the same plan."""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from word2vec_tpu.io import checkpoint as jck  # noqa: E402
from word2vec_tpu.tune import cache as jcache  # noqa: E402
from word2vec_tpu.tune import cost_model as jcm  # noqa: E402

from word2vec_tpu_torch.cli import main as run  # noqa: E402
from word2vec_tpu_torch.io.checkpoint import load_checkpoint  # noqa: E402
from word2vec_tpu_torch.tune.planner import TunePlan  # noqa: E402

WORDS = 300


@pytest.fixture
def zipf_file(tmp_path):
    rng = np.random.default_rng(3)
    p = 1.0 / np.arange(1, WORDS + 1)
    p /= p.sum()
    path = tmp_path / "zipf.txt"
    path.write_text(" ".join(rng.choice([f"t{i}" for i in range(WORDS)],
                                        20000, p=p)))
    return str(path)


def flags(corpus):
    return ["-train", corpus, "-output", "", "-size", "8", "-negative", "3",
            "-min-count", "2", "-iter", "1", "--backend", "cpu",
            "--max-sentence-len", "64"]


def autotune_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("autotune (")]


def test_autotune_line_and_the_plan_applied_config(tmp_path, zipf_file, capsys):
    cache = str(tmp_path / "plans.json")
    ck, mdir = str(tmp_path / "ck"), str(tmp_path / "m")
    assert run(flags(zipf_file) + ["--autotune", "probe", "--plan-cache", cache]) == 0
    probed = autotune_lines(capsys.readouterr().out)
    doc = json.load(open(cache))
    (key, entry), = doc["plans"].items()
    vocab_size = int(key.split("|")[3][1:])
    # the JAX package's key for the same run on the same host
    assert key == jcache.plan_key("cpu", "cpu", "band-ns", vocab_size, 8,
                                  "split", 64, "xla")
    plan = TunePlan.from_json(entry["plan"])
    assert probed == [f"autotune (probed, key {key}): {plan.to_json()}"]

    assert run(flags(zipf_file) + [
        "--autotune", "cached", "--plan-cache", cache, "--checkpoint-dir", ck,
        "--metrics-dir", mdir, "--health-metrics", "0"]) == 0
    # the JAX CLI's line (word2vec_tpu/cli.py:1213-1218)
    assert autotune_lines(capsys.readouterr().out) == [
        f"autotune (cache hit, key {key}): {plan.to_json()}"]

    _, cfg, _ = load_checkpoint(ck)
    assert cfg.current_plan() == plan and cfg.autotune == "off"
    assert cfg.plan_cache == cache
    _, jcfg, _ = jck.load_checkpoint(ck)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    man = json.load(open(os.path.join(mdir, "manifest.json")))
    assert (man["plan_source"], man["plan_key"], man["plan_probes"]) == (
        "cache", key, 0)
    assert man["plan"] == plan.to_json()
    assert man["config"]["autotune"] == "off"
    assert man["plan_predicted"] == entry["predicted"]
    # cost_calibrate as the JAX CLI banks it (word2vec_tpu/cli.py:2160-2180)
    cal = man["cost_calibrate"]
    est = jcm.predict(jcfg, vocab_size, "cpu", "cpu")
    ref = jcm.cost_calibrate(est, cal["measured_device_ms"])
    assert sorted(cal) == sorted(ref)
    assert [r["anchor"] for r in cal["anchors"]] == [
        r["anchor"] for r in ref["anchors"]]
    for got, want in zip(cal["anchors"], ref["anchors"]):
        assert sorted(got) == sorted(want)
        assert got["count"] == want["count"]
    assert cal["measured_device_ms"] > 0


def test_jax_checkpoint_with_autotune_resumes_as_the_jax_cli(
        tmp_path, zipf_file, capsys):
    """A JAX-written checkpoint whose config carries autotune='cached' and a
    plan cache: its config is authoritative on --resume, so both CLIs
    resolve the plan from that cache and print the same line."""
    from word2vec_tpu.cli import main as jax_run

    cache = str(tmp_path / "plans.json")
    ck0, jpath = str(tmp_path / "ck0"), str(tmp_path / "jck")
    assert run(flags(zipf_file) + ["--checkpoint-dir", ck0, "--quiet"]) == 0
    # a search of the same problem fills the cache the checkpoint names
    assert run(flags(zipf_file) + ["--quiet", "--autotune", "probe",
                                   "--plan-cache", cache]) == 0
    (key,) = json.load(open(cache))["plans"]
    jstate, jcfg, jv = jck.load_checkpoint(ck0)
    jck.save_checkpoint(jpath, jstate, dataclasses.replace(
        jcfg, autotune="cached", plan_cache=cache), jv)
    capsys.readouterr()

    resume = flags(zipf_file) + ["--resume", jpath]
    assert run(resume + ["--checkpoint-dir", str(tmp_path / "t1")]) == 0
    cap = capsys.readouterr()
    ours = autotune_lines(cap.out)
    assert "resetting config fields" not in cap.err
    assert jax_run(resume + ["--checkpoint-dir", str(tmp_path / "j1")]) == 0
    theirs = autotune_lines(capsys.readouterr().out)
    assert ours == theirs and len(ours) == 1
    assert ours[0].startswith(f"autotune (cache hit, key {key}): ")
    _, t1, _ = load_checkpoint(str(tmp_path / "t1"))
    _, j1, _ = jck.load_checkpoint(str(tmp_path / "j1"))
    assert t1.autotune == j1.autotune == "off"
    assert dataclasses.asdict(t1) == dataclasses.asdict(j1)
