"""The port's CLI under tensor and sequence parallelism (--tp, --sp) on
--backend cpu, after tests/test_cli.py at the JAX CLI's mesh flags:

  * --tp 2 --sp 2 trains, exports [V, d] vectors with the JAX CLI's
    header (the same shape as the JAX CLI's run of the same flags), and
    writes the manifest's mesh keys (mesh_size, dp, sp, tp, the mesh
    record); its checkpoint holds the unreplicated [V, d] tables;
  * --tp 2 with a Pallas band backend exits 1 with the JAX trainer's
    refusal; a width that does not divide exits 1 with JAX's message;
  * the flags' defaults, types and help are the JAX CLI's.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu_torch.cli import build_parser, main as cli  # noqa: E402
from word2vec_tpu_torch.io import checkpoint as ck  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices"
)


@pytest.fixture(scope="module")
def zipf_file(tmp_path_factory):
    rng = np.random.default_rng(2)
    p = 1.0 / np.arange(1, 81)
    p /= p.sum()
    toks = rng.choice([f"w{i}" for i in range(80)], 4000, p=p)
    path = tmp_path_factory.mktemp("corpus") / "zipf.txt"
    path.write_text(" ".join(toks))
    return str(path)


def _common(zipf_file, *extra):
    return ["-train", zipf_file, "-output", "", "-size", "16", "-window", "2",
            "-negative", "3", "-iter", "1", "-min-count", "1",
            "-subsample", "0", "--backend", "cpu", "--batch-rows", "4",
            "--max-sentence-len", "32", "--quiet", *extra]


def _header(path):
    with open(path) as f:
        return tuple(map(int, f.readline().split()))


def test_tp2_sp2_trains_exports_and_records_the_mesh(tmp_path, zipf_file):
    from word2vec_tpu.cli import main as jcli

    out, jout, ckd, mdir = (str(tmp_path / n) for n in ("v.txt", "j.txt", "ck", "m"))
    mesh = ["--tp", "2", "--sp", "2", "--dp-sync-every", "4"]
    args = _common(zipf_file, *mesh, "--checkpoint-dir", ckd, "--metrics-dir", mdir,
                   "--quality-probe-every", "0")
    args[args.index("-output") + 1] = out
    assert cli(args) == 0
    jargs = _common(zipf_file, *mesh)
    jargs[jargs.index("-output") + 1] = jout
    jargs.remove("--backend")
    jargs.remove("cpu")
    assert jcli(jargs) == 0
    assert _header(out) == _header(jout) == (80, 16)
    with open(out) as f:
        f.readline()
        row = f.readline().split()
    assert len(row) == 17 and np.all(np.isfinite(np.float32(row[1:])))
    state, _, _ = ck.load_checkpoint(ckd, fallback=False)
    for v in state.params.values():
        assert v.dim() == 2 and v.shape[1] == 16 and bool(torch.isfinite(v).all())
    with open(os.path.join(mdir, "manifest.json")) as f:
        man = json.load(f)
    assert (man["mesh_size"], man["dp"], man["sp"], man["tp"]) == (4, 1, 2, 2)
    assert man["split_shards"] is False
    gen = man["mesh_events"][0]
    assert (gen["event"], gen["mesh_size"], gen["dp"], gen["sp"], gen["tp"]) == (
        "generation_start", 4, 1, 2, 2)
    with open(os.path.join(mdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert any(r.get("event") == "mesh" and r["mesh_size"] == 4 for r in recs)


def test_refusals_exit_1_with_the_jax_reasons(zipf_file, capsys):
    args = _common(zipf_file, "--tp", "2", "--band-backend", "pallas")
    assert cli(args) == 1
    err = capsys.readouterr().err
    assert "band_backend='pallas' is single-chip only" in err
    assert "Use band_backend='xla' for sharded training" in err
    assert cli(_common(zipf_file, "--tp", "3")) == 1
    assert "word_dim 16 not divisible by tp=3" in capsys.readouterr().err


def test_mesh_flags_match_the_jax_cli():
    from word2vec_tpu.cli import build_parser as jparser

    mine, theirs = build_parser(), jparser()
    for flag in ("--tp", "--sp"):
        a = next(x for x in mine._actions if flag in x.option_strings)
        b = next(x for x in theirs._actions if flag in x.option_strings)
        assert (a.default, a.type, a.choices, a.help) == (
            b.default, b.type, b.choices, b.help), flag
