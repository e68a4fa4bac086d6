"""`python -m word2vec_tpu_torch.serve` as a subprocess, on --backend cpu:
over text, binary and int8 files written by the port's io/embeddings, the
JSON ready line, answers equal to the JAX engine's over the same file
(word lists in order, scores within 1e-6), and SIGTERM draining to exit 0
with flight.json; --probe-pairs putting w2v_quality_* on /metrics; an
unservable fault kind and an unreadable file exiting 1; and --backend gpu
without a card exiting non-zero with a message, never serving on the
CPU."""

import json
import os
import select
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.serve.__main__ import load_table as j_load_table
from word2vec_tpu.serve.query import QueryEngine as JQueryEngine

from word2vec_tpu_torch.io.embeddings import (
    save_embeddings_binary, save_embeddings_int8, save_embeddings_text,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NV, ND = 80, 16
WORDS = [f"w{i}" for i in range(NV)]
SAVE = {"text": save_embeddings_text, "binary": save_embeddings_binary,
        "int8": save_embeddings_int8}


def _table():
    return np.random.default_rng(21).normal(size=(NV, ND)).astype(np.float32)


def _start(args, env=None):
    """Launch the serve CLI; returns (process, ready-line dict or None)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "word2vec_tpu_torch.serve", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})},
    )
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else ""
    if not line:
        return proc, None
    return proc, json.loads(line)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        body = r.read().decode()
    return json.loads(body) if path.startswith("/v1/") else body


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/query", data=json.dumps(doc).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, err


@pytest.mark.parametrize("fmt", list(SAVE))
def test_serve_cli_answers_like_the_jax_engine(fmt, tmp_path):
    path = str(tmp_path / f"vec.{fmt}")
    SAVE[fmt](path, WORDS, _table())
    mdir = str(tmp_path / "m")
    proc, ready = _start(["--vectors", path, "--format", fmt, "--backend",
                          "cpu", "--port", "0", "--metrics-dir", mdir,
                          "--quiet"])
    try:
        assert ready is not None, proc.communicate(timeout=30)[1]
        assert ready == {"event": "serving", "host": "127.0.0.1",
                         "port": ready["port"], "vocab": NV, "dim": ND,
                         "table_dtype": "float32"}
        port = ready["port"]
        words, M = j_load_table(path, fmt)
        eng = JQueryEngine(M, JVocab(words, np.ones(len(words), np.int64)))
        for i, w in enumerate(("w0", "w7", "w33", "w79")):
            got = _get(port, f"/v1/neighbors?word={w}&k={3 + i}")
            want = eng.neighbors_batch([w], k=3 + i)[0]
            assert [x for x, _ in got["neighbors"]] == [x for x, _ in want]
            np.testing.assert_allclose([s for _, s in got["neighbors"]],
                                       [s for _, s in want], atol=1e-6,
                                       rtol=0)
        doc = _post(port, {"queries": [
            {"op": "analogy", "a": "w1", "b": "w2", "c": "w3", "k": 4},
            {"op": "similarity", "w1": "w4", "w2": "w5"},
        ]})
        an, sim = doc["results"]
        want = eng.analogy_batch([("w1", "w2", "w3")], k=4)[0]
        assert an["status"] == 200
        assert [x for x, _ in an["neighbors"]] == [x for x, _ in want]
        np.testing.assert_allclose([s for _, s in an["neighbors"]],
                                   [s for _, s in want], atol=1e-6, rtol=0)
        assert sim["status"] == 200
        assert abs(sim["similarity"]
                   - eng.similarity_batch([("w4", "w5")])[0]) <= 1e-6
        stats = json.loads(_get(port, "/stats"))
        assert stats["serve_requests_total"] == 6
    finally:
        rc, err = _stop(proc)
    assert rc == 0, err
    fl = json.load(open(os.path.join(mdir, "flight.json")))
    assert fl["reason"] == "drained" and fl["exit_code"] == 0
    assert fl["stats"]["serve_requests_total"] == 6


def test_serve_cli_probe_pairs_on_metrics(tmp_path):
    path = str(tmp_path / "vec.txt")
    save_embeddings_text(path, WORDS, _table())
    pairs = tmp_path / "pairs.csv"
    pairs.write_text("".join(f"w{i},w{i + 1},{i % 7}\n" for i in range(12)))
    proc, ready = _start(["--vectors", path, "--backend", "cpu", "--port",
                          "0", "--probe-pairs", str(pairs)])
    try:
        assert ready is not None, proc.communicate(timeout=30)[1]
        prom = _get(ready["port"], "/metrics")
    finally:
        rc, err = _stop(proc)
    assert rc == 0, err
    assert "w2v_quality_spearman" in prom
    assert "w2v_quality_probes_total 1.0" in prom
    assert "startup quality probe" in err


@pytest.mark.parametrize("case", ["fault", "missing"])
def test_serve_cli_startup_errors_exit_1(case, tmp_path):
    path = str(tmp_path / "vec.txt")
    if case == "fault":
        save_embeddings_text(path, WORDS, _table())
    extra = ["--faults", "nan@1"] if case == "fault" else []
    proc, ready = _start(["--vectors", path, "--backend", "cpu", "--port",
                          "0", *extra])
    _, err = proc.communicate(timeout=60)
    assert ready is None and proc.returncode == 1
    assert ("not servable" if case == "fault" else "error:") in err


def test_serve_cli_gpu_without_a_card_exits_nonzero(tmp_path):
    path = str(tmp_path / "vec.txt")
    save_embeddings_text(path, WORDS, _table())
    proc, ready = _start(["--vectors", path, "--port", "0"])
    _, err = proc.communicate(timeout=60)
    assert ready is None and proc.returncode != 0
    assert "no CUDA device is available" in err
