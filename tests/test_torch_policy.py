"""The port's elastic policy (word2vec_tpu_torch/resilience/policy.py), its
delivery channel (the PeerAgreement policy column) and the warm-restart
kernel cache (tune/compile_cache.py) against the JAX package on the same
inputs: tests/test_policy.py's cases, each run through both packages and
held equal (parse results and error messages, the decisions over the same
signal rows, the latched delivery encoding), plus the port's own
in-process remesh leg (its device count is the port's rule for replicas
per card) and its kernel-cache fence.
"""

import os

import pytest

jax = pytest.importorskip("jax")

from word2vec_tpu.resilience import policy as jpol  # noqa: E402
from word2vec_tpu_torch.resilience import policy as tpol  # noqa: E402

def _row(window, **signals):
    row = {"event": "signals", "window": window, "host": 0}
    for k, v in signals.items():
        row[f"signal_{k}"] = v
    return row


def _policy(m, spec, world=3, **kw):
    p = m.parse_policy(spec)
    p.world = world
    for k, v in kw.items():
        setattr(p, k, v)
    return p


# ------------------------------------------------------------------ parsing
@pytest.mark.parametrize("spec", [
    "throughput_wps<0.6*baseline:for=2:act=shrink,"
    "throughput_wps>0.8*baseline:for=3:act=grow:victim=highest,"
    "cooldown=5,min_world=2,max_world=4",
    "straggler_skew>4:for=3",
    "slo_breach>0:for=1:act=shrink:cooldown=2",
    "",
])
def test_parse_equal_to_jax(spec):
    j, t = jpol.parse_policy(spec), tpol.parse_policy(spec)
    assert t.summary() == j.summary()
    assert [r.to_json() for r in t.rules] == [r.to_json() for r in j.rules]
    assert [str(r) for r in t.rules] == [str(r) for r in j.rules]
    assert t.grow_gate() == j.grow_gate() and bool(t) == bool(j)


@pytest.mark.parametrize("spec", [
    "throughput_wps<0.5:for=2,bogus>>3", "throughput_wps<0.5:act=explode",
    "cooldowns=3", "throughput_wps<fast", "x<1:victim=random",
])
def test_parse_errors_equal_to_jax(spec):
    with pytest.raises(jpol.PolicyError) as je:
        jpol.parse_policy(spec)
    with pytest.raises(tpol.PolicyError) as te:
        tpol.parse_policy(spec)
    assert str(te.value) == str(je.value)


def test_parse_json_file(tmp_path):
    import json

    f = os.path.join(tmp_path, "policy.json")
    with open(f, "w") as fh:
        json.dump(["straggler_skew>3:for=2:act=shrink", "cooldown=4"], fh)
    for m in (jpol, tpol):
        p = m.parse_policy(f)
        assert len(p.rules) == 1 and p.cooldown == 4


def test_config_validates_policy_spec():
    from word2vec_tpu.config import Word2VecConfig as JConfig
    from word2vec_tpu_torch.config import Word2VecConfig

    Word2VecConfig(elastic_policy="throughput_wps<0.5:for=2")
    msgs = []
    for cfg in (JConfig, Word2VecConfig):
        with pytest.raises(ValueError, match="bad elastic_policy") as e:
            cfg(elastic_policy="nope>>1")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------- decisions over the same rows
def _drive(spec, rows, fleet=(), slo=(), **kw):
    """Both packages' policies over the same bus inputs: the pending
    request, the delivery encoding, the gate and the event log after each
    window."""
    out = []
    for m in (jpol, tpol):
        events = []
        p = _policy(m, spec, log_fn=events.append, **kw)
        trail = []
        for i, row in enumerate(rows):
            for w, f in fleet:
                if w == i:
                    p.on_fleet(f)
            for w, e in slo:
                if w == i:
                    p.on_slo(e)
            p.on_window(row)
            trail.append((p.pending(), p.poll(), p.grow_gate()))
        out.append((trail, events, p.summary()))
    return out


@pytest.mark.parametrize("case", [
    # for=N streak before action
    ("throughput_wps<100:for=3", [50.0] * 3, {"cooldown": 0}),
    # an oscillating signal never flaps
    ("throughput_wps<100:for=2", [50.0 if w % 2 else 150.0 for w in range(1, 21)],
     {"cooldown": 0}),
    # the cooldown defers but does not lose a sustained breach
    ("throughput_wps<100:for=2", [50.0] * 5, {"cooldown": 4}),
    # one eviction latched per generation
    ("throughput_wps<100:for=1", [10.0] * 5, {"cooldown": 0}),
    # min_world blocks a shrink
    ("throughput_wps<100:for=1", [10.0], {"world": 2, "cooldown": 0}),
    # the grow gate opens on a sustained recovery only
    ("throughput_wps>80:for=2:act=grow,throughput_wps<10:for=9:act=shrink",
     [100.0, 100.0], {"cooldown": 0}),
    # max_world blocks a grow
    ("throughput_wps>80:for=1:act=grow,max_world=3", [100.0, 100.0], {"cooldown": 0}),
])
def test_decisions_equal_to_jax(case):
    spec, values, kw = case
    rows = [_row(w + 1, throughput_wps=v) for w, v in enumerate(values)]
    (jt, je, js), (tt, te, ts) = _drive(spec, rows, **kw)
    assert tt == jt and te == je and ts == js


def test_victim_and_slo_pseudo_signal_equal_to_jax():
    rows = [_row(1, throughput_wps=10.0)]
    for host, want in ((1, 1), (0, 2)):  # never rank 0: the highest instead
        (jt, _, _), (tt, _, _) = _drive(
            "throughput_wps<100:for=1", rows,
            fleet=[(0, {"event": "fleet", "fleet_straggler_host": host})],
            cooldown=0)
        assert tt == jt and tt[-1][0]["victim"] == want
    (jt, _, _), (tt, _, _) = _drive(
        "slo_breach>0:for=1", [_row(1), _row(2)],
        slo=[(1, {"event": "slo_breach", "rule": "x<1"})], cooldown=0)
    assert tt == jt and tt[0][0] is None and tt[1][0] is not None


def test_bus_attach_detach():
    from word2vec_tpu_torch.obs.signals import SignalBus

    bus = SignalBus()
    p = _policy(tpol, "throughput_wps<100:for=1", cooldown=0).attach(bus)
    bus.publish("fleet", {"event": "fleet", "fleet_straggler_host": 2})
    bus.publish("signals", _row(1, throughput_wps=10.0))
    assert p.pending()["victim"] == 2
    p.detach()
    assert bus.topics() == []


# ------------------------------------------------- delivery (PeerAgreement)
@pytest.mark.parametrize("cols,stop,want", [
    ({"policy_fn": lambda: 3.0}, False, ("PolicyShrinkRequested", 8, 2)),
    ({"policy_fn": lambda: 3.0}, True, True),
    ({"elastic_fn": lambda: 1.0, "policy_fn": lambda: 2.0}, False,
     ("PolicyShrinkRequested", 8, 1)),
    ({"elastic_fn": lambda: 1.0}, False, ("GrowRequested", 8, None)),
    ({"elastic_fn": lambda: 1.0}, True, True),
    ({}, False, False),
])
def test_heartbeat_rows_raise_the_same_exception(cols, stop, want):
    """The same heartbeat row raises the same exception in both packages
    (tests/test_policy.py:192-221, tests/test_elastic.py:394-411)."""
    from word2vec_tpu.resilience.shutdown import ShutdownHandler as JHandler
    from word2vec_tpu.resilience.watchdog import PeerAgreement as JPA
    from word2vec_tpu_torch.resilience.shutdown import ShutdownHandler
    from word2vec_tpu_torch.resilience.watchdog import PeerAgreement

    got = []
    for pa_cls, h_cls in ((JPA, JHandler), (PeerAgreement, ShutdownHandler)):
        h = h_cls()
        h.requested = stop
        pa = pa_cls(h, agree_every=1, **cols)
        try:
            got.append(pa.check(8))
        except RuntimeError as e:
            got.append((type(e).__name__, e.step, getattr(e, "victim", None)))
    assert got[0] == got[1] == want


# --------------------------------------------------- in-process remesh leg
def test_apply_inprocess_drives_sharded_remesh():
    """A latched policy shrink halves dp through ShardedTrainer.remesh
    (tests/test_policy.py:225); the port counts the devices it may place
    replicas on by its own rule (any number on the CPU, one a card on the
    card)."""
    from test_torch_elastic import tiny_setup
    from word2vec_tpu_torch.parallel import ShardedTrainer

    cfg, vocab, corpus = tiny_setup()
    t = ShardedTrainer(cfg, vocab, corpus, dp=4, device="cpu")
    s = t.init_state()
    p = _policy(tpol, "throughput_wps<100:for=1", world=4, cooldown=0)
    p.on_window(_row(1, throughput_wps=10.0))
    assert tpol.placeable_devices(t) == float("inf")
    rec = p.apply_inprocess(t, state=s)
    assert rec and rec["dp"] == 2 and rec["trigger"] == "policy"
    assert t.dp == 2 and len(t._replicas) == 2
    assert p.pending() is None  # consumed
    assert p.apply_inprocess(t, state=s) is None  # nothing pending


# ------------------------------------------------ warm kernel cache fence
def test_topology_key_equal_to_jax():
    from word2vec_tpu.config import Word2VecConfig as JConfig
    from word2vec_tpu.tune.compile_cache import topology_key as jkey
    from word2vec_tpu_torch.config import Word2VecConfig
    from word2vec_tpu_torch.tune.compile_cache import topology_key

    for kw in ({}, {"table_layout": "unified", "band_backend": "pallas_fused",
                    "dp_sync_every": 8, "chunk_steps": 8}):
        jc, tc = JConfig(**kw), Word2VecConfig(**kw)
        for args, plan in (((3, 6, 1, 1), None), ((2, 4, 1, 1), None),
                           ((3, 6, 1, 1), "k1")):
            want = jkey(*args, jc, plan_key=plan)
            assert topology_key(*args, tc, plan_key=plan,
                                version=jax.__version__) == want
    a = topology_key(3, 6, 1, 1, Word2VecConfig())
    assert a.startswith("w3dp6tp1sp1-") and a == topology_key(3, 6, 1, 1, Word2VecConfig())
    assert a != topology_key(2, 4, 1, 1, Word2VecConfig())


def test_warm_cache_fenced_to_next_generation_processes(tmp_path, monkeypatch):
    """Only an exec'd generation (gen > 0) points the kernel lookup at
    <root>/<key>, seeded from the default build directory; generation 0
    and an operator-set W2V_KERNEL_BUILD_DIR are refused
    (tests/test_policy.py:252-282)."""
    from word2vec_tpu_torch import _build
    from word2vec_tpu_torch.tune import compile_cache as cc

    default = tmp_path / "default"
    default.mkdir()
    names = _build.library_names()
    (default / names[0]).write_bytes(b"lib")
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", default)
    monkeypatch.setattr(_build, "BUILD_DIR", default)
    root = str(tmp_path / "cache")
    try:
        assert cc.enable_warm_cache(root, "w3dp6-abc", gen=0) is None
        assert _build.BUILD_DIR == default
        assert cc.enable_warm_cache("", "w3dp6-abc", gen=2) is None
        assert cc.enable_warm_cache(root, "w3dp6-abc", gen=2,
                                    env={_build.ENV_BUILD_DIR: "/operator"}) is None
        assert _build.BUILD_DIR == default
        path = cc.enable_warm_cache(root, "w2dp4-def", gen=1, env={})
        assert path == os.path.join(root, "w2dp4-def")
        assert str(_build.BUILD_DIR) == path
        # the current sources' library copied in (a hit: no nvcc); a source
        # the default dir lacks stays a miss and builds there
        assert open(os.path.join(path, names[0]), "rb").read() == b"lib"
        assert sorted(os.listdir(path)) == [names[0]]
    finally:
        cc.disable_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR

