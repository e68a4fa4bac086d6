"""The two ordered sums' work split, emulated on the CPU.

On the card `ordered_row_sum` (csrc/row_sum.cu) and `fused_slab_scatter`
(csrc/fused_step.cu) hand out work per run of equal sorted ids, from the
run list that the prepass of csrc/runs.cu builds. The kernels cannot run
here, so this file emulates each one in plain torch / numpy, step by step
as the kernel walks its work:

  * the prepass: tiles of 256 threads x 4 positions, per-position start
    / end / long flags, each tile's offset from the earlier tiles' counts,
    the packed block scan that gives each start its slot, and an end
    taking its run's slot;
  * the row sum: short runs one at a time, long runs in staged pieces of
    kStage values read four at a time, the sum carried across pieces;
  * the scatter: short runs across the row, long runs per 32-column tile
    and per staged block of kStageTerms terms, the accumulator of each
    column carried across blocks, rounded to the table dtype per add.

The constants come from the .cu sources themselves. Each emulation is
held BITWISE against the plain version (fused_slab_scatter_plain,
ordered_row_sum_plain, find_runs_plain) and against the JAX package
(`.at[].add`, and the Pallas scatter in interpret mode on the small sets)
on f32 and bf16 tables over adversarial id sets: one run of every id, all
ids distinct, a -1 prefix, runs one below, at and one above every
threshold and stage size, the unified plane-1 call, and trainer-shaped ids
whose row 0 collects the padding. Zero terms are added too (-0.0 + 0.0).
"""

from itertools import groupby

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops.pallas_step import fused_slab_scatter as j_slab_scatter  # noqa: E402

from word2vec_tpu_torch.ops import fused_step as fs  # noqa: E402
from word2vec_tpu_torch.ops import runs as rl  # noqa: E402
from word2vec_tpu_torch.ops import train_step as ts  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402

from run_sets import (  # noqa: E402
    LONG_RUN, ROW_STAGE, ROW_SUM_SETS, SCATTER_SETS, STAGE_TERMS, TILE_COLS,
    const, id_set,
)

torch.set_num_threads(1)

PF_THREADS = const("runs.cu", "kThreads")
PF_PER = const("runs.cu", "kPer")
NV = 600  # table rows of the id sets
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# sets small enough for the Pallas interpreter's per-position grid
SMALL = {"one_run", "distinct", "neg_prefix", "long_edges", "trainer"}


def _vals(rng, shape):
    """Normal values with exact +0.0 terms sprinkled in."""
    v = rng.normal(size=shape).astype(np.float32)
    v.reshape(shape[0], -1)[::5] = 0.0
    return v


# --------------------------------------------------------------- emulations
def emulate_find_runs(idx: np.ndarray) -> np.ndarray:
    """csrc/runs.cu count_runs_kernel + write_runs_kernel, position by
    position: each tile's offset is the sum of the earlier tiles' counts."""
    a = idx.astype(np.int64)
    n = a.size
    out = np.zeros(rl.run_list_size(n), np.int32)
    h = rl.HEADER
    shorts = out[h : h + 2 * n].reshape(n, 2)
    longs = out[h + 2 * n : h + 4 * n].reshape(n, 2)
    tile = PF_THREADS * PF_PER
    at = lambda p: a[p] if 0 <= p < n else -2  # noqa: E731
    base_s = base_l = 0
    for base in range(0, n, tile):
        flags, packed = [], np.zeros(PF_THREADS, np.int64)
        for t in range(PF_THREADS):
            f = []
            for j in range(PF_PER):
                p = base + t * PF_PER + j
                r = at(p)
                if p >= n or r < 0:
                    f.append(None)
                    continue
                start = at(p - 1) != r
                lng = start and p + LONG_RUN < n and a[p + LONG_RUN] == r
                end = at(p + 1) != r
                lend = end and p - LONG_RUN >= 0 and a[p - LONG_RUN] == r
                f.append((start, lng, end, lend))
                if start:
                    packed[t] += (1 << 16) if lng else 1
            flags.append(f)
        excl = np.cumsum(packed) - packed
        total = int(packed.sum())
        # the packed halves never carry into each other
        assert (total & 0xFFFF) <= tile and (total >> 16) <= tile
        for t in range(PF_THREADS):
            cs = base_s + int(excl[t] & 0xFFFF)
            cl = base_l + int(excl[t] >> 16)
            for j, f in enumerate(flags[t]):
                if f is None:
                    continue
                p = base + t * PF_PER + j
                start, lng, end, lend = f
                if start:
                    if lng:
                        longs[cl, 0] = p
                        cl += 1
                    else:
                        shorts[cs, 0] = p
                        cs += 1
                if end:
                    if lend:
                        longs[cl - 1, 1] = p + 1
                    else:
                        shorts[cs - 1, 1] = p + 1
        base_s += total & 0xFFFF
        base_l += total >> 16
    out[0], out[1] = base_s, base_l
    return out


def _used(runs: torch.Tensor, n: int):
    s, l_ = rl.unpack_runs(runs, n)
    return s.tolist(), l_.tolist()


def emulate_row_sum(num_rows, idx, vals, runs, out=None):
    """csrc/row_sum.cu ordered_row_sum_kernel: short runs one sequential
    chain each; long runs in staged pieces of ROW_STAGE values read four at
    a time, the sum carried from piece to piece."""
    o = np.zeros(num_rows, np.float32) if out is None else out.numpy().copy()
    i, v = idx.numpy(), vals.numpy().astype(np.float32)
    shorts, longs = _used(runs, i.size)
    for s, e in shorts:
        acc = o[i[s]]
        for q in range(s, e):
            acc = np.float32(acc + v[q])
        o[i[s]] = acc
    for s, e in longs:
        acc = o[i[s]]
        for lo in range(s, e, ROW_STAGE):
            piece = v[lo : min(e, lo + ROW_STAGE)]
            c4 = piece.size & ~3
            for k in range(0, c4, 4):
                for x in piece[k : k + 4]:
                    acc = np.float32(acc + x)
            for x in piece[c4:]:
                acc = np.float32(acc + x)
        o[i[s]] = acc
    return torch.from_numpy(o)


def emulate_scatter(emb, idx, vals, runs, plane=None):
    """csrc/fused_step.cu slab_scatter_kernel: short runs across the row;
    long runs per TILE_COLS-column tile (the last one ragged) and per
    staged block of STAGE_TERMS terms, each column's accumulator carried
    across blocks and rounded to the table dtype after every add."""
    rows, v, col0 = fs._scatter_view(emb, vals, plane)
    width, dt = v.shape[1], emb.dtype

    def add(acc, x):
        return (acc.float() + x.float()).to(dt)

    shorts, longs = _used(runs, idx.numel())
    for s, e in shorts:
        r = int(idx[s])
        acc = rows[r, col0 : col0 + width].clone()
        for q in range(s, e):
            acc = add(acc, v[q])
        rows[r, col0 : col0 + width] = acc
    for s, e in longs:
        r = int(idx[s])
        for c0 in range(0, width, TILE_COLS):
            cols = slice(col0 + c0, col0 + min(width, c0 + TILE_COLS))
            acc = rows[r, cols].clone()
            for lo in range(s, e, STAGE_TERMS):
                blk = v[lo : min(e, lo + STAGE_TERMS), c0 : c0 + TILE_COLS]
                for k in range(blk.shape[0]):
                    acc = add(acc, blk[k])
            rows[r, cols] = acc
    return emb


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("src,name,value", [
    ("runs.cu", "kLongRun", rl.LONG_RUN),
    ("runs.cu", "kThreads * kPer", rl.RUN_TILE),
    ("runs.cuh", "kHeader", rl.HEADER),
])
def test_python_constants_match_the_sources(src, name, value):
    got = 1
    for part in name.split(" * "):
        got *= const(src, part)
    assert got == value
    assert STAGE_TERMS % 4 == 0 and TILE_COLS % 4 == 0 and ROW_STAGE % 4 == 0


@pytest.mark.parametrize("name", sorted(set(SCATTER_SETS) | set(ROW_SUM_SETS)))
def test_prepass_emulation_matches_plain(name):
    idx = id_set(name, np.random.default_rng(0))
    plain = rl.find_runs_plain(torch.from_numpy(idx))
    emu = emulate_find_runs(idx)
    n = idx.size
    assert _used(torch.from_numpy(emu), n) == _used(plain, n)
    # and both are the runs of equal valid ids, in order
    want, p = [], 0
    for r, grp in groupby(idx.tolist()):
        k = len(list(grp))
        if r >= 0:
            want.append([p, p + k])
        p += k
    s, l_ = _used(plain, n)
    assert sorted(s + l_) == want
    assert all(e - b > LONG_RUN for b, e in l_)
    assert all(e - b <= LONG_RUN for b, e in s)
    assert rl.find_runs(torch.from_numpy(idx)).equal(plain)  # CPU: plain
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("name", ROW_SUM_SETS)
def test_row_sum_emulation_bitwise(name):
    rng = np.random.default_rng(1)
    idx = id_set(name, rng)
    idx = idx[idx >= 0]  # the row sum's callers never pass -1 ids
    vals = (rng.random(idx.size) * 10.0 ** rng.uniform(-4, 4, size=idx.size))
    vals = vals.astype(np.float32)
    vals[::7] = 0.0
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    start = torch.from_numpy(rng.normal(size=NV).astype(np.float32))
    start[::3] = -0.0
    runs = rl.find_runs(t_idx)
    emu = emulate_row_sum(NV, t_idx, t_vals, runs, out=start)
    plain = ts.ordered_row_sum_plain(NV, t_idx, t_vals, start.clone())
    ref = np.asarray(jnp.asarray(start.numpy()).at[jnp.asarray(idx)].add(
        jnp.asarray(vals)))
    assert torch.equal(emu.view(torch.int32), plain.view(torch.int32))
    np.testing.assert_array_equal(emu.numpy().view(np.int32), ref.view(np.int32))
    # the wrapper with the list given takes the plain version on the CPU
    got = ts.ordered_row_sum(NV, t_idx, t_vals, start.clone(), presorted=True,
                             runs=runs)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SCATTER_SETS)
def test_scatter_emulation_bitwise(name, dtype):
    rng = np.random.default_rng(2)
    idx = id_set(name, rng)
    n, d = idx.size, 20  # whole rows 40 wide: a 32-column tile and a ragged 8
    emb = rng.normal(size=(NV, 2, d)).astype(np.float32)
    emb[::3] = -0.0
    vals = _vals(rng, (n, 2, d))
    j_emb = jnp.asarray(emb).astype(JDT[dtype])
    j_vals = jnp.asarray(vals).astype(JDT[dtype])
    t_idx = torch.from_numpy(idx)
    runs = rl.find_runs(t_idx)
    emu = emulate_scatter(_to_torch(j_emb), t_idx, _to_torch(j_vals), runs)
    plain = fs.fused_slab_scatter_plain(_to_torch(j_emb), t_idx, _to_torch(j_vals))
    assert torch.equal(emu.float().view(torch.int32), plain.float().view(torch.int32))
    keep = idx >= 0  # XLA's .at[-1] would wrap to the last row
    ref = j_emb.at[jnp.asarray(idx[keep])].add(j_vals[np.flatnonzero(keep)])
    np.testing.assert_array_equal(emu.float().numpy(), np.asarray(ref, np.float32))
    if name in SMALL:
        ref_k = j_slab_scatter(j_emb, jnp.asarray(idx), j_vals, interpret=True)
        np.testing.assert_array_equal(emu.float().numpy(),
                                      np.asarray(ref_k, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["long_edges", "trainer"])
def test_plane_scatter_emulation_bitwise(name, dtype):
    """The unified negative tail: plane=1 of [V, 2, d], d = 36 (a 32-column
    tile and a ragged 4)."""
    rng = np.random.default_rng(3)
    idx = id_set(name, rng)
    n, d = idx.size, 36
    emb = rng.normal(size=(NV, 2, d)).astype(np.float32)
    vals = _vals(rng, (n, d))
    j_emb = jnp.asarray(emb).astype(JDT[dtype])
    j_vals = jnp.asarray(vals).astype(JDT[dtype])
    t_idx = torch.from_numpy(idx)
    runs = rl.find_runs(t_idx)
    emu = emulate_scatter(_to_torch(j_emb), t_idx, _to_torch(j_vals), runs, plane=1)
    plain = fs.fused_slab_scatter_plain(_to_torch(j_emb), t_idx, _to_torch(j_vals),
                                        plane=1)
    assert torch.equal(emu.float().view(torch.int32), plain.float().view(torch.int32))
    ref = j_emb.at[jnp.asarray(idx), 1].add(j_vals)
    np.testing.assert_array_equal(emu.float().numpy(), np.asarray(ref, np.float32))
    got = fs.fused_slab_scatter(_to_torch(j_emb), t_idx, _to_torch(j_vals),
                                plane=1, runs=runs)
    assert torch.equal(got.float().view(torch.int32), plain.float().view(torch.int32))


def test_scatter_vector_width_follows_shape_and_alignment():
    emb = torch.zeros(10, 2, 300)
    assert fs.scatter_vector(emb, torch.zeros(4, 600), 600, 0) == 4
    assert fs.scatter_vector(emb, torch.zeros(4, 300), 600, 300) == 4
    assert fs.scatter_vector(torch.zeros(10, 2, 7), torch.zeros(4, 7), 14, 7) == 1
    bf = torch.zeros(10, 2, 300, dtype=torch.bfloat16)
    assert fs.scatter_vector(bf, torch.zeros(4, 300, dtype=torch.bfloat16), 600, 300) == 4
    bf7 = torch.zeros(10, 2, 7, dtype=torch.bfloat16)
    assert fs.scatter_vector(bf7, torch.zeros(4, 14, dtype=torch.bfloat16), 14, 0) == 2
    assert fs.scatter_vector(bf7, torch.zeros(4, 7, dtype=torch.bfloat16), 14, 7) == 1


def test_run_list_rules():
    with pytest.raises(ValueError, match="presorted"):
        ts.ordered_row_sum(5, torch.tensor([1, 0], dtype=torch.int32),
                           torch.ones(2), runs=torch.zeros(12, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        rl.check_runs(torch.zeros(5, dtype=torch.int32), 3, torch.device("cpu"))
    empty = rl.find_runs(torch.zeros(0, dtype=torch.int32))
    assert empty.tolist() == [0] * rl.HEADER
