"""Kernel auto-selection in the band kernel's degeneracy domain.

Port of the fence of word2vec_tpu/tune/planner.py:71-141 (the constants,
`degeneracy_domain` and `select_kernel`), copied so the port imports
nothing of the JAX package. The rest of the JAX planner (the cost model,
the timed probes, the plan cache) is not ported yet.

The measured quality-collapse domain of the shared-negative band kernel
(benchmarks/BAND_DEGENERACY_r5.md): a tiny closed vocabulary over-trained
for thousands of occurrences per word. Full collapse at ~860 words /
4,600 occ (analogy 0.0 vs pair 0.74); measured degradation up to ~4.4k
words; onset ~1,000+ occ/word. Realistic corpora (text8: 71k vocab,
~240 occ/word) sit 20x outside.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..config import Word2VecConfig

DEGENERACY_VOCAB_MAX = 5000
DEGENERACY_OCC_PER_WORD = 1000


def degeneracy_domain(
    config: Word2VecConfig, vocab_size: int, total_tokens: int
) -> bool:
    """True when (vocab, planned training tokens) sit inside the band
    kernel's measured degeneracy domain — the fence the trainer warning
    and the kernel auto-selection below share."""
    return (
        config.use_ns
        and 0 < vocab_size < DEGENERACY_VOCAB_MAX
        and total_tokens * config.iters
        > DEGENERACY_OCC_PER_WORD * vocab_size
    )


def select_kernel(
    config: Word2VecConfig, vocab_size: int, total_tokens: int
) -> Optional[Dict]:
    """For kernel='auto' runs whose corpus shape sits inside the measured
    degeneracy domain, choose kernel='pair' (per-pair negative draws hold
    near-reference accuracy on the identical stream) instead of warning
    and collapsing. Returns the decision record when a change is
    selected, else None. An explicit kernel='band' is the override: the
    trainer only consults this for kernel='auto', so a forced band config
    keeps the fast path (and gets the degeneracy warning instead)."""
    if config.kernel != "auto" or not config.use_ns:
        return None
    # band-only levers are an explicit opt-in to the band machinery (and a
    # pair config would reject them outright — config.__post_init__): the
    # static warning still fires for these, selection stands aside
    if (
        config.fused_tables or config.slab_scatter
        or config.table_layout != "split"
        or config.band_backend != "xla"
        or config.negative_scope != "row"
    ):
        return None
    if not degeneracy_domain(config, vocab_size, total_tokens):
        return None
    occ = total_tokens * config.iters // max(1, vocab_size)
    return {
        "event": "kernel_auto_selection",
        "selected": "pair",
        "instead_of": "band",
        "reason": (
            f"degeneracy domain: {vocab_size}-word vocabulary at ~{occ} "
            f"training occurrences/word (fence: vocab < "
            f"{DEGENERACY_VOCAB_MAX} and occ/word > "
            f"{DEGENERACY_OCC_PER_WORD}; benchmarks/BAND_DEGENERACY_r5.md)"
        ),
        "vocab_size": int(vocab_size),
        "occ_per_word": int(occ),
        "override": "--kernel band forces the band fast path",
    }
