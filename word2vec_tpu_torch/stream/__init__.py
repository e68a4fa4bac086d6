"""Continuous-training data plane: streaming corpus segments, online vocab
growth into reserved table rows, mid-stream cursor checkpoints, and hot
table swaps into a live serve engine (the port of word2vec_tpu/stream/).

    from word2vec_tpu_torch.stream import StreamRun, make_source, StreamCursor

    source = make_source("corpus_dir/", segment_tokens=4_000_000)
    run = StreamRun(trainer, source)
    state, report = run.train(checkpoint_cb=..., checkpoint_every=500)

See stream/source.py (shard/pipe/array sources + the StreamCursor replay
coordinate) and stream/driver.py (the segment loop and its producer
thread, growth admission with the step's recapture, and the gated swap).
"""

from .driver import (  # noqa: F401
    DEFAULT_SEGMENT_TOKENS, StreamRun, admission_order, gate_table,
    table_capacity,
)
from .source import (  # noqa: F401
    ArraySource, FileSource, PipeSource, RawSegment, StreamCursor,
    make_source, resolve_shards,
)
