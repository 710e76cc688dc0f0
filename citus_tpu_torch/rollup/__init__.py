"""Continuous aggregation: storable sketches + CDC-fed rollup refresh.

Reference scenario: Citus real-time analytics (SURVEY §2.12 CDC, §2.6
aggregate push-down) — heavy event ingest plus dashboards served from
small pre-aggregated rollup tables kept fresh incrementally, instead of
re-scanning raw events per dashboard hit.

Layout:

- ``sketches``  — the serialized sketch value codec (encode / decode /
  merge / finalize) shared by storage, the upsert merge path, and the
  dashboard routing path.
- ``kernels``   — delta-batch partial states: the hand-written CUDA
  kernel ``csrc/rollup_delta.cu`` on the card, its plain PyTorch version
  on the CPU, bucketing like the scan aggregates' fold.
- ``manager``   — rollup specs, the CDC-fed refresh loop with a durable
  per-rollup LSN watermark, and the ``citus_rollups()`` view rows.
- ``routing``   — planner-side matcher that serves dashboard queries
  from the rollup table, finalizing stored sketches host-side.
"""

from citus_tpu_torch.rollup.sketches import (  # noqa: F401
    decode_sketch, encode_sketch, finalize_sketch, merge_sketch_words,
)
from citus_tpu_torch.rollup.manager import RollupManager  # noqa: F401
