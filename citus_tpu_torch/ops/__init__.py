"""Device kernel layer.

The per-shard scan→filter→partial-aggregate programs that replace the
reference's row-at-a-time ColumnarScanNext hot loop
(src/backend/columnar/columnar_customscan.c:1855 →
columnar_reader.c:323) with whole-batch tensor code around the
hand-written CUDA kernels of ``csrc/`` (``scan_agg_fold``,
``hash_agg_insert``) and the predicate kernels that
``expr_codegen`` generates (``filter_mask``).
"""

from citus_tpu_torch.ops.scan_agg import (
    build_fused_worker_fn, build_worker_fn, combine_partials_host,
)

__all__ = ["build_fused_worker_fn", "build_worker_fn",
           "combine_partials_host"]
