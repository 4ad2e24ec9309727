"""Serving subsystem, in PyTorch: micro-batched, multi-tenant exact and
open-modification DB-search serving, and streaming spectral clustering,
on one card.

``queue.MicroBatchQueue`` groups requests into tenant-homogeneous
micro-batches; ``cache.QueryHVCache`` memoizes query encodes and
``cache.BankRegistry`` builds per-tenant banks on first use and takes
appended rows into ``delta.DeltaBank`` deltas (searched merged with the
base, exactly, until compacted); ``db_search.DBSearchServer`` runs the
flush-sync loop or ``scheduler.ContinuousScheduler``'s slots over the
``SearchExecutor`` seam, searching through the ``topk_hamming`` or
``encode_search`` kernels (their banded twins in OMS mode, planned by
``oms``) and routing results through target-decoy FDR; clustering
requests go to per-tenant ``clustering.StreamingClusterer`` state, whose
distance step is the ``hamming_pop`` kernel. A ``trace.SpanRecorder``
attached to the server records spans of its serving path.
``repro_torch.launch.serve_db`` and ``repro_torch.launch.serve_cluster``
are the runnable entry points.
"""

from repro_torch.serve.cache import BankRegistry, QueryHVCache
from repro_torch.serve.clustering import (
    ClusterAssignment,
    ClusteringConfig,
    StreamingClusterer,
)
from repro_torch.serve.db_search import (
    ClusterBatchHandle,
    DBSearchServer,
    FDRSearchResult,
    QueryEncoder,
    QueryResult,
    SearchExecutor,
    ShardedDatabase,
    bucket_for,
    encode_queries,
    fdr_route,
    make_buckets,
    oms_plan,
    oms_search,
    oms_search_encoded,
    oms_search_levels,
    oms_search_with_fdr,
    search_database,
    search_database_encoded,
    search_database_levels,
    search_with_fdr,
    shard_database,
    sharded_topk_search,
)
from repro_torch.serve.delta import (
    DeltaBank,
    MergedLayout,
    MergedOMSPlan,
    merged_layout,
    merged_oms_plan,
    merged_oms_search_encoded,
    merged_search_encoded,
)
from repro_torch.serve.oms import (
    OMSConfig,
    OMSPlan,
    PrecursorIndex,
    build_precursor_index,
    plan_candidates,
)
from repro_torch.serve.queue import LatencyStats, MicroBatchQueue, Request
from repro_torch.serve.scheduler import (
    ContinuousScheduler,
    CoordinatedScheduler,
    Slot,
)
from repro_torch.serve.trace import SpanRecorder

__all__ = [
    "BankRegistry",
    "ClusterAssignment",
    "ClusterBatchHandle",
    "ClusteringConfig",
    "ContinuousScheduler",
    "CoordinatedScheduler",
    "DBSearchServer",
    "DeltaBank",
    "FDRSearchResult",
    "LatencyStats",
    "MergedLayout",
    "MergedOMSPlan",
    "MicroBatchQueue",
    "OMSConfig",
    "OMSPlan",
    "PrecursorIndex",
    "QueryEncoder",
    "QueryHVCache",
    "QueryResult",
    "Request",
    "SearchExecutor",
    "ShardedDatabase",
    "Slot",
    "SpanRecorder",
    "StreamingClusterer",
    "bucket_for",
    "build_precursor_index",
    "encode_queries",
    "fdr_route",
    "make_buckets",
    "merged_layout",
    "merged_oms_plan",
    "merged_oms_search_encoded",
    "merged_search_encoded",
    "oms_plan",
    "oms_search",
    "oms_search_encoded",
    "oms_search_levels",
    "oms_search_with_fdr",
    "plan_candidates",
    "search_database",
    "search_database_encoded",
    "search_database_levels",
    "search_with_fdr",
    "shard_database",
    "sharded_topk_search",
]
