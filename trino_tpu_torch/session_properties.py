"""Session property registry: per-query tuning knobs.

Reference analog: ``SystemSessionProperties.java`` (122 properties,
1,574 LoC) + airlift config binding. Typed defaults with validation;
``SET SESSION`` updates a Session's overrides, engine components read
through ``value()`` (session objects) / ``prop_value()`` (the bare
dicts that ride worker RPCs).

Every declared property must have a read site and every literal
lookup must be declared — machine-checked by the ``session-props``
pass of ``python -m trino_tpu.analysis`` (a knob that validates but
changes nothing, like the removed ``page_rows``, is a finding).
Readers, per property (checked against the pass's literal-lookup
index — rows list REGISTRY read sites; workers
additionally consume several knobs straight off the session dict
shipped on ``run_task`` via ``session_props.get(...)``, which the
registry pass deliberately does not count):

========================================== ===========================
property                                   read by
========================================== ===========================
task_concurrency                           parallel/distributed.py
desired_splits                             runner.py (workers receive
                                           it in the task RPC payload)
broadcast_join_threshold                   parallel/distributed.py,
                                           parallel/process_runner.py
join_distribution_type                     parallel/distributed.py
query_max_memory_bytes                     runner.py, exec/memory.py,
                                           parallel/worker.py,
                                           parallel/process_runner.py
spill_enabled, spill_to_disk_enabled,      exec/memory.py,
spill_host_memory_bytes                    parallel/worker.py
node_max_memory_bytes                      parallel/worker.py
query_max_total_memory,                    parallel/process_runner.py
memory_killer_policy, retry_initial_memory
scan_coalesce_enabled,                     runner.py,
enable_dynamic_filtering,                  parallel/distributed.py
join_max_expand_lanes                      (workers: shipped dict)
filter_pushdown_enabled                    planner/rules.py,
                                           planner/optimizer.py
streaming_execution,                       parallel/distributed.py,
exchange_max_pending_pages                 parallel/process_runner.py
retry_policy, query_max_run_time,          parallel/process_runner.py
retry_max_attempts, retry_*_backoff,
speculation_*, query_tracing_enabled
rpc_request_timeout                        parallel/process_runner.py
                                           (workers: shipped dict)
hash_grouping_enabled,                     exec/local_planner.py
adaptive_partial_aggregation_*             (grouping_options)
device_exchange, device_exchange_sizing,   parallel/distributed.py
hot_partition_split_threshold,
scale_writers_enabled
rebalance_min_collectives                  parallel/distributed.py,
                                           parallel/worker.py
join_strategy, aggregation_strategy        planner/optimizer.py
matmul_join_max_key_range                  planner/optimizer.py,
                                           exec/local_planner.py
hybrid_join_enabled,                       exec/local_planner.py
hybrid_join_fanout,                        (grouping_options)
hybrid_join_max_depth
global_hash_agg_max_table                  planner/optimizer.py
                                           (mesh runtime via
                                           choose_agg_strategy default)
plan_cache_enabled, plan_cache_entries,    runner.py
result_cache_enabled
admission_batching_enabled,                server/protocol.py
admission_batch_max
plan_template_enabled,                     runner.py
batched_execution_enabled,
batched_execution_max_depth,
batched_execution_min_shape_uses,
batched_execution_pad_rows_limit
plan_template_seed_enabled                 runner.py,
                                           parallel/process_runner.py
                                           (workers: shipped dict)
query_profiling_enabled                    runner.py,
                                           parallel/distributed.py,
                                           parallel/worker.py
slow_query_log_threshold                   runner.py,
                                           parallel/process_runner.py
tracing_otlp_endpoint                      parallel/process_runner.py
hbo_enabled                                runner.py,
                                           parallel/distributed.py,
                                           parallel/process_runner.py,
                                           parallel/worker.py
hbo_reorder_joins_enabled                  planner/optimizer.py
hbo_distribution_enabled                   parallel/distributed.py
hbo_store_path                             runner.py,
                                           parallel/process_runner.py
hbo_ewma_alpha                             runner.py,
                                           parallel/distributed.py,
                                           parallel/process_runner.py
partial_stage_retry                        parallel/process_runner.py
                                           (workers: shipped dict)
autoscale_enabled,                         parallel/process_runner.py
autoscale_min_workers,
autoscale_max_workers,
autoscale_cooldown_s,
autoscale_up_queue_depth,
autoscale_down_idle_ticks
========================================== ===========================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .types import TrinoError


@dataclass(frozen=True)
class SessionProperty:
    name: str
    type: str            # integer | double | boolean | varchar
    default: Any
    description: str
    validate: Optional[Callable[[Any], bool]] = None
    normalize: Optional[Callable[[Any], Any]] = None


REGISTRY: Dict[str, SessionProperty] = {}


def register(prop: SessionProperty):
    REGISTRY[prop.name] = prop
    return prop


register(SessionProperty(
    "task_concurrency", "integer", 4,
    "Parallel worker tasks per fragment",
    lambda v: v >= 1))
register(SessionProperty(
    "desired_splits", "integer", 4,
    "Target table-scan split count",
    lambda v: v >= 1))
register(SessionProperty(
    "broadcast_join_threshold", "double", 50_000.0,
    "Estimated build rows below which joins broadcast",
    lambda v: v >= 0))
register(SessionProperty(
    "join_distribution_type", "varchar", "AUTOMATIC",
    "AUTOMATIC | BROADCAST | PARTITIONED",
    lambda v: v in ("AUTOMATIC", "BROADCAST", "PARTITIONED"),
    normalize=str.upper))
register(SessionProperty(
    "query_max_memory_bytes", "integer", 8 << 30,
    "Per-query device-memory accounting limit",
    lambda v: v > 0))
register(SessionProperty(
    "spill_enabled", "boolean", False,
    "Spill aggregation/join state to host on memory pressure"))
register(SessionProperty(
    "spill_to_disk_enabled", "boolean", False,
    "Second spill tier below host RAM: when the host spill ledger "
    "exceeds spill_host_memory_bytes, the largest parked pages demote "
    "to per-query CRC-framed spill files (reference: "
    "FileSingleStreamSpiller) and reload transparently"))
register(SessionProperty(
    "spill_host_memory_bytes", "integer", 4 << 30,
    "Host-RAM budget for spilled state before the disk tier takes the "
    "overflow (0 = spill straight to disk)",
    lambda v: v >= 0))
register(SessionProperty(
    "node_max_memory_bytes", "integer", 0,
    "Worker-wide memory pool shared by ALL concurrent queries on a "
    "node; over-budget reservations revoke across queries largest-"
    "first, then fail with EXCEEDED_NODE_MEMORY (reference: the "
    "per-node general MemoryPool). 0 = auto: derive from the device's "
    "reported memory stats (exec.memory.default_node_memory_bytes), "
    "falling back to 16 GiB where the backend reports none",
    lambda v: v >= 0))
register(SessionProperty(
    "query_max_total_memory", "integer", 0,
    "Cluster-wide cap on one query's total reservation summed over all "
    "workers; the ClusterMemoryManager kills a query crossing it with "
    "EXCEEDED_CLUSTER_MEMORY (0 = unlimited; reference: "
    "query.max-total-memory)",
    lambda v: v >= 0))
register(SessionProperty(
    "memory_killer_policy", "varchar", "total-reservation-on-blocked-nodes",
    "Low-memory-killer victim policy when workers report blocked "
    "memory pools: total-reservation-on-blocked-nodes (default) | "
    "total-reservation | none (reference: "
    "TotalReservationOnBlockedNodesLowMemoryKiller)",
    lambda v: v in ("total-reservation-on-blocked-nodes",
                    "total-reservation", "none"),
    normalize=str.lower))
register(SessionProperty(
    "retry_initial_memory", "integer", 1 << 30,
    "Floor for the re-admitted per-query memory budget when an "
    "INSUFFICIENT_RESOURCES failure retries: the next attempt runs "
    "with max(this, growth x observed peak) and reduced task width "
    "(reference: PartitionMemoryEstimator escalation)",
    lambda v: v > 0))
register(SessionProperty(
    "scan_coalesce_enabled", "boolean", True,
    "Coalesce small scan pages (split tails) on host up to the "
    "connector's page size before device upload: one kernel launch "
    "per full page instead of one per fragmentized page (reference: "
    "MergePages)"))
register(SessionProperty(
    "enable_dynamic_filtering", "boolean", True,
    "Prune probe-side scans with join build-side key domains "
    "(min/max + small value sets)"))
register(SessionProperty(
    "join_max_expand_lanes", "integer", 1 << 20,
    "Candidate-pair lanes per join-probe kernel launch; larger probe "
    "pages split in half recursively to stay under this bound",
    lambda v: v >= 1024))
register(SessionProperty(
    "filter_pushdown_enabled", "boolean", True,
    "Offer extractable filter conjuncts to connectors as TupleDomains "
    "(ConnectorMetadata.apply_filter); enforced domains drop from the "
    "plan and prune at the scan"))
register(SessionProperty(
    "streaming_execution", "boolean", True,
    "Run all stages of a distributed query concurrently with pages "
    "streaming through exchanges (backpressure + blocked-task parking); "
    "off = barrier per stage boundary (the fault-tolerant shape)"))
register(SessionProperty(
    "exchange_max_pending_pages", "integer", 32,
    "Streaming backpressure: undrained pages per exchange partition "
    "before the producing pipeline stalls",
    lambda v: v >= 1))
register(SessionProperty(
    "retry_policy", "varchar", "QUERY",
    "Failure recovery for the multi-process runtime: NONE (fail), "
    "QUERY (re-run the query), TASK (durable spooled exchange; failed "
    "tasks retry from spool WITHOUT re-running producer stages)",
    lambda v: v in ("NONE", "QUERY", "TASK")))
register(SessionProperty(
    "rpc_request_timeout", "double", 600.0,
    "Seconds a single coordinator<->worker RPC may take before the "
    "request is abandoned (reference: query.remote-task.max-error "
    "duration); replaces the old hardwired 600 s",
    lambda v: v > 0))
register(SessionProperty(
    "query_max_run_time", "double", 0.0,
    "Wall-clock deadline for one query in seconds, enforced across all "
    "coordinator->worker RPCs and retry backoff waits; exceeding it "
    "raises EXCEEDED_TIME_LIMIT (a USER error: never retried). "
    "0 = unlimited",
    lambda v: v >= 0))
register(SessionProperty(
    "retry_max_attempts", "integer", 4,
    "Per-query attempt budget for retryable failures (worker loss, "
    "transport faults, internal errors); USER errors never consume it",
    lambda v: v >= 1))
register(SessionProperty(
    "retry_initial_backoff", "double", 0.05,
    "First retry delay in seconds; doubles per attempt with "
    "deterministic jitter up to retry_max_backoff",
    lambda v: v > 0))
register(SessionProperty(
    "retry_max_backoff", "double", 2.0,
    "Upper bound on the exponential retry backoff in seconds",
    lambda v: v > 0))
register(SessionProperty(
    "speculative_execution_enabled", "boolean", True,
    "Under retry_policy=TASK, re-dispatch a straggling task on another "
    "worker once it runs far past the median of its completed siblings; "
    "the spool's first-publish-wins rename makes duplicates safe"))
register(SessionProperty(
    "speculation_multiplier", "double", 2.0,
    "A task is a straggler when its runtime exceeds this multiple of "
    "the median runtime of its fragment's completed sibling tasks",
    lambda v: v >= 1))
register(SessionProperty(
    "speculation_min_seconds", "double", 1.0,
    "Never speculate before a task has run at least this long "
    "(guards against re-dispatching short tasks on scheduling noise)",
    lambda v: v >= 0))
register(SessionProperty(
    "hash_grouping_enabled", "boolean", True,
    "GROUP BY via the vectorized open-addressing hash table "
    "(ops/hashtable.py): dense group ids without sorting key and state "
    "columns through lax.sort. Off = sort-based grouping everywhere "
    "(the correctness oracle). Float grouping keys and probe-budget "
    "overflow always take the sort path"))
register(SessionProperty(
    "adaptive_partial_aggregation_enabled", "boolean", True,
    "Partial aggregation observes its groups/rows reduction ratio and "
    "switches to pass-through when grouping stops reducing rows "
    "(high-cardinality keys); the final step re-groups, results are "
    "unchanged"))
def _agg_default(name: str):
    """Adaptive-partial defaults live in ops/aggregation.py (the operator
    can be built directly, without a session); the registry re-exports
    them so the two paths cannot drift. Lazy import: this module loads
    before jax-heavy ops in some entry points."""
    from .ops import aggregation

    return getattr(aggregation, name)


register(SessionProperty(
    "adaptive_partial_aggregation_unique_rows_ratio_threshold",
    "double", _agg_default("ADAPTIVE_RATIO_THRESHOLD"),
    "Observed unique-groups-to-input-rows ratio above which the "
    "partial aggregation step stops aggregating",
    lambda v: 0 < v <= 1))
register(SessionProperty(
    "adaptive_partial_aggregation_min_rows", "integer",
    _agg_default("ADAPTIVE_MIN_ROWS"),
    "Input rows a partial aggregation must observe before its "
    "reduction ratio is trusted",
    lambda v: v >= 1))
register(SessionProperty(
    "adaptive_partial_aggregation_key_range_buckets", "integer",
    _agg_default("ADAPTIVE_KEY_BUCKETS"),
    "Per-key-range adaptive partial aggregation ('Partial Partial "
    "Aggregates'): the hashed key space splits into this many range "
    "buckets and the pass-through decision is made PER BUCKET, so a "
    "skewed stream keeps aggregating its hot key ranges while cold "
    "(mostly-unique) ranges pass through ungrouped. 1 = one global "
    "per-stream decision",
    lambda v: 1 <= v <= 256))
register(SessionProperty(
    "device_exchange", "boolean", True,
    "Run hash exchanges between co-resident stages as an all_to_all "
    "device collective over the mesh (falls back to the host path when "
    "tasks outnumber devices or types are host-only)"))
register(SessionProperty(
    "hot_partition_split_threshold", "double", 0.5,
    "Hot-partition SPLITTING in the device-collective exchange: a "
    "partition holding more than this fraction of the exchange's rows "
    "is re-bucketed across all receiver devices (row-index-derived "
    "sub-bucket salt inside the jit'd program; the consumer gather "
    "re-merges by carried partition id). 1.0 disables splitting "
    "(reference: ScaleWriterPartitioningExchanger's skewed-partition "
    "scaling, applied to the receive side)",
    lambda v: 0 < v <= 1))
register(SessionProperty(
    "scale_writers_enabled", "boolean", False,
    "Scaled writers: INSERT/CTAS plans repartition rows to writer "
    "tasks through a rebalancing exchange — logical partitions are "
    "re-assigned to writer lanes from observed row counts "
    "(EWMA-smoothed with hysteresis), so one hot partition no longer "
    "serializes the write behind a single writer (reference: "
    "ScaleWriterPartitioningExchanger + UniformPartitionRebalancer)"))
register(SessionProperty(
    "rebalance_min_collectives", "integer", 2,
    "Scaled-writer hysteresis: the rebalancer changes partition->"
    "writer-lane assignments at most once per this many observed "
    "collectives/pages, so assignments cannot flap on bursty input",
    lambda v: v >= 1))
register(SessionProperty(
    "query_tracing_enabled", "boolean", True,
    "Distributed tracing: the coordinator opens a root span per query "
    "with plan/fragment/attempt children, span context rides every "
    "task RPC, and workers return task/operator spans that assemble "
    "into one tree (QueryResult.stats['trace'], Chrome-trace export, "
    "EXPLAIN ANALYZE Trace: line). Consulted by the multi-process "
    "runner; zero-cost when off (no-op spans, nothing shipped), and "
    "spans are never opened inside jit'd code"))
register(SessionProperty(
    "join_strategy", "varchar", "AUTOMATIC",
    "Join probe kernel: AUTOMATIC (cost model picks from build NDV/"
    "range stats) | SORTED_INDEX (searchsorted binary-search probe) | "
    "MATMUL (blocked one-hot matmul over the dense key domain — the "
    "MXU-native low-NDV path; infeasible builds fall back per build, "
    "reason in EXPLAIN ANALYZE)",
    lambda v: v in ("AUTOMATIC", "SORTED_INDEX", "MATMUL"),
    normalize=str.upper))
register(SessionProperty(
    "matmul_join_max_key_range", "integer", 1024,
    "Densest key domain the matmul join strategy will one-hot encode "
    "(per-probe-row MACs); AUTOMATIC picks matmul only when the "
    "build key range/pool size estimate fits (the measured low-NDV "
    "win region — BENCH_ROLE=kernels reports the crossover)",
    lambda v: v >= 2))
register(SessionProperty(
    "hybrid_join_enabled", "boolean", True,
    "Dynamic hybrid hash join: a join build under memory pressure "
    "partitions by a splitmix64 key sub-hash, keeps hot partitions "
    "device-resident, parks cold partitions through the spill tiers, "
    "and joins them in per-partition unspill->probe passes — the "
    "pool's revocation demotes one partition at a time instead of "
    "dumping the whole build (reference: 'Design Trade-offs for a "
    "Robust Dynamic Hybrid Hash Join'). Off = wholesale build spill "
    "(the pre-hybrid behavior); FULL OUTER joins always use it"))
register(SessionProperty(
    "hybrid_join_fanout", "integer", 0,
    "Build partition count for the hybrid hash join (rounded to a "
    "power of two, capped at 256). 0 = automatic: the HBO spill "
    "record of the node's previous run, else pool headroom vs bytes "
    "accumulated when pressure first hit",
    lambda v: v >= 0))
register(SessionProperty(
    "hybrid_join_max_depth", "integer", 3,
    "Recursion bound on repartitioning an unspilled partition that "
    "still exceeds the pool (each level quarters it); at the bound "
    "the partition joins anyway and may legitimately exceed the pool",
    lambda v: v >= 1))
register(SessionProperty(
    "aggregation_strategy", "varchar", "AUTOMATIC",
    "Distributed GROUP BY merge shape: AUTOMATIC (cost model picks "
    "from group-count estimates) | EXCHANGE (all_to_all of partial "
    "groups + per-device merge-final) | GLOBAL_HASH (one replicated "
    "device-resident table updated by collective scatter-add — the "
    "low-NDV path of 'Global Hash Tables Strike Back!')",
    lambda v: v in ("AUTOMATIC", "EXCHANGE", "GLOBAL_HASH"),
    normalize=str.upper))
register(SessionProperty(
    "global_hash_agg_max_table", "integer", 16384,
    "Largest global-hash aggregation table (slots, 2x the group-count "
    "bound) AUTOMATIC will pick; past it the exchange+merge-final "
    "shape moves fewer bytes than the table all-reduce",
    lambda v: v >= 16))
register(SessionProperty(
    "plan_cache_enabled", "boolean", True,
    "Cache analysis->plan->optimize output per normalized statement "
    "shape (+ literal vector + session fingerprint + connector "
    "snapshot versions) AND share the compiled PageProcessors, so a "
    "repeat statement skips parse/plan entirely and performs zero jit "
    "traces (the prepared-statement analog of the _exchange_program "
    "lru_cache). Invalidation is structural: DDL/writes bump the "
    "connector snapshot version and SET SESSION moves the fingerprint, "
    "so stale entries can never be served"))
register(SessionProperty(
    "plan_cache_entries", "integer", 256,
    "LRU bound on resident plan-cache entries (one entry per "
    "shape x literal-vector x fingerprint combination)",
    lambda v: v >= 1))
register(SessionProperty(
    "result_cache_enabled", "boolean", False,
    "Serve repeat deterministic SELECTs straight from cached rows, "
    "keyed WITH literals and invalidated by connector snapshot "
    "versions; cached pages charge a dedicated QueryMemoryPool and "
    "evict LRU over budget. Off by default: repeated dashboards opt "
    "in (statements over unversioned/live catalogs never cache)"))
register(SessionProperty(
    "admission_batching_enabled", "boolean", True,
    "Dispatcher-side admission batching: a burst of same-shape "
    "statements queued for one resource group executes under ONE "
    "admission slot (identical texts coalesce to a single execution, "
    "demuxed per submitter); shapes that diverge fall back to plain "
    "serial dispatch, byte-equal by construction"))
register(SessionProperty(
    "admission_batch_max", "integer", 16,
    "Largest statement burst one admission slot may absorb",
    lambda v: v >= 2))
register(SessionProperty(
    "plan_template_enabled", "boolean", True,
    "Value-independent plan templates: plan a statement "
    "SHAPE once with its cache-marked literals as opaque ParamRef "
    "slots, then serve every literal vector of the shape from that one "
    "optimized plan and the one set of compiled (param-slotted) "
    "PageProcessors — a new-literal repeat statement performs zero "
    "planning and zero jit traces. Shapes whose planning genuinely "
    "depends on a literal value fall back to per-statement planning, "
    "loudly counted by reason (trino_plan_template_total)"))
register(SessionProperty(
    "batched_execution_enabled", "boolean", True,
    "Single-launch batched execution: a same-shape admission burst "
    "stacks its literal vectors on a (B,) axis and runs each "
    "scan->filter/project pipeline stage as ONE vmapped device launch "
    "(per-statement demux of result pages; ACL and result-cache "
    "semantics enforced per member exactly as the serial path). "
    "Requires plan_template_enabled; ineligible plans execute serially "
    "through the shared template, byte-equal by construction"))
register(SessionProperty(
    "batched_execution_max_depth", "integer", 16,
    "Deepest (B,) literal-batch axis one vmapped launch may carry; "
    "larger bursts execute in chunks of this depth",
    lambda v: v >= 2))
register(SessionProperty(
    "batched_execution_min_shape_uses", "integer", 2,
    "Submissions of a statement shape (a batch of B counts as B) "
    "before it earns a plan template — the build trial must amortize; "
    "shapes with recorded history (HBO statement hint) qualify "
    "immediately",
    lambda v: v >= 1))
register(SessionProperty(
    "plan_template_seed_enabled", "boolean", True,
    "Distributed template-cache coherence: the "
    "coordinator's per-shape earn totals and fallback verdicts "
    "piggyback on worker configure() and the heartbeat, so a "
    "replacement or steady-state worker rides an already-earned "
    "template on its first statement instead of re-earning "
    "batched_execution_min_shape_uses locally (and skips shapes the "
    "cluster already proved value-dependent). No effect when "
    "plan_template_enabled is off"))
register(SessionProperty(
    "batched_execution_pad_rows_limit", "integer", 1_000_000,
    "HBO-informed padding policy: when the shape's recorded scan rows "
    "reach this limit, batch depth pads to the exact member count "
    "instead of the next power of two (padding lanes re-scan the "
    "whole input — FLOPs that stop paying once pages are large)",
    lambda v: v >= 1))
register(SessionProperty(
    "query_profiling_enabled", "boolean", False,
    "Compiled-program profiling (telemetry.profiler): record trace/"
    "compile wall and XLA cost_analysis/memory_analysis per program, "
    "attribute flops/bytes/compile-ms per operator, and serve the "
    "registry on system.runtime.kernels. Zero-cost when off (the "
    "profiler is never consulted inside traced code); EXPLAIN ANALYZE "
    "VERBOSE enables it for its own run regardless"))
register(SessionProperty(
    "slow_query_log_threshold", "double", 0.0,
    "Seconds of query wall time above which a structured slow-query "
    "record (trace critical path + top cost-attributed operators) is "
    "attached to the QueryCompletedEvent and surfaced in "
    "system.runtime.queries. 0 disables the log"))
register(SessionProperty(
    "tracing_otlp_endpoint", "varchar", "",
    "OTLP/HTTP collector URL (e.g. http://host:4318/v1/traces): when "
    "set, the finished span tree of every traced query exports "
    "best-effort as OTLP JSON; empty = no export, and failures are "
    "silently swallowed (an exporter must never fail a query)"))
register(SessionProperty(
    "hbo_enabled", "boolean", True,
    "History-based statistics (telemetry.stats_store): record per-"
    "plan-node actuals (rows/bytes/peak memory/wall/flops) after every "
    "executed query, keyed by (statement shape, canonical node "
    "fingerprint), and let recorded history beat connector estimates "
    "in the join/agg strategy rules, adaptive partial-agg seeding, "
    "admission sizing, and progress fallback. EXPLAIN annotates "
    "source=hbo per overridden estimate; a material misestimate on a "
    "decision node invalidates cached plans of the shape so the next "
    "run re-plans from history. Off = exactly the pre-HBO engine: no "
    "store writes, no per-page stats collection"))
register(SessionProperty(
    "hbo_reorder_joins_enabled", "boolean", True,
    "Let recorded history price the cost-based join-order exploration "
    "(ReorderJoins' DP over the flattened inner-join region): observed "
    "per-relation cardinalities beat connector estimates, so a "
    "connector lying by orders of magnitude reorders the join tree on "
    "the statement's second run (EXPLAIN tags such relations [hbo] in "
    "the order provenance). Off = the DP prices from connector "
    "estimates only; no effect when hbo_enabled is off"))
register(SessionProperty(
    "hbo_distribution_enabled", "boolean", True,
    "Let recorded history drive the broadcast-vs-partitioned exchange "
    "choice: observed build rows beat broadcast_join_threshold "
    "comparisons against connector estimates, and a build that "
    "SPILLED on a prior run refuses broadcast outright (replicating a "
    "build that overflowed one task's memory is strictly worse than "
    "partitioning it). EXPLAIN renders distribution=... [source=hbo] "
    "on affected joins. Off = connector estimates only; no effect "
    "when hbo_enabled is off"))
register(SessionProperty(
    "hbo_store_path", "varchar", "",
    "JSON sidecar path for the history store: loaded before the first "
    "HBO-planned query of a process, re-saved after every recording, "
    "so history survives restarts (atomic tmp+rename writes; a corrupt "
    "sidecar warns loudly and starts empty). Empty = in-memory only"))
register(SessionProperty(
    "hbo_ewma_alpha", "double", 0.4,
    "EWMA weight of the newest observation when merging per-node "
    "actuals across runs (the first run seeds exactly); smaller = "
    "smoother history, larger = faster adaptation to drift",
    lambda v: 0 < v <= 1))
register(SessionProperty(
    "device_exchange_sizing", "varchar", "history",
    "How the device collective picks its all_to_all lane capacity "
    "(per_dest): EXACT = count-first pass (tiny counting collective, "
    "zero overflow retries by construction); HISTORY = EWMA of observed "
    "loads per exchange shape pre-sizes repeat shapes and skips the "
    "count pass, falling back to EXACT until confident; LEGACY = "
    "capacity guess with the doubling-retry overflow protocol (the 2x "
    "re-shuffle cliff under skew)",
    lambda v: v in ("exact", "history", "legacy"),
    normalize=str.lower))
register(SessionProperty(
    "partial_stage_retry", "boolean", False,
    "Streaming fault tolerance without the barrier: producer tasks "
    "retain their serialized frames (durable streams), tee output into "
    "the external spool backend, and on producer loss the coordinator "
    "restarts ONLY that task — consumers resume from their ack cursors "
    "(deterministic replay) or adopt the committed spool object, with "
    "zero whole-query retries (reference: the spooling exchange "
    "half of fault-tolerant execution, applied per task)"))
register(SessionProperty(
    "autoscale_enabled", "boolean", False,
    "Elastic membership: the coordinator's monitor drives a "
    "deterministic hysteresis-guarded autoscaler from resource-group "
    "queue depth + heartbeat snapshots, growing the cluster with "
    "add_workers and shrinking it with drain-based retire_worker"))
register(SessionProperty(
    "autoscale_min_workers", "integer", 1,
    "Autoscaler floor: scale-down never drops the cluster below this "
    "many workers, and a below-floor cluster restores immediately",
    lambda v: v >= 1))
register(SessionProperty(
    "autoscale_max_workers", "integer", 8,
    "Autoscaler ceiling for scale-up decisions",
    lambda v: v >= 1))
register(SessionProperty(
    "autoscale_cooldown_s", "double", 10.0,
    "Seconds after any scale decision during which the autoscaler "
    "holds (hysteresis against membership flapping)",
    lambda v: v >= 0))
register(SessionProperty(
    "autoscale_up_queue_depth", "integer", 1,
    "Queued-query depth (summed over resource groups) that must "
    "persist for consecutive monitor ticks before the cluster doubles",
    lambda v: v >= 1))
register(SessionProperty(
    "autoscale_down_idle_ticks", "integer", 4,
    "Consecutive idle monitor ticks (nothing queued or running) "
    "before ONE worker drains and retires",
    lambda v: v >= 1))


def _parse(prop: SessionProperty, raw):
    try:
        if prop.type == "integer":
            return int(raw)
        if prop.type == "double":
            return float(raw)
        if prop.type == "boolean":
            if isinstance(raw, bool):
                return raw
            return str(raw).lower() in ("true", "1", "on")
        return str(raw)
    except (TypeError, ValueError):
        raise TrinoError(
            f"invalid value {raw!r} for session property {prop.name} "
            f"({prop.type})", "INVALID_SESSION_PROPERTY")


def set_property(properties: Dict[str, Any], name: str, raw):
    prop = REGISTRY.get(name)
    if prop is None:
        raise TrinoError(f"unknown session property: {name}",
                         "INVALID_SESSION_PROPERTY")
    value = _parse(prop, raw)
    if prop.normalize is not None:
        value = prop.normalize(value)
    if prop.validate is not None and not prop.validate(value):
        raise TrinoError(
            f"value {value!r} out of range for {name}",
            "INVALID_SESSION_PROPERTY")
    properties[name] = value


def value(session, name: str):
    prop = REGISTRY[name]
    return session.properties.get(name, prop.default)


def prop_value(properties: Dict[str, Any], name: str):
    """``value`` over a bare properties dict (worker-side: the session
    rides RPC requests as a plain mapping) — one default-resolution
    path, not a per-call-site closure."""
    return properties.get(name, REGISTRY[name].default)


def listing(session) -> List[tuple]:
    out = []
    for name in sorted(REGISTRY):
        p = REGISTRY[name]
        out.append((name, str(value(session, name)), str(p.default),
                    p.type, p.description))
    return out
