"""repro_torch.core — serverless (a)sync federated learning, on the device.

Public API mirrors the paper's usage snippet:

    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, FederatedCallback
    from repro_torch.core.strategies import FedAvg

    node = AsyncFederatedNode(strategy=FedAvg(), store=connect("/mnt/shared/exp1"))
    callback = FederatedCallback(node, num_examples_per_epoch=...)
    trainer.fit(..., callbacks=[callback])
"""
from .callback import Callback, FederatedCallback
from .gossip import (
    GossipHierarchy,
    ShardedFolders,
    ShardedWeightStore,
    balanced_groups,
    default_group_of,
    read_roster,
    write_roster,
)
from .fleet import (
    ChaosEvent,
    ChaosSpec,
    FleetSpec,
    SoakReport,
    WorkerReport,
    assemble_report,
    chaos_schedule,
    claim_leases,
    claim_slots,
    fleet_state_hash,
    lease_fresh,
    read_lease_index,
    run_fleet_local,
    run_worker,
    try_adopt,
    worker_kill_victims,
)
from .node import AsyncFederatedNode, FederationTimeout, SyncFederatedNode
from .partition import partition_dataset, partition_sequence_dataset, skewed_assignment
from .serialize import (
    FlatUpdate,
    GroupSummary,
    NodeUpdate,
    SuperSummary,
    deserialize_group_summary,
    deserialize_obs_blob,
    deserialize_super_summary,
    deserialize_update,
    deserialize_update_delta,
    peek_meta,
    serialize_group_summary,
    serialize_obs_blob,
    serialize_super_summary,
    serialize_update,
    serialize_update_delta,
)
from .simulation import (
    ClientResult,
    ProcessCrashed,
    ProcessSupervisor,
    run_multiprocess,
    run_threaded,
    simulate_timeline,
    straggler_speedup,
)
from .store import (
    TRANSPORTS,
    CachingFolder,
    DiskFolder,
    InMemoryFolder,
    RetryFolder,
    S3Folder,
    SharedFolder,
    WeightStore,
    make_folder,
)
from .strategies import (
    STRATEGIES,
    FedAdagrad,
    FedAdam,
    FedAsync,
    FedAvg,
    FedAvgM,
    FedBuff,
    FedYogi,
    PartialFedAvg,
    Strategy,
    get_strategy,
)
from .telemetry import (
    SpanRecorder,
    Telemetry,
    chrome_trace,
    collect_obs,
    kernel_launches,
    telemetry_rollups,
)
from .transport import (
    PipelineStats,
    Prefetcher,
    TransportPipeline,
    family_transport_spec,
    normalize_transport,
    parse_folder_uri,
    parse_pipeline_spec,
)
from .tree import FAMILY_PATTERNS, FamilyView, LeafSpec, register_family, resolve_family_patterns

__all__ = [
    "AsyncFederatedNode", "SyncFederatedNode", "FederationTimeout",
    "Callback", "FederatedCallback",
    "NodeUpdate", "FlatUpdate", "serialize_update", "deserialize_update", "peek_meta",
    "serialize_obs_blob", "deserialize_obs_blob",
    "serialize_update_delta", "deserialize_update_delta",
    "GroupSummary", "SuperSummary", "serialize_group_summary", "deserialize_group_summary",
    "serialize_super_summary", "deserialize_super_summary",
    "GossipHierarchy", "ShardedFolders", "ShardedWeightStore", "default_group_of",
    "balanced_groups", "read_roster", "write_roster",
    "LeafSpec", "FamilyView", "FAMILY_PATTERNS", "register_family", "resolve_family_patterns",
    "SharedFolder", "InMemoryFolder", "DiskFolder", "S3Folder", "CachingFolder",
    "RetryFolder", "WeightStore", "TRANSPORTS", "make_folder",
    "TransportPipeline", "PipelineStats", "Prefetcher", "family_transport_spec",
    "normalize_transport", "parse_pipeline_spec", "parse_folder_uri",
    "Strategy", "FedAvg", "FedAvgM", "FedAdam", "FedYogi", "FedAdagrad", "FedAsync",
    "FedBuff", "PartialFedAvg", "STRATEGIES", "get_strategy",
    "skewed_assignment", "partition_dataset", "partition_sequence_dataset",
    "run_threaded", "run_multiprocess", "ClientResult", "ProcessCrashed", "ProcessSupervisor",
    "simulate_timeline", "straggler_speedup",
    "FleetSpec", "ChaosSpec", "ChaosEvent", "SoakReport", "WorkerReport", "chaos_schedule",
    "claim_leases", "claim_slots", "lease_fresh", "read_lease_index", "try_adopt",
    "worker_kill_victims", "fleet_state_hash", "run_worker", "run_fleet_local",
    "assemble_report",
    "Telemetry", "SpanRecorder", "collect_obs", "telemetry_rollups", "chrome_trace",
    "kernel_launches",
]
