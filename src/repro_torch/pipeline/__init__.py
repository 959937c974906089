"""Closed pipeline of the port: workload → batcher → stability → ordering.

The four decoupled HT-Paxos stages (§4.1) as one :func:`pipeline_tick`
(``closed``), driven by pre-drawn client workload tensors
(``workload``), through the tensor twin of the byte-budget batcher
(``vbatch``), a per-node lag delivery model, and the gated engine behind
the ``engine.api`` facade. The reference's jitted run is
:func:`run_pipeline`, which on a CUDA device replays one captured CUDA
graph of the lock-step tick; :func:`pipeline_tick` runs eagerly.
"""
from .closed import (PipelineConfig, PipelineState, build_route_table,
                     committed, decode_merged, init_pipeline, lane_bid,
                     pipeline_tick, plan_admissions, reconfigure_pipeline,
                     run_pipeline)
from .vbatch import BatchState, TickFlushes, batch_step, init_batch_state, \
    tick_flushes
from .workload import Workload, WorkloadModel

__all__ = [
    "PipelineConfig", "PipelineState", "build_route_table", "committed",
    "decode_merged", "init_pipeline", "lane_bid", "pipeline_tick",
    "plan_admissions", "reconfigure_pipeline", "run_pipeline",
    "BatchState", "TickFlushes", "batch_step", "init_batch_state",
    "tick_flushes",
    "Workload", "WorkloadModel",
]
