"""Executable gradient sync (the port of ``repro.distributed``): the
strategy zoo (``collectives``), gradient compression (``compression``),
bucketed comm/compute overlap (``overlap``) and the data-parallel trainer
(``trainer``), in one process or one process per card, the
bounded-staleness parameter server (``async_ps``) and 1F1B pipeline
parallelism (``pipeline``), one process driving every stage; and the
sharded rank program (``layout``, ``spmd``) that the models run under a
mesh.

The names below load their module on first use, so that the models can
import ``spmd`` without loading the trainers, which import the models.
"""
import importlib

_EXPORTS = {
    "AsyncPSReport": "async_ps", "AsyncPSTrainer": "async_ps",
    "STRATEGIES": "collectives", "Group": "collectives",
    "SyncStrategy": "collectives", "flatten_tree": "collectives",
    "get_strategy": "collectives", "unflatten_tree": "collectives",
    "COMPRESSORS": "compression", "Compressor": "compression",
    "get_compressor": "compression",
    "BucketPlan": "overlap", "build_bucket_plan": "overlap",
    "PipelineReport": "pipeline", "PipelineTrainer": "pipeline",
    "DataParallelTrainer": "trainer", "SyncReport": "trainer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
