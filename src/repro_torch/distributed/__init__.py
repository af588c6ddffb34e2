"""Executable gradient sync (the port of ``repro.distributed``): the
strategy zoo (``collectives``), gradient compression (``compression``),
bucketed comm/compute overlap (``overlap``) and the data-parallel trainer
(``trainer``), in one process or one process per card.  The async
parameter server and 1F1B pipelining are not ported yet (ROADMAP Next 2
and Next 3)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    STRATEGIES, Group, SyncStrategy, flatten_tree, get_strategy,
    unflatten_tree,
)
from repro_torch.distributed.compression import (  # noqa: F401
    COMPRESSORS, Compressor, get_compressor,
)
from repro_torch.distributed.overlap import (  # noqa: F401
    BucketPlan, build_bucket_plan,
)
from repro_torch.distributed.trainer import (  # noqa: F401
    DataParallelTrainer, SyncReport,
)
