"""Serving subsystem of the port: continuous batching with fused outcome
recording (see ``engine``), the page pool and the outcome recorder."""

from repro_torch.serving.engine import (  # noqa: F401
    Engine,
    EngineLedgerHandle,
    EngineState,
    Request,
    delayed_outcomes,
    insert_cache_slot,
    insert_paged_cache_slot,
    make_slot_sampler,
    pad_safe,
)
from repro_torch.serving.pages import PagePool, pages_for  # noqa: F401
from repro_torch.serving.recorder import (  # noqa: F401
    RETENTIONS,
    OutcomeRecorder,
    RecorderState,
    topk_score,
)
