"""repro_torch.api — the port's public surface, the reference's
``repro.api`` names with ``H100`` in ``V5E``'s place.

Close the survey's §4 auto-parallelisation loop in three calls:

    from repro_torch.api import Session, plan

    p = plan(cfg, shape, chips=world_size)           # search  (§4)
    print(p.summary())                               # inspect
    session = Session.from_plan(cfg, p)              # execute: plan ->
    session.train(...) / .generate / .serve          # one facade

Everything here is re-exported from the subsystem modules so callers
depend on ONE import path.
"""
from repro_torch.core.costmodel import Degrees, H100, Hardware  # noqa: F401
from repro_torch.core.planner import Plan, plan  # noqa: F401
from repro_torch.core.strategy import (MEGATRON_BASELINE,  # noqa: F401
                                       MEGATRON_SP, Strategy)
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,  # noqa: F401
                                     make_pipeline_mesh,
                                     make_production_mesh)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
from repro_torch.serve.driver import AsyncDriver, TokenStream  # noqa: F401
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.server import ServeHTTPServer  # noqa: F401
from repro_torch.api.session import Session  # noqa: F401

__all__ = [
    "Session", "Plan", "plan", "Strategy", "Degrees", "Hardware", "H100",
    "MEGATRON_BASELINE", "MEGATRON_SP", "TrainConfig", "Trainer",
    "AsyncDriver", "TokenStream", "ServeMetrics", "ServeHTTPServer",
    "make_mesh", "make_host_mesh", "make_pipeline_mesh",
    "make_production_mesh",
]
