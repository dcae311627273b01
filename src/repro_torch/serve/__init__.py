"""Registration-as-a-service: the serving front end of the solver stack
(port of ``repro.serve``).

    from repro_torch import serve

    with serve.Server(serve.ServeConfig(max_batch=4,
                                        cache_dir="cache/")) as server:
        fut = server.submit(serve.Request(m0, m1, subject="patient-7"))
        print(fut.result().mismatch_rel)

Requests are bucketed by (grid shape, solver variant, measure), dynamically
batched into padded Newton-solve waves on the card (``ServeConfig(device=
"cpu")`` for the plain PyTorch path), or slab-sharded over a layout of
ranks, and warm-started from a per-subject velocity cache persisted
through ``repro_torch.checkpoint``. See ``repro_torch.serve.server`` for
the pipeline and ``repro_torch.launch.serve_registration`` for the asyncio
front end.
"""

from .batching import BucketKey, RequestQueue
from .cache import WarmStartCache
from .metrics import ServeStats, percentile
from .request import Request, RequestResult
from .server import ServeConfig, Server

__all__ = [
    "BucketKey",
    "percentile",
    "Request",
    "RequestQueue",
    "RequestResult",
    "ServeConfig",
    "Server",
    "ServeStats",
    "WarmStartCache",
]
