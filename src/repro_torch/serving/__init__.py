"""``repro_torch.serving`` — the serving API (port of ``repro.serving``).

```python
import torch

from repro_torch import serving
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params

spec = serving.ServingSpec(layout="compressed", sparsity=(2, 4), slots=4)
cfg = spec.apply_to(get_smoke_config("internlm2_1_8b"))
params = init_params(torch.Generator().manual_seed(0), cfg)
prepared = serving.prepare(params, spec, cfg=cfg)          # on CUDA
report = serving.Engine(prepared).run(serving.make_poisson_trace(seed=0))
```
"""

from .engine import Engine, RequestStats, ServingReport, percentile
from .scheduler import PagedScheduler, Request
from .spec import (Prepared, ServingSpec, config_from_manifest, prepare,
                   prepare_from_artifact, resolve_device, spec_from_manifest)
from .traffic import make_poisson_trace

__all__ = [
    "Engine",
    "PagedScheduler",
    "Prepared",
    "Request",
    "RequestStats",
    "ServingReport",
    "ServingSpec",
    "config_from_manifest",
    "make_poisson_trace",
    "percentile",
    "prepare",
    "prepare_from_artifact",
    "resolve_device",
    "spec_from_manifest",
]
