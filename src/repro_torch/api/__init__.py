"""Public API facade of the PyTorch wizard.

    from repro_torch.api import TuningSession, WizardConfig, SearchConfig

The counterpart of `repro.api`: the wizard's query path, its streaming
maintenance, serving (`TuningSession.serve` / `serve_async` and the
frontend's config surface) and persistence (`save` / `load`).
`from_reference` carries a store, a tuned state and measured maintenance
costs from the JAX package (as numpy arrays and `serde` JSON) into this
one.
"""
from repro_torch.core.quality import MaintenanceCostModel, QualityWeights
from repro_torch.core.search import SearchConfig
from repro_torch.core.wizard import WizardConfig
from repro_torch.maintenance import (Delta, MaintenanceConfig,
                                     UpdateStream, ViewMaintainer)
# async serving frontend config surface (pure python)
from repro_torch.serve.frontend import (FrontendConfig,  # noqa: F401
                                        QueryClass, ServingFrontend)
from repro_torch.serve.loadgen import ClassSpec, TrafficConfig  # noqa: F401

from repro_torch.api.convert import Carried, from_reference  # noqa: F401
from repro_torch.api.session import (ApplyReport, RetuneReport,  # noqa: F401
                                     TuningSession)

__all__ = [
    "TuningSession",
    "RetuneReport",
    "ApplyReport",
    "WizardConfig",
    "SearchConfig",
    "QualityWeights",
    "MaintenanceCostModel",
    "MaintenanceConfig",
    "ViewMaintainer",
    "Delta",
    "UpdateStream",
    "FrontendConfig",
    "QueryClass",
    "ServingFrontend",
    "ClassSpec",
    "TrafficConfig",
    "Carried",
    "from_reference",
]
