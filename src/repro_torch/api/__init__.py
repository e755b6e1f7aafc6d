"""Public API facade of the PyTorch wizard.

    from repro_torch.api import TuningSession, WizardConfig, SearchConfig

The counterpart of `repro.api` for the wizard's query path.
`from_reference` carries a store and a tuned state from the JAX package
(as numpy arrays and `state_to_json` output) into this one.
"""
from repro_torch.core.quality import MaintenanceCostModel, QualityWeights
from repro_torch.core.search import SearchConfig
from repro_torch.core.wizard import WizardConfig

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
    "Carried",
    "from_reference",
]
