"""Fault-tolerant batched CNN serving on the port's engine: the port of
``repro.serving``'s CNN front end (the token-shaped ``ServingEngine`` of
the language-model stack is not ported)."""
from repro_torch.serving.cnn import (CNNServer, FailedResult, ImageRequest,
                                     ImageResult, NonFiniteInputError,
                                     ServerWedgedError, ShedResult,
                                     SupervisorConfig)
from repro_torch.serving.degrade import DegradeController, Rung, default_ladder
from repro_torch.serving.faults import (EngineFault, FaultInjector,
                                        FaultScript, PersistentEngineFault,
                                        TransientEngineFault)

__all__ = ["CNNServer", "DegradeController", "EngineFault", "FailedResult",
           "FaultInjector", "FaultScript", "ImageRequest", "ImageResult",
           "NonFiniteInputError", "PersistentEngineFault", "Rung",
           "ServerWedgedError", "ShedResult", "SupervisorConfig",
           "TransientEngineFault", "default_ladder"]
