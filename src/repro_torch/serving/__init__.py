"""Serving on the port: fault-tolerant batched CNN serving on the port's
engine (``CNNServer``) and the language models' continuous-batching
``ServingEngine`` — the port of ``repro.serving``."""
from repro_torch.serving.cnn import (CNNServer, FailedResult, ImageRequest,
                                     ImageResult, NonFiniteInputError,
                                     ServerWedgedError, ShedResult,
                                     SupervisorConfig)
from repro_torch.serving.degrade import DegradeController, Rung, default_ladder
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import (EngineFault, FaultInjector,
                                        FaultScript, PersistentEngineFault,
                                        TransientEngineFault)

__all__ = ["CNNServer", "DegradeController", "EngineFault", "FailedResult",
           "FaultInjector", "FaultScript", "ImageRequest", "ImageResult",
           "NonFiniteInputError", "PersistentEngineFault", "Request",
           "Rung", "ServerWedgedError", "ServingEngine", "ShedResult",
           "SupervisorConfig", "TransientEngineFault", "default_ladder"]
