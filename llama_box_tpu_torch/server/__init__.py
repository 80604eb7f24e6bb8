from .engine import Engine, EngineConfig
from .task import CompletionsTask, EmbeddingsTask, RerankTask

__all__ = ["Engine", "EngineConfig", "CompletionsTask", "EmbeddingsTask",
           "RerankTask"]
