from repro_torch.serving.engine import BatchStats, Request, Result, \
    ServeEngine

__all__ = ["BatchStats", "Request", "Result", "ServeEngine"]
