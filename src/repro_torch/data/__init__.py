from .pipeline import Prefetcher, TokenLoader
from .synthetic import ClassifyTask, TokenTask

__all__ = ["TokenTask", "ClassifyTask", "TokenLoader", "Prefetcher"]
