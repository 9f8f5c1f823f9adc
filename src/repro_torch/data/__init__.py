from .synthetic import ClassifyTask, TokenTask

__all__ = ["TokenTask", "ClassifyTask"]
