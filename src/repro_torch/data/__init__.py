from .synthetic import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
