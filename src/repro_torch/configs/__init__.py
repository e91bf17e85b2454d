from repro_torch.configs.base import BladeConfig

__all__ = ["BladeConfig"]
