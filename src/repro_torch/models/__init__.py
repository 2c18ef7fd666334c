from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
