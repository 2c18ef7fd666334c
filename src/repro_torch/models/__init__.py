from repro_torch.models.model import Model, build_model, make_batch

__all__ = ["Model", "build_model", "make_batch"]
