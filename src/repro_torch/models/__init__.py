from repro_torch.models.registry import build_model, Model
