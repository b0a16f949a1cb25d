from repro_torch.models.model import DecoderLM, Model, build_model

__all__ = ["DecoderLM", "Model", "build_model"]
