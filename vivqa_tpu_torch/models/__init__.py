"""Models of the port (counterpart of vivqa_tpu/models)."""
from vivqa_tpu_torch.models.config import (AnswerHeadConfig,
                                           DecoderVQAConfig, FusionConfig,
                                           GenerativeVQAConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig,
                                           get_default_generative_vqa_config,
                                           get_default_vietnamese_vqa_config)
from vivqa_tpu_torch.models.decoder_vqa import (DecoderVQAModel,
                                                create_decoder_vqa_model)
from vivqa_tpu_torch.models.generative import (GenerativeVQAModel,
                                               create_generative_vqa_model)
from vivqa_tpu_torch.models.vqa_model import (VietnameseVQAModel,
                                              create_vqa_model)

__all__ = [
    "VisualEncoderConfig",
    "TextEncoderConfig",
    "FusionConfig",
    "AnswerHeadConfig",
    "VQAModelConfig",
    "GenerativeVQAConfig",
    "DecoderVQAConfig",
    "VietnameseVQAModel",
    "GenerativeVQAModel",
    "create_vqa_model",
    "create_generative_vqa_model",
    "DecoderVQAModel",
    "create_decoder_vqa_model",
    "get_default_vietnamese_vqa_config",
    "get_default_generative_vqa_config",
]
