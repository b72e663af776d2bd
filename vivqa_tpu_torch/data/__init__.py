"""Host-side data handling (counterpart of vivqa_tpu/data; copies of its
jax-free modules, and the port's own loader and prefetcher)."""

from vivqa_tpu_torch.data.actions import (build_image_index, data_statistics,
                                          load_data_split, load_raw_data,
                                          parse_answers, save_data,
                                          split_data, validate_samples)
from vivqa_tpu_torch.data.augmentation import (CLIP_MEAN, CLIP_STD,
                                               STRENGTH_PRESETS,
                                               DropoutScheduler,
                                               ImageAugmentation,
                                               TextAugmentation,
                                               create_text_augmentation,
                                               normalize_pixels_on_device)
from vivqa_tpu_torch.data.dataset import (GenerativeVQADataset, VQADataset,
                                          generative_collate, vqa_collate)
from vivqa_tpu_torch.data.loader import BatchLoader, device_prefetch
from vivqa_tpu_torch.data.schema import OneSample
from vivqa_tpu_torch.data.synthetic import (ensure_synthetic_vivqa,
                                            generate_synthetic_vivqa,
                                            synthetic_samples)
from vivqa_tpu_torch.data.tokenizer import (PretrainedTokenizer,
                                            WhitespaceTokenizer,
                                            create_tokenizer)
from vivqa_tpu_torch.data.vocab import (build_answer_vocab,
                                        encode_answer_counts,
                                        majority_answer)
from vivqa_tpu_torch.train.losses import IGNORE_INDEX

__all__ = [
    "OneSample", "load_raw_data", "split_data", "validate_samples",
    "data_statistics", "parse_answers", "build_image_index", "save_data",
    "load_data_split",
    "ImageAugmentation", "CLIP_MEAN", "CLIP_STD", "STRENGTH_PRESETS",
    "normalize_pixels_on_device",
    "TextAugmentation", "create_text_augmentation", "DropoutScheduler",
    "VQADataset", "GenerativeVQADataset", "vqa_collate", "generative_collate",
    "IGNORE_INDEX", "BatchLoader", "device_prefetch",
    "WhitespaceTokenizer", "PretrainedTokenizer", "create_tokenizer",
    "build_answer_vocab", "majority_answer", "encode_answer_counts",
    "ensure_synthetic_vivqa", "generate_synthetic_vivqa",
    "synthetic_samples",
]
