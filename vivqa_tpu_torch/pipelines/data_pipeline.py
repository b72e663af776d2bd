"""Data pipeline: 9 deterministic, self-validating steps (counterpart of
vivqa_tpu/pipelines/data_pipeline.py, with its config fields and
defaults).

Counterpart of src/core/data_pipeline.py:84-615 in the reference:
load raw -> validate -> statistics -> split -> answer vocab -> tokenizer
-> transforms -> loaders -> fetched-batch structural check. Each step
logs through PipelineLogger; the batch check raises on the keys, shapes
and label ranges the reference's step 9 (:567-615) asserts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data import (BatchLoader, GenerativeVQADataset,
                                  ImageAugmentation, VQADataset,
                                  build_answer_vocab,
                                  create_text_augmentation, create_tokenizer,
                                  data_statistics, generative_collate,
                                  load_raw_data, split_data, validate_samples,
                                  vqa_collate)
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class DataPipelineConfig(ConfigBase):
    csv_path: str = ""
    image_dir: str = ""
    image_size: int = 224
    max_question_length: int = 64
    max_answer_length: int = 64
    batch_size: int = 32
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    min_answer_freq: int = 1
    min_token_freq: int = 1
    tokenizer_name: str = ""          # HF name; empty -> whitespace
    augmentation_strength: str = "medium"
    # train-split TextAugmentation probability; 0 = off (reference
    # augmentation.py:350-473, create_text_augmentation :593)
    text_augmentation: float = 0.0
    seed: int = 42
    max_samples: int = 0              # 0 = all
    generative: bool = False
    answer_selection: str = "majority"


@dataclasses.dataclass
class DataPipelineOutput:
    train_loader: BatchLoader
    val_loader: BatchLoader
    test_loader: BatchLoader
    answer2id: Dict[str, int]
    id2answer: Dict[int, str]
    tokenizer: object
    train_transform: ImageAugmentation
    eval_transform: ImageAugmentation
    statistics: Dict
    # raw train split (OneSample list), for stages that build on the QA
    # pairs (the JAX package's knowledge provider)
    train_samples: list = dataclasses.field(default_factory=list)


class DataPipeline:
    def __init__(self, config: DataPipelineConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def run(self, samples=None) -> DataPipelineOutput:
        cfg = self.config
        log = self.log
        log.start_stage("data_pipeline")

        # 1. load raw
        if samples is None:
            if not cfg.csv_path:
                raise ValueError(
                    "data.csv_path is required (set it in the YAML config "
                    "or pass --csv-path)")
            samples = load_raw_data(cfg.csv_path, cfg.image_dir or None,
                                    max_samples=cfg.max_samples or None)
        log.success(f"step 1/9 loaded {len(samples)} samples")

        # 2. validate
        samples, problems = validate_samples(samples)
        if problems:
            log.warning(f"step 2/9 dropped {len(problems)} invalid samples")
        else:
            log.success("step 2/9 all samples valid")
        if not samples:
            raise ValueError("no valid samples after validation")

        # 3. statistics
        stats = data_statistics(samples)
        log.success(f"step 3/9 stats: {stats['num_samples']} samples, "
                    f"{stats['num_unique_answers']} unique answers")

        # 4. split
        train, val, test = split_data(samples, cfg.train_ratio,
                                      cfg.val_ratio, cfg.seed)
        log.success(f"step 4/9 split {len(train)}/{len(val)}/{len(test)}")

        # 5. answer vocab (train split only)
        answer2id, id2answer = build_answer_vocab(train, cfg.min_answer_freq)
        log.success(f"step 5/9 answer vocab: {len(answer2id)} entries "
                    f"(<unk>=0)")

        # 6. tokenizer (+ round-trip smoke test, reference :383-393)
        corpus = [s.question for s in samples] + \
                 [a for s in samples for a in s.answers]
        tokenizer = create_tokenizer(cfg.tokenizer_name or None,
                                     cfg.max_question_length, corpus,
                                     cfg.min_token_freq)
        probe = tokenizer.encode_batch([train[0].question])
        if probe["input_ids"].shape[1] != cfg.max_question_length:
            raise ValueError(f"tokenizer pads to {probe['input_ids'].shape[1]}"
                             f", not {cfg.max_question_length}")
        log.success(f"step 6/9 tokenizer vocab={tokenizer.vocab_size}")

        # 7. transforms (+ probe on a real image, reference :437-456)
        train_tf = ImageAugmentation(cfg.image_size, "train",
                                     cfg.augmentation_strength, cfg.seed)
        eval_tf = ImageAugmentation(cfg.image_size, "eval")
        probe_img = eval_tf(train[0].image_path)
        if probe_img.shape != (cfg.image_size, cfg.image_size, 3):
            raise ValueError(f"bad probe image shape {probe_img.shape}")
        text_tf = None
        if cfg.text_augmentation > 0:
            text_tf = create_text_augmentation(cfg.text_augmentation,
                                               seed=cfg.seed)
        log.success("step 7/9 transforms validated"
                    + (f" (text aug p={cfg.text_augmentation})"
                       if text_tf else ""))

        # 8. datasets + loaders (text augmentation on the train split only)
        def mk(s, tf, shuf, ttf=None):
            if cfg.generative:
                ds = GenerativeVQADataset(s, tokenizer, tf,
                                          cfg.max_question_length,
                                          cfg.max_answer_length,
                                          cfg.answer_selection,
                                          text_transform=ttf)
                collate = generative_collate
            else:
                ds = VQADataset(s, tokenizer, answer2id, tf,
                                cfg.max_question_length, text_transform=ttf)
                collate = vqa_collate
            return BatchLoader(ds, cfg.batch_size, collate, shuffle=shuf,
                               seed=cfg.seed, drop_last=shuf)
        train_loader = mk(train, train_tf, True, text_tf)
        val_loader = mk(val or train[:1], eval_tf, False)
        test_loader = mk(test or val or train[:1], eval_tf, False)
        log.success(f"step 8/9 loaders: {len(train_loader)} train batches")

        # 9. fetched-batch structural check (reference :567-615)
        batch = next(iter(train_loader))
        self._validate_batch(batch, cfg, len(answer2id))
        log.success("step 9/9 batch validation passed")
        log.end_stage("data_pipeline")

        return DataPipelineOutput(train_loader, val_loader, test_loader,
                                  answer2id, id2answer, tokenizer,
                                  train_tf, eval_tf, stats,
                                  train_samples=list(train))

    def _validate_batch(self, batch: Dict, cfg: DataPipelineConfig,
                        num_answers: int) -> None:
        B = min(cfg.batch_size, batch["pixel_values"].shape[0])
        if batch["pixel_values"].shape != (B, cfg.image_size,
                                           cfg.image_size, 3):
            raise ValueError(
                f"bad pixel shape {batch['pixel_values'].shape}")
        if cfg.generative:
            required = ("pixel_values", "question_ids", "question_mask",
                        "decoder_input_ids", "decoder_mask", "labels")
        else:
            required = ("pixel_values", "input_ids", "attention_mask",
                        "labels", "answer_counts")
        missing = [k for k in required if k not in batch]
        if missing:
            raise ValueError(f"batch missing keys {missing}")
        if cfg.generative:
            if batch["decoder_input_ids"].shape != (B, cfg.max_answer_length):
                raise ValueError(f"bad decoder_input_ids shape "
                                 f"{batch['decoder_input_ids'].shape}")
        else:
            labels = np.asarray(batch["labels"])
            if labels.min() < 0 or labels.max() >= num_answers:
                raise ValueError(f"label out of range [0, {num_answers})")
