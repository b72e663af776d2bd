"""Model pipeline: self-validating build of the classification model
(counterpart of vivqa_tpu/pipelines/model_pipeline.py).

Counterpart of src/core/model_pipeline.py:80-588 in the reference: device
setup -> nested config build -> create model with seeded weights ->
param-count table -> dummy forward validation. ``load_checkpoint`` infers
num_answers from the checkpoint's metadata or its answer-head bias and
merges the weights by name and shape (``train/checkpoint.py:
partial_load``). The JAX package's mesh field becomes ``device``: the
card unless the caller asks for the CPU. Pretrained towers wait for the
HF import (ROADMAP.md Queue A item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import VQAModelConfig
from vivqa_tpu_torch.models.vqa_model import (VietnameseVQAModel,
                                              create_vqa_model)
from vivqa_tpu_torch.pipelines.common import count_parameters
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              partial_load)
from vivqa_tpu_torch.utils import get_pipeline_logger

HEAD_BIAS = "answer_head.classifier.bias"


@dataclasses.dataclass(frozen=True)
class ModelPipelineConfig(ConfigBase):
    model: VQAModelConfig = dataclasses.field(default_factory=VQAModelConfig)
    device: str = "cuda"
    seed: int = 42
    validate_forward: bool = True
    # HF name-or-path of pretrained towers to initialize from; empty =
    # random init (not ported yet: ROADMAP.md Queue A item 13)
    pretrained_visual: str = ""
    pretrained_text: str = ""


@dataclasses.dataclass
class ModelPipelineOutput:
    model: VietnameseVQAModel
    device: torch.device
    param_counts: dict


class ModelPipeline:
    def __init__(self, config: ModelPipelineConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def run(self, num_answers: Optional[int] = None) -> ModelPipelineOutput:
        cfg = self.config
        log = self.log
        if cfg.pretrained_visual or cfg.pretrained_text:
            raise NotImplementedError(
                "pretrained towers (pretrained_visual / pretrained_text) "
                "need the HF import, not ported yet (ROADMAP.md Queue A "
                "item 13)")
        log.start_stage("model_pipeline")

        # 1. device setup
        device = resolve_device(cfg.device)
        log.success(f"step 1/7 device {device}"
                    + (f" ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else ""))

        # 2. config assembly
        model_cfg = cfg.model
        if num_answers is not None:
            model_cfg = model_cfg.replace(num_answers=num_answers)
        log.success(f"step 2/7 config: visual={model_cfg.visual.backbone} "
                    f"text={model_cfg.text.backbone} "
                    f"fusion={model_cfg.fusion.fusion_type} "
                    f"moe={model_cfg.moe.use_moe} "
                    f"answers={model_cfg.num_answers}")

        # 3/4. create model, weights from the seed
        model = create_vqa_model(
            model_cfg, device=device,
            generator=torch.Generator().manual_seed(cfg.seed))
        log.success("step 3/7 model created")
        log.success("step 4/7 params initialized")

        # 5. param counts
        counts = count_parameters(model)
        log.log_model_architecture(type(model).__name__, counts)

        # 6/7. dummy forward validation (reference :428-480)
        if cfg.validate_forward:
            s = model_cfg.visual.image_size
            px = torch.zeros((2, s, s, 3), dtype=torch.float32,
                             device=device)
            ids = torch.ones((2, model_cfg.text.max_length),
                             dtype=torch.long, device=device)
            # the knowledge branch runs only with contexts: dummy ones,
            # as the JAX pipeline feeds its init and check
            know = {}
            if model_cfg.knowledge.use_knowledge:
                kc = model_cfg.knowledge
                know = {"knowledge_embeddings": torch.zeros(
                            (2, kc.num_retrieved, kc.knowledge_dim),
                            device=device),
                        "knowledge_mask": torch.ones(
                            (2, kc.num_retrieved), dtype=torch.long,
                            device=device)}
            with torch.no_grad():
                logits = model(px, ids, **know)["logits"]
            expected = (2, model_cfg.num_answers)
            if tuple(logits.shape) != expected:
                raise RuntimeError(f"logits {tuple(logits.shape)} != "
                                   f"{expected}")
            if not torch.isfinite(logits.float()).all():
                raise RuntimeError("dummy forward gave non-finite logits")
            log.success(f"step 7/7 dummy forward validated "
                        f"logits={tuple(logits.shape)}")

        log.end_stage("model_pipeline")
        return ModelPipelineOutput(model, device, counts)

    def load_checkpoint(self, ckpt_dir: str,
                        num_answers: Optional[int] = None):
        """Rebuild the model from the best checkpoint of ``ckpt_dir``;
        num_answers from the argument, else the checkpoint's metadata,
        else its answer-head bias. Returns (output, metadata)."""
        mgr = CheckpointManager(CheckpointConfig(directory=ckpt_dir))
        restored, meta = mgr.restore_best(map_location="cpu")
        params = restored["params"] if "params" in restored else restored
        if num_answers is None:
            num_answers = meta.get("num_answers")
        if num_answers is None:
            if HEAD_BIAS not in params:
                raise ValueError("cannot infer num_answers from checkpoint")
            num_answers = int(params[HEAD_BIAS].shape[0])
            self.log.info("inferred num_answers=%d from checkpoint",
                          num_answers)
        out = self.run(num_answers=num_answers)
        partial_load(params, out.model, self.log)
        return out, meta
