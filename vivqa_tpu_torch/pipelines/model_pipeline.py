"""Model pipeline: self-validating build of the classification model
(counterpart of vivqa_tpu/pipelines/model_pipeline.py).

Counterpart of src/core/model_pipeline.py:80-588 in the reference: device
setup -> nested config build -> create model with seeded weights ->
param-count table -> dummy forward validation. ``load_checkpoint`` infers
num_answers from the checkpoint's metadata or its answer-head bias and
merges the weights by name and shape (``train/checkpoint.py:
partial_load``). ``device`` is the card unless the caller asks for the
CPU; ``mesh`` (read from the YAML's ``model.mesh``, as the JAX package's
field) joins the launched process group (``parallel/mesh.py``; one
process: the 1x1 mesh) and gives this rank its device. The model is
built whole on every rank; ``TrainingPipeline`` places it. Pretrained towers
(``pretrained_visual`` / ``pretrained_text``: a local HF model directory
or a model in the local HF cache, read without ``transformers`` by
``models/convert.py``) re-derive their encoder sub-configs from the HF
architecture; the model is built and seeded, then the converted weights
are grafted over its towers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import VQAModelConfig
from vivqa_tpu_torch.models.convert import (graft_pretrained,
                                            load_pretrained_text_encoder,
                                            load_pretrained_visual_encoder)
from vivqa_tpu_torch.models.vqa_model import (VietnameseVQAModel,
                                              create_vqa_model)
from vivqa_tpu_torch.parallel.mesh import Mesh, MeshConfig, create_mesh
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
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 42
    validate_forward: bool = True
    # HF name-or-path of pretrained towers to initialize from (converted
    # through models/convert.py; the encoder sub-configs are re-derived
    # from the HF architecture). Empty = random init. Counterpart of the
    # reference's AutoModel-backed encoders (src/core/
    # model_pipeline.py:303, vqa_model.py:83-98)
    pretrained_visual: str = ""
    pretrained_text: str = ""


@dataclasses.dataclass
class ModelPipelineOutput:
    model: VietnameseVQAModel
    device: torch.device
    param_counts: dict
    mesh: Optional[Mesh] = None


class ModelPipeline:
    def __init__(self, config: ModelPipelineConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def run(self, num_answers: Optional[int] = None) -> ModelPipelineOutput:
        cfg = self.config
        log = self.log
        log.start_stage("model_pipeline")

        # 1. mesh and device setup
        mesh = create_mesh(cfg.mesh, cfg.device)
        device = resolve_device(mesh.device)
        log.success(f"step 1/7 device {device}"
                    + (f" ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else "")
                    + f", mesh {mesh.shape}"
                    + (f" over {mesh.backend}" if mesh.backend else ""))

        # 2. config assembly: pretrained towers re-derive their encoder
        # sub-config from the HF architecture so the model's leaves match
        # the converted weights exactly
        model_cfg = cfg.model
        if num_answers is not None:
            model_cfg = model_cfg.replace(num_answers=num_answers)
        pre_visual = pre_text = None
        if cfg.pretrained_visual:
            enc, pre_visual = load_pretrained_visual_encoder(
                cfg.pretrained_visual, model_cfg.visual)
            if (enc.config.backbone in ("vit", "clip", "dino")
                    and enc.config.image_size
                    != model_cfg.visual.image_size):
                raise ValueError(
                    f"pretrained visual encoder expects image_size="
                    f"{enc.config.image_size} but the pipeline is "
                    f"configured for {model_cfg.visual.image_size} — "
                    f"set data.image_size to match")
            model_cfg = model_cfg.replace(visual=enc.config)
            log.success(f"pretrained visual: {cfg.pretrained_visual} "
                        f"({enc.config.backbone}, "
                        f"{enc.config.num_layers}l x "
                        f"{enc.config.hidden_dim}d)")
        if cfg.pretrained_text:
            enc, pre_text = load_pretrained_text_encoder(
                cfg.pretrained_text, model_cfg.text)
            model_cfg = model_cfg.replace(text=enc.config)
            log.success(f"pretrained text: {cfg.pretrained_text} "
                        f"({enc.config.num_layers}l x "
                        f"{enc.config.hidden_dim}d, "
                        f"vocab {enc.config.vocab_size})")
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

        # 4b. graft pretrained tower weights over the random init
        if pre_visual is not None:
            graft_pretrained(model, "visual_encoder", pre_visual, log)
        if pre_text is not None:
            graft_pretrained(model, "text_encoder", pre_text, log)

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
        return ModelPipelineOutput(model, device, counts, mesh)

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
