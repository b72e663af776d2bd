"""Complete pipeline walkthrough on the port (counterpart of
examples/complete_vqa_pipeline.py).

Everything between a CSV of QA pairs and a served answer, in one
self-contained script: synthetic data generation, the 9-step data
pipeline, the 7-step model pipeline, training, checkpointed evaluation,
single-image inference, and resume. The same flow the
`vivqa_tpu_torch/cli/*.sh` wrappers drive from the shell.

Stage map (reference src/core/):
  DataPipeline      9 steps: load -> validate -> stats -> split -> vocab
                    -> tokenizer -> transforms -> loaders -> batch check
  ModelPipeline     7 steps: mesh setup -> config -> create -> init ->
                    place -> param table -> dummy-forward validation
  TrainingPipeline  train step (the attention through the port's CUDA
                    kernels on the card), per-epoch 13-metric
                    validation, best-checkpoint, early stopping
  VQAPipeline       chains the three + writes pipeline_summary.json

Run:
    python3 -m vivqa_tpu_torch.examples.complete_vqa_pipeline [--device cpu]
"""

import pathlib
import tempfile

import torch

from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.config import (FusionConfig, MoEModelConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.parallel import MeshConfig
from vivqa_tpu_torch.pipelines import (DataPipeline, DataPipelineConfig,
                                       ModelPipelineConfig,
                                       TrainingPipelineConfig, VQAPipeline,
                                       VQAPipelineConfig)
from vivqa_tpu_torch.train import OptimizerConfig


def main(argv=None):
    device = parse_args(__doc__, argv).device
    with tempfile.TemporaryDirectory() as tmp:
        walkthrough(device, tmp)


def walkthrough(device: str, tmp: str) -> None:
    banner("Step 0 — synthetic ViVQA corpus")
    print("""generate_synthetic_vivqa writes data.csv (columns
image_link,question,answers — the reference's exact schema) plus a
folder of JPEGs. learnable=True paints the ANSWER into the image
(background color, block count, object band) so training can prove
real multimodal learning, not label memorization:""")
    csv, imgs = generate_synthetic_vivqa(tmp, n=64, image_size=32,
                                         learnable=True)
    print(f"  csv={csv}\n  images={imgs}")
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"  device: {device} ({name})")

    banner("Step 1 — the data pipeline alone (9 steps)")
    data_cfg = DataPipelineConfig(
        csv_path=str(csv), image_dir=str(imgs), image_size=32,
        max_question_length=8, batch_size=8, augmentation_strength="light")
    data_out = DataPipeline(data_cfg).run()
    print(f"\n  answer vocab: {len(data_out.answer2id)} entries "
          f"(<unk>=0 quirk preserved: {data_out.answer2id['<unk>'] == 0})")
    batch = next(iter(data_out.train_loader))
    print(f"  one batch: pixel_values {tuple(batch['pixel_values'].shape)}, "
          f"input_ids {tuple(batch['input_ids'].shape)}, "
          f"labels {tuple(batch['labels'].shape)}")
    print("  The training loop prefetches on a host thread into pinned\n"
          "  buffers and copies on a side stream, so step N+1's transfer\n"
          "  overlaps step N's compute; eval loaders pad the final batch\n"
          "  and carry _num_valid so metrics can trim the padding.")

    banner("Step 2 — full pipeline, mode=train")
    print("""The model here is the flagship shape shrunk to demo size:
ViT visual tower + PhoBERT-class text tower + MCAN fusion + a
2-expert MoE. MeshConfig(data_axis=-1) splits the batch over every
rank of a launcher (torchrun); one process is a mesh of one rank, and
the pipeline then runs the plain step.""")
    cfg = VQAPipelineConfig(
        mode="train",
        data=data_cfg,
        model=ModelPipelineConfig(
            model=VQAModelConfig(
                visual=VisualEncoderConfig(image_size=32, patch_size=8,
                                           hidden_dim=32, num_layers=1,
                                           num_heads=1),
                text=TextEncoderConfig(vocab_size=512, hidden_dim=32,
                                       num_layers=1, num_heads=1,
                                       max_length=8),
                fusion=FusionConfig(fusion_type="mcan", hidden_dim=32,
                                    num_heads=1, num_layers=1),
                moe=MoEModelConfig(use_moe=True, num_experts=2, top_k=1,
                                   expert_hidden_dim=32)),
            device=device,
            mesh=MeshConfig(data_axis=-1, model_axis=1)),
        training=TrainingPipelineConfig(
            num_epochs=2, optimizer=OptimizerConfig(learning_rate=5e-3),
            checkpoint_dir=f"{tmp}/ck", log_every=5),
        output_dir=f"{tmp}/out")
    summary = VQAPipeline(cfg).run()
    print("\n  final metrics:",
          {k: round(v, 4) for k, v in summary["final_metrics"].items()
           if isinstance(v, float)})
    print(f"  summary JSON: {tmp}/out/pipeline_summary.json "
          f"(exists: {pathlib.Path(tmp, 'out', 'pipeline_summary.json').exists()})")

    banner("Step 3 — mode=evaluate from the checkpoint")
    print("""Evaluation-only rebuilds the model from checkpoint metadata
(num_answers is inferred from the answer-head bias shape when
absent — the reference's ModelPipeline.load_checkpoint quirk) and
computes the full 13-metric dict on the test split:""")
    eval_summary = VQAPipeline(cfg.replace(
        mode="evaluate", resume=f"{tmp}/ck")).run()
    print("\n  test metrics:", {k: round(v, 4) for k, v in
                                eval_summary["metrics"].items()})

    banner("Step 4 — single-image inference")
    print("""VQAPredictor wraps the softmax forward with image/question
preprocessing and top-k answer decoding (reference
vqa_predictor.py:79-614). Batches are padded to batch_pad, as the JAX
package pads them for its jit cache, so every request batch has one
shape:""")
    from vivqa_tpu_torch.eval.predictor import VQAPredictor
    from vivqa_tpu_torch.pipelines import ModelPipeline
    # reload the best weights the way the evaluate mode does: the model
    # pipeline rebuilds the module and partial-loads the checkpoint.
    # NOTE the vocab: the data pipeline sized the token embedding to the
    # REAL tokenizer vocab, so the rebuild must match or partial_load
    # skips the embedding table.
    mp_cfg = cfg.model.replace(model=cfg.model.model.replace(
        text=cfg.model.model.text.replace(
            vocab_size=data_out.tokenizer.vocab_size)))
    model_out, _ = ModelPipeline(mp_cfg).load_checkpoint(
        f"{tmp}/ck", num_answers=len(data_out.answer2id))
    id2answer = {v: k for k, v in data_out.answer2id.items()}
    predictor = VQAPredictor(model_out.model, data_out.tokenizer, id2answer,
                             image_size=32, max_question_length=8,
                             device=device)
    sample_img = sorted(pathlib.Path(imgs).glob("*.jpg"))[0]
    result = predictor.predict(str(sample_img), "đây là màu gì?")
    print(f"\n  Q: 'đây là màu gì?' on {sample_img.name}")
    print(f"  -> answer='{result.answer}' confidence={result.confidence:.3f}")
    print("     top:", [(t['answer'], round(t['confidence'], 3))
                        for t in result.top_answers[:3]])

    banner("Step 5 — resume semantics")
    print("""--resume restores the FULL train state (parameters, optimizer
moments, step counter, generator seed) — not just weights — and
offsets new checkpoint steps past the restored ones so checkpoints
never collide. Interrupting with Ctrl-C triggers the emergency save;
restarting with resume= continues the LR schedule where it left off.

Where to next:
  * shell wrappers:  vivqa_tpu_torch/cli/quick_start.sh --synthetic
  * generative flow: python3 -m vivqa_tpu_torch.examples.generative_decoding_examples
  * MoE ablations:   vivqa_tpu_torch/cli/run_ablation.sh --dry-run
  * RAG training:    use_knowledge=true + kb_path in the YAML""")


if __name__ == "__main__":
    main()
