"""ViVQA end-to-end tutorial on the port (counterpart of
examples/vivqa_examples.py).

The full generative ViVQA workflow: the external dataset format, a
short generative training run, checkpoint-only evaluation with the
reference's exact metric suite, and the exported artifacts.

Reference surface: src/core/generative_vqa_pipeline.py,
vivqa_evaluation_pipeline.py, vivqa_eval_cli.py, and
src/data/vivqa_dataset.py.

Sections
  1. The two CSV schemas (training vs external evaluation)
  2. Train a tiny generative model on synthetic data
  3. Batch inference with JSON export
  4. Checkpoint-only external evaluation (VivqaEvaluationPipeline)
  5. The metric suite and reading the numbers
  6. The demo REPL and serving

Run (on the card, or on the CPU with --device cpu; the 1-epoch
training run dominates):
    python3 -m vivqa_tpu_torch.examples.vivqa_examples [--device cpu]
"""

import json
import pathlib
import tempfile

from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.config import (GenerativeVQAConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.parallel import MeshConfig
from vivqa_tpu_torch.pipelines import (DataPipelineConfig,
                                       GenerativeTrainingConfig,
                                       GenerativeVQAPipeline,
                                       GenerativeVQAPipelineConfig,
                                       VivqaEvaluationConfig,
                                       VivqaEvaluationPipeline)
from vivqa_tpu_torch.train import OptimizerConfig


def section_schemas():
    banner("1. The two CSV schemas")
    print("""Training CSV (reference data_actions.py:63-154):
    image_link,question,answers
    img_00001.jpg,"quả táo màu gì?","['màu đỏ','đỏ']"
  answers is a python-literal LIST (ast.literal_eval — the
  reference's quirk, preserved); images resolve by filename.

External ViVQA evaluation CSV (reference vivqa_dataset.py:25-322):
    img_id,question,answer
    458752,"đây là con gì?","con mèo"
  img_id is a COCO image id; files resolve by trying the raw id,
  '<id>.jpg', and the zero-padded '%012d.jpg' COCO layout.

The synthetic generator emits the TRAINING schema; evaluation below
reads the same file through the external loader (it accepts both
column sets).""")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    with tempfile.TemporaryDirectory() as tmp:
        walkthrough(device, tmp)


def walkthrough(device: str, tmp: str) -> None:
    section_schemas()

    banner("2. Train a tiny generative model")
    print("CLIP-class visual tower + PhoBERT-class question tower +\n"
          "cross-modal fusion + from-scratch causal decoder, teacher-forced\n"
          "with -100 label padding, BLEU-best checkpointing:\n")
    csv, imgs = generate_synthetic_vivqa(tmp, n=48, image_size=16,
                                         learnable=True)
    cfg = GenerativeVQAPipelineConfig(
        mode="train",
        data=DataPipelineConfig(csv_path=str(csv), image_dir=str(imgs),
                                image_size=16, max_question_length=8,
                                max_answer_length=6, batch_size=8,
                                augmentation_strength="light",
                                generative=True),
        model=GenerativeVQAConfig(
            visual=VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=1),
            text=TextEncoderConfig(vocab_size=512, hidden_dim=32,
                                   num_layers=1, num_heads=1, max_length=8),
            fusion_dim=32, fusion_layers=1, fusion_heads=1,
            decoder_layers=1, decoder_heads=1, decoder_dim=32,
            decoder_ff_dim=64, dropout=0.0),
        training=GenerativeTrainingConfig(
            num_epochs=1, checkpoint_dir=f"{tmp}/gck",
            optimizer=OptimizerConfig(learning_rate=1e-2), log_every=100),
        device=device,
        mesh=MeshConfig(model_axis=1),
        output_dir=f"{tmp}/gout")
    summary = GenerativeVQAPipeline(cfg).run()
    ep0 = summary["history"][0]
    print("\n  epoch-0 validation:",
          {k: round(v, 3) for k, v in ep0.items()
           if isinstance(v, float) and k in
           ("loss", "bleu", "rouge_l", "exact_match", "perplexity")})
    print("  Validation GENERATES (KV-cached greedy) then scores —\n"
          "  the reference's slowest path; on the card every attention call\n"
          "  of a decode step goes through the port's forward kernel.")

    banner("3. Batch inference with JSON export")
    inf = GenerativeVQAPipeline(cfg.replace(
        mode="inference", resume=f"{tmp}/gck")).run()
    results = json.loads(pathlib.Path(inf["results_path"]).read_text())
    print(f"  wrote {len(results)} predictions -> {inf['results_path']}")
    print(f"  record schema: {sorted(results[0].keys())}")
    print(f"  sample: Q='{results[0]['question']}' -> "
          f"'{results[0]['generated_answer']}'")

    banner("4. Checkpoint-only external evaluation")
    print("""VivqaEvaluationPipeline needs ONLY a checkpoint directory: the
model config is rebuilt from checkpoint metadata (reference
vivqa_eval_cli.py:30), weights partial-load with shape filtering,
and the inference loop runs over the external CSV:
""")
    ev = VivqaEvaluationPipeline(VivqaEvaluationConfig(
        checkpoint_dir=f"{tmp}/gck", csv_path=str(csv), image_dir=str(imgs),
        image_size=16, batch_size=8, max_question_length=8,
        max_answer_length=6, output_dir=f"{tmp}/veval", max_samples=16,
        device=device))
    res = ev.evaluate()
    print("  metrics:", {k: round(v, 3) for k, v in res["metrics"].items()})
    print(f"  artifacts: {sorted(p.name for p in pathlib.Path(tmp, 'veval').iterdir())}")
    print("\n  The shell entry point is identical:\n"
          f"    bash vivqa_tpu_torch/cli/run_vivqa_eval.sh --checkpoint-dir {tmp}/gck \\\n"
          f"         --csv-path {csv} --image-dir {imgs}")

    banner("5. Reading the metric suite")
    print("""  exact_match     normalized string equality vs any gold answer
  precision/recall/token_f1   bag-of-words overlap (the reference's
                  custom token-level P/R/F1, vivqa_evaluation :293-454)
  bleu            corpus BLEU-4, smoothing method 1 (NLTK-parity)
  rouge_l         LCS-based F, best-of-references
  meteor          staged aligner (exact -> stem -> synonym) with the
                  fragmentation penalty
  cider           reference-exact TF-IDF consensus (idf=log((N+1)/(df+1)),
                  x10 scaling) — formula-parity tested vs the reference
  wups_0.9        Wu-Palmer similarity over a bilingual taxonomy

On this random tiny model the scores are near zero; see
vivqa_tpu_torch/bench_convergence.py for a run that drives
exact_match >= 0.9 on the learnable corpus.""")

    banner("6. Demo REPL and serving")
    print("""Interactive REPL (reference --mode demo, the generative pipeline's
interactive loop):     python -m vivqa_tpu_torch.pipelines.generative_vqa_pipeline \\
                           --mode demo --resume <ckpt>
Serving throughput:    python3 -m vivqa_tpu_torch.bench_serving
                       (answers/sec, p50/p95)""")


if __name__ == "__main__":
    main()
