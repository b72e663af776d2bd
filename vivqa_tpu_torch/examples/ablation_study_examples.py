"""Ablation-study tutorial on the port (counterpart of
examples/ablation_study_examples.py; reference: src/ablation/ — the
reference ships the subsystem but no walkthrough; this fills that gap).

The ablation orchestrator is the flagship feature: it answers "which
experts earn their parameters?" by training the SAME model under
systematic modifications (drop the MoE, leave one expert out, swap the
router) and comparing a primary metric across runs — with honest
statistics, because at research-scale val sets the interesting deltas
are usually smaller than the naive noise floor.

Reference surface: src/ablation/{ablation_config,ablation_runner,
ablation_trainer,ablation_evaluator,ablation_analyzer,ablation_reporter,
run_ablation}.py. Differences the port keeps from the JAX package:
expert masking is FUNCTIONAL (a mask tensor into the router's forward,
-inf + renormalize) instead of the reference's monkey-patched
router.forward, and held equal to the JAX package's
(tests/test_torch_moe_zoo.py); and the statistics layer (binomial noise
floor, paired McNemar) is new capability.

Sections
  1. Search space -> experiment matrix (ids, priorities, dedup)
  2. Expert masks: functional ablation semantics
  3. A mini end-to-end study on synthetic data (public CLI)
  4. Reading the analysis: importance, noise floor, paired McNemar
  5. Operational workflows: resume / rerun / report-only / backfill

Run (on the card, or on the CPU with --device cpu; shapes are tiny):
    python3 -m vivqa_tpu_torch.examples.ablation_study_examples [--device cpu]
"""

import json
import pathlib
import tempfile

from vivqa_tpu_torch.examples import banner, parse_args


def section_matrix():
    banner("1. Search space -> experiment matrix")
    print("""AblationSearchSpace declares WHAT varies; AblationConfig
.generate_experiment_matrix() expands it into deduplicated, prioritized
ExperimentConfigs (reference ablation_config.py:221-563). Baselines come
first so an interrupted study still has its reference points.""")
    from vivqa_tpu_torch.ablation import AblationConfig, AblationSearchSpace
    cfg = AblationConfig(search=AblationSearchSpace(
        num_experts=3, include_full=True, include_no_moe=True,
        include_leave_one_out=True, include_single_expert=False,
        router_types=("noisy_topk", "soft"), top_k_values=(2,),
        load_balance_weights=(0.01,)))
    for i, e in enumerate(cfg.generate_experiment_matrix()):
        print(f"  [{i}] prio={e.priority}  {e.experiment_id}")
    print("""Note the dedup rules: soft ignores top_k, so only one soft
experiment is emitted per load-balance weight (reference :339-361).""")
    return cfg


def section_masks():
    banner("2. Expert masks: functional ablation")
    print("""The reference monkey-patches router.forward to zero disabled
experts (ablation_trainer.py:150-197). Here, as in the JAX package, the
mask is a (E,) 0/1 TENSOR passed through the layer: disabled experts
get -inf router logits, the rest renormalize. Same semantics
(test-equal: tests/test_moe.py), and no module is patched.""")
    from vivqa_tpu_torch.ablation import build_expert_mask
    from vivqa_tpu_torch.ablation.config import ExpertAblationConfig
    for mode, idx in (("full", (0, 1, 2, 3)), ("leave_one_out", (2,)),
                      ("single_expert", (1,))):
        e = ExpertAblationConfig(mode, idx)
        print(f"  {mode:15s} -> mask {build_expert_mask(e, 4)}")


def section_run_study(tmp, device):
    banner("3. Mini end-to-end study (public CLI)")
    print("""The same entry point as the round-3 study on the card
(tools/ablation_study_r3.py): python -m
vivqa_tpu_torch.ablation.run_ablation. Here: a 16-image learnable
corpus, 2 specialized experts, experiments full / leave_one_out_0
(matrix indices 0 and 4 — check with --dry-run), 1 epoch each (the
walkthrough trains the minimal pair needed for a paired comparison).""")
    from vivqa_tpu_torch.ablation.run_ablation import main
    from vivqa_tpu_torch.data import generate_synthetic_vivqa
    csv, imgs = generate_synthetic_vivqa(f"{tmp}/corpus", n=16,
                                         image_size=16, seed=0,
                                         learnable=True)
    out = f"{tmp}/runs"
    main(["--csv-path", str(csv), "--image-dir", str(imgs),
          "--image-size", "16", "--epochs", "1", "--batch-size", "8",
          "--hidden-dim", "256", "--num-layers", "1",
          "--expert-hidden-dim", "256", "--patch-size", "8",
          "--vision-experts", "0", "--text-experts", "0",
          "--multimodal-experts", "0", "--specialized-experts", "2",
          "--output-dir", out, "--experiments", "0,4",
          "--device", device])
    return out


def section_analysis(out):
    banner("4. Reading the analysis")
    print("""reports/analysis.json carries the statistics layer:

  noise_floor          binomial 95% bound on a BETWEEN-RUN difference of
                       the primary metric at this val-set size. Any
                       importance below it is indistinguishable from
                       retraining noise — reporting it as a finding
                       would be statistical malpractice.
  paired_comparisons   exact McNemar tests vs the full baseline, built
                       from per-sample correct_mask vectors each
                       experiment records. Paired tests only count
                       DISCORDANT samples, so they separate real effects
                       at n where the independent bound cannot.
  expert_contributions significance uses the paired verdict when masks
                       exist, else the binomial bound.""")
    a = json.loads((pathlib.Path(out) / "reports" /
                    "analysis.json").read_text())
    print("  noise_floor:", a["noise_floor"])
    for p in a["paired_comparisons"]:
        print(f"  paired: {p['experiment_id']}: b={p['baseline_only_correct']}"
              f" c={p['ablated_only_correct']} p={p['p_value']:.3f}")
    for f in a["key_findings"]:
        print("  finding:", f)
    print("\nreports/: report.md (tables), results.csv,",
          "expert_contributions.csv, table.tex, raw_results.json")


def section_workflows():
    banner("5. Operational workflows")
    print("""Every invocation is resumable: completed experiments are
skipped via their result JSONs (reference ablation_runner.py:288), so a
long study fits bounded scheduler slots; under a launcher (torchrun)
the study trains on every rank and rank 0 alone writes.

  --experiments "1,3,5-7"  bound a chunk explicitly
  --rerun                  delete + retrain the selected experiments
  --report-only            re-analyze persisted results offline (no
                           kernel runs); --n-eval feeds the noise floor
  --backfill-masks         compute correct_mask for older studies from
                           their saved best checkpoints -> paired tests
                           without retraining
  --dry-run                print the matrix and exit
  Ctrl-C                   persists the partial result + a partial
                           report, then raises GracefulInterrupt

The JAX study's artifact lives in reports/ablation_r3/ — study.yaml
(search space, expert_names labels), runs/reports/ (the generated
report); tools/ablation_study_r3.py runs the same study on the card.""")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    cfg = section_matrix()
    del cfg
    section_masks()
    with tempfile.TemporaryDirectory() as tmp:
        out = section_run_study(tmp, device)
        section_analysis(out)
    section_workflows()
    print("\ndone.")


if __name__ == "__main__":
    main()
