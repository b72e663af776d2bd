"""Mixture-of-Experts tutorial on the port (counterpart of
examples/moe_examples.py).

The MoE subsystem is this framework's flagship ablation subject. This
walkthrough covers every router, every layer type, every expert family
(including all six specialized experts), the dispatch designs, the aux
losses, the telemetry, and the expert-masking mechanism the ablation
study is built on.

Reference surface: src/modeling/moe/ (router.py, expert_types.py,
specialized_experts.py, moe_layer.py, moe_utils.py). The JAX package's
redesign, which the port keeps: homogeneous experts are ONE stacked
(E, D, H) tensor computed in a single einsum (batched GEMMs, and
splittable over the 'model' mesh axis = expert parallelism) instead of
a Python loop over expert modules, and the sparse path uses sort-based
(Megablocks-style) static-shape dispatch instead of index_add scatter.

Sections
  1. Routers: topk / noisy_topk / soft / expert_choice
  2. Aux losses: load-balance and router z-loss, and why they exist
  3. Homogeneous layers: standard (dense) vs sparse (capacity) dispatch
  4. Capacity & dropped-token telemetry
  5. Hierarchical MoE (2-level routing)
  6. Expert families: FF / GLU / vision / text / multimodal
  7. The six specialized experts and their distinct inductive biases
  8. VQA MoE layer: fixed expert order + ablation masks
  9. Expert parallelism: the expert axis split over gloo ranks

Run (on the card, or on the CPU with --device cpu; shapes are tiny):
    python3 -m vivqa_tpu_torch.examples.moe_examples [--device cpu]
"""

import numpy as np
import torch
import torch.nn.functional as F

from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.layers import DropoutRNG, init_weights
from vivqa_tpu_torch.models.moe.config import (SPECIALIZED_TYPES,
                                               ExpertConfig, MoEConfig,
                                               RouterConfig, VQAMoEConfig)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer
from vivqa_tpu_torch.models.moe.routers import (create_router,
                                                load_balance_loss,
                                                router_z_loss)

DIM = 64
RANKS = 2           # section 9's 'model' axis


def built(module, device, seed: int = 0):
    """``module`` with weights drawn by flax's laws, in eval mode."""
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval()


def n_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def rng_on(device) -> DropoutRNG:
    """The randomness of one training forward (the router's noise)."""
    return DropoutRNG(torch.Generator(device=device).manual_seed(1))


def section_routers(x):
    banner("1. Routers")
    print("""A router maps each token to a distribution over experts and
selects which experts compute it. Four strategies (reference
router.py:75-449), each with a different compute/quality trade:

  topk           softmax -> top-k -> renormalize. The classic Shazeer
                 gate; deterministic given the logits.
  noisy_topk     adds learned, softplus-scaled Gaussian noise to the
                 logits during training (exploration; the default for
                 the VQA MoE layer). Draws from the forward's generator
                 (a training forward: model.train(), generator=...).
  soft           every expert computes every token, combined by the full
                 softmax. No discreteness -> no load-balance problem,
                 but no compute savings either.
  expert_choice  inverted: each EXPERT picks its top-capacity tokens.
                 Perfect load balance by construction; a token may be
                 picked by 0 or several experts.
""")
    for rt in ("topk", "noisy_topk", "soft", "expert_choice"):
        router = built(create_router(RouterConfig(router_type=rt, top_k=2),
                                     4, DIM), x.device).train()
        with torch.no_grad():
            out = router(x, None, rng_on(x.device))
        usage = out.metrics["expert_usage"].float().cpu().numpy()
        print(f"  {rt:>14}: usage={usage.round(2)}"
              f"  aux={float(out.aux_loss):.4f}")
    print("\n  'usage' = fraction of routed token-slots per expert; a\n"
          "  uniform vector means balanced load.")


def section_aux_losses(x):
    banner("2. Aux losses")
    print("""Discrete routing collapses without regularization: the router
finds one good expert and starves the rest. Two standard fixes,
exposed as pure functions (reference moe_utils.py:35-97):

  load_balance_loss   E * sum_e(frac_tokens_e * mean_prob_e)
                      (Switch Transformer eq. 4) — minimized when the
                      routing is uniform; differentiable through the
                      mean-prob factor.
  router_z_loss       mean(logsumexp(logits)^2) — keeps router logits
                      small so the softmax stays in a trainable regime
                      (ST-MoE). Off by default; enable with
                      RouterConfig(z_loss_weight=1e-3).
""")
    router = built(create_router(RouterConfig(router_type="topk", top_k=2),
                                 4, DIM), x.device)
    with torch.no_grad():
        out = router(x)
    print(f"  combined aux from the router: {float(out.aux_loss):.4f}")
    # Show the functions directly on a synthetic skewed distribution
    skewed = torch.tensor([[0.97, 0.01, 0.01, 0.01]] * 100)
    uniform = torch.full((100, 4), 0.25)
    for name, p in (("skewed", skewed), ("uniform", uniform)):
        dispatch = F.one_hot(p.argmax(-1), 4).float()
        lb = float(load_balance_loss(p, dispatch))
        print(f"  load_balance_loss on {name:>7} routing: {lb:.3f}")
    logits_big = torch.full((100, 4), 30.0)
    logits_small = torch.zeros((100, 4))
    print(f"  router_z_loss   on large logits: "
          f"{float(router_z_loss(logits_big)):.1f}   "
          f"on small logits: {float(router_z_loss(logits_small)):.2f}")


def section_layers(x):
    banner("3. Homogeneous layers: dense vs sparse dispatch")
    print("""Two dispatch designs for the same (router, experts) pair:

  standard  every expert computes EVERY token in one stacked einsum
            (B,L,D)x(E,D,H); the router weights only the combine. For
            small E this is often FASTER than sparse: one batched GEMM
            and no gather. (This matches what the reference's MOELayer
            computes, minus its Python loop.)
  sparse    tokens are sorted by assigned expert and each expert
            computes only its capacity slice — Megablocks-style
            static-shape dispatch (sort + segment boundaries), NOT a
            dynamic scatter. Wins when E is large or experts are heavy.
""")
    for mt in ("standard", "sparse"):
        cfg = MoEConfig(num_experts=4, input_dim=DIM,
                        expert=ExpertConfig(hidden_dim=128),
                        router=RouterConfig(top_k=2), moe_type=mt)
        layer = built(create_moe_layer(cfg), x.device)
        with torch.no_grad():
            y, aux = layer(x)
        print(f"  {mt:>10}: out={tuple(y.shape)}  params={n_params(layer):,}"
              f"  aux={float(aux['aux_loss']):.4f}")
    print("\n  Identical parameter trees -> you can switch moe_type in the\n"
          "  config without invalidating a checkpoint.")


def section_capacity(x):
    banner("4. Capacity & dropped-token telemetry")
    print("""Sparse dispatch bounds each expert's token count by the config
(static shapes, as the JAX package's XLA needs; here it keeps every
step's buffers one size). capacity = factor * T * k / E.
Tokens routed to a full expert are DROPPED (their residual passes
through unchanged). The layer reports the dropped fraction — watch
it during training; >5% sustained means raise capacity_factor:
""")
    for cf in (0.5, 1.0, 1.25, 2.0):
        cfg = MoEConfig(num_experts=4, input_dim=DIM,
                        expert=ExpertConfig(hidden_dim=128),
                        router=RouterConfig(top_k=2, capacity_factor=cf),
                        moe_type="sparse")
        layer = built(create_moe_layer(cfg), x.device)
        with torch.no_grad():
            _, aux = layer(x)
        dropped = float(aux["metrics"]["dropped_token_fraction"])
        print(f"  capacity_factor={cf:<5} -> dropped {dropped * 100:5.1f}% of tokens")


def section_hierarchical(x):
    banner("5. Hierarchical MoE")
    print("""Two-level routing (reference moe_layer.py:361-548): a group
router picks among num_groups groups, then a per-group router picks
experts inside the winning group. Aux losses from both levels sum.
Useful when experts have natural families (e.g. per-modality).
""")
    cfg = MoEConfig(num_experts=4, input_dim=DIM, num_groups=2,
                    expert=ExpertConfig(hidden_dim=128),
                    router=RouterConfig(top_k=1), moe_type="hierarchical")
    layer = built(create_moe_layer(cfg), x.device)
    with torch.no_grad():
        y, aux = layer(x)
    print(f"  2 groups x 2 experts: out={tuple(y.shape)} "
          f"aux={float(aux['aux_loss']):.4f}")


def section_expert_families(x):
    banner("6. Expert families")
    print("""Homogeneous experts (FF, GLU) live in stacked tensors; the
heterogeneous families have real sub-architectures and compute
per-module (reference expert_types.py):

  feed_forward  2-layer MLP + residual + LN   (stacked)
  glu           gated linear unit variant     (stacked)
  vision        spatial multi-head attention over patch tokens
  text          self-attention + FFN over word tokens
  multimodal    cross-attention with a learned sigmoid modality gate
""")
    from vivqa_tpu_torch.models.moe.experts import (StackedExperts,
                                                    create_expert)
    stacked = built(StackedExperts(4, DIM, 128), x.device)
    with torch.no_grad():
        per_expert = stacked(x)
    print(f"  StackedExperts(4): (B,L,D) -> per-expert {tuple(per_expert.shape)}"
          "   [one einsum for all four]")
    for et in ("vision", "text", "multimodal"):
        mod = built(create_expert(ExpertConfig(expert_type=et, hidden_dim=128,
                                               num_heads=2), DIM), x.device)
        with torch.no_grad():
            y = mod(x)
        print(f"  {et:>16}: (B,L,D) -> {tuple(y.shape)}  "
              f"({n_params(mod):,} params)")


def section_specialized(x):
    banner("7. The six specialized experts")
    print("""Reference-grade architectures (specialized_experts.py), each a
(B,L,D)->(B,L,D) module with a distinct inductive bias:

  segmentation      mask tokens -> transformer decoder -> boundary conv
  object_detection  DETR-style: learned object queries through a
                    multi-layer decoder, cross-attended back to tokens
  ocr               text-region queries + reading-order attention +
                    Vietnamese diacritic head
  scene             scene tokens + encoder + global context attention
  spatial           O(S^2) pairwise relation embeddings + graph attention
  counting          count queries + density head (soft counting)
""")
    from vivqa_tpu_torch.models.moe.experts import create_expert
    for name in SPECIALIZED_TYPES:
        mod = built(create_expert(ExpertConfig(expert_type=name,
                                               hidden_dim=128, num_heads=2),
                                  DIM), x.device)
        with torch.no_grad():
            y = mod(x)
        print(f"  {name:>16}: out={tuple(y.shape)}  params={n_params(mod):,}")
    print("\n  Distinctness matters: the ablation study's expert-importance\n"
          "  numbers are only meaningful if experts are architecturally\n"
          "  different (tests/test_moe.py::test_specialized_experts_are_nonlocal\n"
          "  proves each one is, and tests/test_torch_moe_zoo.py holds the\n"
          "  port's experts to the JAX package's).")


def section_vqa_layer(x):
    banner("8. VQA MoE layer + ablation masks")
    print("""The heterogeneous flagship layer. Experts are created in a FIXED
order — vision, text, multimodal, then specialized (reference
moe_layer.py:617-689) — because the ablation study addresses
experts by index. Masking an expert zeroes its router weight and
renormalizes the remainder, exactly reproducing the reference's
monkey-patched router semantics, but functionally (a mask tensor,
not a mutation):
""")
    vcfg = VQAMoEConfig(input_dim=DIM, num_vision_experts=1,
                        num_text_experts=1, num_multimodal_experts=1,
                        specialized_types=("counting", "spatial_reasoning"),
                        expert_hidden_dim=128, num_heads=2)
    layer = built(create_moe_layer(vcfg), x.device)
    print(f"  expert order/ranges: {vcfg.expert_index_ranges()}")

    def usage(mask=None):
        with torch.no_grad():
            _, aux = layer(x, None if mask is None
                           else torch.tensor(mask, device=x.device))
        return aux["metrics"]["expert_usage"].float().cpu().numpy().round(3)
    print(f"  full usage:        {usage()}")
    print(f"  vision-masked:     {usage([0.0, 1.0, 1.0, 1.0, 1.0])}")
    print(f"  specialized-off:   {usage([1.0, 1.0, 1.0, 0.0, 0.0])}")
    print("\n  The ablation runner builds these masks from experiment\n"
          "  configs (vivqa_tpu_torch/ablation/modifier.py) — see\n"
          "  vivqa_tpu_torch/cli/run_ablation.sh for the full study.")


def expert_parallel_rank(rank: int, device: str, x: np.ndarray) -> dict:
    """One rank of section 9: the layer's one-process output, then its
    slice of the stacked experts on the 'model' axis and the split
    layer's output."""
    from vivqa_tpu_torch.parallel import MeshConfig, create_mesh, \
        logical_to_mesh
    mesh = create_mesh(MeshConfig(data_axis=1, model_axis=RANKS), device)
    cfg = MoEConfig(num_experts=4, input_dim=DIM,
                    expert=ExpertConfig(hidden_dim=128),
                    router=RouterConfig(top_k=2))
    layer = built(create_moe_layer(cfg), mesh.device)   # same seed: same
    xt = torch.from_numpy(x).to(mesh.device)            # weights everywhere
    with torch.no_grad():
        whole = layer(xt)[0].float().cpu()
        whole_shape = tuple(layer.experts_w_in.shape)
        logical_to_mesh(layer, mesh)
        split = layer(xt)[0].float().cpu()
    return {"whole": whole_shape, "slice": tuple(layer.experts_w_in.shape),
            "mesh": {"data": mesh.data.size, "model": mesh.model.size},
            "max_diff": float((split - whole).abs().max())}


def section_expert_parallel(x):
    banner("9. Expert parallelism on a device mesh")
    print(f"""Because homogeneous experts are ONE (E, D, H) tensor, expert
parallelism is a placement rule: split the E axis over the 'model'
mesh axis and each rank keeps its experts' slice; the layer computes
its experts' share of every token and one all-reduce over 'model'
sums them. The partition rules in vivqa_tpu_torch/parallel/mesh.py
(logical_to_mesh) do this for every stacked expert tensor.
Demonstration on {RANKS} gloo ranks of this host
(vivqa_tpu_torch/parallel/launch.py; torchrun does the same across
cards, NCCL between them):
""")
    from vivqa_tpu_torch.parallel.launch import run_ranks
    ranks = run_ranks(expert_parallel_rank, RANKS, str(x.device),
                      x.cpu().numpy(), timeout=300)
    r = ranks[0]
    print(f"  stacked weights {r['whole']} split as {r['slice']} a rank "
          f"over mesh {r['mesh']}")
    print("  max |split layer - one process| by rank: "
          + ", ".join(f"{q['max_diff']:.1e}" for q in ranks))
    print("  Training this way needs no code change: see\n"
          "  tests/test_torch_parallel.py (the expert-parallel steps held\n"
          "  against one process and JAX's ShardedStep).")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    x = torch.randn(2, 10, DIM, generator=torch.Generator().manual_seed(3)
                    ).to(device)
    section_routers(x)
    section_aux_losses(x)
    section_layers(x)
    section_capacity(x)
    section_hierarchical(x)
    section_expert_families(x)
    section_specialized(x)
    section_vqa_layer(x)
    section_expert_parallel(x)
    banner("Done")
    print("Wire MoE into a full model with\n"
          "  MoEModelConfig(use_moe=True, num_experts=..., top_k=...)\n"
          "inside VQAModelConfig — see\n"
          "  python3 -m vivqa_tpu_torch.examples.complete_vqa_pipeline.")


if __name__ == "__main__":
    main()
