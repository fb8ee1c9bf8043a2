"""A call written in JAX's positional order binds the same in the port.

Both packages are parsed with ``ast`` (nothing is imported). For every
public function, method and class ``__init__`` that the two share by module
path and name:

- the parameters they share come in the same order;
- a shared parameter sits at JAX's position whenever every JAX parameter
  before it exists in the port too (so a positional call binds alike as
  far as the port has JAX's parameters);
- every JAX parameter the port lacks is in ``MISSING``, which names the
  ROADMAP.md item (or departure) that says why, and an entry that no longer
  describes a lacking parameter fails the test (it went stale)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ROADMAP = (ROOT / "ROADMAP.md").read_text()

RENAMED = "Renamed parameters"  # a ROADMAP.md departure: same slot, the port's name
PALLAS = "Pallas tiling parameters"  # a ROADMAP.md departure
INIT = "**Init** draws from a `torch.Generator`"  # a ROADMAP.md departure
_KEY = {"rng": RENAMED}
PER_DEVICE = "One process per device"  # a ROADMAP.md departure (A11)

# (module, qualified name) -> {JAX parameter the port lacks: ROADMAP anchor}
MISSING = {
    ("clients.engine", "ClientLogic.augment"): _KEY,
    ("clients.personalized", "DittoPersonalizedLogic.augment"): _KEY,
    ("clients.personalized", "MrMtlPersonalizedLogic.augment"): _KEY,
    ("clients.engine", "create_train_state"): {"rng": INIT, "sample_x": INIT},
    ("clients.fedpm", "sample_masks"): _KEY,
    ("clients.engine", "epoch_batches"): _KEY,
    ("clients.nnunet", "NnunetClientLogic.augment"): _KEY,
    ("core.pytree", "global_norm"): {"tree": RENAMED},
    ("core.pytree", "ravel"): {"tree": RENAMED},
    ("core.pytree", "leaf_paths"): {"tree": RENAMED},
    ("core.pytree", "select_by_path"): {"tree": RENAMED},
    ("datasets.synthetic", "synthetic_classification"): _KEY,
    ("datasets.synthetic", "synthetic_text_classification"): _KEY,
    ("kernels.dp_clip", "fused_clipped_masked_sum"): {"tile": PALLAS, "interpret": PALLAS},
    ("kernels.dp_clip", "per_example_sq_norms"): {"tile": PALLAS, "interpret": PALLAS},
    ("kernels.dp_clip", "scaled_masked_sum"): {"tile": PALLAS, "interpret": PALLAS},
    ("kernels.flash_attention", "flash_attention"): {
        "block_q": PALLAS, "block_k": PALLAS, "interpret": PALLAS},
    ("kernels.flash_attention", "flash_attention_lse"): {
        "block_q": PALLAS, "block_k": PALLAS, "interpret": PALLAS},
    ("losses.contrastive", "cosine_similarity"): {"axis": RENAMED},
    **{("losses.mmd", f"DeepMmd.{fn}"): _KEY for fn in ("init", "train", "train_step")},
    ("models.autoencoders", "reparameterize"): _KEY,
    ("models.autoencoders", "VariationalAe.sampling"): _KEY,
    ("models.autoencoders", "ConditionalVae.sampling"): _KEY,
    ("models.masked", "bernoulli_ste"): _KEY,
    ("nnunet.augment", "augment_patch_batch"): _KEY,
    ("observability.manifest", "run_manifest"): {"donation": "Buffer donation"},
    ("parallel.compat", "axis_size"): {"axis_name": RENAMED},
    **{("parallel.mesh", fn): {"devices": PER_DEVICE}
       for fn in ("client_mesh", "hybrid_mesh", "client_data_mesh")},
    ("parallel.ring_attention", "ring_flash_attention"): {"interpret": PALLAS},
    ("privacy.dpsgd", "gaussian_noise_like"): _KEY,
    ("privacy.dpsgd", "noisy_clipped_mean_grads"): _KEY,
    ("privacy.dpsgd", "validate_dp_safe_model_state"): {"model_state": "The BatchNorm check"},
    **{("server.client_manager", f"{cls}.{fn}"): _KEY
       for cls, fns in (("ClientManager", ("sample", "sample_indices")),
                        ("FixedFractionManager", ("draw_cohort", "sample", "sample_indices")),
                        ("FixedSamplingManager", ("sample",)),
                        ("FullParticipationManager", ("draw_cohort", "sample",
                                                      "sample_indices")),
                        ("PoissonSamplingManager", ("draw_cohort", "sample",
                                                    "sample_indices")))
       for fn in fns},
    ("datasets.synthetic", "fedprox_synthetic"): _KEY,
    ("datasets.synthetic", "dirichlet_partition"): _KEY,
}


def _signatures(package: str) -> dict:
    """(module, qualified name) -> ast.arguments of every public module
    function, and every public method and ``__init__`` of a public class."""
    out = {}
    base = ROOT / package
    for path in sorted(base.rglob("*.py")):
        module = ".".join(path.relative_to(base).with_suffix("").parts)
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    out[(module, node.name)] = node.args
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                for sub in node.body:
                    if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and (sub.name == "__init__" or not sub.name.startswith("_"))):
                        out[(module, f"{node.name}.{sub.name}")] = sub.args
    return out


def _positional(args: ast.arguments) -> list[str]:
    return [a.arg for a in args.posonlyargs + args.args]


def _every(args: ast.arguments) -> list[str]:
    return (_positional(args) + ([args.vararg.arg] if args.vararg else [])
            + [a.arg for a in args.kwonlyargs])


JAX, PORT = _signatures("fl4health_tpu"), _signatures("fl4health_tpu_torch")
SHARED = sorted(set(JAX) & set(PORT))


def test_the_packages_share_their_public_callables():
    # a parse that found nothing would pass every check below
    assert len(SHARED) > 500
    assert ("server.simulation", "FederatedSimulation.__init__") in SHARED
    assert ("resilience.supervisor", "RecoverySupervisor.__init__") in SHARED
    assert ("sweep.hoisting", "apply_state_scalars") in SHARED


# the sweep runner's and Ditto's public callables, each held by the checks
# below (a key missing from SHARED would escape them)
SWEEP_AND_DITTO = [
    ("sweep.spec", "SweepCell.label"), ("sweep.spec", "SweepSpec.bucket_for"),
    ("sweep.spec", "SweepSpec.applicable_scalar_axes"), ("sweep.spec", "SweepSpec.expand_cells"),
    ("sweep.bucketing", "GroupKey.label"), ("sweep.bucketing", "SweepPlan.describe"),
    ("sweep.bucketing", "plan_groups"), ("sweep.bucketing", "pad_datasets"),
    ("sweep.bucketing", "pad_stack_rows"), ("sweep.bucketing", "padded_mask"),
    ("sweep.runner", "CellResult.row"), ("sweep.runner", "SweepResult.leaderboard"),
    ("sweep.runner", "SweepResult.bench_block"), ("sweep.runner", "SweepLedger.__init__"),
    ("sweep.runner", "SweepLedger.load_completed"), ("sweep.runner", "SweepLedger.append"),
    ("sweep.runner", "SweepRunner.__init__"), ("sweep.runner", "SweepRunner.run"),
    ("sweep.runner", "run_sweep"),
    ("clients.ditto", "DittoClientLogic.__init__"),
    ("clients.ditto", "DittoClientLogic.init_round_context"),
    ("clients.ditto", "DittoClientLogic.training_loss"),
    ("clients.ditto", "DittoClientLogic.eval_loss"), ("clients.ditto", "DittoClientLogic.pack"),
    ("clients.ditto", "KeepLocalExchanger.push"), ("clients.ditto", "KeepLocalExchanger.pull"),
    ("clients.ditto", "MrMtlClientLogic.__init__"),
    ("clients.ditto", "MrMtlClientLogic.init_round_context"),
    ("clients.ditto", "MrMtlClientLogic.training_loss"), ("clients.ditto", "MrMtlClientLogic.pack"),
    ("models.bases", "TwinModel.exchange_global_model"),
]


@pytest.mark.parametrize("key", SWEEP_AND_DITTO, ids=lambda k: f"{k[0]}:{k[1]}")
def test_the_sweep_and_ditto_callables_are_shared(key):
    assert key in SHARED, key


def _methods(module: str, cls: str, *names: str) -> list:
    return [(module, f"{cls}.{n}") for n in names]


# the split-model personalisation family's public callables and the
# engine's step hooks, each held by the checks below
PERSONALIZATION = [
    *_methods("clients.engine", "ClientLogic", "predict", "update_before_step",
              "update_after_step"),
    *_methods("clients.apfl", "ApflClientLogic", "__init__", "init_extra", "predict",
              "training_loss", "update_after_step", "eval_loss"),
    ("clients.apfl", "apfl_model_def"),
    *_methods("clients.fenda", "PerFclClientLogic", "__init__", "init_extra",
              "init_round_context", "training_loss", "finalize_round"),
    *_methods("clients.fenda", "ConstrainedFendaClientLogic", "__init__", "init_extra",
              "training_loss", "finalize_round"),
    *_methods("clients.fenda", "FendaDittoClientLogic", "__init__", "init_round_context",
              "training_loss", "eval_loss"),
    *_methods("clients.fedrep", "FedRepClientLogic", "__init__", "init_round_context",
              "transform_gradients"),
    *_methods("clients.gpfl", "GpflClientLogic", "__init__", "init_round_context", "predict",
              "training_loss"),
    ("clients.gpfl", "gpfl_model_def"),
    *_methods("clients.ensemble", "EnsembleClientLogic", "__init__", "training_loss"),
    *_methods("clients.fedsimclr", "FedSimClrClientLogic", "__init__", "predict",
              "training_loss", "eval_loss"),
    *_methods("clients.personalized", "DittoPersonalizedLogic", "__init__", "init_extra",
              "augment", "init_round_context", "training_loss", "eval_loss",
              "transform_gradients", "update_before_step", "update_after_step",
              "finalize_round", "pack"),
    *_methods("clients.personalized", "MrMtlPersonalizedLogic", "__init__", "init_extra",
              "augment", "init_round_context", "predict", "training_loss", "eval_loss",
              "transform_gradients", "update_before_step", "update_after_step",
              "finalize_round", "pack"),
    ("clients.personalized", "twin_model_def"), ("clients.personalized", "make_it_personal"),
    ("clients.personalized", "exchange_global_subtree"),
    ("losses.contrastive", "ntxent_loss"), ("losses.contrastive", "cosine_similarity_loss"),
    ("losses.contrastive", "perfcl_loss"),
    ("models.bases", "SequentiallySplitModel.exchange_features_only"),
    ("models.bases", "ParallelSplitModel.exchange_global_extractor"),
    ("models.bases", "ApflModule.exchange_global_model"),
    ("models.bases", "GpflModel.exchange_shared"),
]


@pytest.mark.parametrize("key", PERSONALIZATION, ids=lambda k: f"{k[0]}:{k[1]}")
def test_the_personalization_callables_are_shared(key):
    assert key in SHARED, key


# the algorithm-breadth slice's public callables (MMD, Flash, FedDG-GA,
# partial exchange, model merge, the autoencoders, FedPCA), each held by
# the checks below
BREADTH = [
    ("losses.mmd", "default_gammas"), ("losses.mmd", "uniform_betas"), ("losses.mmd", "mkmmd"),
    ("losses.mmd", "optimize_betas"),
    *_methods("losses.mmd", "DeepMmd", "__init__", "init", "value", "train_step", "train"),
    *_methods("clients.mmd", "DittoMkMmdClientLogic", "__init__", "training_loss"),
    *_methods("clients.mmd", "MrMtlMkMmdClientLogic", "__init__", "training_loss"),
    *_methods("clients.mmd", "DittoDeepMmdClientLogic", "__init__", "training_loss"),
    *_methods("clients.mmd", "MrMtlDeepMmdClientLogic", "__init__", "training_loss"),
    ("clients.engine", "masked_mse"), ("clients.engine", "masked_bce_with_logits"),
    ("losses.containers", "LossMeter.create"), ("losses.containers", "TrainingLosses.as_dict"),
    ("losses.containers", "EvaluationLosses.as_dict"),
    ("clients.flash", "make_flash_local_train"),
    *_methods("strategies.flash", "Flash", "__init__", "init", "aggregate"),
    *_methods("strategies.feddg_ga", "FedDgGa", "__init__", "init", "aggregate",
              "update_after_eval"),
    *_methods("strategies.feddg_ga", "FedDgGaAdaptiveConstraint", "__init__", "init",
              "client_payload", "aggregate", "update_after_eval"),
    ("exchange.packer", "packet_like"), ("exchange.packer", "full_leaf_mask"),
    ("exchange.packer", "full_element_mask"),
    *_methods("exchange.exchanger", "DynamicLayerExchanger", "push", "pull"),
    *_methods("exchange.exchanger", "SparseExchanger", "push", "pull"),
    *_methods("strategies.dynamic_layer", "FedAvgDynamicLayer", "__init__", "init",
              "client_payload", "aggregate"),
    *_methods("strategies.dynamic_layer", "FedAvgSparse", "__init__", "init",
              "client_payload", "aggregate"),
    *_methods("strategies.model_merge", "ModelMergeStrategy", "__init__", "init", "aggregate"),
    *_methods("server.servers", "EvaluateServer", "__init__", "fit"),
    *_methods("server.servers", "ModelMergeServer", "__init__", "fit"),
    ("models.autoencoders", "reparameterize"), ("models.autoencoders", "unpack_vae_output"),
    ("models.autoencoders", "kl_to_standard_normal"), ("models.autoencoders", "make_vae_loss"),
    *_methods("models.autoencoders", "BasicAe", "encode", "decode"),
    *_methods("models.autoencoders", "PcaModule", "__init__", "maybe_reshape", "fit",
              "project_lower_dim", "project_back", "reconstruction_error",
              "projection_variance", "explained_variance_ratios",
              "cumulative_explained_variance"),
    *_methods("strategies.fedpca", "FedPCA", "__init__", "init", "global_params", "aggregate"),
]


@pytest.mark.parametrize("key", BREADTH, ids=lambda k: f"{k[0]}:{k[1]}")
def test_the_algorithm_breadth_callables_are_shared(key):
    assert key in SHARED, key


def test_shared_parameters_come_in_jax_order():
    bad = {}
    for key in SHARED:
        j, t = _positional(JAX[key]), _positional(PORT[key])
        if [n for n in j if n in t] != [n for n in t if n in j]:
            bad[key] = (j, t)
    assert not bad, bad


def test_positional_calls_bind_as_in_jax():
    """A shared parameter stands at JAX's index wherever the port has every
    JAX parameter before it (a renamed one counts as present: same slot)."""
    bad = {}
    for key in SHARED:
        j, t = _positional(JAX[key]), _positional(PORT[key])
        renamed = {n for n, why in MISSING.get(key, {}).items() if why == RENAMED}
        for i, name in enumerate(j):
            if not all(p in t or p in renamed for p in j[:i]):
                break
            if name in t and t.index(name) != i:
                bad[key] = (name, i, t.index(name))
                break
            if name in renamed and (i >= len(t) or t[i] in j):
                bad[key] = (name, "renamed slot", t)
                break
    assert not bad, bad


def test_missing_parameters_are_exactly_the_allow_list():
    missing = {}
    for key in SHARED:
        lacking = [n for n in _every(JAX[key]) if n not in _every(PORT[key])]
        if lacking:
            missing[key] = lacking
    assert {k: sorted(v) for k, v in missing.items()} == {
        k: sorted(v) for k, v in MISSING.items()}


@pytest.mark.parametrize("anchor", sorted({a for v in MISSING.values() for a in v.values()}))
def test_every_allow_list_reason_is_in_the_roadmap(anchor):
    assert anchor in ROADMAP, anchor


def test_the_simulation_takes_jax_arguments_in_jax_slots():
    j = _positional(JAX[("server.simulation", "FederatedSimulation.__init__")])
    t = _positional(PORT[("server.simulation", "FederatedSimulation.__init__")])
    # every JAX argument and the port's device last
    assert t == j + ["device"]
