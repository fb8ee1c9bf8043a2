"""The port's DP clip kernels (plain route on the CPU), DP-SGD primitives and
instance-level accountant against the JAX package, from the same numpy
inputs.

Bounds are the JAX kernel tests' (tests/kernels/test_dp_clip.py): squared
norms rtol 1e-5, sums atol 1e-5, for f32 and bf16 gradients alike: both
packages widen the same bf16 values to f32 and sum f32 products, so they
differ only in summation order. The JAX side runs its Pallas kernels in
interpret mode. The routes are compared at ``noise_multiplier=0``; the noise
itself is JAX's stream (``gaussian_noise_like`` against JAX's at 1e-6, the
2 ulp of ``rng.normal``) and is checked by its statistics too."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import chip_smoke
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fl4health_tpu.kernels import dp_clip as jdp
from fl4health_tpu.privacy import accountants as jacc
from fl4health_tpu.privacy import dpsgd as jdpsgd
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.kernels import dp_clip as tdp
from fl4health_tpu_torch.privacy import accountants as tacc
from fl4health_tpu_torch.privacy import dpsgd as tdpsgd

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _matrix(b, w, dtype, seed):
    """Seeded [b, w] gradients, rounded to ``dtype`` once, for both packages."""
    x = np.random.default_rng(seed).standard_normal((b, w)).astype(np.float32)
    x = x.astype(DTYPES[dtype][0])
    return jnp.asarray(x), torch.tensor(x.astype(np.float32)).to(DTYPES[dtype][1])


def _tree(b, dtype, seed):
    """A CifarNet-like tree of [b, ...] leaves: conv kernels, dense kernels,
    biases, and widths that are no multiple of 128 (ragged tiles)."""
    shapes = {"Conv_0/kernel": (3, 3, 3, 4), "Conv_0/bias": (4,),
              "Dense_0/kernel": (36, 20), "Dense_0/bias": (20,),
              "Dense_1/kernel": (20, 7), "Dense_1/bias": (7,)}
    rng = np.random.default_rng(seed)
    leaves = {k: (rng.standard_normal((b, *s)) * 0.3).astype(np.float32)
              .astype(DTYPES[dtype][0]) for k, s in shapes.items()}
    jt = {k: jnp.asarray(v) for k, v in leaves.items()}
    tt = {k: torch.tensor(v.astype(np.float32)).to(DTYPES[dtype][1])
          for k, v in leaves.items()}
    return jt, tt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,w", [(5, 300), (4, 129), (7, 1000), (3, 10), (2, 2048)])
def test_sq_norms_match_jax(dtype, b, w):
    jg, tg = _matrix(b, w, dtype, seed=w)
    want = jdp.per_example_sq_norms(jg, tile=128, interpret=True)
    got = tdp.per_example_sq_norms(tg)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,w", [(6, 500), (4, 129), (7, 1000), (3, 10)])
def test_scaled_sum_matches_jax(dtype, b, w):
    jg, tg = _matrix(b, w, dtype, seed=w + 1)
    scale = np.linspace(0.0, 2.0, b).astype(np.float32)
    scale[1] = 0.0  # a masked example
    want = jdp.scaled_masked_sum(jg, jnp.asarray(scale), tile=128, interpret=True)
    got = tdp.scaled_masked_sum(tg, torch.tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (w,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bound", [0.8, 100.0])
def test_fused_matches_jax(dtype, bound):
    jt, tt = _tree(6, dtype, seed=3)
    mask = np.asarray([1, 1, 0, 1, 1, 0], np.float32)
    want, wnorms = jdp.fused_clipped_masked_sum(jt, jnp.asarray(mask), bound, tile=128,
                                                interpret=True, return_norms=True)
    got, gnorms = tdp.fused_clipped_masked_sum(tt, torch.tensor(mask), bound,
                                               return_norms=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(gnorms.numpy(), np.asarray(wnorms), rtol=1e-5)


def test_plain_route_counts_no_launch_and_other_devices_raise():
    tdp.reset_launch_counts()
    g = torch.ones((2, 3))
    tdp.per_example_sq_norms(g)
    tdp.scaled_masked_sum(g, torch.ones(2))
    assert tdp.LAUNCHES == {"dp_sq_norms": 0, "dp_scaled_sum": 0}
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdp.per_example_sq_norms(meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdp.scaled_masked_sum(meta, torch.ones(2, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    # the wrappers that launch never run the plain version in their place
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdp.sq_norms_tree_kernel([torch.ones((2, 3))])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdp.scaled_sum_kernel(torch.ones((2, 3)), torch.ones(2))


def _many_leaves(b, dtype, seed, n=tdp.K1_MAX_LEAVES + 2):
    """n leaves of [b, w] with ragged widths from 1 to 300: more than one K1
    launch's table holds."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(1, 301, size=n)
    leaves = [(rng.standard_normal((b, w)) * 0.3).astype(np.float32).astype(DTYPES[dtype][0])
              for w in widths]
    return ([jnp.asarray(v) for v in leaves],
            [torch.tensor(v.astype(np.float32)).to(DTYPES[dtype][1]) for v in leaves])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["tree", "more_leaves_than_a_launch"])
def test_tree_sq_norms_match_jax(dtype, case):
    """K1 over a tree: the JAX kernel per leaf, summed in leaf order (the JAX
    fold), and the squared norms the JAX fused clip returns."""
    if case == "tree":
        jt, tt = _tree(6, dtype, seed=7)
        keys = list(tt)
        jmats = [jt[k].reshape(6, -1) for k in keys]
        tmats = [tt[k].reshape(6, -1) for k in keys]
    else:
        jmats, tmats = _many_leaves(5, dtype, seed=8)
        jt = {f"l{i:02d}": m for i, m in enumerate(jmats)}
    assert len(tdp.tree_plan(tmats[0].shape[0], tuple(
        (m.shape[1], m.element_size(), True) for m in tmats))) == (case != "tree") + 1
    want = sum(jdp.per_example_sq_norms(m, tile=128, interpret=True) for m in jmats)
    got = tdp.per_example_tree_sq_norms(tmats)
    assert got.dtype == torch.float32 and got.shape == (tmats[0].shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if case == "tree":
        mask = jnp.ones(6, jnp.float32)
        _, jnorms = jdp.fused_clipped_masked_sum(jt, mask, 1.0, tile=128, interpret=True,
                                                 return_norms=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnorms) ** 2, rtol=1e-5)


def _cifar_widths():
    return [int(np.prod(s)) for s in chip_smoke.CIFAR_LEAVES.values()]


def _decode(plan, item):
    """Item ``item`` of a launch as sq_norms_tree_kernel decodes it: (leaf,
    rows, columns, workspace slots of those rows)."""
    leaf = 0
    while leaf + 1 < len(plan.leaves) and item >= plan.leaves[leaf + 1].item0:
        leaf += 1
    lf = plan.leaves[leaf]
    group, chunk = divmod(item - lf.item0, lf.n_chunks)
    rows = range(group * lf.rows, min(plan.b, (group + 1) * lf.rows))
    cols = range(chunk * lf.chunk, min(lf.width, (chunk + 1) * lf.chunk))
    return leaf, rows, cols, [lf.ws0 + r * lf.n_chunks + chunk for r in rows]


@pytest.mark.parametrize("b,leaves", [
    (32, [(w, 4, True) for w in _cifar_widths()[:-1]] + [(10, 4, False)]),  # the DP path
    (32, [(w, 2, True) for w in _cifar_widths()]),
    (7, [(1000, 4, True), (8192 * 2 + 5, 4, True), (3, 2, False), (129, 4, False)]),
    (1, [(1, 4, False), (tdp.K1_ITEM_LOADS * 4, 4, True), (tdp.K1_ITEM_LOADS * 4 + 4, 4, True)]),
    (300, [(2, 2, False), (40, 4, True)]),
    (3, [(w, 4, w % 4 == 0) for w in range(1, 3 * tdp.K1_MAX_LEAVES + 5)]),  # three launches
])
def test_tree_plan_covers_every_element_once(b, leaves):
    """K1's item plan, decoded as the kernel decodes it: every (leaf, row,
    column) belongs to exactly one item, no item leaves its leaf, each
    launch's workspace slots belong to one item and one (row, chunk) each, and
    the finish's fold over those slots gives the tree's squared norms."""
    plans = tdp.tree_plan(b, tuple(leaves))
    assert [len(p.leaves) for p in plans] == [
        min(tdp.K1_MAX_LEAVES, len(leaves) - i) for i in range(0, len(leaves), tdp.K1_MAX_LEAVES)]
    rng = np.random.default_rng(b)
    data = [rng.standard_normal((b, w)).astype(np.float32) for w, _, _ in leaves]
    want = sum((x.astype(np.float64) ** 2).sum(1) for x in data)
    got, first = np.zeros(b), 0
    for plan in plans:
        covered = [np.zeros((b, lf.width), np.int64) for lf in plan.leaves]
        ws = np.full(plan.n_slots, np.nan)
        for lf, (width, elem, vec) in zip(plan.leaves, leaves[first:]):
            assert lf.width == width and lf.flags == (elem == 2) | (2 * vec)
            assert lf.n_chunks == 1 or lf.chunk * elem % 16 == 0 or not vec
            assert (lf.n_chunks - 1) * lf.chunk < width <= lf.n_chunks * lf.chunk
        for item in range(plan.n_items):
            leaf, rows, cols, slots = _decode(plan, item)
            assert len(rows) and len(cols) and cols.stop <= plan.leaves[leaf].width
            covered[leaf][rows.start:rows.stop, cols.start:cols.stop] += 1
            x = data[first + leaf][rows.start:rows.stop, cols.start:cols.stop]
            for slot, part in zip(slots, (x.astype(np.float64) ** 2).sum(1)):
                assert np.isnan(ws[slot]), f"slot {slot} written twice"
                ws[slot] = part
        assert all((c == 1).all() for c in covered)
        assert not np.isnan(ws).any()
        for lf in plan.leaves:  # the finish: column order, then leaf order
            got += ws[lf.ws0:lf.ws0 + b * lf.n_chunks].reshape(b, lf.n_chunks).sum(1)
        first += len(plan.leaves)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_tree_plan_keeps_every_thread_loading_on_cifarnet():
    """On the DP path's tree (B = 32, f32) every thread of every item's CTA
    loads at least once: narrow leaves pack rows (a bias of 32 columns is 32
    rows of 8 threads), and the tree is one launch of 586 items, one CTA
    each: 512 chunks of Dense_0/kernel's rows, 64 of Conv_1/kernel's, 4 items
    of 8 rows of Conv_0/kernel, 2 of 16 rows of Dense_1/kernel, and one item
    for each bias."""
    (plan,) = tdp.tree_plan(32, tuple([(w, 4, True) for w in _cifar_widths()[:-1]]
                                      + [(10, 4, False)]))
    assert (len(plan.leaves), plan.n_items) == (8, 586)
    assert [(lf.rows, lf.n_chunks) for lf in plan.leaves] == [
        (8, 1), (32, 1), (1, 2), (32, 1), (1, 16), (32, 1), (16, 1), (32, 1)]
    for item in range(plan.n_items):
        leaf, rows, cols, _ = _decode(plan, item)
        lf = plan.leaves[leaf]
        unit = 4 if lf.flags & 2 else 1
        packs, tail = divmod(len(cols), unit)
        loading = min(tdp.THREADS // lf.rows, max(packs, tail))  # threads of each row
        assert len(rows) * loading == tdp.THREADS, (item, lf)


def test_tree_wrappers_refuse_cpu_mixed_batches_and_mixed_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdp.sq_norms_tree_kernel([torch.ones((2, 3)), torch.ones((2, 5))])
    for fn in (tdp.sq_norms_tree_kernel, tdp.per_example_tree_sq_norms):
        with pytest.raises(ValueError, match=r"\[B=2, W\]"):
            fn([torch.ones((2, 3)), torch.ones((3, 3))])
        with pytest.raises(ValueError, match="leaves on cpu and meta"):
            fn([torch.ones((2, 3)), torch.empty((2, 3), device="meta")])
        with pytest.raises(ValueError, match="at least one leaf"):
            fn([])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_per_example_matches_jax(dtype):
    jt, tt = _tree(5, dtype, seed=4)
    jclipped, jnorms = jdpsgd.clip_per_example(jt, 0.5)
    tclipped, tnorms = tdpsgd.clip_per_example(tt, 0.5)
    # bf16 leaves: both packages compute the norms, the clip factor and the
    # product in bf16, each a rounding of at most 2^-8 relative that the two
    # may take apart: 3 * 2^-8 < 2^-6
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2**-6, atol=0)
    np.testing.assert_allclose(tnorms.float().numpy(),
                               np.asarray(jnorms).astype(np.float32), **tol)
    for k in jclipped:
        assert tclipped[k].dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(tclipped[k].float().numpy(),
                                   np.asarray(jclipped[k]).astype(np.float32), **tol)


@pytest.mark.parametrize("fused_port", [False, True])
@pytest.mark.parametrize("fused_jax", [False, True])
def test_noisy_clipped_mean_grads_routes_match_jax(fused_port, fused_jax):
    jt, tt = _tree(6, "float32", seed=5)
    mask = np.asarray([1, 0, 1, 1, 1, 1], np.float32)
    want, wfrac = jdpsgd.noisy_clipped_mean_grads(
        jt, jnp.asarray(mask), jax.random.PRNGKey(9), 0.5, 0.0,
        use_fused_kernel=fused_jax, return_clip_fraction=True)
    got, gfrac = tdpsgd.noisy_clipped_mean_grads(
        tt, torch.tensor(mask), rng.PRNGKey(9), 0.5, 0.0,
        use_fused_kernel=fused_port, return_clip_fraction=True)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    assert float(gfrac) == pytest.approx(float(wfrac), abs=1e-7)
    assert 0.0 < float(gfrac) <= 1.0


def test_noise_has_the_dp_std_and_fresh_draws_per_client_and_step():
    """Zero gradients isolate the noise: every coordinate is
    N(0, (sigma C)^2) / n_real. 200,000 draws estimate the std within
    ~0.16% (one standard error), so 1% is six standard errors. Each client
    and step draws from its own key (the client's key split once a step, as
    the engine splits it), and the same key draws the same noise again."""
    b, sigma, bound = 8, 1.3, 0.7
    mask = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.float32)
    zeros = {"w": torch.zeros((b, 400, 500))}
    init_rng = rng.fold_in(rng.PRNGKey(3), 0)
    draws, step_keys = {}, {}
    for client in (0, 1):
        key = rng.fold_in(init_rng, client + 1)
        for step in (0, 1):
            key, step_keys[client, step] = rng.split(key)
            draws[client, step] = tdpsgd.noisy_clipped_mean_grads(
                zeros, mask, step_keys[client, step], bound, sigma,
                use_fused_kernel=True)["w"]
    want_std = sigma * bound / float(mask.sum())
    for d in draws.values():
        assert float(d.mean()) == pytest.approx(0.0, abs=5 * want_std / 200_000 ** 0.5)
        assert float(d.std()) == pytest.approx(want_std, rel=0.01)
    keys = list(draws)
    for i, a in enumerate(keys):
        for c in keys[i + 1:]:
            assert not torch.equal(draws[a], draws[c]), (a, c)
    # the same key draws the same noise again
    again = tdpsgd.noisy_clipped_mean_grads(zeros, mask, step_keys[1, 1].clone(), bound,
                                            sigma, use_fused_kernel=True)["w"]
    assert torch.equal(again, draws[1, 1])


@pytest.mark.parametrize("seed", [0, 9])
def test_gaussian_noise_like_matches_jax(seed):
    """One key per leaf in JAX's flatten order (keys sorted at each level of
    the nested flax dict), whatever the order of the port's flat dict; f32
    draws cast to the leaf's dtype. 1e-6: ``rng.normal``'s 2 ulp."""
    shapes = {"Dense_1/kernel": (20, 7), "Conv_0/kernel": (3, 3, 3, 4),
              "Dense_0/bias": (20,), "Conv_0/bias": (4,), "Dense_0/kernel": (36, 20)}
    tree = {k: torch.zeros(s) for k, s in shapes.items()}
    nested = {}
    for k, s in shapes.items():
        mod, leaf = k.split("/")
        nested.setdefault(mod, {})[leaf] = jnp.zeros(s)
    want = jdpsgd.gaussian_noise_like(jax.random.PRNGKey(seed), nested, 0.7)
    got = tdpsgd.gaussian_noise_like(rng.PRNGKey(seed), tree, 0.7)
    assert list(got) == list(tree)
    for k in shapes:
        mod, leaf = k.split("/")
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[mod][leaf]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_make_per_example_grads_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    xs = rng.standard_normal((5, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnp.tanh(x @ p["w"]) ** 2)

    def tloss(p, x):
        return (torch.tanh(x @ p["w"]) ** 2).sum()

    want = jdpsgd.make_per_example_grads(jloss)({"w": jnp.asarray(w)}, jnp.asarray(xs))
    got = tdpsgd.make_per_example_grads(tloss)({"w": torch.tensor(w)}, torch.tensor(xs))
    assert got["w"].shape == (5, 4, 3)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6)


def test_validate_rejects_batchnorm():
    ok = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    tdpsgd.validate_dp_safe_model_state(ok)
    tdpsgd.validate_dp_safe_model_state(None)
    bad = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with pytest.raises(ValueError, match="BatchNorm"):
        tdpsgd.validate_dp_safe_model_state(bad)
    with pytest.raises(ValueError, match="batch_stats|BatchNorm"):
        jdpsgd.validate_dp_safe_model_state({"batch_stats": {}})


@pytest.mark.parametrize("kw", [
    # the full-width DP run of chip_smoke.py, whose epsilon it checks on the card
    dict(q=1.0, sigma=chip_smoke.DP_SIGMA, sizes=[chip_smoke.DP_TRAIN] * chip_smoke.DP_CLIENTS,
         batch=chip_smoke.BATCH, steps=chip_smoke.LOCAL_STEPS, epochs=None,
         rounds=chip_smoke.DP_ROUNDS, delta=1 / (chip_smoke.DP_TRAIN * chip_smoke.DP_CLIENTS)),
    dict(q=0.5, sigma=1.3, sizes=[40, 57, 100], batch=8, steps=None, epochs=2,
         rounds=3, delta=1e-5),
    dict(q=0.25, sigma=0.9, sizes=[64, 33], batch=16, steps=4, epochs=None,
         rounds=5, delta=1e-6),
])
def test_instance_level_accountant_matches_jax(kw):
    args = dict(client_sampling_rate=kw["q"], noise_multiplier=kw["sigma"],
                epochs_per_round=kw["epochs"],
                client_batch_sizes=[kw["batch"]] * len(kw["sizes"]),
                client_dataset_sizes=kw["sizes"], steps_per_round=kw["steps"])
    j, t = jacc.FlInstanceLevelAccountant(**args), tacc.FlInstanceLevelAccountant(**args)
    eps_j = j.get_epsilon(kw["rounds"], kw["delta"])
    eps_t = t.get_epsilon(kw["rounds"], kw["delta"])
    assert 0.0 < eps_t < np.inf
    assert abs(eps_t - eps_j) <= 1e-9
    if len(kw["sizes"]) == chip_smoke.DP_CLIENTS:
        assert abs(eps_t - chip_smoke.DP_EPSILON) <= 1e-9
    else:  # (64 identical clients make get_delta slow and teach nothing more)
        assert abs(t.get_delta(kw["rounds"], eps_t)
                   - j.get_delta(kw["rounds"], eps_j)) <= 1e-9


@pytest.mark.parametrize("b,w,elem_bytes,split", [
    (32, 524288, 4, 1),   # Dense_0/kernel: 512 CTAs unsplit
    (32, 51200, 4, 4),    # Conv_1/kernel: 50 CTAs unsplit, 200 at 4
    (32, 2400, 4, 32),    # Conv_0/kernel: 3 CTAs unsplit
    (32, 1280, 4, 32),    # Dense_1/kernel
    (32, 32, 4, 32),      # Conv_0/bias: 8 column groups
    (32, 10, 4, 32),      # Dense_1/bias
    (32, 134144, 4, 2),   # 33,536 groups: 131 CTAs, one short of 132 SMs
    (32, 134148, 4, 1),   # 33,537 groups: 132 CTAs
    (32, 268288, 2, 2),   # the same two sides in bf16 (8 columns a group)
    (32, 268296, 2, 1),
    (7, 1000, 4, 4),      # at most B, as a power of two
    (1, 10, 4, 1),
])
def test_scaled_sum_split_rule(b, w, elem_bytes, split):
    """K2's row split is a rule on the shape and the SM count (132 on an
    H100): the least power of two that gives every SM a CTA, capped at 32
    and at B."""
    assert tdp.scaled_sum_split(b, w, elem_bytes, n_sms=132) == split
