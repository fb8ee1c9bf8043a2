"""Hopper DP clip kernels (K1 squared norms over a tree, K2 scaled sum, and
the fused clip over a tree) against their plain PyTorch versions, on the card.

Needs an NVIDIA card and nvcc: every test here skips with a reason where
CUDA is absent. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_dp_clip_cuda.py

Bounds are the JAX kernel tests' (tests/kernels/test_dp_clip.py): K1 rtol
1e-5, K2 and the fused sums atol 1e-5. They hold for bf16 gradients too: the
kernel and the plain version widen the same bf16 values to f32 and sum the
same f32 products, in another order.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import numpy as np
import pytest
import torch

from fl4health_tpu_torch.kernels import dp_clip as dp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _grads(shape, dtype, device, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(x).to(device=device, dtype=dtype)


DTYPES = [torch.float32, torch.bfloat16]
# widths: ragged (no multiple of any pack or chunk), a bias, one pack, and
# more than one 8192-column chunk with a ragged tail; CifarNet's narrow
# leaves (10, 32, 1,280, 2,400 columns), where K2 splits its rows over
# threads; and f32 widths of 33,536 and 33,537 column groups, one on each
# side of the split rule on an H100's 132 SMs (dp.scaled_sum_split)
WIDTHS = [(7, 1000), (32, 10), (3, 8), (4, 8192 * 2 + 5), (32, 2400), (32, 32),
          (32, 1280), (32, 134144), (32, 134148)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w", WIDTHS)
def test_sq_norms_match_plain(cuda, dtype, b, w):
    g = _grads((b, w), dtype, cuda, seed=w)
    dp.reset_launch_counts()
    got = dp.per_example_sq_norms(g)
    torch.cuda.synchronize()
    assert dp.LAUNCHES["dp_sq_norms"] == 1
    assert got.dtype == torch.float32 and got.shape == (b,)
    torch.testing.assert_close(got, dp.per_example_sq_norms_reference(g), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w", WIDTHS)
def test_scaled_sum_matches_plain(cuda, dtype, b, w):
    g = _grads((b, w), dtype, cuda, seed=w + 1)
    scale = torch.linspace(0.0, 1.5, b, device=cuda)
    dp.reset_launch_counts()
    got = dp.scaled_masked_sum(g, scale)
    torch.cuda.synchronize()
    assert dp.LAUNCHES["dp_scaled_sum"] == 1
    assert got.dtype == torch.float32 and got.shape == (w,)
    torch.testing.assert_close(got, dp.scaled_masked_sum_reference(g, scale), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unaligned_and_strided_views(cuda, dtype):
    # a view that starts one element in (no 16-byte alignment: scalar loads)
    # and one whose row stride (1032, aligned) is wider than its rows
    base = _grads((6, 1032), dtype, cuda, seed=3)
    for g in (base[:, 1:], base[:, :1000]):
        torch.testing.assert_close(dp.per_example_sq_norms(g),
                                   dp.per_example_sq_norms_reference(g), rtol=1e-5, atol=0)
        scale = torch.rand(6, device=cuda)
        torch.testing.assert_close(dp.scaled_masked_sum(g, scale),
                                   dp.scaled_masked_sum_reference(g, scale), atol=1e-5,
                                   rtol=0)


CIFAR_SHAPES = {"Conv_0/kernel": (5, 5, 3, 32), "Conv_0/bias": (32,),
                "Conv_1/kernel": (5, 5, 32, 64), "Conv_1/bias": (64,),
                "Dense_0/kernel": (4096, 128), "Dense_0/bias": (128,),
                "Dense_1/kernel": (128, 10), "Dense_1/bias": (10,)}


def _cifar_mats(b, dtype, device, seed=0):
    return [_grads((b, *s), dtype, device, seed=seed + i).reshape(b, -1)
            for i, s in enumerate(CIFAR_SHAPES.values())]


def _tree_close(mats, launches):
    dp.reset_launch_counts()
    got = dp.sq_norms_tree_kernel(mats)
    torch.cuda.synchronize()
    assert dp.LAUNCHES["dp_sq_norms"] == launches
    assert got.dtype == torch.float32 and got.shape == (mats[0].shape[0],)
    torch.testing.assert_close(got, dp.per_example_tree_sq_norms_reference(mats), rtol=1e-5,
                               atol=0)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_kernel_matches_plain_over_the_cifarnet_tree(cuda, dtype):
    # the DP path's tree: eight leaves, one launch
    _tree_close(_cifar_mats(32, dtype, cuda), launches=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_larger_than_a_launch(cuda, dtype):
    # 70 leaves of ragged widths: three launches, each adding onto the last
    rng = np.random.default_rng(4)
    mats = [_grads((5, int(w)), dtype, cuda, seed=i)
            for i, w in enumerate(rng.integers(1, 3000, size=2 * dp.K1_MAX_LEAVES + 6))]
    _tree_close(mats, launches=3)


def test_tree_with_unaligned_strided_and_mixed_leaves(cuda):
    # in one launch: a view one element in (scalar loads), one whose row
    # stride is wider than its rows, bf16 beside f32, a wide leaf cut into
    # column chunks and a narrow scalar one
    base = _grads((6, 1032), torch.float32, cuda, seed=3)
    half = _grads((6, 4104), torch.bfloat16, cuda, seed=4)
    mats = [base[:, 1:], base[:, :1000], half[:, 1:4097], half[:, :4096],
            _grads((6, 40000), torch.float32, cuda, seed=5), _grads((6, 10), torch.float32, cuda)]
    _tree_close(mats, launches=1)


@pytest.mark.parametrize("b", [1, 7, 300])
def test_tree_kernel_batch_sizes(cuda, b):
    # one row; a ragged row group; more rows than a CTA has threads
    _tree_close(_cifar_mats(b, torch.float32, cuda, seed=b), launches=1)


def test_one_leaf_route_is_the_tree_kernel(cuda):
    g = _grads((32, 524288), torch.float32, cuda, seed=6)
    dp.reset_launch_counts()
    assert torch.equal(dp.per_example_sq_norms(g), dp.sq_norms_tree_kernel([g]))
    assert dp.LAUNCHES["dp_sq_norms"] == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_matches_plain_over_a_cifarnet_tree(cuda, dtype):
    shapes = CIFAR_SHAPES
    b = 32
    # per-example norms from about 0.4 to 1.9, so that C = 1 clips some
    row_scale = torch.linspace(0.5e-3, 2.5e-3, b, device=cuda)
    tree = {k: (_grads((b, *s), torch.float32, cuda, seed=i)
                * row_scale.view(b, *[1] * len(s))).to(dtype)
            for i, (k, s) in enumerate(shapes.items())}
    mask = torch.ones(b, device=cuda)
    mask[-3:] = 0.0
    dp.reset_launch_counts()
    got, norms = dp.fused_clipped_masked_sum(tree, mask, 1.0, return_norms=True)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == {"dp_sq_norms": 1, "dp_scaled_sum": 8}
    mats = {k: v.reshape(b, -1) for k, v in tree.items()}
    sq = sum(dp.per_example_sq_norms_reference(m) for m in mats.values())
    want_norms = torch.sqrt(sq)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0)
    scale = torch.clamp(1.0 / torch.clamp(want_norms, min=1e-12), max=1.0) * mask
    assert 0 < int((want_norms > 1.0).sum()) < b  # some examples clip, some do not
    for k, m in mats.items():
        assert got[k].dtype == torch.float32 and got[k].shape == tree[k].shape[1:]
        torch.testing.assert_close(got[k], dp.scaled_masked_sum_reference(m, scale)
                                   .reshape(tree[k].shape[1:]), atol=1e-5, rtol=0)


def test_kernels_are_deterministic(cuda):
    scale = torch.rand(32, device=cuda)
    # the largest leaf, and a narrow one on which K2 splits its rows
    for w in (524288, 2400):
        g = _grads((32, w), torch.float32, cuda, seed=9)
        a, b = dp.per_example_sq_norms(g), dp.per_example_sq_norms(g)
        assert torch.equal(a, b)
        assert torch.equal(dp.scaled_masked_sum(g, scale), dp.scaled_masked_sum(g, scale))
    # K1 over a tree: twice on tree A, once on tree B (other shapes, so
    # another grid), then A again: all of A's bit-identical, so the ticket
    # counter is back at 0 after every launch
    tree_a = _cifar_mats(32, torch.float32, cuda, seed=10)
    tree_b = [_grads((32, w), torch.bfloat16, cuda, seed=w) for w in (7, 300, 70000)]
    first = dp.sq_norms_tree_kernel(tree_a)
    assert torch.equal(first, dp.sq_norms_tree_kernel(tree_a))
    other = dp.sq_norms_tree_kernel(tree_b)
    assert torch.equal(first, dp.sq_norms_tree_kernel(tree_a))
    assert torch.equal(other, dp.sq_norms_tree_kernel(tree_b))


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dp.sq_norms_tree_kernel([torch.ones((2, 3), dtype=torch.float16, device=cuda)])
    with pytest.raises(ValueError, match=r"\[B=2, W\]"):
        dp.sq_norms_tree_kernel([torch.ones((2, 3), device=cuda),
                                 torch.ones((3, 3), device=cuda)])
    with pytest.raises(ValueError, match="scale"):
        dp.scaled_sum_kernel(torch.ones((2, 3), device=cuda), torch.ones(3, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["clients", "rows"])
@pytest.mark.parametrize("b,w", [(5, 1000), (32, 32), (32, 2400), (4, 8192 * 2 + 5)])
def test_client_batched_entries_match_plain(cuda, dtype, layout, b, w):
    """K1 over [C, B, W] stacks as one launch of C * B rows, K2's batched
    entry as one launch with a grid row a client: both read the stack
    through its client and row strides, in either layout the client vmap
    leaves (each client's rows together, or row-major over [B, C])."""
    c = 6
    x = _grads((c, b, w) if layout == "clients" else (b, c, w), dtype, cuda, seed=w + b)
    g = x if layout == "clients" else x.transpose(0, 1)
    scale = torch.rand((c, b), device=cuda)
    dp.reset_launch_counts()
    norms, sums = dp.sq_norms_tree_kernel([g, g[..., : w // 2]]), dp.scaled_sum_kernel(g, scale)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == {"dp_sq_norms": 1, "dp_scaled_sum": 1}
    assert norms.shape == (c, b) and sums.shape == (c, w)
    torch.testing.assert_close(
        norms, dp.per_example_tree_sq_norms_reference([g, g[..., : w // 2]]), rtol=1e-5,
        atol=0)
    torch.testing.assert_close(sums, dp.scaled_masked_sum_reference(g, scale), rtol=0,
                               atol=1e-5)


def test_fused_clip_under_vmap_launches_once_and_copies_nothing(cuda):
    """The fused clip under torch.func.vmap over 4 clients, per-example
    gradients in the layout that does not fold as a view: one K1 launch,
    one K2 launch a leaf, no copy, and the plain clip's result per client."""
    tree = {k: _grads((7, 4, *s), torch.float32, cuda, seed=i).transpose(0, 1)
            for i, (k, s) in enumerate({"a": (3, 5), "b": (11,)}.items())}
    mask = torch.ones((4, 7), device=cuda)
    mask[:, 2] = 0.0
    dp.reset_launch_counts()
    got = torch.func.vmap(lambda t, m: dp.fused_clipped_masked_sum(t, m, 2.0))(tree, mask)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == {"dp_sq_norms": 1, "dp_scaled_sum": 2}
    assert dp.COPIES == {"dp_per_example": 0}
    for i in range(4):
        leaves = {k: v[i].reshape(7, -1) for k, v in tree.items()}
        norms = torch.sqrt(dp.per_example_tree_sq_norms_reference(list(leaves.values())))
        scale = torch.clamp(2.0 / torch.clamp(norms, min=1e-12), max=1.0) * mask[i]
        for k, m in leaves.items():
            torch.testing.assert_close(got[k][i].reshape(-1),
                                       dp.scaled_masked_sum_reference(m, scale),
                                       rtol=0, atol=1e-5)


def test_a_full_width_async_wave_matches_plain(cuda):
    """One local step of a buffered-async restart wave at the
    ``async_dp_cifar_cnn`` path's width: 64 clients under torch.func.vmap,
    32 examples each over the CifarNet tree in bf16, the per-example
    gradients in the layout the client vmap leaves; the clients that did not
    arrive train beside the arrived ones (their results are dropped after),
    and a padded last batch masks examples. One K1 launch, one K2 launch a
    leaf, no copy, and each client's clipped sums equal the plain clip's."""
    c, b = 64, 32
    row_scale = torch.linspace(0.5e-3, 2.5e-3, b, device=cuda)
    # drawn on the card: the Dense_0 leaf alone is 2^30 values
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {k: (torch.randn((b, c, *s), generator=gen, device=cuda)
                * row_scale.view(b, 1, *[1] * len(s))).to(torch.bfloat16).transpose(0, 1)
            for k, s in CIFAR_SHAPES.items()}
    mask = torch.ones((c, b), device=cuda)
    mask[1::2, -5:] = 0.0  # padded last batches on half the clients
    dp.reset_launch_counts()
    got = torch.func.vmap(lambda t, m: dp.fused_clipped_masked_sum(t, m, 1.0))(tree, mask)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == {"dp_sq_norms": 1, "dp_scaled_sum": len(CIFAR_SHAPES)}
    assert dp.COPIES == {"dp_per_example": 0}
    for i in (0, 1, 31, 62, 63):
        mats = {k: v[i].reshape(b, -1) for k, v in tree.items()}
        norms = torch.sqrt(dp.per_example_tree_sq_norms_reference(list(mats.values())))
        scale = torch.clamp(1.0 / torch.clamp(norms, min=1e-12), max=1.0) * mask[i]
        for k, m in mats.items():
            torch.testing.assert_close(got[k][i].reshape(-1),
                                       dp.scaled_masked_sum_reference(m, scale),
                                       rtol=0, atol=1e-5)
