"""Hopper DP clip kernels (K1 squared norms, K2 scaled sum, and the fused
clip over a tree) against their plain PyTorch versions, on the card.

Needs an NVIDIA card and nvcc: every test here skips with a reason where
CUDA is absent. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_dp_clip_cuda.py

Bounds are the JAX kernel tests' (tests/kernels/test_dp_clip.py): K1 rtol
1e-5, K2 and the fused sums atol 1e-5. They hold for bf16 gradients too: the
kernel and the plain version widen the same bf16 values to f32 and sum the
same f32 products, in another order.
"""

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


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_matches_plain_over_a_cifarnet_tree(cuda, dtype):
    shapes = {"Conv_0/kernel": (5, 5, 3, 32), "Conv_0/bias": (32,),
              "Conv_1/kernel": (5, 5, 32, 64), "Conv_1/bias": (64,),
              "Dense_0/kernel": (4096, 128), "Dense_0/bias": (128,),
              "Dense_1/kernel": (128, 10), "Dense_1/bias": (10,)}
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
    assert dp.LAUNCHES == {"dp_sq_norms": 8, "dp_scaled_sum": 8}
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


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dp.sq_norms_kernel(torch.ones((2, 3), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="scale"):
        dp.scaled_sum_kernel(torch.ones((2, 3), device=cuda), torch.ones(3, device=cuda))
