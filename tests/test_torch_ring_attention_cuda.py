"""The flash ring on the card: ``ring_flash_attention`` over a one-rank NCCL
world (a ``FileStore`` in the test's temporary directory, no network)
against ``flash_attention_lse`` on the same inputs. With one rank the ring
has no hop and its merge divides by exactly 1, so the output and the q/k/v
gradients equal the kernels' bit for bit, and the ring launches K3, K4 and
K5 once each.

Needs an NVIDIA card and nvcc: every test here skips with a reason where
CUDA is absent. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_ring_attention_cuda.py
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import importlib
import os

import pytest
import torch
import torch.distributed as dist

# the module: the package exports the function of that name, as JAX's does
fa = importlib.import_module("fl4health_tpu_torch.kernels.flash_attention")
pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl_world(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield torch.device("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_ring_equals_the_kernels(nccl_world, dtype):
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.ring_attention import ring_flash_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 128, 4, 64, generator=gen).to(nccl_world, dtype)
                   for _ in range(4))
    mask = torch.ones(2, 128, device=nccl_world)
    mask[1, 100:] = 0.0
    mesh = make_mesh((1,), ("seq",))

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        return [out.detach(), *(t.grad for t in leaves)]

    fa.reset_launch_counts()
    ring = run(lambda a, b, c: ring_flash_attention(a, b, c, mesh, pad_mask=mask))
    launches = dict(fa.LAUNCHES)
    plain = run(lambda a, b, c: fa.flash_attention_lse(a, b, c, mask)[0])
    assert launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for got, want, what in zip(ring, plain, ("out", "dq", "dk", "dv")):
        assert torch.equal(got, want), what
