#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (fl4health_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. Require CUDA; print the card's name and power limit (nvidia-smi).
  2. Build the flash-attention extension from kernels/csrc (sm_90a).
  3. Hold the forward, dQ and dK/dV kernels against their plain PyTorch
     versions at the main path's shapes (B=32, T=2048, H=8, D=64, ragged pad
     masks, one batch element with no real key) in f32 and bf16, and at a T
     that is not a multiple of the 64-row tile. bf16 at D=64 takes the
     tensor-core kernels (wgmma): out, dQ, dK and dV are held to the derived
     bounds of ``bf16_operand_bounds``, lse to TOL below, and a second dQ
     launch must be bit-identical; each check prints the share of its
     bound used. The first slice's CUDA-core bf16 kernels
     are held to TOL on the same inputs, and bf16 at head dim 12 runs them
     through the wrapper and autograd at the ragged T. Time each kernel,
     its plain version, F.scaled_dot_product_attention (a yardstick the port
     never calls) and the CUDA-core kernel of the first slice on the same
     bf16 inputs, with CUDA events.
  4. A tiny federated run on the card (kernels) against the same run on the
     CPU (plain version): per-round losses and final params within 5e-4.
     Then the same tiny transformer (head dim 64) in bf16 compute for 2
     rounds on the card through the kernels and through the plain version,
     and the plain run in f32 compute: the kernels may move losses and
     params by no more than bf16 compute moves the plain run.
  5. The main path: federated training of the transformer_long configuration
     at full width (vocab 8192, d_model 512, 8 heads, 4 layers, d_ff 2048,
     T 2048, remat, bf16 compute / f32 params) for 2 FedAvg rounds of
     2 clients x 5 local SGD steps of batch 32, with the launch counts set to 0
     just before and read just after: every launch must take the tensor
     cores.
  6. Hold the DP clip kernels (K1 squared norms, K2 scaled sum, and the fused
     clip over a tree) against their plain versions at the DP path's largest
     leaf [32, 524288], over the whole CifarNet per-example tree and at a
     ragged [7, 1000], in f32 and bf16 (K2 splits its rows over threads on
     the tree's narrow leaves; a second K2 launch must be bit-identical);
     time K1 and K2 at the largest leaf and over
     the tree, beside their plain versions and one library call each.
  7. A tiny DP federated run on the card (kernels) against the same run on
     the CPU (plain versions), noise_multiplier 0: within 5e-4.
  8. The DP path: DP-FedAvg of CifarNet at full width (64 clients of 160
     train rows, batch 32, 5 local DP-SGD steps with C = 1 and sigma = 1,
     bf16 compute / f32 params) for 2 rounds under InstanceLevelDpServer, with
     the DP launch counts set to 0 just before and read just after; its
     epsilon must equal the accountant's value for this configuration.
Both extensions are built at the start, in parallel. Then one JSON line with
every kernel, the card line again, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

B, T, H, D = 32, 2048, 8, 64
RAGGED_T = 2000  # not a multiple of the kernels' 64-row tile
N_CLIENTS, BATCH, LOCAL_STEPS, ROUNDS = 2, 32, 5, 2

# (atol, rtol) per output. f32 are the JAX kernel tests' bounds
# (tests/kernels/test_flash_attention.py). bf16 hold the kernel (bf16 in and
# out) against the plain version in f32 on the same bf16-rounded inputs: they
# differ by the one bf16 rounding of out, dq, dk and dv (at most 2^-8
# relative; rtol is twice that) plus f32 summation noise (about 1e-6 here;
# atol is 100 times that). The tensor-core kernels also round P and dS to
# bf16 as operands: out, dq, dk and dv add the term of
# ``bf16_operand_bounds`` for that rounding to these. lse stays f32 in the
# kernels, so it keeps the f32 bound.
TOL = {
    torch.float32: {"out": (2e-5, 1e-4), "lse": (2e-5, 1e-4), "grad": (5e-4, 1e-4)},
    torch.bfloat16: {"out": (1e-4, 2**-7), "lse": (2e-5, 1e-4), "grad": (1e-4, 2**-7)},
}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores; f32 on the
# CUDA cores (f32 here must not use TF32); HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SOURCE = "fl4health_tpu_torch/kernels/csrc/flash_attention.cu"
WGMMA_SOURCE = "fl4health_tpu_torch/kernels/csrc/flash_attention_wgmma.cu"
DP_SOURCE = "fl4health_tpu_torch/kernels/csrc/dp_clip.cu"

# The DP path: bench.py's cifar_cnn run (64 clients of 160 train + 64 val
# rows, batch 32, 5 local steps, SGD 0.05, FedAvg, seed 0) with the
# instance-level DP example's C = 1, sigma = 1
DP_CLIENTS, DP_TRAIN, DP_VAL, DP_ROUNDS = 64, 160, 64, 2
DP_CLIP, DP_SIGMA = 1.0, 1.0
# epsilon of that run at delta = 1 / (64 * 160), from the CPU accountant
# (tests/test_torch_dp_clip.py holds both packages' accountants to it)
DP_EPSILON = 4.8447493207072
# (atol, rtol) of the JAX kernel tests (tests/kernels/test_dp_clip.py), for
# f32 and bf16 gradients alike: the kernels and the plain versions widen the
# same values to f32 and sum the same f32 products, in another order
DP_TOL = {"dp_sq_norms": (0.0, 1e-5), "dp_scaled_sum": (1e-5, 0.0),
          "fused": (1e-5, 0.0)}
# CifarNet's parameter leaves, each with a leading per-example axis on the path
CIFAR_LEAVES = {"Conv_0/kernel": (5, 5, 3, 32), "Conv_0/bias": (32,),
                "Conv_1/kernel": (5, 5, 32, 64), "Conv_1/bias": (64,),
                "Dense_0/kernel": (4096, 128), "Dense_0/bias": (128,),
                "Dense_1/kernel": (128, 10), "Dense_1/bias": (10,)}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 7, warmup: int = 2, calls: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``calls`` back-to-back
    calls, per call, in ms. A spin kernel (~10 ms) runs ahead of the start
    event, so the host has enqueued every call before the device reaches
    it: the time is the device's, without the host's launch latency (which
    is most of a 20-microsecond kernel's call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float) -> float:
    """max |got - want|; fails where |got - want| > atol + rtol |want|."""
    return check_stats(name, got, want, atol, rtol)["max_abs_err"]


def check_stats(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float) -> dict:
    """As ``check``, with the size of the values held and the largest share
    of the bound that an element used."""
    return check_bound(name, got, want, atol + rtol * want.float().abs(),
                       f"atol={atol} rtol={rtol}")


def check_bound(name: str, got: torch.Tensor, want: torch.Tensor,
                bound: torch.Tensor, what: str = "the derived bound") -> dict:
    """Fails where |got - want| exceeds the per-element ``bound``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    bad = diff > bound
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements beyond {what}, "
             f"max abs err {float(diff.max()):.3e}")
    return {"max_abs_err": float(diff.max()), "mean_abs_ref": float(want.abs().mean()),
            "max_abs_ref": float(want.abs().max()),
            "bound_used": float((diff / bound).max())}


def attention_inputs(b: int, t: int, dtype: torch.dtype, seed: int, d: int = D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, H, d), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    dlse = torch.randn((b, H, t), generator=g, device="cuda")
    lengths = np.random.default_rng(seed).integers(t // 2, t + 1, size=b)
    lengths[-1] = 0  # one batch element with no real key
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).float().cuda()
    return q, k, v, mask, do, dlse


def plain_grads(fa, q, k, v, mask, do, dlse, out) -> tuple:
    """``([dq, dk, dv], lse, delta)`` of (out, lse) under cotangents (do,
    dlse), by the plain version in f32. f32: autograd through it (no lse or
    delta returned). bf16: the kernels' contract
    hands out O in bf16 and the backward reads delta = rowsum(dO O) - dlse
    from that O (as the JAX ``_bwd_call`` does); the tensor-core forward's O
    differs from the plain one's by its rounding of P, which would move dq
    and dk through delta by more than the kernels' own error. So the plain
    backward reads delta from ``out``, the O the kernel path handed out, and
    is in f32 otherwise."""
    if q.dtype == torch.float32:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fa.flash_attention_reference(*leaves, mask)
        torch.autograd.backward([o, lse], [do, dlse])
        return [x.grad for x in leaves], None, None
    with torch.no_grad():
        _, lse = fa.flash_attention_reference(q, k, v, mask)
        delta = fa.backward_delta(do, out, dlse)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        return [fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta),
                *fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)], lse, delta


def kernel_checks(fa, b: int, t: int, dtype: torch.dtype, seed: int,
                  autograd_check: bool, d: int = D) -> dict:
    """Each kernel against its plain version on the same inputs; returns the
    max abs errors and prints them with the size of the values held and the
    share of each bound used. On the tensor-core route the first slice's
    CUDA-core forward, dQ and dK/dV (which bf16 at other head dims still
    takes) are held to TOL on the same inputs too."""
    tol = TOL[dtype]
    g_atol, g_rtol = tol["grad"]
    q, k, v, mask, do, dlse = attention_inputs(b, t, dtype, seed, d)
    tensor_cores = fa.wgmma_route(q)
    tag = f"{str(dtype).split('.')[-1]} B={b} T={t}" + (f" d={d}" if d != D else "")

    def bounds(*args):
        """out, dq, dk, dv bounds: the derived ones on the tensor-core route."""
        if not tensor_cores:
            return None
        return fa.bf16_operand_bounds(*args, atol=tol["out"][0], rtol=tol["out"][1])

    def held(name, got, want, bnd, key, atol, rtol):
        if bnd is None:
            return check_stats(name, got, want, atol, rtol)
        return check_bound(name, got, want, bnd[key])

    with torch.no_grad():
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        out, lse = fa.flash_fwd(q, k, v, mask)
        ref_out, ref_lse = fa.flash_attention_reference(qf, kf, vf, mask)
        if not torch.all(out[-1] == 0):
            fail(f"{tag}: a row with no real key must give out = 0")
        stats = {"out": held(f"fwd out {tag}", out, ref_out, bounds(qf, kf, vf, mask),
                             "out", *tol["out"]),
                 "lse": check_stats(f"fwd lse {tag}", lse, ref_lse, *tol["lse"])}
        delta = fa.backward_delta(do, out, dlse)
        if tensor_cores:
            core_fwd, core_dq, core_dkv, core = cuda_core_launchers(fa, q, k, v, mask, do,
                                                                    lse, delta)
            core_fwd()
            stats["cuda_core_out"] = check_stats(f"CUDA-core fwd out {tag}", core["out"],
                                                 ref_out, *tol["out"])
            stats["cuda_core_lse"] = check_stats(f"CUDA-core fwd lse {tag}", core["lse"],
                                                 ref_lse, *tol["lse"])
        del ref_out, ref_lse
        bnd = bounds(qf, kf, vf, mask, dof, lse, delta)
        dq = fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)
        ref = fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta)
        stats["dq"] = held(f"dq {tag}", dq, ref, bnd, "dq", g_atol, g_rtol)
        if tensor_cores:
            # no atomics and each row written once: a second launch is bit-identical
            if not torch.equal(dq, fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)):
                fail(f"dq {tag}: a second launch differs from the first")
            core_dq()
            stats["cuda_core_dq"] = check_stats(f"CUDA-core dq {tag}", core["dq"], ref,
                                                g_atol, g_rtol)
        del ref
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)
        stats["dk"] = held(f"dk {tag}", dk, ref_dk, bnd, "dk", g_atol, g_rtol)
        stats["dv"] = held(f"dv {tag}", dv, ref_dv, bnd, "dv", g_atol, g_rtol)
        if tensor_cores:
            core_dkv()
            stats["cuda_core_dk"] = check_stats(f"CUDA-core dk {tag}", core["dk"], ref_dk,
                                                g_atol, g_rtol)
            stats["cuda_core_dv"] = check_stats(f"CUDA-core dv {tag}", core["dv"], ref_dv,
                                                g_atol, g_rtol)
            del core
        del ref_dk, ref_dv, dq, dk, dv, bnd
    if autograd_check:
        # the autograd.Function end to end (forward kernel, delta, both
        # backward kernels) against the plain version's gradients
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o, l_ = fa._FlashAttention.apply(*leaves, mask)
        torch.autograd.backward([o.float(), l_], [do.float(), dlse])
        got = [x.grad for x in leaves]
        want, p_lse, p_delta = plain_grads(fa, q, k, v, mask, do, dlse, o.detach())
        with torch.no_grad():
            bnd = bounds(qf, kf, vf, mask, dof, p_lse, p_delta)
        del o, l_, leaves
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            stats[f"autograd_{name}"] = held(f"autograd {name} {tag}", g, w, bnd, name,
                                             g_atol, g_rtol)
        del got, want, bnd
    worst = lambda *names: max(stats[n]["max_abs_err"] for n in names)  # noqa: E731
    err = {"flash_fwd": worst("out", "lse"), "flash_bwd_dq": worst("dq"),
           "flash_bwd_dkv": worst("dk", "dv")}
    share = {n: max(stats[x]["bound_used"] for x in xs) for n, xs in
             (("flash_fwd", ("out", "lse")), ("flash_bwd_dq", ("dq",)),
              ("flash_bwd_dkv", ("dk", "dv")))}
    if tensor_cores:
        err["cuda_core"] = {"flash_fwd": worst("cuda_core_out", "cuda_core_lse"),
                            "flash_bwd_dq": worst("cuda_core_dq"),
                            "flash_bwd_dkv": worst("cuda_core_dk", "cuda_core_dv")}
    print(json.dumps({"check": tag, "tensor_cores": tensor_cores, "max_abs_err": err,
                      "bound_used": share, "stats": stats,
                      "tolerance": {name: list(b) for name, b in tol.items()},
                      "derived_bounds": ["out", "dq", "dk", "dv"] if tensor_cores else []}))
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "bound_used": share}


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_core_launchers(fa, q, k, v, mask, do, lse, delta):
    """The first slice's CUDA-core forward, dQ and dK/dV kernels on the same
    inputs (the route bf16 at D=64 took before the tensor-core kernels),
    launched through the extension directly, to check and time beside them:
    ``(fwd, dq, dkv, outputs)``, where each launch writes ``outputs``' out
    and lse, dq, or dk and dv."""
    ext, (b, t, h, d) = fa.build_extension(), q.shape
    bf16, stream = q.dtype == torch.bfloat16, torch.cuda.current_stream().cuda_stream
    out, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [x.data_ptr() for x in (q, k, v, mask)]
    bwd = [do.data_ptr(), lse.data_ptr(), delta.data_ptr()]

    def fwd():
        if ext.fwd(*ptrs, out.data_ptr(), lse_out.data_ptr(), b, t, h, d, d ** -0.5,
                   bf16, stream):
            fail("CUDA-core forward launch failed")

    def bwd_dq():
        if ext.bwd_dq(*ptrs, *bwd, dq.data_ptr(), b, t, h, d, d ** -0.5, bf16, stream):
            fail("CUDA-core dQ launch failed")

    def dkv():
        if ext.bwd_dkv(*ptrs, *bwd, dk.data_ptr(), dv.data_ptr(), b, t, h, d, d ** -0.5,
                       bf16, stream):
            fail("CUDA-core dK/dV launch failed")
    return fwd, bwd_dq, dkv, {"out": out, "lse": lse_out, "dq": dq, "dk": dk, "dv": dv}


def kernel_timings(fa, dtype: torch.dtype) -> dict:
    """Kernel, plain version and SDPA times at the main path's shapes, and
    the first slice's CUDA-core kernels on the same inputs."""
    q, k, v, mask, do, dlse = attention_inputs(B, T, dtype, seed=11)
    es = q.element_size()
    n, rows = q.numel(), B * H * T
    # query rows x real keys, over batch and heads: the work this data needs
    pairs = float(T * H * mask.sum())
    small = mask.numel() * 4 + rows * 4  # mask + one [B,H,T] f32 vector
    with torch.no_grad():
        out, lse = fa.flash_fwd(q, k, v, mask)
        delta = fa.backward_delta(do, out, dlse)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        key_ok = (mask > 0)[:, None, None, :]
        core_fwd, core_dq, core_dkv, _ = cuda_core_launchers(fa, q, k, v, mask, do, lse,
                                                             delta)
        res = {
            "flash_fwd": dict(
                ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, mask)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask), reps=3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=key_ok)),
                cuda_core_ms=cuda_ms(core_fwd),
                bound=bound_ms(4 * D * pairs, 4 * n * es + small, dtype)),
            "flash_bwd_dq": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # no library call computes dQ alone
                cuda_core_ms=cuda_ms(core_dq),
                bound=bound_ms(6 * D * pairs, 5 * n * es + small + rows * 4, dtype)),
            "flash_bwd_dkv": dict(
                ms=cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)),
                plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, mask, do, lse, delta), reps=3),
                library_ms=None,  # nor dK and dV alone
                cuda_core_ms=cuda_ms(core_dkv),
                bound=bound_ms(8 * D * pairs, 6 * n * es + small + rows * 4, dtype)),
        }
    # SDPA's backward computes dQ, dK and dV in one call: a yardstick for
    # flash_bwd_dq + flash_bwd_dkv together
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=key_ok)
    doh = do.transpose(1, 2).contiguous()
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))
    print(json.dumps({"timing": str(dtype).split(".")[-1], "shape": [B, T, H, D],
                      **{k: {kk: vv for kk, vv in r.items() if kk != "bound"}
                         for k, r in res.items()},
                      "sdpa_backward_ms": sdpa_bwd,
                      "kernels_backward_ms": res["flash_bwd_dq"]["ms"]
                      + res["flash_bwd_dkv"]["ms"]}))
    del o, leaves
    torch.cuda.empty_cache()
    res["flash_bwd_dq"]["library_dqkv_ms"] = sdpa_bwd
    res["flash_bwd_dkv"]["library_dqkv_ms"] = sdpa_bwd
    return res


def build_sim(modules, datasets, dtype, device, seed, attention_fn=None):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.transformer import TransformerClassifier
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    module = TransformerClassifier(
        **modules, dtype=dtype, remat=True,
        attention_fn=attention_fn or flash_attention)
    return FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=datasets, batch_size=BATCH,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=LOCAL_STEPS,
        seed=seed, device=device)


def text_datasets(vocab: int, seq: int, n_rows: int, n_train: int):
    from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(N_CLIENTS):
        x, y = synthetic_text_classification(torch.Generator().manual_seed(i), n_rows,
                                             vocab, seq, 4)
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def tiny_parity() -> None:
    """The same tiny federated run on the card (kernels) and on the CPU
    (plain version), from the same params."""
    cfg = dict(vocab_size=64, n_classes=4, d_model=64, n_heads=2, n_layers=2,
               d_ff=128, max_len=80)
    data = text_datasets(64, 80, 48, 40)
    runs = []
    for device in ("cuda", "cpu"):
        sim = build_sim(cfg, data, torch.float32, device, seed=3)
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        runs.append((sim.fit(2), sim.global_params, init))
    (gpu_hist, gpu_params, _), (cpu_hist, cpu_params, _) = runs
    for gr, cr in zip(gpu_hist, cpu_hist):
        for key in ("backward",):
            check(f"tiny fit loss r{gr.round}", torch.tensor(gr.fit_losses[key]),
                  torch.tensor(cr.fit_losses[key]), 5e-4, 0)
        check(f"tiny eval loss r{gr.round}", torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    err = max(check(f"tiny param {k}", gpu_params[k].cpu(), cpu_params[k], 5e-4, 0)
              for k in cpu_params)
    print(json.dumps({"tiny_parity": "cuda kernels vs cpu plain", "rounds": 2,
                      "fit_losses": [r.fit_losses["backward"] for r in gpu_hist],
                      "max_param_abs_err": err}))


def bf16_model_check(fa) -> dict:
    """The tiny transformer at head dim 64 in bf16 compute, 2 rounds on the
    card through the kernels (tensor-core forward and dK/dV) and through the
    plain version, and the plain version in f32 compute, all from the same
    params: the kernels may move the losses and the params by no more than
    bf16 compute moves the plain run."""
    cfg = dict(vocab_size=64, n_classes=4, d_model=128, n_heads=2, n_layers=2,
               d_ff=256, max_len=80)
    data = text_datasets(64, 80, 48, 40)

    def plain(q, k, v, pad_mask=None):
        return fa.flash_attention_reference(q, k, v, pad_mask)[0]

    runs, init = {}, None
    for name, dtype, attn in (("kernels_bf16", torch.bfloat16, None),
                              ("plain_bf16", torch.bfloat16, plain),
                              ("plain_f32", torch.float32, plain)):
        sim = build_sim(cfg, data, dtype, "cuda", seed=3, attention_fn=attn)
        if init is None:
            init = {k: v.clone() for k, v in sim.global_params.items()}
        sim.set_global_params({k: v.clone() for k, v in init.items()})
        fa.reset_launch_counts()
        hist = sim.fit(2)
        torch.cuda.synchronize()
        losses = torch.tensor([x for r in hist for x in (r.fit_losses["backward"],
                                                         r.eval_losses["checkpoint"])])
        runs[name] = (losses, sim.global_params, dict(fa.WGMMA_LAUNCHES))
    if min(runs["kernels_bf16"][2].values()) == 0:
        fail(f"bf16 model check: the tensor-core kernels never ran {runs['kernels_bf16'][2]}")
    if max(runs["plain_bf16"][2].values()) != 0:
        fail("bf16 model check: the plain run launched kernels")

    def gap(a, b):
        la, pa, _ = runs[a]
        lb, pb, _ = runs[b]
        return (float((la - lb).abs().max()),
                max(float((pa[k] - pb[k]).abs().max()) for k in pa))
    kernels, bf16 = gap("kernels_bf16", "plain_bf16"), gap("plain_bf16", "plain_f32")
    res = {"bf16_model_check": "tiny transformer, head dim 64, 2 rounds",
           "kernels_vs_plain_bf16": {"loss": kernels[0], "param": kernels[1]},
           "plain_bf16_vs_plain_f32": {"loss": bf16[0], "param": bf16[1]},
           "losses": {k: v[0].tolist() for k, v in runs.items()},
           "wgmma_launches": runs["kernels_bf16"][2]}
    print(json.dumps(res))
    if not all(np.isfinite(runs[k][0].numpy()).all() for k in runs):
        fail("bf16 model check: non-finite losses")
    if kernels[0] > bf16[0] or kernels[1] > bf16[1]:
        fail(f"bf16 model check: the kernels move (loss, param) by {kernels}, "
             f"more than bf16 compute does {bf16}")
    return res


def main_path(fa) -> dict:
    """Full-width transformer_long federated training, bf16 compute."""
    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=T)
    data = text_datasets(8192, T, BATCH * LOCAL_STEPS + 16, BATCH * LOCAL_STEPS)
    sim = build_sim(cfg, data, torch.bfloat16, "cuda", seed=0)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.time()
    hist = sim.fit(ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, wgmma = dict(fa.LAUNCHES), dict(fa.WGMMA_LAUNCHES)
    positions = N_CLIENTS * LOCAL_STEPS * BATCH * T
    real = sum(int((d.x_train > 0).sum()) for d in data)  # one pass over each client's rows
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({
            "round": r.round, "fit_loss": r.fit_losses["backward"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_s": r.fit_elapsed_s, "eval_s": r.eval_elapsed_s,
            "round_wall_s": r.fit_elapsed_s + r.eval_elapsed_s,
            "train_token_positions_per_s": positions / r.fit_elapsed_s,
            "train_real_tokens_per_s": real / r.fit_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    if not finite or moved <= 0:
        fail(f"global params after training: finite={finite}, max change {moved}")
    expected = {  # per round: 2 clients x 5 steps x 4 layers (x2 for remat) + eval
        "flash_fwd": ROUNDS * (N_CLIENTS * LOCAL_STEPS * 4 * 2 + N_CLIENTS * 4),
        "flash_bwd_dq": ROUNDS * N_CLIENTS * LOCAL_STEPS * 4,
        "flash_bwd_dkv": ROUNDS * N_CLIENTS * LOCAL_STEPS * 4,
    }
    print(json.dumps({"main_path": "transformer_long", "rounds": ROUNDS, "wall_s": wall,
                      "n_params": sum(v.numel() for v in init.values()),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected, "wgmma_launches": wgmma}))
    if launches != expected:
        fail(f"main-path launches {launches}, expected {expected}")
    # bf16 at head dim 64: every launch of all three kernels took the tensor cores
    if wgmma != launches:
        fail(f"main-path tensor-core launches {wgmma}, expected all of {launches}")
    return launches


def dp_tree(shapes: dict, b: int, dtype: torch.dtype, seed: int,
            grad_scale: bool = False) -> dict:
    """Per-example gradients [b, *shape] on the card: unit normals (as the
    JAX kernel tests draw them), or with ``grad_scale`` times a per-example
    scale from 0.5e-3 to 2.5e-3, so that at the CifarNet tree's width C = 1
    clips some examples and not others."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    row = (torch.linspace(0.5e-3, 2.5e-3, b, device="cuda") if grad_scale
           else torch.ones(b, device="cuda"))
    return {k: (torch.randn((b, *s), generator=g, device="cuda")
                * row.view(b, *[1] * len(s))).to(dtype) for k, s in shapes.items()}


def fused_plain(dp, tree: dict, mask: torch.Tensor, bound: float):
    """The fused clip and sum, composed of the plain versions."""
    mats = {k: v.reshape(v.shape[0], -1) for k, v in tree.items()}
    norms = torch.sqrt(sum(dp.per_example_sq_norms_reference(m) for m in mats.values()))
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0) * mask
    return {k: dp.scaled_masked_sum_reference(m, scale).reshape(tree[k].shape[1:])
            for k, m in mats.items()}, norms


def dp_kernel_checks(dp, dtype: torch.dtype) -> dict:
    """K1, K2 and the fused clip against their plain versions at the largest
    leaf, over the whole CifarNet tree and at a ragged width (K1 and K2 on
    unit normals, the fused clip on gradient-sized values that C = 1 clips in
    part); returns the max abs error of each kernel at the largest leaf."""
    tag = str(dtype).split(".")[-1]
    stats, at_leaf = {}, {}
    cases = {"leaf": {"Dense_0/kernel": (524288,)}, "tree": CIFAR_LEAVES,
             "ragged": {"w": (1000,)}}
    for case, shapes in cases.items():
        b = 7 if case == "ragged" else BATCH
        tree = dp_tree(shapes, b, dtype, seed=len(stats) + 21)
        grads = dp_tree(shapes, b, dtype, seed=len(stats) + 22, grad_scale=True)
        mask = torch.ones(b, device="cuda")
        mask[1] = 0.0  # a padding example
        scale = torch.rand(b, device="cuda") * 1.5 * mask
        with torch.no_grad():
            for k, leaf in tree.items():
                m = leaf.reshape(b, -1)
                name = f"{case} {k} {tag} {list(m.shape)}"
                stats[f"dp_sq_norms {name}"] = check_stats(
                    f"dp_sq_norms {name}", dp.sq_norms_kernel(m),
                    dp.per_example_sq_norms_reference(m), *DP_TOL["dp_sq_norms"])
                got = dp.scaled_sum_kernel(m, scale)
                stats[f"dp_scaled_sum {name}"] = check_stats(
                    f"dp_scaled_sum {name}", got,
                    dp.scaled_masked_sum_reference(m, scale), *DP_TOL["dp_scaled_sum"])
                # a fixed order on both routes: a second launch is bit-identical
                if not torch.equal(got, dp.scaled_sum_kernel(m, scale)):
                    fail(f"dp_scaled_sum {name}: a second launch differs from the first")
                if case == "leaf":
                    at_leaf = {n: stats[f"{n} {name}"]["max_abs_err"]
                               for n in ("dp_sq_norms", "dp_scaled_sum")}
            got, norms = dp.fused_clipped_masked_sum(grads, mask, DP_CLIP, return_norms=True)
            want, want_norms = fused_plain(dp, grads, mask, DP_CLIP)
            stats[f"fused norms {case} {tag}"] = check_stats(
                f"fused norms {case} {tag}", norms, want_norms, *DP_TOL["dp_sq_norms"])
            for k in want:
                stats[f"fused {case} {k} {tag}"] = check_stats(
                    f"fused {case} {k} {tag}", got[k], want[k], *DP_TOL["fused"])
            if case == "tree":
                clipped = int(((want_norms > DP_CLIP) * mask).sum())
                if not 0 < clipped < int(mask.sum()):
                    fail(f"tree check clips {clipped} examples: it must clip some, not all")
        del tree, grads
    print(json.dumps({"check": f"dp_clip {tag}",
                      "max_abs_err": {k: v["max_abs_err"] for k, v in stats.items()},
                      "bound_used": max(v["bound_used"] for v in stats.values()),
                      "tolerance": {k: list(v) for k, v in DP_TOL.items()}}))
    torch.cuda.empty_cache()
    return at_leaf


def dp_kernel_timings(dp) -> dict:
    """K1 and K2 at the DP path's largest leaf and over its whole per-example
    tree (f32, as the path gives them), beside their plain versions and one
    library call computing the same function (a yardstick the port never
    calls); device time per call, 20 calls a timing. Bounds: bytes in and out
    once over 3.35 TB/s, against two f32 operations per element over the f32
    rate."""
    res = {}
    time_it = lambda fn: cuda_ms(fn, calls=20)  # noqa: E731
    for case, shapes in (("leaf", {"Dense_0/kernel": (524288,)}), ("tree", CIFAR_LEAVES)):
        tree = dp_tree(shapes, BATCH, torch.float32, seed=31, grad_scale=True)
        mats = [v.reshape(BATCH, -1) for v in tree.values()]
        scale = torch.rand(BATCH, device="cuda")
        widths = [m.shape[1] for m in mats]
        elems = BATCH * sum(widths)
        k1_bytes = 4 * elems + 4 * BATCH * len(mats)
        k2_bytes = 4 * elems + 4 * BATCH * len(mats) + 4 * sum(widths)
        with torch.no_grad():
            res[case] = {
                "dp_sq_norms": dict(
                    ms=time_it(lambda: [dp.sq_norms_kernel(m) for m in mats]),
                    plain_ms=time_it(lambda: [dp.per_example_sq_norms_reference(m)
                                              for m in mats]),
                    library_ms=time_it(lambda: [torch.linalg.vector_norm(
                        m, dim=1, dtype=torch.float32) for m in mats]),
                    bound=bound_ms(2 * elems, k1_bytes, torch.float32)),
                "dp_scaled_sum": dict(
                    ms=time_it(lambda: [dp.scaled_sum_kernel(m, scale) for m in mats]),
                    plain_ms=time_it(lambda: [dp.scaled_masked_sum_reference(m, scale)
                                              for m in mats]),
                    library_ms=time_it(lambda: [torch.mv(m.t(), scale) for m in mats]),
                    bound=bound_ms(2 * elems, k2_bytes, torch.float32)),
            }
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({"timing": f"dp_clip {case} float32",
                          "shape": [BATCH, widths[0]] if case == "leaf" else
                          [BATCH, sum(widths)], "leaves": len(mats),
                          # threads that share a column group in K2, per leaf
                          "k2_split": [dp.scaled_sum_split(BATCH, w, 4, sms) for w in widths],
                          **{k: {kk: vv for kk, vv in r.items()}
                             for k, r in res[case].items()}}))
        del tree, mats
    torch.cuda.empty_cache()
    return res


def build_dp_sim(data, dtype, device, noise_multiplier, seed,
                 input_shape=(32, 32, 3), batch=BATCH, local_steps=LOCAL_STEPS):
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.clients import engine
    from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import CifarNet
    from fl4health_tpu_torch.server.simulation import FederatedSimulation
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    logic = InstanceLevelDpClientLogic(
        engine.from_module(CifarNet(dtype=dtype, input_shape=input_shape)),
        engine.masked_cross_entropy, clipping_bound=DP_CLIP,
        noise_multiplier=noise_multiplier)
    return FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=FedAvg(), datasets=data,
        batch_size=batch, metrics=MetricManager((efficient.accuracy(),)),
        local_steps=local_steps, seed=seed, device=device)


def image_datasets(n_clients: int, n_train: int, n_val: int, shape) -> list:
    from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
    from fl4health_tpu_torch.server.simulation import ClientDataset

    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(torch.Generator().manual_seed(i),
                                        n_train + n_val, shape, 10)
        out.append(ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def tiny_dp_parity(dp) -> None:
    """The same tiny DP run (f32, noise 0) on the card through the kernels
    and on the CPU through the plain versions, from the same params."""
    data = image_datasets(2, 16, 8, (32, 32, 3))
    runs = []
    for device in ("cuda", "cpu"):
        sim = build_dp_sim(data, torch.float32, device, 0.0, seed=3, batch=8,
                           local_steps=2)
        if runs:
            sim.set_global_params({k: v.cpu() for k, v in runs[0][2].items()})
        init = {k: v.clone() for k, v in sim.global_params.items()}
        dp.reset_launch_counts()
        runs.append((sim.fit(2), sim.global_params, init, dict(dp.LAUNCHES)))
    (gpu_hist, gpu_params, _, gpu_launches), (cpu_hist, cpu_params, _, cpu_launches) = runs
    if min(gpu_launches.values()) == 0 or max(cpu_launches.values()) != 0:
        fail(f"tiny DP run: launches {gpu_launches} on the card, {cpu_launches} on the CPU")
    for gr, cr in zip(gpu_hist, cpu_hist):
        check(f"tiny DP fit loss r{gr.round}", torch.tensor(gr.fit_losses["backward"]),
              torch.tensor(cr.fit_losses["backward"]), 5e-4, 0)
        check(f"tiny DP eval loss r{gr.round}",
              torch.tensor(gr.eval_losses["checkpoint"]),
              torch.tensor(cr.eval_losses["checkpoint"]), 5e-4, 0)
    err = max(check(f"tiny DP param {k}", gpu_params[k].cpu(), cpu_params[k], 5e-4, 0)
              for k in cpu_params)
    print(json.dumps({"tiny_dp_parity": "cuda kernels vs cpu plain", "rounds": 2,
                      "noise_multiplier": 0.0,
                      "fit_losses": [r.fit_losses["backward"] for r in gpu_hist],
                      "clip_fraction": [r.fit_losses["clip_fraction"] for r in gpu_hist],
                      "launches": gpu_launches, "max_param_abs_err": err}))


def dp_main_path(dp) -> dict:
    """Full-width DP-FedAvg of CifarNet, bf16 compute, 2 rounds."""
    from fl4health_tpu_torch.server.servers import InstanceLevelDpServer

    data = image_datasets(DP_CLIENTS, DP_TRAIN, DP_VAL, (32, 32, 3))
    sim = build_dp_sim(data, torch.bfloat16, "cuda", DP_SIGMA, seed=0)
    server = InstanceLevelDpServer(sim, noise_multiplier=DP_SIGMA, batch_size=BATCH)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp.reset_launch_counts()
    t0 = time.time()
    hist, epsilon = server.fit(DP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(dp.LAUNCHES)
    examples = DP_CLIENTS * LOCAL_STEPS * BATCH
    for r in hist:
        if not all(np.isfinite(v) for v in (*r.fit_losses.values(),
                                              *r.eval_losses.values())):
            fail(f"DP round {r.round}: non-finite losses {r.fit_losses} {r.eval_losses}")
        print(json.dumps({
            "dp_round": r.round, "fit_loss": r.fit_losses["backward"],
            "clip_fraction": r.fit_losses["clip_fraction"],
            "eval_loss": r.eval_losses["checkpoint"],
            "eval_accuracy": r.eval_metrics["accuracy"],
            "fit_s": r.fit_elapsed_s, "eval_s": r.eval_elapsed_s,
            "round_wall_s": r.fit_elapsed_s + r.eval_elapsed_s,
            "train_examples_per_s": examples / r.fit_elapsed_s}))
    moved = max(float((sim.global_params[k] - init[k]).abs().max()) for k in init)
    finite = all(torch.isfinite(v).all() for v in sim.global_params.values())
    if not finite or moved <= 0:
        fail(f"DP global params after training: finite={finite}, max change {moved}")
    # per round: 64 clients x 5 steps x 8 leaves, one K1 and one K2 launch each
    per_round = DP_CLIENTS * LOCAL_STEPS * len(CIFAR_LEAVES)
    expected = {"dp_sq_norms": DP_ROUNDS * per_round, "dp_scaled_sum": DP_ROUNDS * per_round}
    print(json.dumps({"main_path": "dp_fedavg_cifar_cnn", "rounds": DP_ROUNDS,
                      "wall_s": wall, "epsilon": epsilon,
                      "n_params": sum(v.numel() for v in init.values()),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "max_param_change": moved, "launches": launches,
                      "expected_launches": expected}))
    if abs(epsilon - DP_EPSILON) > 1e-9:
        fail(f"DP epsilon {epsilon!r}, the accountant gives {DP_EPSILON!r}")
    if launches != expected:
        fail(f"DP main-path launches {launches}, expected {expected}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: needs an NVIDIA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fl4health_tpu_torch.kernels import dp_clip as dp
    from fl4health_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False  # and f32 convolutions too
    card = card_line()
    print(card)

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:  # each build compiles its sources in parallel
        for build in [pool.submit(m.build_extension) for m in (fa, dp)]:
            build.result()
    print(json.dumps({"build_s": time.time() - t0}))

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = kernel_checks(fa, B, T, dtype, seed=1,
                                    autograd_check=dtype == torch.float32)
        kernel_checks(fa, 4, RAGGED_T, dtype, seed=2, autograd_check=True)
    # bf16 at head dim 12 (24-byte rows, no TMA stride): the CUDA-core route
    # through the wrapper and autograd
    kernel_checks(fa, 4, RAGGED_T, torch.bfloat16, seed=3, autograd_check=True, d=12)
    timings = kernel_timings(fa, torch.bfloat16)
    tiny_parity()
    bf16_model_check(fa)
    launches = main_path(fa)

    dp_errs = {dtype: dp_kernel_checks(dp, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    dp_timings = dp_kernel_timings(dp)
    tiny_dp_parity(dp)
    dp_launches = dp_main_path(dp)

    replaces = {"flash_fwd": "fl4health_tpu/kernels/flash_attention.py:71",
                "flash_bwd_dq": "fl4health_tpu/kernels/flash_attention.py:141",
                "flash_bwd_dkv": "fl4health_tpu/kernels/flash_attention.py:175"}
    kernels = []
    for name, rep in replaces.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": WGMMA_SOURCE, "replaces": rep,
            "design": "wgmma", "launches": launches[name],
            "max_abs_err": errs[torch.bfloat16]["max_abs_err"][name],
            "bound_used": errs[torch.bfloat16]["bound_used"][name],
            "max_abs_err_f32": errs[torch.float32]["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # the first slice's CUDA-core kernel that this one replaces for
            # bf16 (f32 still takes it), timed here on the same inputs, and
            # its error there
            "cuda_core_source": SOURCE, "cuda_core_ms": t["cuda_core_ms"],
            "cuda_core_max_abs_err": errs[torch.bfloat16]["max_abs_err"]["cuda_core"][name],
            # one SDPA backward call, which computes dQ, dK and dV together
            **({"library_dqkv_ms": t["library_dqkv_ms"]} if "library_dqkv_ms" in t else {}),
            "dtype": "bfloat16", "shape": [B, T, H, D]})
    dp_replaces = {"dp_sq_norms": "fl4health_tpu/kernels/dp_clip.py:54",
                   "dp_scaled_sum": "fl4health_tpu/kernels/dp_clip.py:100"}
    for name, rep in dp_replaces.items():
        t, tree = dp_timings["leaf"][name], dp_timings["tree"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": DP_SOURCE, "replaces": rep,
            "launches": dp_launches[name],
            "max_abs_err": dp_errs[torch.float32][name],
            "max_abs_err_bf16": dp_errs[torch.bfloat16][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # the same over all 8 leaves of the CifarNet per-example tree
            "tree_ms": tree["ms"], "tree_plain_ms": tree["plain_ms"],
            "tree_bound_ms": tree["bound"][0], "tree_library_ms": tree["library_ms"],
            "dtype": "float32", "shape": [BATCH, 524288]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
